"""The optimizers the fits take by name: ``optimizer(method, leaves, lr)``.

The JAX package's angular loop takes ``getattr(optax, method)(learning_rate)``
and its schema accepts any optax callable.  The port takes every optimizer of
optax 0.2.6's aliases by its name (``METHODS``), each with optax's defaults
and its update arithmetic, in the order optax does it: the ``scale_by_*``
transforms, then ``add_decayed_weights`` where optax chains it there, then
``-learning_rate`` times the result added to the parameter (``_Optax.update``;
a class whose chain ends otherwise writes its own).  Every state entry is a
tensor shaped like its parameter, or a 0-d or 1-d tensor (``count`` a Python
int), so ``state_dict()`` is what a checkpoint holds.

``adam`` is ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8): optax's update
up to the order of its roundings (the 1V loops have always taken it).
``torch.optim.RMSprop`` puts eps outside the root and ``torch.optim``'s
Adamax, Adagrad, NAdam, RAdam and AdamW part from optax's in their eps
placement, initial accumulators, bias correction or weight decay, so the
others are written here.

The JAX loop calls ``solver.update(grad, state)`` without the parameters.
adadelta, adafactor, adamaxw, adamw, adan, fromage, lamb, lars, lion,
nadamw and novograd need them (weight decay, trust ratios, the parameter
scale) and raise there; the port gives them the parameters, as optax's own
examples do (ROADMAP.md §3).  ``lbfgs`` and ``polyak_sgd`` need the loss value
in ``update`` as well, and fail in the JAX loop; the port raises for them
with that reason (``UNRUNNABLE``).  ``sm3`` keeps one accumulator per
dimension of a leaf and fails on a 0-d leaf in optax; the port raises there
too.  ``noisy_sgd`` draws its noise from a ``torch.Generator`` seeded with 0,
the seed of optax's default key; JAX's random stream itself cannot be
matched (ROADMAP.md §3).
"""

import math

import numpy as np
import torch


class _Optax(torch.optim.Optimizer):
    """One optax ``chain(scale_by_..., [add_decayed_weights,] scale_by_learning_rate(lr))`` per leaf."""

    DEFAULTS = {}

    def __init__(self, params, lr, **overrides):
        super().__init__(params, dict(self.DEFAULTS, lr=lr, **overrides))

    def init_state(self, p, group):
        """The transform's state of one parameter, before the first step."""
        return {}

    def direction(self, g, state, group, p):
        """The transform's update of one parameter at step ``state["count"]`` (1 at the first)."""
        raise NotImplementedError

    def update(self, g, state, group, p):
        """What is added to the parameter: the direction, the decayed weights where the group has them, times
        -lr."""
        u = self.direction(g, state, group, p)
        if group.get("weight_decay"):
            u = u + group["weight_decay"] * p
        return u * -group["lr"]

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self.init_state(p, group), count=0)
                state["count"] += 1
                p.add_(self.update(p.grad, state, group, p))


def _moment(g, m, decay):
    """optax's ``update_moment``: (1 - decay) g + decay m."""
    return (1 - decay) * g + decay * m


def _bias_corrected(m, decay, count):
    return m / torch.tensor(1 - decay**count, dtype=m.dtype, device=m.device)


def _zeros(p, *names):
    return {k: torch.zeros_like(p) for k in names}


class SGD(_Optax):
    """``optax.sgd(lr)``: no momentum."""

    def direction(self, g, state, group, p):
        return g


class RMSprop(_Optax):
    """``optax.rmsprop(lr)``: nu = decay nu + (1 - decay) g^2 from nu = 0, update rsqrt(nu + eps) g (eps inside the
    root, where ``torch.optim.RMSprop`` puts it outside)."""

    DEFAULTS = dict(decay=0.9, eps=1e-8)

    def init_state(self, p, group):
        return _zeros(p, "nu")

    def direction(self, g, state, group, p):
        state["nu"] = _moment(g * g, state["nu"], group["decay"])
        return torch.rsqrt(state["nu"] + group["eps"]) * g


class _AdamFamily(_Optax):
    """``scale_by_adam``'s moments; ``nesterov`` is optax's nadam form of the first moment."""

    DEFAULTS = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0)
    nesterov = False

    def init_state(self, p, group):
        return _zeros(p, "mu", "nu")

    def moments(self, g, state, group):
        """(mu_hat, nu_hat) after this step's moment updates."""
        b1, b2, t = group["b1"], group["b2"], state["count"]
        state["mu"] = _moment(g, state["mu"], b1)
        state["nu"] = _moment(g * g, state["nu"], b2)
        if self.nesterov:
            mu_hat = b1 * _bias_corrected(state["mu"], b1, t + 1) + (1 - b1) * _bias_corrected(g, b1, t)
        else:
            mu_hat = _bias_corrected(state["mu"], b1, t)
        return mu_hat, _bias_corrected(state["nu"], b2, t)

    def direction(self, g, state, group, p):
        mu_hat, nu_hat = self.moments(g, state, group)
        return mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])


class AdamW(_AdamFamily):
    """``optax.adamw(lr)``: adam, then weight decay 1e-4 on every parameter."""

    DEFAULTS = dict(_AdamFamily.DEFAULTS, weight_decay=1e-4)


class NAdam(_AdamFamily):
    """``optax.nadam(lr)``: adam with the Nesterov first moment."""

    nesterov = True


class RAdam(_AdamFamily):
    """``optax.radam(lr)``: the rectified adam update where rho >= 5, the bias-corrected first moment before."""

    DEFAULTS = dict(_AdamFamily.DEFAULTS, threshold=5.0)

    def direction(self, g, state, group, p):
        b2, t = group["b2"], state["count"]
        mu_hat, nu_hat = self.moments(g, state, group)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2**t
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        if ro < group["threshold"]:
            return mu_hat
        r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return r * mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])


class AMSGrad(_AdamFamily):
    """``optax.amsgrad(lr)``: adam over the running maximum of the bias-corrected second moment."""

    def init_state(self, p, group):
        return _zeros(p, "mu", "nu", "nu_max")

    def direction(self, g, state, group, p):
        mu_hat, nu_hat = self.moments(g, state, group)
        state["nu_max"] = torch.maximum(state["nu_max"], nu_hat)
        return mu_hat / (torch.sqrt(state["nu_max"] + group["eps_root"]) + group["eps"])


class AdaBelief(_AdamFamily):
    """``optax.adabelief(lr)``: the second moment of g - mu, plus eps_root, eps 1e-16 outside the root."""

    DEFAULTS = dict(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16)

    def direction(self, g, state, group, p):
        b1, b2, t = group["b1"], group["b2"], state["count"]
        state["mu"] = _moment(g, state["mu"], b1)
        err = g - state["mu"]
        state["nu"] = _moment(err * err, state["nu"], b2) + group["eps_root"]
        mu_hat, nu_hat = _bias_corrected(state["mu"], b1, t), _bias_corrected(state["nu"], b2, t)
        return mu_hat / (torch.sqrt(nu_hat) + group["eps"])


class Yogi(_AdamFamily):
    """``optax.yogi(lr)``: both moments from 1e-6, nu -= (1 - b2) sign(nu - g^2) g^2, eps 1e-3."""

    DEFAULTS = dict(b1=0.9, b2=0.999, eps=1e-3, eps_root=0.0)

    def init_state(self, p, group):
        return {k: torch.full_like(p, 1e-6) for k in ("mu", "nu")}

    def direction(self, g, state, group, p):
        b1, b2, t = group["b1"], group["b2"], state["count"]
        state["mu"] = _moment(g, state["mu"], b1)
        g2 = g * g
        state["nu"] = state["nu"] - (1 - b2) * torch.sign(state["nu"] - g2) * g2
        mu_hat, nu_hat = _bias_corrected(state["mu"], b1, t), _bias_corrected(state["nu"], b2, t)
        return mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])


class Adamax(_AdamFamily):
    """``optax.adamax(lr)``: the infinity norm max(|g| + eps, b2 nu), no bias correction of it."""

    def direction(self, g, state, group, p):
        b1, t = group["b1"], state["count"]
        state["mu"] = _moment(g, state["mu"], b1)
        state["nu"] = torch.maximum(torch.abs(g) + group["eps"], group["b2"] * state["nu"])
        return _bias_corrected(state["mu"], b1, t) / state["nu"]


class Adagrad(_Optax):
    """``optax.adagrad(lr)``: the sum of squares from 0.1, update rsqrt(sum + 1e-7) g where the sum is positive."""

    DEFAULTS = dict(initial_accumulator_value=0.1, eps=1e-7)

    def init_state(self, p, group):
        return {"sum_of_squares": torch.full_like(p, group["initial_accumulator_value"])}

    def direction(self, g, state, group, p):
        s = state["sum_of_squares"] = g * g + state["sum_of_squares"]
        return torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0) * g


class Lion(_Optax):
    """``optax.lion(lr)``: sign((1 - b1) g + b1 mu), mu with b2, then weight decay 1e-3."""

    DEFAULTS = dict(b1=0.9, b2=0.99, weight_decay=1e-3)

    def init_state(self, p, group):
        return _zeros(p, "mu")

    def direction(self, g, state, group, p):
        u = torch.sign((1.0 - group["b1"]) * g + group["b1"] * state["mu"])
        state["mu"] = _moment(g, state["mu"], group["b2"])
        return u


def _safe_norm(x, min_norm):
    """optax's ``safe_norm``: max(||x||, min_norm), the norm over every entry."""
    norm = torch.linalg.vector_norm(x)
    return torch.where(norm <= min_norm, torch.full_like(norm, min_norm), norm)


def _trust_ratio(u, p, min_norm=0.0, trust_coefficient=1.0, eps=0.0):
    """optax's ``scale_by_trust_ratio`` of one leaf: u times coefficient ||p|| / (||u|| + eps), 1 where either
    norm is 0."""
    param_norm, update_norm = _safe_norm(p, min_norm), _safe_norm(u, min_norm)
    ratio = trust_coefficient * param_norm / (update_norm + eps)
    return u * torch.where((param_norm == 0.0) | (update_norm == 0.0), torch.ones_like(ratio), ratio)


class AdamaxW(Adamax):
    """``optax.adamaxw(lr)``: adamax, then weight decay 1e-4."""

    DEFAULTS = dict(Adamax.DEFAULTS, weight_decay=1e-4)


class NAdamW(NAdam):
    """``optax.nadamw(lr)``: nadam, then weight decay 1e-4."""

    DEFAULTS = dict(NAdam.DEFAULTS, weight_decay=1e-4)


class SignSGD(_Optax):
    """``optax.sign_sgd(lr)``: the sign of the gradient."""

    def direction(self, g, state, group, p):
        return torch.sign(g)


class NoisySGD(_Optax):
    """``optax.noisy_sgd(lr)``: g plus Gaussian noise of variance eta / count^gamma (eta 0.01, gamma 0.55), drawn
    from a ``torch.Generator`` seeded with ``seed`` (one a device)."""

    DEFAULTS = dict(eta=0.01, gamma=0.55, seed=0)

    def __init__(self, params, lr, **overrides):
        super().__init__(params, lr, **overrides)
        self._generators = {}

    def direction(self, g, state, group, p):
        gen = self._generators.get(g.device)
        if gen is None:
            gen = self._generators[g.device] = torch.Generator(device=g.device).manual_seed(group["seed"])
        std = math.sqrt(group["eta"] / state["count"] ** group["gamma"])
        return g + std * torch.randn(g.shape, generator=gen, dtype=g.dtype, device=g.device)


class OptimisticGD(_Optax):
    """``optax.optimistic_gradient_descent(lr)``: (alpha + beta) g - beta g_prev, g_prev = g at the first step."""

    DEFAULTS = dict(alpha=1.0, beta=1.0)

    def init_state(self, p, group):
        return _zeros(p, "previous_gradient")

    def optimistic(self, g, state, alpha, beta):
        prev = g if state["count"] == 1 else state["previous_gradient"]
        state["previous_gradient"] = g.clone()
        return (alpha + beta) * g - beta * prev

    def direction(self, g, state, group, p):
        return self.optimistic(g, state, group["alpha"], group["beta"])


class OptimisticAdamV2(_AdamFamily):
    """``optax.optimistic_adam_v2(lr)``: adam with the Nesterov first moment, then the optimistic step
    (alpha = beta = 1) on its direction."""

    DEFAULTS = dict(_AdamFamily.DEFAULTS, alpha=1.0, beta=1.0)
    nesterov = True

    def init_state(self, p, group):
        return _zeros(p, "mu", "nu", "previous_gradient")

    optimistic = OptimisticGD.optimistic

    def direction(self, g, state, group, p):
        return self.optimistic(_AdamFamily.direction(self, g, state, group, p), state, group["alpha"], group["beta"])


class OptimisticAdam(OptimisticAdamV2):
    """``optax.optimistic_adam(lr)`` (deprecated in optax): as v2 with alpha = beta = lr, and no learning-rate
    scale after it (the chain ends with ``scale_by_learning_rate(1.0)``)."""

    def update(self, g, state, group, p):
        return -self.optimistic(_AdamFamily.direction(self, g, state, group, p), state, group["lr"], group["lr"])


class Rprop(_Optax):
    """``optax.rprop(lr)``: per-entry step sizes from lr, times 1.2 where the gradient kept its sign and 0.5 where
    it flipped, within [1e-6, 50].  As optax 0.2.6 writes it, the update applied is the previous step's
    sign(g) x step size, zeroed where the sign flipped (zero at the first step); the learning rate is in the
    step sizes."""

    DEFAULTS = dict(eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6, max_step_size=50.0)

    def init_state(self, p, group):
        return {"step_sizes": torch.full_like(p, group["lr"]), "prev_updates": torch.zeros_like(p)}

    def update(self, g, state, group, p):
        sign = g * state["prev_updates"]
        factor = torch.full_like(g, group["eta_minus"]).masked_fill_(sign > 0, group["eta_plus"])  # in g's dtype
        grown = factor * state["step_sizes"]
        steps = torch.where(sign == 0, state["step_sizes"],
                            torch.clamp(grown, min=group["min_step_size"], max=group["max_step_size"]))
        u = torch.where(sign < 0, torch.zeros_like(g), state["prev_updates"])
        state["step_sizes"] = steps
        state["prev_updates"] = torch.where(sign < 0, torch.zeros_like(g), steps * torch.sign(g))
        return -u


class SM3(_Optax):
    """``optax.sm3(lr)``: one accumulator a dimension of a leaf (``mu_0``, ``mu_1``, ...), the entry's
    accumulator g^2 + the least of its dimensions', rsqrt of it times g, a momentum of 0.9 over that."""

    DEFAULTS = dict(b1=0.9, eps=1e-8)

    def init_state(self, p, group):
        if p.dim() == 0:
            raise ValueError("optax's sm3 keeps one accumulator per dimension of a leaf and has none for a 0-d "
                             "leaf: it fails on one (IndexError in scale_by_sm3), in the JAX angular loop too")
        return {**{f"mu_{i}": p.new_zeros(n) for i, n in enumerate(p.shape)}, "nu": torch.zeros_like(p)}

    def direction(self, g, state, group, p):
        mus = [state[f"mu_{i}"].reshape([1] * i + [n] + [1] * (g.dim() - i - 1)) for i, n in enumerate(g.shape)]
        accum = g * g + (mus[0] if g.dim() < 2 else torch.stack(torch.broadcast_tensors(*mus)).amin(dim=0))
        inv = torch.where(accum > 0, torch.rsqrt(accum + group["eps"]), torch.zeros_like(accum))
        state["nu"] = _moment(g * inv, state["nu"], group["b1"])
        for i in range(g.dim()):
            state[f"mu_{i}"] = accum if g.dim() < 2 else accum.amax(dim=[d for d in range(g.dim()) if d != i])
        return state["nu"]


class Adadelta(_Optax):
    """``optax.adadelta(lr)``: e_g = rho e_g + (1 - rho) g^2, u = sqrt(e_x + eps) / sqrt(e_g + eps) g,
    e_x = rho e_x + (1 - rho) u^2 (rho 0.9, eps 1e-6); its weight decay (0) comes first."""

    DEFAULTS = dict(rho=0.9, eps=1e-6)

    def init_state(self, p, group):
        return _zeros(p, "e_g", "e_x")

    def direction(self, g, state, group, p):
        rho, eps = group["rho"], group["eps"]
        state["e_g"] = _moment(g * g, state["e_g"], rho)
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(state["e_g"] + eps) * g
        state["e_x"] = _moment(u * u, state["e_x"], rho)
        return u


class Adafactor(_Optax):
    """``optax.adafactor(lr)``: the factored second moment of a leaf whose two largest dimensions are both at
    least 128 (row and column means of g^2 + 1e-30), the full one of any other, decaying by
    1 - (step + 1)^-0.8 (in float32, as optax forms it); the update clipped to a block RMS of 1, times lr,
    times the leaf's RMS (at least 1e-3)."""

    DEFAULTS = dict(min_dim_size_to_factor=128, decay_rate=0.8, clipping_threshold=1.0, eps=1e-30, min_scale=1e-3)

    def _factored(self, shape, group):
        """optax's ``_factored_dims``: (d1, d0), the two largest dimensions, or None."""
        if len(shape) < 2:
            return None
        dims = np.argsort(shape)
        if shape[dims[-2]] < group["min_dim_size_to_factor"]:
            return None
        return int(dims[-2]), int(dims[-1])

    def init_state(self, p, group):
        factored = self._factored(tuple(p.shape), group)
        if factored is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = factored
        return {"v_row": p.new_zeros([n for i, n in enumerate(p.shape) if i != d0]),
                "v_col": p.new_zeros([n for i, n in enumerate(p.shape) if i != d1])}

    def update(self, g, state, group, p):
        t = np.float32(state["count"])  # optax's step + 1
        decay = float(np.float32(1.0) - t ** np.float32(-group["decay_rate"]))
        grad_sqr = g * g + group["eps"]
        factored = self._factored(tuple(p.shape), group)
        if factored is None:
            state["v"] = decay * state["v"] + (1.0 - decay) * grad_sqr
            u = g * state["v"] ** -0.5
        else:
            d1, d0 = factored
            state["v_row"] = decay * state["v_row"] + (1.0 - decay) * torch.mean(grad_sqr, dim=d0)
            state["v_col"] = decay * state["v_col"] + (1.0 - decay) * torch.mean(grad_sqr, dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (state["v_row"] / torch.mean(state["v_row"], dim=reduced_d1, keepdim=True)) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (state["v_col"] ** -0.5).unsqueeze(d1)
        u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / group["clipping_threshold"], min=1.0)
        u = u * group["lr"]
        rms = torch.sqrt(torch.mean(p * p))
        return -(u * torch.where(rms <= group["min_scale"], torch.full_like(rms, group["min_scale"]), rms))


class Adan(_Optax):
    """``optax.adan(lr)``: the moments of g, of g - g_prev and of (g + (1 - b2)(g - g_prev))^2, bias-corrected,
    (m + (1 - b2) v) / (sqrt(n + eps_root) + eps) (b1 0.98, b2 0.92, b3 0.99, eps and eps_root 1e-8); its
    weight decay (0) after it."""

    DEFAULTS = dict(b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8)

    def init_state(self, p, group):
        return _zeros(p, "m", "v", "n", "g")

    def direction(self, g, state, group, p):
        b1, b2, b3, t = group["b1"], group["b2"], group["b3"], state["count"]
        diff = torch.zeros_like(g) if t == 1 else g - state["g"]
        state["m"] = _moment(g, state["m"], b1)
        state["v"] = _moment(diff, state["v"], b2)
        sq = g + (1 - b2) * diff
        state["n"] = _moment(sq * sq, state["n"], b3)
        state["g"] = g.clone()
        m_hat, v_hat, n_hat = (_bias_corrected(state[k], b, t) for k, b in (("m", b1), ("v", b2), ("n", b3)))
        return (m_hat + (1 - b2) * v_hat) / (torch.sqrt(n_hat + group["eps_root"]) + group["eps"])


class Fromage(_Optax):
    """``optax.fromage(lr)``: the trust ratio (norms at least 1e-6), times lr / sqrt(1 + lr^2), then the
    parameter decayed by 1 / sqrt(1 + lr^2) - 1."""

    DEFAULTS = dict(min_norm=1e-6)

    def update(self, g, state, group, p):
        mult = 1.0 / math.sqrt(1.0 + group["lr"] ** 2)
        return -(group["lr"] * mult) * _trust_ratio(g, p, group["min_norm"]) + (mult - 1.0) * p


class Lamb(_AdamFamily):
    """``optax.lamb(lr)``: adam (eps 1e-6), its weight decay (0), then the trust ratio."""

    DEFAULTS = dict(_AdamFamily.DEFAULTS, eps=1e-6, weight_decay=0.0)

    def update(self, g, state, group, p):
        u = _AdamFamily.direction(self, g, state, group, p) + group["weight_decay"] * p
        return -group["lr"] * _trust_ratio(u, p)


class Lars(_Optax):
    """``optax.lars(lr)``: its weight decay (0), the trust ratio with coefficient 1e-3, times -lr, then a
    momentum trace of 0.9."""

    DEFAULTS = dict(weight_decay=0.0, trust_coefficient=0.001, eps=0.0, momentum=0.9)

    def init_state(self, p, group):
        return _zeros(p, "trace")

    def update(self, g, state, group, p):
        u = _trust_ratio(g + group["weight_decay"] * p, p, 0.0, group["trust_coefficient"], group["eps"])
        state["trace"] = -group["lr"] * u + group["momentum"] * state["trace"]
        return state["trace"]


class Novograd(_Optax):
    """``optax.novograd(lr)``: a second moment per leaf of ||g||^2 (b2 0.25, from the first step's), the first
    moment b1 mu + g / (sqrt(nu) + eps) + wd p (b1 0.9, eps 1e-6, wd 0)."""

    DEFAULTS = dict(b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0, decay=0.0)

    def init_state(self, p, group):
        return {"mu": torch.zeros_like(p), "nu": p.new_zeros(())}

    def direction(self, g, state, group, p):
        norm2 = torch.linalg.vector_norm(g) ** 2
        state["nu"] = norm2 if state["count"] == 1 else _moment(norm2, state["nu"], group["b2"])
        u = g / (torch.sqrt(state["nu"] + group["eps_root"]) + group["eps"]) + group["decay"] * p
        state["mu"] = u if state["count"] == 1 else group["b1"] * state["mu"] + u
        return state["mu"]


_CLASSES = {"sgd": SGD, "rmsprop": RMSprop, "adamw": AdamW, "adamax": Adamax, "adagrad": Adagrad,
            "adabelief": AdaBelief, "amsgrad": AMSGrad, "nadam": NAdam, "lion": Lion, "yogi": Yogi, "radam": RAdam,
            "noisy_sgd": NoisySGD, "optimistic_adam": OptimisticAdam, "optimistic_adam_v2": OptimisticAdamV2,
            "optimistic_gradient_descent": OptimisticGD, "rprop": Rprop, "sign_sgd": SignSGD, "sm3": SM3,
            "adadelta": Adadelta, "adafactor": Adafactor, "adamaxw": AdamaxW, "adan": Adan, "fromage": Fromage,
            "lamb": Lamb, "lars": Lars, "novograd": Novograd, "nadamw": NAdamW}
METHODS = ("adam",) + tuple(_CLASSES)  # the optax names the angular fit takes
# optax optimizers whose update needs the loss value: the JAX loop's update(grad, state) fails for them
UNRUNNABLE = {
    "lbfgs": (ValueError, "optax's lbfgs needs the parameters, the loss value, the gradient and value_fn in "
                          "update(); the angular loop calls update(grad, state) as the JAX package's does "
                          "(tsadar_tpu/inverse/loops.py:444), which fails there (ValueError: Expected None)"),
    "polyak_sgd": (TypeError, "optax's polyak_sgd needs the loss value in update(); the angular loop calls "
                              "update(grad, state) as the JAX package's does (tsadar_tpu/inverse/loops.py:444), "
                              "which fails there (TypeError: missing 'value')"),
}


def optimizer(method, leaves, lr, capturable=False):
    """The optimizer ``method`` (an optax name of ``METHODS``) over ``leaves`` at learning rate ``lr``.

    ``capturable`` (adam only) keeps Adam's step count on the device, so that its step can be captured in a CUDA
    graph (``loops._1d_adam_loop_`` on the card)."""
    if method == "adam":
        return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
    if method in UNRUNNABLE:
        error, reason = UNRUNNABLE[method]
        raise error(reason)
    if method not in _CLASSES:
        raise ValueError(f"optimizer method {method!r} is not an optax optimizer: the port takes {METHODS}")
    return _CLASSES[method](leaves, lr=lr)
