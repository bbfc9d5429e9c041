"""The optimizers the fits take by name: ``optimizer(method, leaves, lr)``.

The JAX package's angular loop takes ``getattr(optax, method)(learning_rate)``
and its schema accepts any optax callable.  The port takes the names in
``METHODS``, each with optax 0.2's defaults and its update arithmetic, in the
order optax does it: the direction of the ``scale_by_*`` transform, then
``add_decayed_weights`` (adamw, lion), then ``-learning_rate`` times it added
to the parameter.  Every state entry is a tensor shaped like its parameter
(``count`` a Python int), so ``state_dict()`` is what a checkpoint holds.

``adam`` is ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8): optax's update
up to the order of its roundings (the 1V loops have always taken it).
``torch.optim.RMSprop`` puts eps outside the root and ``torch.optim``'s
Adamax, Adagrad, NAdam, RAdam and AdamW part from optax's in their eps
placement, initial accumulators, bias correction or weight decay, so the
others are written here.  Any other optax name is refused by the schema
(``utils.schema``), a recorded departure (ROADMAP.md §3).

The JAX loop calls ``solver.update(grad, state)`` without the parameters,
which ``add_decayed_weights`` needs: adamw and lion raise there.  The port
gives them the parameters, as optax's own examples do (ROADMAP.md §3).
"""

import math

import torch


class _Optax(torch.optim.Optimizer):
    """One optax ``chain(scale_by_..., [add_decayed_weights,] scale_by_learning_rate(lr))`` per leaf."""

    DEFAULTS = {}

    def __init__(self, params, lr, **overrides):
        super().__init__(params, dict(self.DEFAULTS, lr=lr, **overrides))

    def init_state(self, p, group):
        """The transform's state of one parameter, before the first step."""
        return {}

    def direction(self, g, state, group):
        """The transform's update of one parameter at step ``state["count"]`` (1 at the first)."""
        raise NotImplementedError

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
                u = self.direction(p.grad, state, group)
                if group.get("weight_decay"):
                    u = u + group["weight_decay"] * p
                p.add_(u * -group["lr"])


def _moment(g, m, decay):
    """optax's ``update_moment``: (1 - decay) g + decay m."""
    return (1 - decay) * g + decay * m


def _bias_corrected(m, decay, count):
    return m / torch.tensor(1 - decay**count, dtype=m.dtype, device=m.device)


def _zeros(p, *names):
    return {k: torch.zeros_like(p) for k in names}


class SGD(_Optax):
    """``optax.sgd(lr)``: no momentum."""

    def direction(self, g, state, group):
        return g


class RMSprop(_Optax):
    """``optax.rmsprop(lr)``: nu = decay nu + (1 - decay) g^2 from nu = 0, update rsqrt(nu + eps) g (eps inside the
    root, where ``torch.optim.RMSprop`` puts it outside)."""

    DEFAULTS = dict(decay=0.9, eps=1e-8)

    def init_state(self, p, group):
        return _zeros(p, "nu")

    def direction(self, g, state, group):
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

    def direction(self, g, state, group):
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

    def direction(self, g, state, group):
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

    def direction(self, g, state, group):
        mu_hat, nu_hat = self.moments(g, state, group)
        state["nu_max"] = torch.maximum(state["nu_max"], nu_hat)
        return mu_hat / (torch.sqrt(state["nu_max"] + group["eps_root"]) + group["eps"])


class AdaBelief(_AdamFamily):
    """``optax.adabelief(lr)``: the second moment of g - mu, plus eps_root, eps 1e-16 outside the root."""

    DEFAULTS = dict(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16)

    def direction(self, g, state, group):
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

    def direction(self, g, state, group):
        b1, b2, t = group["b1"], group["b2"], state["count"]
        state["mu"] = _moment(g, state["mu"], b1)
        g2 = g * g
        state["nu"] = state["nu"] - (1 - b2) * torch.sign(state["nu"] - g2) * g2
        mu_hat, nu_hat = _bias_corrected(state["mu"], b1, t), _bias_corrected(state["nu"], b2, t)
        return mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])


class Adamax(_AdamFamily):
    """``optax.adamax(lr)``: the infinity norm max(|g| + eps, b2 nu), no bias correction of it."""

    def direction(self, g, state, group):
        b1, t = group["b1"], state["count"]
        state["mu"] = _moment(g, state["mu"], b1)
        state["nu"] = torch.maximum(torch.abs(g) + group["eps"], group["b2"] * state["nu"])
        return _bias_corrected(state["mu"], b1, t) / state["nu"]


class Adagrad(_Optax):
    """``optax.adagrad(lr)``: the sum of squares from 0.1, update rsqrt(sum + 1e-7) g where the sum is positive."""

    DEFAULTS = dict(initial_accumulator_value=0.1, eps=1e-7)

    def init_state(self, p, group):
        return {"sum_of_squares": torch.full_like(p, group["initial_accumulator_value"])}

    def direction(self, g, state, group):
        s = state["sum_of_squares"] = g * g + state["sum_of_squares"]
        return torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0) * g


class Lion(_Optax):
    """``optax.lion(lr)``: sign((1 - b1) g + b1 mu), mu with b2, then weight decay 1e-3."""

    DEFAULTS = dict(b1=0.9, b2=0.99, weight_decay=1e-3)

    def init_state(self, p, group):
        return _zeros(p, "mu")

    def direction(self, g, state, group):
        u = torch.sign((1.0 - group["b1"]) * g + group["b1"] * state["mu"])
        state["mu"] = _moment(g, state["mu"], group["b2"])
        return u


_CLASSES = {"sgd": SGD, "rmsprop": RMSprop, "adamw": AdamW, "adamax": Adamax, "adagrad": Adagrad,
            "adabelief": AdaBelief, "amsgrad": AMSGrad, "nadam": NAdam, "lion": Lion, "yogi": Yogi, "radam": RAdam}
METHODS = ("adam",) + tuple(_CLASSES)  # the optax names the angular fit takes


def optimizer(method, leaves, lr):
    """The optimizer ``method`` (an optax name of ``METHODS``) over ``leaves`` at learning rate ``lr``."""
    if method == "adam":
        return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if method not in _CLASSES:
        raise NotImplementedError(f"optimizer method {method!r} is not ported: the port takes {METHODS} "
                                  "(ROADMAP.md §1 item 7e)")
    return _CLASSES[method](leaves, lr=lr)
