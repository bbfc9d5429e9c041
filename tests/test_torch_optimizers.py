"""The optimizers the port takes by their optax names (``tsadar_tpu_torch.inverse.optimizers``) against optax, in float64.

For each of ``METHODS`` but adam (``torch.optim.Adam``, held by the adam
loops' own tests), at optax's defaults:

* five steps on a fixed quadratic, 0.5 x.A.x - b.x over two leaves (a vector
  and a 0-d scalar, as the angular fit's leaves are), every parameter after
  every step to 1e-12 relative of optax's;
* three steps of ``angular_optax`` on the small ARTS 2V loss of
  ``tests/test_torch_arts_loss.py`` (the trainable 32 x 32 ``fval``) against
  optax's steps over the JAX package's loss: every loss and the best ``fval``
  to 1e-9 relative.

The optimizers this file added last (``NEW``) also take ten steps on a
separable quadratic over three leaves, a vector, a 0-d scalar and a
[128, 128] matrix (adafactor factors a leaf whose two largest dimensions are
both >= 128, as the ARTS 2V EDF is), every parameter after every step to
1e-12 relative of optax's.  ``noisy_sgd`` draws its noise from a
``torch.Generator``, which JAX's random stream cannot match: with eta 0 it is
``sgd`` to 1e-12, and its noise has the variance eta / count^0.55 (within 3 %
over 16 384 draws).  ``sm3`` fails on a 0-d leaf in optax and in the port.

optax's weight decay, trust ratios and parameter scale (adamw, lion,
adadelta, adafactor, adamaxw, adan, fromage, lamb, lars, nadamw, novograd)
need the parameters: ``opt.update(grad, state, params)``.  The JAX package's
angular loop leaves them out, and raises for those (ROADMAP.md §3); the
reference here is optax as its documentation calls it.  ``lbfgs`` and
``polyak_sgd`` need the loss value as well: they fail in the JAX loop's call,
and the port raises the same error types for them.  The schema takes every
optax optimizer's name and refuses another (also
``tests/test_torch_schema.py``).
"""

import numpy as np
import optax
import pytest
import torch
from jax import numpy as jnp

import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path
from tsadar_tpu_torch.inverse import optimizers
from tsadar_tpu_torch.utils.schema import ConfigError, validate_config

from .test_torch_arts_loss import FVAL, _all_data, _config, jax_side  # noqa: F401  (jax_side: module fixture)
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

OPTAX_NAMES = tuple(m for m in optimizers.METHODS if m != "adam")
NEW = ("noisy_sgd", "optimistic_adam", "optimistic_adam_v2", "optimistic_gradient_descent", "rprop", "sign_sgd", "sm3",
       "adadelta", "adafactor", "adamaxw", "adan", "fromage", "lamb", "lars", "novograd", "nadamw")
LR = 2e-3


def _optax_update(opt, grad, state, params):
    updates, state = opt.update(grad, state, params)
    return optax.apply_updates(params, updates), state


def test_the_ten_names():
    """The names: the ten of the first optax slice, then every other optimizer of optax's aliases."""
    assert OPTAX_NAMES == ("sgd", "rmsprop", "adamw", "adamax", "adagrad", "adabelief", "amsgrad", "nadam", "lion", "yogi",
                           "radam") + NEW
    assert set(optimizers.METHODS) | set(optimizers.UNRUNNABLE) == set(n for n in dir(optax._src.alias)
                                                                       if n in dir(optax) and n[0].islower()
                                                                       and callable(getattr(optax, n)))
    assert all(isinstance(optimizers.optimizer(m, [torch.nn.Parameter(torch.zeros(2))], 0.1), torch.optim.Optimizer)
               for m in optimizers.METHODS)
    with pytest.raises(ValueError, match="not an optax optimizer"):
        optimizers.optimizer("lambda", [torch.nn.Parameter(torch.zeros(2))], 0.1)
    cfg, _ = _config()  # the schema refuses it before any run, and takes every optax optimizer's name
    for method in optimizers.METHODS + ("polyak_sgd",):
        validate_config(dict(cfg, optimizer=dict(cfg["optimizer"], method=method)), mode="fit")
    with pytest.raises(ConfigError, match=r"'lambda' is not one of .*the port takes these optax optimizers"):
        validate_config(dict(cfg, optimizer=dict(cfg["optimizer"], method="lambda")), mode="fit")


@pytest.mark.parametrize("method, error", [("lbfgs", ValueError), ("polyak_sgd", TypeError)])
def test_what_needs_the_loss_value_fails_as_in_the_jax_loop(method, error):
    """optax's update(grad, state), the JAX angular loop's call, fails for these; the port raises the same type."""
    params = {"x": jnp.ones(3)}
    opt = getattr(optax, method)(0.1)
    with pytest.raises(error):
        opt.update({"x": jnp.ones(3)}, opt.init(params))
    with pytest.raises(error, match="update"):
        optimizers.optimizer(method, [torch.nn.Parameter(torch.zeros(3))], 0.1)


def _leaf_quadratic(seed):
    """(start values, curvatures, targets) of three leaves: a vector, a 0-d scalar and a [128, 128] matrix."""
    rng = np.random.default_rng(seed)
    shapes = {"v": (5,), "s": (), "M": (128, 128)}
    draw = lambda lo, hi: {k: rng.uniform(lo, hi, shp) for k, shp in shapes.items()}  # noqa: E731
    return draw(-1.0, 1.0), draw(0.5, 2.0), draw(-0.5, 0.5)


@pytest.mark.parametrize("method", NEW)
def test_the_new_optimizers_match_optax_for_ten_steps(method):
    start, curv, target = _leaf_quadratic(5)
    names = [k for k in start if not (method == "sm3" and k == "s")]  # sm3 has no accumulator for a 0-d leaf
    opt = optax.noisy_sgd(0.05, eta=0.0) if method == "noisy_sgd" else getattr(optax, method)(0.05)
    params = {k: jnp.asarray(start[k]) for k in names}
    state = opt.init(params)
    leaves = {k: torch.nn.Parameter(torch.tensor(start[k], dtype=torch.float64)) for k in names}
    if method == "noisy_sgd":
        mine = optimizers.NoisySGD(list(leaves.values()), 0.05, eta=0.0)
    else:
        mine = optimizers.optimizer(method, list(leaves.values()), 0.05)
    for _ in range(10):
        grads = {k: jnp.asarray(curv[k] * (np.asarray(params[k]) - target[k])) for k in names}
        params, state = _optax_update(opt, grads, state, params)
        for k, p in leaves.items():
            p.grad = torch.tensor(curv[k] * (p.detach().numpy() - target[k]))
        mine.step()
        for k, p in leaves.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-12, atol=1e-15, err_msg=k)
    if method == "sm3":
        scalar = {"s": jnp.asarray(0.3)}
        with pytest.raises(IndexError):
            opt.update({"s": jnp.asarray(0.1)}, opt.init(scalar), scalar)
        p = torch.nn.Parameter(torch.tensor(0.3, dtype=torch.float64))
        p.grad = torch.tensor(0.1, dtype=torch.float64)
        with pytest.raises(ValueError, match="0-d leaf"):
            optimizers.optimizer("sm3", [p], 0.05).step()


def test_noisy_sgd_noise_has_optaxs_variance():
    p = torch.nn.Parameter(torch.zeros((128, 128), dtype=torch.float64))
    opt = optimizers.optimizer("noisy_sgd", [p], 1.0)
    for count in range(1, 4):
        before = p.detach().clone()
        p.grad = torch.zeros_like(p)
        opt.step()
        noise = (before - p.detach()).numpy()  # -lr (g + std z), g = 0
        std = np.sqrt(0.01 / count**0.55)
        assert abs(noise.std() / std - 1.0) < 3e-2 and abs(noise.mean()) < 4 * std / 128
    again = torch.nn.Parameter(torch.zeros((128, 128), dtype=torch.float64))
    again.grad = torch.zeros_like(again)
    optimizers.optimizer("noisy_sgd", [again], 1.0).step()
    first = torch.nn.Parameter(torch.zeros((128, 128), dtype=torch.float64))
    first.grad = torch.zeros_like(first)
    optimizers.optimizer("noisy_sgd", [first], 1.0).step()
    assert torch.equal(again, first)  # the seed makes the draws reproducible


@pytest.mark.parametrize("method", [m for m in OPTAX_NAMES if m not in ("noisy_sgd", "sm3")])
def test_steps_on_a_quadratic_match_optax(method):
    rng = np.random.default_rng(3)
    m = rng.standard_normal((5, 5))
    a, b = m @ m.T + 5 * np.eye(5), rng.standard_normal(5)
    x0, s0 = rng.standard_normal(4), 0.7

    def grads(x, s):  # the quadratic over the joined vector (x, s)
        g = a @ np.concatenate([np.asarray(x), [float(s)]]) - b
        return g[:4], g[4]

    opt = getattr(optax, method)(0.05)
    params = {"s": jnp.asarray(s0), "x": jnp.asarray(x0)}
    state = opt.init(params)
    x, s = (torch.nn.Parameter(torch.tensor(v, dtype=torch.float64)) for v in (x0, s0))
    mine = optimizers.optimizer(method, [x, s], 0.05)
    for _ in range(5):
        gx, gs = grads(params["x"], params["s"])
        params, state = _optax_update(opt, {"s": jnp.asarray(gs), "x": jnp.asarray(gx)}, state, params)
        x.grad, s.grad = (torch.tensor(v, dtype=torch.float64) for v in grads(x.detach().numpy(), s.detach().numpy()))
        mine.step()
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(params["x"]), rtol=1e-12, atol=0)
        np.testing.assert_allclose(float(s), float(params["s"]), rtol=1e-12, atol=0)


@pytest.mark.parametrize("method", [m for m in OPTAX_NAMES if m != "noisy_sgd"])
def test_angular_fit_steps_match_optax(jax_side, method):  # noqa: F811
    _, _, batch, loss_fn, diff, static = jax_side
    opt = getattr(optax, method)(LR)
    state, want, fvals = opt.init(diff), [], []
    for _ in range(3):
        (value, _), grad = loss_fn._vg_func_(diff, static, batch)
        diff, state = _optax_update(opt, grad, state, diff)
        want.append(float(value))
        fvals.append(leaves_by_path(diff)[FVAL])
    # the best parameters: those after the step whose pre-update loss is the least
    want_fval = fvals[int(np.argmin(want))]

    cfg, sas = _config()
    cfg["optimizer"].update(method=method, learning_rate=LR, num_epochs=3, chunk_size=3)
    record = {}
    best, _, _ = port.angular_optax(cfg, _all_data(0), sas, device="cpu", record=record)
    np.testing.assert_allclose(record["losses"], want, rtol=1e-9)
    fval = best.electron.distribution_functions.fval.detach().numpy()
    np.testing.assert_allclose(fval, want_fval, rtol=0, atol=1e-9 * np.abs(want_fval).max())
