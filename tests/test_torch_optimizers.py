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

optax's weight decay (adamw, lion) needs the parameters:
``opt.update(grad, state, params)``.  The JAX package's angular loop leaves
them out, and raises for those two (ROADMAP.md §3); the reference here is
optax as its documentation calls it.  The schema takes the ported names and
refuses another (also ``tests/test_torch_schema.py``).
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
LR = 2e-3


def _optax_update(opt, grad, state, params):
    updates, state = opt.update(grad, state, params)
    return optax.apply_updates(params, updates), state


def test_the_ten_names():
    assert OPTAX_NAMES == ("sgd", "rmsprop", "adamw", "adamax", "adagrad", "adabelief", "amsgrad", "nadam", "lion", "yogi",
                           "radam")
    assert all(isinstance(optimizers.optimizer(m, [torch.nn.Parameter(torch.zeros(2))], 0.1), torch.optim.Optimizer)
               for m in optimizers.METHODS)
    with pytest.raises(NotImplementedError, match="not ported"):
        optimizers.optimizer("lamb", [torch.nn.Parameter(torch.zeros(2))], 0.1)
    cfg, _ = _config()  # the schema refuses it before any run, and takes the ported names
    for method in optimizers.METHODS:
        validate_config(dict(cfg, optimizer=dict(cfg["optimizer"], method=method)), mode="fit")
    with pytest.raises(ConfigError, match=r"'lamb' is not one of .*the port takes these optax optimizers"):
        validate_config(dict(cfg, optimizer=dict(cfg["optimizer"], method="lamb")), mode="fit")


@pytest.mark.parametrize("method", OPTAX_NAMES)
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


@pytest.mark.parametrize("method", OPTAX_NAMES)
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
