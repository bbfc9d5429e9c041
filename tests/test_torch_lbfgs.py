"""The port's L-BFGS (``inverse/lbfgs.py``) step by step against ``optax.lbfgs()``, and its fit loop against JAX's.

On the CPU in float64:

* a smooth function (an extended Rosenbrock in 6 variables) for 15 steps from
  one start: every step's parameters, value and line-search step size agree
  with optax's to 1e-10 relative, and so do the line-search trials of each step;
  the steps include accepted unit steps, interval growth and zooms;
* the loss of ``tests/test_inverse/test_1d_random.py``'s seed-7 setup (the
  JAX spectrum at the truth as data, the mean squared error of ThryE over the
  flat active parameters in ``ravel_pytree`` order) for 4 steps: the same with
  the JAX loss (jitted, as inside optax's step) through both optimizers; with
  the port's own loss, parameters and values to 1e-8 (measured 5e-10 and
  1.3e-9: the lam gradient cancels ~8 digits, so the two models' last digits
  show), step sizes and trials the same;
* ``_1d_device_lbfgs_loop_`` against ``tsadar_tpu.inverse.loops`` own on the
  2-lineout ``_small_config`` (EPW feature alone, as the adam loop's test has
  it) for 3 epochs: the value and every fitted parameter to 1e-8 relative, the
  record's per-step values and evaluations; ``num_epochs`` 0 gives
  ``(inf, the initial parameters)``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.flatten_util import ravel_pytree

import __graft_entry__ as ge
from tsadar_tpu.inverse.loops import _1d_device_lbfgs_loop_ as jax_lbfgs_loop
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.core.params import get_filter_spec
from tsadar_tpu_torch.core.params.ts_params import ravel_order
from tsadar_tpu_torch.inverse import lbfgs
from tsadar_tpu_torch.inverse.loops import _1d_device_lbfgs_loop_, one_d_loop

from .test_inverse import test_1d_random as random_test
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

RTOL = 1e-10


def _optax_steps(fn, x0, n):
    """(parameters after each step, each step's value, step size and line-search trials) of ``optax.lbfgs()``."""
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(fn)

    @jax.jit
    def step(x, state):
        value, grad = value_and_grad(x, state=state)
        updates, state = opt.update(grad, state, x, value=value, grad=grad, value_fn=fn)
        return optax.apply_updates(x, updates), state, value

    state, xs, values, stepsizes, trials = opt.init(x0), [], [], [], []
    x = x0
    for _ in range(n):
        x, state, value = step(x, state)
        xs.append(np.asarray(x))
        values.append(float(value))
        stepsizes.append(float(state[2].learning_rate))
        trials.append(int(state[2].info.num_linesearch_steps))
    return xs, values, stepsizes, trials


def _port_steps(value_and_grad, x0, n):
    state, x, out = lbfgs.init(x0), x0, ([], [], [], [])
    for _ in range(n):
        x, value, state = lbfgs.step(x, state, value_and_grad)
        for lst, v in zip(out, (x.numpy().copy(), value, state.learning_rate, state.linesearch_steps)):
            lst.append(v)
    return out


def _assert_same_steps(want, got):
    for i, (wx, gx) in enumerate(zip(want[0], got[0])):
        np.testing.assert_allclose(gx, wx, rtol=RTOL, atol=RTOL * np.abs(wx).max(), err_msg=f"parameters, step {i}")
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, err_msg="values")
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL, err_msg="step sizes")
    assert got[3] == want[3], "line-search trials"


def _rosenbrock(x, lib):
    return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def test_lbfgs_matches_optax_on_a_smooth_function():
    x0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.5, -0.3])
    want = _optax_steps(lambda x: _rosenbrock(x, jnp), jnp.asarray(x0), 15)

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        value = _rosenbrock(x, torch)
        return value.detach(), torch.autograd.grad(value, x)[0]

    got = _port_steps(value_and_grad, torch.as_tensor(x0), 15)
    _assert_same_steps(want, got)
    assert max(want[3]) > 1 and min(want[3]) == 1  # zooms or interval growth, and accepted first trials
    assert want[1][-1] < 1e-2 * want[1][0]


def test_lbfgs_matches_optax_on_the_seed7_loss():
    config, _, diff0, static, jax_loss = random_test._setup(seed=7)
    x0, unravel = ravel_pytree(diff0)
    want = _optax_steps(lambda x: jax_loss(unravel(x)), x0, 4)

    from tsadar_tpu.core.diagnostic import ThomsonScatteringDiagnostic as JaxDiagnostic
    gt = random_test._setup(seed=7)[1]
    target = torch.as_tensor(np.array(JaxDiagnostic(config, scattering_angles=jax_angles(config))(gt, random_test.DUMMY_BATCH)[0]))
    diag = port.ThomsonScatteringDiagnostic(config, port.get_scattering_angles(config), device="cpu")
    params = port.ThomsonParams.create(config["parameters"], 1, activate=True, device="cpu")
    trainable = get_filter_spec(config["parameters"], params)
    leaves = [trainable[k] for k in ravel_order(trainable)]
    start = torch.cat([p.detach().reshape(-1) for p in leaves])
    np.testing.assert_allclose(start.numpy(), np.asarray(x0), rtol=1e-15)  # the same vector, in the same order

    def value_and_grad(x):
        with torch.no_grad():
            for i, p in enumerate(leaves):
                p.copy_(x[i : i + 1].view_as(p))
        value = torch.mean(torch.square(diag(params, random_test.DUMMY_BATCH)[0] - target))
        return value.detach(), torch.cat([g.reshape(-1) for g in torch.autograd.grad(value, leaves)])

    jax_vg = jax.jit(jax.value_and_grad(lambda v: jax_loss(unravel(v))))

    def jax_value_and_grad(x):  # the same function through both optimizers
        value, grad = jax_vg(jnp.asarray(x.numpy()))
        return torch.as_tensor(float(value), dtype=torch.float64), torch.as_tensor(np.array(grad))

    _assert_same_steps(want, _port_steps(jax_value_and_grad, start, 4))
    assert want[1][-1] < want[1][0]
    # the port's own loss: its lam gradient cancels ~8 digits, so the packages part by ~1e-9 after 4 steps
    got = _port_steps(value_and_grad, start, 4)
    for i, (wx, gx) in enumerate(zip(want[0], got[0])):
        np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-8 * np.abs(wx).max(), err_msg=f"parameters, step {i}")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-8, err_msg="values")
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL, err_msg="step sizes")
    assert got[3] == want[3]


def _loop_setup(num_epochs):
    cfg = ge._small_config(2)
    cfg["optimizer"].update(method="lbfgs", num_epochs=num_epochs)
    cfg["other"]["extraoptions"].update(load_ion_spec=False, fit_IAW=False)
    return cfg, ge._make_batch(2)


def _physical(ts_params):
    out = ts_params.get_unnormed_params()
    return {f"{g}.{k}": np.asarray(v.detach() if isinstance(v, torch.Tensor) else v) for g, d in out.items() for k, v in d.items()}


def test_device_lbfgs_loop_matches_jax():
    cfg, batch = _loop_setup(3)
    want_loss, want = jax_lbfgs_loop(cfg, JaxLoss(cfg, jax_angles(cfg), batch), None, batch)
    record = {}
    loss_fn = port.LossFunction(copy.deepcopy(cfg), port.get_scattering_angles(cfg), batch, device="cpu")
    got_loss, got = _1d_device_lbfgs_loop_(cfg, loss_fn, None, batch, record=record)
    assert isinstance(got_loss, float) and isinstance(got, port.ThomsonParams)
    assert all(p.grad is None for p in got.parameters())
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-8)
    want, got = _physical(want), _physical(got)
    for k in ("electron.Te", "electron.ne", "electron.m", "general.amp1", "general.amp2", "general.lam"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
    assert record["losses"][-1] == got_loss and len(record["losses"]) == 3
    assert record["losses"][2] < record["losses"][0]
    assert record["evaluations"][0] >= 2 and all(n >= 1 for n in record["evaluations"])  # the first step evaluates at x0
    assert len(record["stepsizes"]) == 3 and len(record["seconds"]) == 1


def test_device_lbfgs_loop_zero_epochs_and_one_d_loop():
    cfg, batch = _loop_setup(0)
    loss_fn = port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu")
    loss, weights = _1d_device_lbfgs_loop_(cfg, loss_fn, None, batch)
    assert loss == np.inf
    init = port.ThomsonParams.create(cfg["parameters"], 2, activate=True, device="cpu")
    for (k, a), b in zip(weights.state_dict().items(), init.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    cfg["optimizer"]["num_epochs"] = 2
    all_data = {"e_data": batch["e_data"], "i_data": batch["i_data"], "e_amps": batch["e_amps"], "i_amps": batch["i_amps"],
                "noiseE": batch["noise_e"], "noiseI": batch["noise_i"]}
    record = {}
    weights, overall, loss_fn = one_d_loop(cfg, all_data, port.get_scattering_angles(cfg), np.arange(2), 1, device="cpu", record=record)
    assert len(weights) == 1 and np.isfinite(overall) and isinstance(loss_fn, port.LossFunction)
    assert len(record["losses"]) == 2 and overall == pytest.approx(record["losses"][-1], rel=0, abs=0)
