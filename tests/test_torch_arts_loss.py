"""The angular (ARTS 2V) loss, its gradient and the angular fit loop against the JAX package, on the CPU in float64.

At npts 128, a 128 x 128 CCD, nvx 32 (``num_beta`` 256), with the arbitrary 2D
EDF trainable (``fval`` [32, 32]) and data made from a seed:

* ``LossFunction``: loss, ThryE and the gradient with respect to ``fval``
  against ``tsadar_tpu``'s ``LossFunction._vg_func_``, to 1e-8 of the largest
  entry;
* ``angular_optax``: five adam steps and three rmsprop steps against the same
  steps taken with optax over the JAX loss (every loss to 1e-9 relative, the
  final ``fval`` to 1e-9), the window arithmetic on the deck, the early stop,
  the multiplexed loop, the 2V moment penalties, and what it refuses (the
  other optimizers are in ``tests/test_torch_optimizers.py``).
"""

import copy
import os

import jax
import numpy as np
import optax
import pytest
import torch
import yaml
from jax import numpy as jnp

from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import combine, partition
from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec
from tsadar_tpu.inverse.loops import angular_optax as jax_angular_optax
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path, thomson_params_from_partitions
from tsadar_tpu_torch.inverse import loops, optimizers
from tsadar_tpu_torch.utils.process import batches
from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges

HERE = os.path.dirname(__file__)
CONFIGS = os.path.join(HERE, "configs")
SIZE, UNIT = 128, 8  # 1024 fine angles in blocks of 8 -> 128 resolution units
FVAL = ".electron.distribution_functions.fval"


def _config():
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, n))) for n in ("arts2v_test_defaults.yaml", "arts2d_test_inputs.yaml")]
    cfg = set_forward_ranges(merge_configs(*decks))
    cfg["other"].update(npts=SIZE, CCDsize=[SIZE, SIZE], ang_res_unit=UNIT)
    cfg["parameters"]["electron"]["fe"].update(type="arbitrary", dim=2, nvx=32, params=dict(init_m=2.5, learn_log=True))
    cfg["optimizer"].update(method="adam", learning_rate=2e-3, num_epochs=5)
    sas = port.get_scattering_angles(cfg)
    sas["angAxis"] = port.get_calibrations(104000, "angular", 0.0, cfg["other"]["CCDsize"])[0]
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    return cfg, sas


def _all_data(seed):
    """A seeded image in resolution units, the whole CCD: smooth in wavelength, positive."""
    rng = np.random.default_rng(seed)
    lam = np.linspace(400.0, 700.0, SIZE)
    e_data = (0.2 + np.exp(-(((lam - 480.0) / 40.0) ** 2)) + 0.7 * np.exp(-(((lam - 600.0) / 50.0) ** 2)))[None, :] * rng.uniform(
        0.5, 1.5, (SIZE, 1)) + 0.02 * rng.standard_normal((SIZE, SIZE))
    return {"e_data": e_data, "e_amps": e_data.max(axis=1, keepdims=True), "i_data": np.zeros(SIZE), "i_amps": np.zeros(SIZE),
            "noiseE": 0.01 * rng.uniform(0.0, 1.0, (SIZE, SIZE)), "noiseI": np.zeros((SIZE, SIZE))}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX loss on the windowed batch, its (diff, static) parameters, and value_and_grad at the start."""
    cfg, sas = _config()
    lo, hi = int(cfg["data"]["lineouts"]["start"] / UNIT), int(cfg["data"]["lineouts"]["end"] / UNIT)
    cfg["data"]["lineouts"].update(start=lo, end=hi)
    batch = batches.angular_batch(_all_data(0), slice(lo, hi))
    loss_fn = JaxLoss(cfg, sas, batch)
    jp = JaxParams.create(cfg["parameters"], num_params=1, batch=False, activate=True)
    diff, static = partition(jp, jax_filter_spec(cfg["parameters"], jp))
    assert list(leaves_by_path(diff)) == [FVAL]
    return cfg, sas, batch, loss_fn, diff, static


def _optax_steps(jax_side, opt, n):
    _, _, batch, loss_fn, diff, static = jax_side
    state, losses = opt.init(diff), []
    for _ in range(n):
        (value, _), grad = loss_fn._vg_func_(diff, static, batch)
        updates, state = opt.update(grad, state)
        diff = optax.apply_updates(diff, updates)
        losses.append(float(value))
    return losses, leaves_by_path(diff)[FVAL]


def test_loss_and_gradient_match_jax(jax_side):
    cfg, sas, batch, jloss, diff, static = jax_side
    (want, aux), g_ref = jloss._vg_func_(diff, static, batch)
    g_ref = leaves_by_path(g_ref)[FVAL]
    assert batch["e_data"].shape == (107, SIZE) and np.isfinite(g_ref).all() and np.abs(g_ref).max() > 0

    loss_fn = port.LossFunction(cfg, sas, batch, device="cpu")
    tp = thomson_params_from_partitions(cfg["parameters"], diff, static, activate=True, device="cpu")
    (value, paux), grads = loss_fn.value_and_grad(tp, batch)
    assert list(grads) == [FVAL] and grads[FVAL].shape == (32, 32)
    np.testing.assert_allclose(float(value), float(want), rtol=1e-10)
    ThryE = np.asarray(aux[0])
    np.testing.assert_allclose(paux[0].numpy(), ThryE, rtol=0, atol=1e-10 * ThryE.max())
    np.testing.assert_allclose(grads[FVAL].numpy(), g_ref, rtol=0, atol=1e-8 * np.abs(g_ref).max())
    np.testing.assert_allclose(paux[2].numpy(), np.asarray(aux[2]), rtol=1e-9)


@pytest.mark.parametrize("method, steps", [("adam", 5), ("rmsprop", 3)])
def test_angular_loop_matches_optax(jax_side, method, steps):
    lr = 2e-3
    want_losses, want_fval = _optax_steps(jax_side, getattr(optax, method)(lr), steps)
    cfg, sas = _config()
    cfg["optimizer"].update(method=method, learning_rate=lr, num_epochs=steps, chunk_size=2)
    record = {}
    best, last_loss, loss_fn = port.angular_optax(cfg, _all_data(0), sas, device="cpu", record=record)
    assert cfg["optimizer"]["batch_size"] == 1 and cfg["data"]["lineouts"]["start"] == 11 and cfg["data"]["lineouts"]["end"] == 118
    assert record["chunk_steps"] == [2] * (steps // 2) + [1] and len(record["losses"]) == steps
    np.testing.assert_allclose(record["losses"], want_losses, rtol=1e-9)
    assert last_loss == record["losses"][-1] and want_losses[-1] < want_losses[0]
    # the losses fall, so the best parameters are the last ones: the pre-update loss is credited to the post-update parameters
    fval = best.electron.distribution_functions.fval.detach().numpy()
    np.testing.assert_allclose(fval, want_fval, rtol=0, atol=1e-9 * np.abs(want_fval).max())
    assert all(p.grad is None for p in best.parameters())
    assert isinstance(loss_fn, port.LossFunction)


def test_rmsprop_is_optax_rmsprop_not_torchs_default():
    rng = np.random.default_rng(1)
    x0, grads = rng.standard_normal(6), 1e-4 * rng.standard_normal((3, 6))  # small gradients: eps inside the root matters
    opt = optax.rmsprop(1e-2)
    xj, state = jnp.asarray(x0), None
    state = opt.init(xj)
    p = torch.nn.Parameter(torch.tensor(x0))
    mine = optimizers.RMSprop([p], lr=1e-2)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state)
        xj = optax.apply_updates(xj, updates)
        p.grad = torch.tensor(g)
        mine.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(xj), rtol=1e-12)


class _ScriptedLoss:
    """Stands in for ``LossFunction``: hands ``angular_optax`` a scripted sequence of losses."""

    def __init__(self, losses):
        self.losses, self.calls = losses, 0
        self.ts_diag = type("D", (), {"device": torch.device("cpu"), "dtype": torch.float64})()

    def device_batch(self, batch):
        return batch

    def value_and_grad(self, ts_params, batch, trainable):
        value = torch.tensor(self.losses[min(self.calls, len(self.losses) - 1)], dtype=torch.float64)
        self.calls += 1
        return (value, None), {k: torch.zeros_like(p) for k, p in trainable.items()}


@pytest.mark.parametrize("script, counted, why", [
    ([1.0] + [1.0 - 1e-7 * i for i in range(1, 30)], 7, "stalled"),  # the 1st improves by 99; then 6 improvements < 1e-6
    ([1.0] + [2.0] * 30, 7, "rising"),  # six rising epochs after the first
    ([1.0 / (i + 1) for i in range(12)], 12, "ran out"),
])
def test_early_stop_replays_the_per_epoch_counters(monkeypatch, script, counted, why):
    scripted = _ScriptedLoss(script)
    monkeypatch.setattr(loops, "LossFunction", lambda *a, **k: scripted)
    cfg, sas = _config()
    cfg["optimizer"].update(num_epochs=12, chunk_size=4)
    record = {}
    _, last, _ = port.angular_optax(cfg, _all_data(0), sas, device="cpu", record=record)
    assert len(record["losses"]) == counted, why
    assert last == script[counted - 1]
    # a stop inside a chunk still ran the chunk to its end on the device
    assert scripted.calls == (8 if counted == 7 else 12)


def test_angular_loop_fits_the_arts_1v_deck():
    """The same loop on the ARTS 1V deck (a DLM EDF, Te, ne and m trainable): the loss falls over a few adam steps."""
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, n))) for n in ("arts1v_test_defaults.yaml", "arts1v_test_inputs.yaml")]
    cfg = set_forward_ranges(merge_configs(*decks))
    cfg["other"].update(npts=SIZE, CCDsize=[SIZE, SIZE], ang_res_unit=UNIT)
    cfg["parameters"]["electron"]["fe"]["nvx"] = 64
    cfg["optimizer"].update(method="adam", learning_rate=1e-2, num_epochs=4, chunk_size=4)
    sas = port.get_scattering_angles(cfg)
    sas["angAxis"] = port.get_calibrations(94475, "angular", 0.0, cfg["other"]["CCDsize"])[0]
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    record = {}
    best, _, loss_fn = port.angular_optax(cfg, _all_data(2), sas, device="cpu", record=record)
    trainable = port.core.params.get_filter_spec(cfg["parameters"], best)
    assert {".electron.params.normed['Te']", ".electron.params.normed['ne']", ".electron.distribution_functions.normed_m"} <= set(trainable)
    losses = record["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert best.electron.distribution_functions.normed_m.dim() == 0


def test_what_the_angular_fit_leaves_out_raises():
    """What raised here until it was ported runs: the multiplexed two-shot loop (``{"b1", "b2"}`` batches from the
    ``*_rot`` channels; ``tests/test_torch_multiplex.py`` holds it to the JAX package) and the 2V moment
    penalties (here against the JAX package's on a skewed EDF).  A method outside ``optimizers.METHODS``
    still raises, and the angular ``lbfgs`` fails as the JAX loop does."""
    cfg, sas = _config()
    multiplexed = copy.deepcopy(cfg)
    multiplexed["data"].update(shotnum=[101675, 101676], shot_rot=25.0)
    multiplexed["optimizer"]["num_epochs"] = 1
    all_data, second = _all_data(0), _all_data(1)
    all_data.update(e_data_rot=second["e_data"], e_amps_rot=second["e_amps"], noiseE_rot=second["noiseE"])
    record = {}
    _, last, loss_fn = port.angular_optax(multiplexed, all_data, sas, device="cpu", record=record)
    assert loss_fn.multiplex_ang and len(record["losses"]) == 1 and np.isfinite(last)
    lbfgs = copy.deepcopy(cfg)
    lbfgs["optimizer"]["method"] = "lbfgs"
    # optax's lbfgs needs the loss value in update(): the JAX angular loop's update(grad, state) fails, and so
    # does the port's, with that reason
    with pytest.raises(ValueError):
        jax_angular_optax(copy.deepcopy(lbfgs), _all_data(0), sas)
    with pytest.raises(ValueError, match="lbfgs needs .* update"):
        port.angular_optax(lbfgs, _all_data(0), sas, device="cpu")
    moments = copy.deepcopy(cfg)
    moments["optimizer"]["moment_loss"] = True
    dummy = {"e_data": np.ones((2, 2)), "i_data": np.ones(2)}
    loss_fn = port.LossFunction(moments, sas, dummy, device="cpu")
    v = np.linspace(-6.0, 6.0, 32)
    fe = np.exp(-((v[None, :] - 0.4) ** 2) / 2.0 - ((v[:, None] + 0.2) ** 2) / 1.6) * (1.0 + 0.1 * v[None, :])
    want = JaxLoss(moments, sas, dummy).moment_penalties({"electron": {"fe": jnp.asarray(fe), "v": jnp.asarray(v)}})
    got = loss_fn.moment_penalties({"electron": {"fe": torch.tensor(fe), "v": torch.tensor(v)}})
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-12)
    assert min(float(w) for w in want) > 0.0
