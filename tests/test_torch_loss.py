"""The port's loss function against the JAX package's, on the CPU in float64.

The small 1D deck of ``__graft_entry__`` (EPW and IAW features both fitted,
npts 1024, nvx 64, P9's angles) at B = 2 lineouts whose active parameters are
spread by a seeded draw, on a seeded data batch:

* loss, per-lineout row losses, ThryE and the gradient of every active leaf
  against ``LossFunction._vg_func_`` for the four loss functionals: the values
  to 1e-10 relative, each leaf's gradient to 1e-8 of its largest entry (same
  operations; autograd and XLA sum in different orders);
* ``post_loss`` (theory-normalized, per-lineout means) and the loss with the
  bound and moment penalties switched on, against JAX;
* the functionals, ``_masked_reduce`` and the penalties on the cases of
  ``tests/test_inverse/test_loss.py``;
* the interfaces that are not ported yet raise ``NotImplementedError``;
* float32 on the whole-shot deck (npts 5120, 10 angles, nvx 320; 2 lineouts):
  the plain forms lose lam's gradient to cancellation in the spectral
  difference's chain, the JAX package's as much as the port's.  The port's
  float32 miss of each leaf's float64 gradient is held to 1.1 times JAX's own
  plus 1e-3.  (On the card the tail's backward kernel sums that chain by parts
  and keeps lam's gradient: ``chip_smoke.py`` holds it to float64 there.)
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import chip_smoke
from __graft_entry__ import _make_batch, _small_config
from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import combine, get_filter_spec, partition
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path, thomson_params_from_partitions
from tsadar_tpu_torch.inverse.loss import LossFunction, _masked_reduce

BATCH = 2
VALUE_TOL = 1e-10
GRAD_TOL = 1e-8  # of each leaf's largest |gradient|


def _cfg(**updates):
    cfg = _small_config(BATCH)
    for path, value in updates.items():
        node = cfg
        *parents, leaf = path.split(".")
        for key in parents:
            node = node[key]
        node[leaf] = value
    return cfg


def _spread_partitions(cfg, seed=0):
    """JAX (diff, static) with the active leaves spread per lineout by a seeded draw."""
    tp = JaxParams.create(cfg["parameters"], num_params=BATCH, batch=True, activate=True)
    diff, static = partition(tp, get_filter_spec(cfg["parameters"], tp))
    rng = np.random.default_rng(seed)
    diff = jax.tree.map(lambda x: x + 0.3 * jnp.asarray(rng.standard_normal(x.shape)), diff)
    return diff, static


def _both(cfg, batch):
    """(JAX loss, JAX diff, JAX static, port loss, port params) for one deck."""
    diff, static = _spread_partitions(cfg)
    jl = JaxLoss(cfg, jax_angles(cfg), batch)
    pl = LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu")
    pp = thomson_params_from_partitions(cfg["parameters"], diff, static, device="cpu")
    return jl, diff, static, pl, pp


@pytest.fixture(scope="module")
def batch():
    return _make_batch(BATCH)


@pytest.mark.parametrize("method", ["l1", "l2", "log-cosh", "poisson"])
def test_loss_and_gradients_match_jax(batch, method):
    cfg = _cfg(**{"optimizer.loss_method": method})
    jl, diff, static, pl, pp = _both(cfg, batch)
    (want, (want_E, _, want_rows)), want_grad = jl._vg_func_(diff, static, batch)
    (got, (got_E, got_params, got_rows)), got_grad = pl.value_and_grad(pp, batch)

    assert got.dtype == torch.float64 and not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=VALUE_TOL)
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(want_rows), rtol=VALUE_TOL)
    np.testing.assert_allclose(got_E.numpy(), np.asarray(want_E), rtol=0, atol=VALUE_TOL * np.abs(want_E).max())
    assert set(got_params) == {"electron", "general", "ion-1"}

    want_grad = leaves_by_path(want_grad)
    assert set(got_grad) == set(leaves_by_path(diff)) == set(want_grad)
    assert len(got_grad) == 6  # Te, ne, m, amp1, amp2, lam
    for path, w in want_grad.items():
        assert np.abs(w).max() > 0.0, path
        np.testing.assert_allclose(got_grad[path].numpy(), w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=path)


def test_post_loss_matches_jax(batch):
    cfg = _cfg()
    jl, diff, static, pl, pp = _both(cfg, batch)
    want = jl.array_loss(combine(diff, static), batch)
    with torch.no_grad():
        got = pl.post_loss(pp, batch)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VALUE_TOL)
    assert got[0].shape == (BATCH,)
    for key in ("ele", "ion"):
        w = np.asarray(want[1][key])  # errors over the theory itself: large where the theory is small
        np.testing.assert_allclose(got[1][key].numpy(), w, rtol=1e-8, atol=VALUE_TOL * np.abs(w).max())
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=VALUE_TOL * np.abs(np.asarray(w)).max())


def test_penalties_match_jax_via_config_flags(batch):
    flags = {"optimizer.bound_penalty": True, "optimizer.moment_loss": True,
             "parameters.electron.fe.fe_decrease_strict": True}
    jl, diff, static, pl, pp = _both(_cfg(**flags), batch)
    want, _ = jl._loss_(diff, static, batch)
    _, _, _, pl_off, _ = _both(_cfg(), batch)
    with torch.no_grad():
        got, base = pl.__loss__(pp, batch)[0], pl_off.__loss__(pp, batch)[0]
    np.testing.assert_allclose(float(got), float(want), rtol=VALUE_TOL)
    assert float(got) > float(base)  # the DLM EDF's moments are off unit by a little: the penalties only ever add
    (_, _), grads = pl.value_and_grad(pp, batch)
    assert all(torch.isfinite(g).all() for g in grads.values())


def _plain_loss():
    cfg = _cfg()
    return LossFunction(cfg, port.get_scattering_angles(cfg), _make_batch(BATCH), device="cpu"), cfg


def test_loss_functional_formulas():
    loss_fn, _ = _plain_loss()
    d, t, u = (torch.tensor(x, dtype=torch.float64) for x in ([1.0, 2.0, 0.5], [0.5, 2.5, 0.5], [2.0, 1.0, 1.0]))
    np.testing.assert_allclose(loss_fn.loss_functionals(d, t, u, "l1"), np.abs(d - t) / u)
    np.testing.assert_allclose(loss_fn.loss_functionals(d, t, u, "l2"), (d - t) ** 2 / u)
    np.testing.assert_allclose(loss_fn.loss_functionals(d, t, u, "log-cosh"), np.log(np.cosh(d - t)))
    np.testing.assert_allclose(loss_fn.loss_functionals(d, t, u, "poisson"), t - d * np.log(np.maximum(t, 1e-300)))
    with pytest.raises(NotImplementedError):
        loss_fn.loss_functionals(d, t, u, "huber")


def test_masked_reduce_handles_unbatched_spectra():
    err = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    mask = torch.tensor([True, True, False, True])
    row = _masked_reduce(err, mask, "mean_axis1")
    assert row.shape == (1,)
    np.testing.assert_allclose(row, [(1.0 + 2.0 + 4.0) / 3.0])
    row2 = _masked_reduce(torch.stack([err, 2 * err]), mask, "mean_axis1")
    assert row2.shape == (2,)
    np.testing.assert_allclose(row2, [7.0 / 3.0, 14.0 / 3.0])
    np.testing.assert_allclose(_masked_reduce(err, mask, "mean"), 7.0 / 3.0)
    np.testing.assert_allclose(_masked_reduce(err, mask, "sum"), 7.0)
    np.testing.assert_allclose(_masked_reduce(err, torch.zeros(4, dtype=torch.bool), "mean"), 0.0)  # empty window
    with pytest.raises(NotImplementedError):
        _masked_reduce(err, mask, "median")


def test_poisson_functional_survives_zero_theory():
    loss_fn, _ = _plain_loss()
    out = loss_fn.loss_functionals(torch.ones(4), torch.zeros(4), torch.ones(4), "poisson")
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_moment_penalties_zero_for_normalized_maxwellian():
    loss_fn, _ = _plain_loss()
    v = torch.linspace(-6.0, 6.0, 4001, dtype=torch.float64)
    fe = torch.exp(-(v**2) / 2) / np.sqrt(2 * np.pi)
    for vv in (v, v[None, :]):  # the port's shared grid [nv], and JAX's per-lineout [B, nv]
        density, temperature, momentum = loss_fn.moment_penalties({"electron": {"fe": fe[None, :], "v": vv}})
        assert float(density) < 1e-6 and float(temperature) < 1e-5 and float(momentum) < 1e-12
    density2, temperature2, _ = loss_fn.moment_penalties({"electron": {"fe": 2.0 * fe[None, :], "v": 1.3 * v}})
    assert float(density2) > 1e-1 and float(temperature2) > 1e-1
    # the 2V arm, which raised here until it was ported: a normalized isotropic 2D Maxwellian has unit density,
    # second moment 2 (unit variance a dimension) and no first moments (tests/test_torch_arts_loss.py holds a
    # skewed EDF to the JAX package's)
    loss_fn.cfg["parameters"]["electron"]["fe"]["dim"] = 2
    v2 = torch.linspace(-8.0, 8.0, 801, dtype=torch.float64)
    fe2 = torch.exp(-(v2[:, None] ** 2 + v2[None, :] ** 2) / 2) / (2 * np.pi)
    density, temperature, momentum = loss_fn.moment_penalties({"electron": {"fe": fe2, "v": v2}})
    assert float(density) < 1e-12 and float(temperature) < 1e-12 and float(momentum) < 1e-24
    density2, temperature2, momentum2 = loss_fn.moment_penalties({"electron": {"fe": torch.roll(fe2, 40, dims=1), "v": v2}})
    assert float(density2) < 1e-12 and float(temperature2) > 1e-2 and float(momentum2) > 1e-2


def test_bound_penalty_fires_out_of_bounds():
    loss_fn, cfg = _plain_loss()
    ts = port.ThomsonParams.create(cfg["parameters"], BATCH, activate=False, device="cpu")
    assert float(loss_fn.bound_penalty(ts)) == pytest.approx(0.0, abs=1e-12)
    with torch.no_grad():
        ts.electron.params.normed["Te"].fill_(1.7)
    assert float(loss_fn.bound_penalty(ts)) == pytest.approx(BATCH * np.log(1.7), rel=1e-12)
    with torch.no_grad():
        ts.electron.params.normed["Te"].fill_(-0.9)
    assert float(loss_fn.bound_penalty(ts)) == pytest.approx(BATCH * np.log(1.9), rel=1e-12)


def test_bound_penalty_inert_for_activated_params():
    loss_fn, cfg = _plain_loss()
    ts = port.ThomsonParams.create(cfg["parameters"], BATCH, activate=True, device="cpu")
    for value in (None, 25.0, -25.0):  # extreme logits saturate inside [0, 1]
        if value is not None:
            with torch.no_grad():
                ts.electron.params.normed["Te"].fill_(value)
        assert float(loss_fn.bound_penalty(ts)) == 0.0


def test_monotonic_decrease_penalty_sign():
    cfg = _cfg(**{"parameters.electron.fe.fe_decrease_strict": True})
    loss_fn = LossFunction(cfg, port.get_scattering_angles(cfg), _make_batch(BATCH), device="cpu")
    v = 0.12 * torch.arange(-50, 51, dtype=torch.float64)  # v = 0 exactly at the centre
    fe = torch.exp(-(v**2) / 2)
    assert float(loss_fn.penalties({"electron": {"fe": fe[None, :], "v": v}})) == pytest.approx(0.0, abs=1e-12)
    bump = fe.clone()
    bump[80] += 0.5  # a bump on the outgoing tail triggers the tan barrier
    assert float(loss_fn.penalties({"electron": {"fe": bump[None, :], "v": v}})) > 0.1


def test_y_norm_and_device_batch():
    loss_fn, cfg = _plain_loss()
    b = _make_batch(BATCH)
    assert loss_fn.e_norm == np.amax(b["e_data"]) and loss_fn.i_norm == np.amax(b["i_data"])
    dev = loss_fn.device_batch(b)
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float64 for v in dev.values())
    assert all(loss_fn.device_batch(dev)[k] is dev[k] for k in dev)  # already there: no copy
    cfg2 = copy.deepcopy(cfg)
    cfg2["optimizer"]["y_norm"] = False
    off = LossFunction(cfg2, port.get_scattering_angles(cfg2), b, device="cpu")
    assert off.e_norm == off.i_norm == 1.0


def test_unported_interfaces_raise():
    """Every interface of the loss is ported: the scipy interface and the Hessian, which raised here until they
    were ported, are held to the JAX package's in ``tests/test_torch_flat_loss.py`` and
    ``tests/test_torch_postprocess.py``; the multiplexed two-shot loss, which raised here until it was ported, builds
    (``multiplex_ang``) and is held to the JAX package's in ``tests/test_torch_multiplex.py``."""
    loss_fn, cfg = _plain_loss()
    for call in (loss_fn.vg_loss, loss_fn.loss, loss_fn.h_loss_wrt_params, loss_fn.array_loss):
        assert callable(call)
    assert not loss_fn.multiplex_ang
    cfg2 = copy.deepcopy(cfg)
    cfg2["data"]["shotnum"] = [1, 2]  # the multiplexed two-shot angular fit
    assert LossFunction(cfg2, port.get_scattering_angles(cfg2), _make_batch(BATCH), device="cpu").multiplex_ang


def test_float32_plain_gradients_no_worse_than_jax_float32():
    n = 2
    cfg = chip_smoke.fit_config(chip_smoke.load_deck(), n, 1)
    draws = chip_smoke.draw_lineouts(n)
    sas = port.get_scattering_angles(cfg)
    diag = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")
    data = {k: np.asarray(v) for k, v in chip_smoke.fit_data(diag, cfg, draws, n).items()}  # the port's float64 forward at the truth

    def jax_grads(x64):
        with jax.enable_x64(x64):
            tp = JaxParams.create(cfg["parameters"], num_params=n, batch=True, activate=True)
            diff, static = partition(tp, get_filter_spec(cfg["parameters"], tp))
            _, grad = JaxLoss(cfg, jax_angles(cfg), data)._vg_func_(diff, static, data)
            return {k: np.asarray(v, np.float64) for k, v in leaves_by_path(grad).items()}

    def port_grads(dtype):
        loss_fn = LossFunction(cfg, sas, data, device="cpu", dtype=dtype)
        params = port.ThomsonParams.create(cfg["parameters"], n, activate=True, device="cpu", dtype=dtype)
        return {k: g.double().numpy() for k, g in loss_fn.value_and_grad(params, data)[1].items()}

    ref, jax32, port64, port32 = jax_grads(True), jax_grads(False), port_grads(torch.float64), port_grads(torch.float32)
    assert set(ref) == set(port64) == set(port32) and len(ref) == 6
    miss = lambda got, k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())  # noqa: E731
    for k in ref:
        print(f"{k}: of the largest gradient, float32 vs float64: JAX {miss(jax32, k):.3e}, port {miss(port32, k):.3e}")
        assert miss(port64, k) <= 1e-6, k
        assert miss(port32, k) <= 1.1 * miss(jax32, k) + 1e-3, k
    lam = next(k for k in ref if "lam" in k)
    assert miss(jax32, lam) > 0.1  # the cancellation is float32's and the formulation's, in both packages
