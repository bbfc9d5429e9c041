"""The port's refits and the calibration of its sigmas (``tsadar_tpu_torch.utils.process.postprocess``), on the CPU.

* The refit write-back of ``tests/test_inverse/test_refit_indexing.py`` on the
  port: a refit lands in lineout i's own (batch, slot), lineout 0 is skipped,
  and each refit runs at batch size 1, warm-started from the previous
  lineout's fitted values.
* ``tests/test_inverse/test_1d_random.py::test_sigma_pull_distribution`` with
  the port: the same seeds and data (the JAX forward at the truth plus seeded
  counting noise), the same scipy call on the port's flat loss, the port's
  Hessian and sigmas: finite, non-zero, median pull inside (0.1, 10).

The Hessian and the sigmas themselves are held to the JAX package's in
``tests/test_torch_postprocess.py``.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from scipy.optimize import minimize

import __graft_entry__ as ge
from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec
from tsadar_tpu.core.params import partition
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.core.params import get_filter_spec, ravel_order
from tsadar_tpu_torch.inverse import loops as port_loops
from tsadar_tpu_torch.inverse.loss import ravel
from tsadar_tpu_torch.utils.process import postprocess as ppp

from .test_torch_postprocess import _all_data
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

SENTINEL_TE = 1.2345


class _FakeRefitLossFn:
    def array_loss(self, weights, batch):
        # always a huge improvement -> the write-back always triggers
        return torch.tensor([-1e9]), None, None, None, None


def test_refit_writes_into_own_batch_slot(monkeypatch):
    """``tests/test_inverse/test_refit_indexing.py`` on the port: lineout 2 is the first of batch 1, and its
    refit lands in (batch 1, slot 0); lineout 0 is skipped; no other lineout's stored fit changes."""
    n_lineouts, bs = 4, 2
    cfg = ge._small_config(n_lineouts)
    cfg["optimizer"].update(method="adam", num_epochs=2, batch_size=bs)
    cfg["other"]["refit"] = True
    cfg["other"]["refit_thresh"] = 1e-9  # force: every lineout's loss exceeds it
    sas = port.get_scattering_angles(cfg)
    all_data = _all_data(n_lineouts)
    batch_indices = np.arange(n_lineouts)
    fitted_weights, _, loss_fn = port_loops.one_d_loop(cfg, all_data, sas, batch_indices.copy(), n_lineouts // bs, device="cpu")

    def te_of(w):
        return w.get_unnormed_params()["electron"]["Te"].detach().numpy().copy()

    te_before = [te_of(w) for w in fitted_weights]
    sent_cfg = ge._small_config(1)
    sent_cfg["parameters"]["electron"]["Te"]["val"] = SENTINEL_TE
    sentinel = port.ThomsonParams.create(sent_cfg["parameters"], 1, activate=True, device="cpu")
    sentinel_te = float(te_of(sentinel)[0])
    calls = []

    def fake_one_d_loop(config, data, sa, inds, nb, **kwargs):
        calls.append((config["optimizer"]["batch_size"], list(inds)))
        return [sentinel], 0.0, _FakeRefitLossFn()

    monkeypatch.setattr(port_loops, "one_d_loop", fake_one_d_loop)
    record = {}
    ppp.refit_bad_fits(cfg, sas, batch_indices.copy(), all_data, loss_fn, fitted_weights, record)
    te_after = [te_of(w) for w in fitted_weights]
    assert calls == [(1, [1]), (1, [2]), (1, [3])]
    assert np.isclose(te_after[0][0], te_before[0][0])
    assert np.isclose(te_after[0][1], sentinel_te, rtol=1e-6)
    assert np.isclose(te_after[1][0], sentinel_te, rtol=1e-6)
    assert np.isclose(te_after[1][1], sentinel_te, rtol=1e-6)
    assert [(r["lineout"], r["batch"], r["slot"], r["written"]) for r in record["refits"]] == [
        (1, 0, 1, True), (2, 1, 0, True), (3, 1, 1, True)]


def test_refit_warm_starts_from_the_previous_lineout(monkeypatch):
    """The refit's deck holds the previous lineout's fitted values (m under fe.params) at batch size 1."""
    cfg = ge._small_config(2)
    cfg["optimizer"].update(method="adam", num_epochs=2)
    cfg["other"].update(refit=True, refit_thresh=1e-9)
    sas = port.get_scattering_angles(cfg)
    all_data = _all_data(2)
    fitted_weights, _, loss_fn = port_loops.one_d_loop(cfg, all_data, sas, np.arange(2), 1, device="cpu")
    prev = {g: {k: float(v.detach().reshape(-1)[0]) for k, v in d.items()} for g, d in fitted_weights[0].get_unnormed_params().items()}
    seen = []

    def fake_one_d_loop(config, data, sa, inds, nb, **kwargs):
        seen.append(copy.deepcopy(config["parameters"]))
        return [fitted_weights[0]], 0.0, _FakeRefitLossFn()

    monkeypatch.setattr(port_loops, "one_d_loop", fake_one_d_loop)
    ppp.refit_bad_fits(cfg, sas, np.arange(2), all_data, loss_fn, fitted_weights)
    (params,) = seen
    assert params["electron"]["Te"]["val"] == pytest.approx(prev["electron"]["Te"])
    assert params["electron"]["fe"]["params"]["m"]["val"] == pytest.approx(prev["electron"]["m"])
    assert params["general"]["lam"]["val"] == pytest.approx(prev["general"]["lam"])
    assert params["electron"]["Te"]["active"] and params["electron"]["Te"]["lb"] == cfg["parameters"]["electron"]["Te"]["lb"]


def test_sigma_pull_distribution():
    """``test_1d_random.py::test_sigma_pull_distribution`` with the port's loss, Hessian and sigmas."""
    B = 4
    COUNTS = 4000.0  # detector-count scale: the Hessian's weights assume var = |data|
    cfg = ge._small_config(B)
    rng = np.random.default_rng(11)
    base = {"e_amps": np.full((B, 1), COUNTS), "i_amps": np.full((B, 1), COUNTS), "noise_e": np.zeros((B, 1024)),
            "noise_i": np.zeros((B, 1024)), "e_data": np.zeros((B, 1024)), "i_data": np.zeros((B, 1024))}
    truth = JaxParams.create(cfg["parameters"], num_params=B, batch=True, activate=True)
    probe = JaxLoss(dict(cfg, optimizer=dict(cfg["optimizer"], y_norm=False)), jax_angles(cfg), base)
    ThryE, ThryI, _, _ = jax.jit(probe.ts_diag)(truth, base)
    ThryE, ThryI = np.asarray(ThryE), np.asarray(ThryI)
    batch = dict(base)
    batch["e_data"] = ThryE + np.sqrt(np.maximum(ThryE, 1.0)) * rng.standard_normal(ThryE.shape)
    batch["i_data"] = ThryI + np.sqrt(np.maximum(ThryI, 1.0)) * rng.standard_normal(ThryI.shape)

    cfg["optimizer"]["method"] = "l-bfgs-b"
    loss_fn = port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu")
    cfg_start = ge._small_config(B)
    cfg_start["parameters"]["electron"]["Te"]["val"] = 0.5
    cfg_start["parameters"]["electron"]["ne"]["val"] = 0.25
    cfg_start["parameters"]["electron"]["fe"]["params"]["m"]["val"] = 3.0
    cfg_start["parameters"]["general"]["lam"]["val"] = 524.5
    start = port.ThomsonParams.create(cfg_start["parameters"], B, activate=True, device="cpu")
    trainable = get_filter_spec(cfg["parameters"], start)
    x0 = ravel([trainable[k] for k in ravel_order(trainable)])
    res = minimize(loss_fn.vg_loss, x0, args=(start, batch), method="L-BFGS-B", jac=True,
                   options={"maxiter": 300, "ftol": 1e-14, "gtol": 1e-12})
    loss_fn.vg_loss(res["x"], start, batch)  # the fitted point into the parameters

    H = ppp.batch_flat_hessian(cfg, loss_fn, start, batch)
    sigmas = ppp.get_sigmas(H, B)
    spec = jax_filter_spec(cfg["parameters"], truth)
    x_truth = np.asarray(ravel_pytree(partition(truth, spec)[0])[0])
    P = res["x"].size // B
    resid = np.abs(res["x"] - x_truth).reshape(P, B).T  # [B, P]
    assert np.all(np.isfinite(sigmas)), "non-finite sigmas"
    assert np.all(np.abs(sigmas) > 0), "zeroed sigmas (silent Hessian failure)"
    pulls = resid / np.abs(sigmas)
    med = float(np.median(pulls))
    assert 0.1 < med < 10.0, f"sigma miscalibration: median pull {med}, pulls {pulls}"
