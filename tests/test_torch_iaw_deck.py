"""The IAW deck (``configs/1d``) from shot 101675's real data: the port's loss and gradient against JAX's, and its fit.

The deck set as ``tests/test_inverse/test_1d_iaw_data.py`` sets it: ps
lineouts 535:735:100 (two, one batch), both channels loaded, only the IAW arm
of the loss counted (``fit_IAW``), Te, Va, ud and amp3 active, the raw-data
visualizer off (a figure: ``tests/test_torch_figures.py``).  Each package's data pipeline
feeds its own ``LossFunction`` at the deck's start values, on the CPU in
float64: the loss and the row losses to 1e-10 relative, ThryE to 1e-10 of its
peak, each active parameter's gradient to 1e-8 of its largest entry (lam's,
where a deck fits it, to 1e-7: it cancels ~8 digits).  This
touches what no other port test on real data does: the ion window's
instrument response, the loss's IAW arm, and the tail's Va and ud chains.

``test_iaw_deck_fit`` (slow-marked, as the JAX test is) runs the deck through
the port's ``fitter.fit(device="cpu")`` with ``calc_sigmas``, ``refit`` and
``refit_thresh`` 1e-9, and holds it to that test's pins and sigma checks.
``deck_losses`` serves the other real-data deck files too.
"""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import get_filter_spec, partition
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.config import merge_configs
from tsadar_tpu.utils.process.prepare import prepare_data as jax_prepare
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path
from tsadar_tpu_torch.inverse import fitter
from tsadar_tpu_torch.inverse.fitter import _lineout_selection
from tsadar_tpu_torch.utils.process.prepare import prepare_data

from .test_torch_data_pipeline import same_scipy_fits
from .test_torch_real_data_loss import GRAD_TOL, VALUE_TOL, _batch
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAM_GRAD_TOL = 1e-7  # lam's gradient cancels ~8 digits (as in tests/test_torch_flat_loss.py); 1.6e-8 on shot 111411


def iaw_deck():
    decks = [yaml.safe_load(open(os.path.join(ROOT, "configs", "1d", f"{n}.yaml"))) for n in ("defaults", "inputs")]
    cfg = merge_configs(*decks)
    cfg["data"]["lineouts"].update({"start": 535, "end": 735, "skip": 100})
    cfg["data"]["launch_data_visualizer"] = False  # a figure: tests/test_torch_figures.py
    return cfg


def deck_losses(cfg):
    """((loss, ThryE, row losses), gradients by JAX leaf path) of JAX, then of the port, at the deck's start values
    and its own lineouts (one batch)."""
    cfg = _lineout_selection(cfg)
    jax_cfg, port_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    with same_scipy_fits():
        data, sa, _ = jax_prepare(jax_cfg, jax_cfg["data"]["shotnum"])
        port_data, port_sa, _ = prepare_data(port_cfg, port_cfg["data"]["shotnum"])
    B = cfg["optimizer"]["batch_size"]
    batch = _batch(data)
    jl = JaxLoss(jax_cfg, sa, batch)
    tp = JaxParams.create(jax_cfg["parameters"], B, batch=True, activate=True)
    diff, static = partition(tp, get_filter_spec(jax_cfg["parameters"], tp))
    (value, aux), grad = jl._vg_func_(diff, static, batch)
    want = (float(value), np.asarray(aux[0]), np.asarray(aux[2])), leaves_by_path(grad)

    batch = _batch(port_data)
    pl = port.LossFunction(port_cfg, port_sa, batch, device="cpu")
    params = port.ThomsonParams.create(port_cfg["parameters"], B, activate=True, device="cpu")
    (value, aux), grad = pl.value_and_grad(params, batch)
    got = (float(value), aux[0].numpy(), aux[2].numpy()), {k: g.numpy() for k, g in grad.items()}
    return want, got


def assert_same_losses(want, got, active):
    ((w, w_E, w_rows), w_grad), ((g, g_E, g_rows), g_grad) = want, got
    assert np.isfinite(g) and g > 0.0
    np.testing.assert_allclose(g, w, rtol=VALUE_TOL)
    np.testing.assert_allclose(g_rows, w_rows, rtol=VALUE_TOL)
    assert g_E.shape == w_E.shape
    np.testing.assert_allclose(g_E, w_E, rtol=0, atol=VALUE_TOL * np.abs(w_E).max())
    assert set(g_grad) == set(w_grad) and {_leaf_name(p) for p in g_grad} == set(active)
    for path, w in w_grad.items():
        assert np.abs(w).max() > 0.0, path
        tol = LAM_GRAD_TOL if _leaf_name(path) == "lam" else GRAD_TOL
        np.testing.assert_allclose(g_grad[path], w, rtol=0, atol=tol * np.abs(w).max(), err_msg=path)


def _leaf_name(path):
    """``.general.params.normed['lam']`` -> ``lam``; ``.electron.distribution_functions.normed_m`` -> ``normed_m``."""
    return path.split("'")[-2] if "'" in path else path.split(".")[-1]


def test_iaw_deck_loss_and_gradient_match_jax():
    cfg = iaw_deck()
    opts = cfg["other"]["extraoptions"]
    assert opts["fit_IAW"] and not (opts["fit_EPWb"] or opts["fit_EPWr"]) and opts["load_ion_spec"]
    want, got = deck_losses(cfg)
    assert_same_losses(want, got, active={"Te", "Va", "ud", "amp3"})


def test_iaw_deck_ion_window_in_float32():
    """The ion spectrum of the deck's two lineouts at its start values (before the instrument response) in the
    port's float32 plain forms against its float64 path: within 5e-2 of the peak (measured 2.7e-2).  The
    ion-acoustic resonance (Z Te / Ti ~ 100) is set by the electron Landau term, whose difference of
    neighbouring f_e there is ~1e-7 of f_e: formed as the difference of two float32 f_e it missed by 84 % of
    the peak (the JAX package's float32 path misses the deck's loss by 2.1e-2 and its Te gradient by 8x its
    largest entry); the kernels and the float32 plain forms form it from the log-EDF less its peak, with
    expm1 (``form_factor._lookups_1v``)."""
    from tsadar_tpu_torch.utils.process.prepare import prepare_data as port_prepare

    cfg = _lineout_selection(iaw_deck())
    all_data, sa, _ = port_prepare(cfg, cfg["data"]["shotnum"])
    batch = _batch(all_data)
    ion = {}
    for dtype in (torch.float64, torch.float32):
        loss_fn = port.LossFunction(cfg, sa, batch, device="cpu", dtype=dtype)
        params = port.ThomsonParams.create(cfg["parameters"], 2, activate=True, device="cpu", dtype=dtype)
        with torch.no_grad():
            ion[dtype] = loss_fn.ts_diag.model.ion_spectrum(params())[1].double()
    peak = ion[torch.float64].abs().max()
    assert peak > 0.0 and torch.isfinite(ion[torch.float32]).all()
    assert float((ion[torch.float32] - ion[torch.float64]).abs().max() / peak) < 5e-2


@pytest.mark.slow
def test_iaw_deck_fit():
    """``tests/test_inverse/test_1d_iaw_data.py`` on the port, in float64 on the CPU."""
    cfg = iaw_deck()
    cfg["other"].update(calc_sigmas=True, refit=True, refit_thresh=1e-9)
    record = {}
    got, loss = fitter.fit(cfg, device="cpu", record=record)
    pinned = {"Te_electron": [0.7497, 0.8844], "Va_general": [-1.885, -1.817], "amp3_general": [0.9707, 0.9590]}
    for key, vals in pinned.items():
        np.testing.assert_allclose(got[key][:2], vals, rtol=5e-2, err_msg=key)
    np.testing.assert_allclose(got["ud_general"][:2], [-2.477, -0.987], rtol=2e-1, err_msg="ud")
    assert loss < 1e-3
    assert [(r["lineout"], r["batch"], r["slot"]) for r in record["refits"]] == [(1, 0, 1)]
    sig = np.stack([got["sigmas"][k] for k in ("electron.Te", "general.Va", "general.amp3", "general.ud")], axis=1)
    assert sig.shape == (2, 4) and np.all(np.isfinite(sig)) and np.all(sig != 0)
    assert np.all(sig[0] > 0), f"lineout 0 not at a local optimum: {sig}"
