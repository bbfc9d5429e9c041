"""Shot 112059 (EPW_CCD, the imaging spectype): the port's loss, gradient and spectrum breakdown against JAX's,
and its fit.

The main deck (``tests/configs/time_test_*``) with
``tests/test_inverse/test_imaging_data.py``'s changes: shot 112059, pixel
lineouts 500:510:5 (one batch of two), adam for 30 epochs, the
``detailed_breakdown`` of the postprocess on; the raw-data visualizer off.  On
the CPU in float64, each package's data pipeline feeding its own loss at the
start values: the tolerances of ``tests/test_torch_iaw_deck.py``; and
``ThomsonScatteringDiagnostic.spectrum_breakdown``'s ten outputs at the same
parameters and batch: the spectra, component stacks and instrument-only
spectra to 1e-10 of their peaks, the axes to 1e-12.  ``test_imaging_data``
(slow-marked, as the JAX test is) runs the deck through the port's
``fitter.fit(device="cpu")``: that test's pins, and the record's breakdown of
the batch, finite, for both features.
"""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.config import merge_configs
from tsadar_tpu.utils.process.prepare import prepare_data as jax_prepare
import tsadar_tpu_torch as port
from tsadar_tpu_torch.inverse import fitter
from tsadar_tpu_torch.inverse.fitter import _lineout_selection
from tsadar_tpu_torch.utils.process.prepare import prepare_data

from .test_torch_data_pipeline import same_scipy_fits
from .test_torch_iaw_deck import assert_same_losses, deck_losses
from .test_torch_real_data_loss import _batch
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
BREAKDOWN = ("modlE", "modlI", "ThryE", "ThryI", "eIRF", "iIRF", "lamAxisE", "lamAxisI", "lamAxisE_raw", "lamAxisI_raw")


def deck_112059():
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, f"time_test_{n}.yaml"))) for n in ("defaults", "inputs")]
    cfg = merge_configs(*decks)
    cfg["data"]["launch_data_visualizer"] = False  # a figure: tests/test_torch_figures.py
    cfg["data"]["shotnum"] = 112059
    cfg["data"]["lineouts"].update({"type": "pixel", "start": 500, "end": 510, "skip": 5})
    cfg["optimizer"].update({"method": "adam", "num_epochs": 30, "batch_size": 2})
    cfg.setdefault("plotting", {})["detailed_breakdown"] = True
    return cfg


def test_112059_loss_and_gradient_match_jax():
    want, got = deck_losses(deck_112059())
    assert_same_losses(want, got, active={"Te", "ne", "normed_m", "amp1", "amp2", "lam"})


def test_112059_spectrum_breakdown_matches_jax():
    cfg = _lineout_selection(deck_112059())
    jax_cfg, port_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    with same_scipy_fits():
        data, sa, _ = jax_prepare(jax_cfg, jax_cfg["data"]["shotnum"])
        port_data, port_sa, _ = prepare_data(port_cfg, port_cfg["data"]["shotnum"])
    tp = JaxParams.create(jax_cfg["parameters"], 2, batch=True, activate=True)
    want = JaxLoss(jax_cfg, sa, _batch(data)).ts_diag.spectrum_breakdown(tp, _batch(data))
    diag = port.LossFunction(port_cfg, port_sa, _batch(port_data), device="cpu").ts_diag
    got = diag.spectrum_breakdown(port.ThomsonParams.create(port_cfg["parameters"], 2, activate=True, device="cpu"),
                                  _batch(port_data))
    assert len(got) == len(want) == 10
    for name, w, g in zip(BREAKDOWN, want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape and g.dtype == np.float64 and np.isfinite(g).all(), name
        tol = 1e-12 if name.startswith("lamAxis") else 1e-10
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-300), err_msg=name)
    assert got[2].shape == (2, 1, 5120, 10) and got[3].shape == (2, 1)  # the deck loads no ion spectrum
    assert np.count_nonzero(got[4]) > 0 and not torch.equal(got[4][0], got[4][1])


@pytest.mark.slow
def test_imaging_data():
    """``tests/test_inverse/test_imaging_data.py`` on the port, in float64 on the CPU (its fit and pins)."""
    record = {}
    got, loss = fitter.fit(deck_112059(), device="cpu", record=record)
    assert float(np.asarray(loss).ravel()[0]) < 2.5e-2
    np.testing.assert_allclose(got["Te_electron"][:2], [0.413, 0.417], rtol=5e-2)
    np.testing.assert_allclose(got["ne_electron"][:2], [0.170, 0.173], rtol=5e-2)
    for feature in ("ele", "ion"):
        fits = record["fits"][feature]
        assert list(fits["spec_comps"]) == list(fits["detailed_axis"]) == [(0, 1)]
        assert all(np.isfinite(a).all() for a in (fits["IRF"], fits["spec_comps"][(0, 1)], fits["detailed_axis"][(0, 1)]))
