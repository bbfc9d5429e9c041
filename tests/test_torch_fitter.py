"""``tsadar_tpu_torch.inverse.fitter.fit`` on the main deck against the JAX package's ``fitter.fit``, on the CPU.

The deck is ``tests/configs/time_test_{defaults,inputs}.yaml`` merged as
written (shot 101675, pixels 500 and 505, batch size 2, ``method: l-bfgs-b``)
with the raw-data visualizer off (a figure; ``tests/test_torch_figures.py``
holds the figures to the JAX package's) and, in
tier-1, ``num_epochs`` cut to 3 L-BFGS-B iterations: both packages' final
parameters agree to 1e-6 relative, the port's come with the lineout pixels and
the time axis, and its record with the stage seconds and scipy's ``nit``.  The
two fits share one fit of the streak background (``same_scipy_fits``: scipy's
``curve_fit`` ends it in either of two mirror solutions).
The JAX package's plots are stubbed out (only ``get_final_params`` is kept):
they cost tier-1 seconds and say nothing of the fit.  The port's fit runs
outside a tracked run, so it writes no file and draws no figure.

``test_fit_main_deck_as_written`` (slow-marked, as
``tests/test_inverse/test_1d_data.py`` is) runs the deck's full 1000
iterations in float64 and holds the result to that test's upstream-validated
values and tolerances and its self-validated pins of both lineouts.  A
multiplexed deck raises before any data is read; an angular deck and
``plotting.detailed_breakdown`` run.
"""

from pathlib import Path

import numpy as np
import pytest
import yaml

from tsadar_tpu.inverse import fitter as jax_fitter
from tsadar_tpu.utils import mlflow_shim as mlflow
from tsadar_tpu.utils.config import merge_configs
from tsadar_tpu.utils.plotting import plotters
from tsadar_tpu_torch.inverse import fitter

from .test_torch_data_pipeline import same_scipy_fits
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CONFIGS = Path(__file__).resolve().parent / "configs"
ACTIVE = ("amp1_general", "amp2_general", "lam_general", "Te_electron", "ne_electron", "m_electron")


def _deck(num_epochs=None):
    decks = [yaml.safe_load((CONFIGS / f"time_test_{n}.yaml").read_text()) for n in ("defaults", "inputs")]
    cfg = merge_configs(*decks)
    cfg["data"]["launch_data_visualizer"] = False
    if num_epochs is not None:
        cfg["optimizer"]["num_epochs"] = num_epochs
    return cfg


def test_fit_matches_jax_fitter(tmp_path, monkeypatch):
    for name in ("plot_ts_data", "detailed_lineouts", "save_sigmas_params", "plot_final_params"):
        monkeypatch.setattr(plotters, name, lambda *a, **k: None)
    monkeypatch.setattr(plotters, "plot_loss_hist", lambda config, losses_init, losses, reduced_points, td: np.asarray(losses))
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    mlflow.set_experiment("tsadar-tpu-tests")
    record = {}
    with same_scipy_fits():  # one fit of the streak background for both packages (its two mirror solutions)
        with mlflow.start_run(run_name="test_torch_fitter"):
            want, want_loss = jax_fitter.fit(config=_deck(num_epochs=3))
        got, got_loss = fitter.fit(_deck(num_epochs=3), device="cpu", record=record)
    assert list(got)[:2] == ["lineout pixel", "Time (ps)"]
    np.testing.assert_array_equal(got["lineout pixel"], [500, 505])
    assert np.all(np.isfinite(got["Time (ps)"]))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for key in ACTIVE:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-6, err_msg=key)
    assert record["scipy"]["nit"] == [3]
    assert all(record[k] > 0.0 for k in ("setup_seconds", "fit_seconds", "postprocess_seconds"))


@pytest.mark.slow
def test_fit_main_deck_as_written():
    """``tests/test_inverse/test_1d_data.py`` on the port, in float64 on the CPU."""
    got, _ = fitter.fit(_deck(), device="cpu")
    real_values = {"amp1_general": (0.733, 1e-1), "amp2_general": (0.520, 1e-1), "lam_general": (523.855, 5e-3),
                   "Te_electron": (0.641, 1e-1), "ne_electron": (0.228, 5e-2), "m_electron": (3.20, 15e-2)}
    for key, (val, rtol) in real_values.items():
        np.testing.assert_allclose(got[key][0], val, rtol=rtol, err_msg=key)
    pinned = {"amp1_general": [0.7855, 0.7621], "amp2_general": [0.5073, 0.5169], "lam_general": [524.57, 524.45],
              "Te_electron": [0.6476, 0.6282], "ne_electron": [0.2291, 0.2295], "m_electron": [3.155, 3.079]}
    for key, vals in pinned.items():
        np.testing.assert_allclose(got[key][:2], vals, rtol=3e-2, err_msg=key)


@pytest.mark.parametrize("option", ["detailed_breakdown", "angular"])
def test_fit_refuses_what_is_not_ported_up_front(option):
    """``plotting.detailed_breakdown``, which raised here until ``spectrum_breakdown`` was ported, runs: the
    record's fitted spectra carry the breakdown of the deck's one batch (``tests/test_torch_imaging_112059.py``
    holds it to JAX's).  The angular fit, which raised here until it was ported, goes on to read its data
    (``tests/test_torch_arts_fit.py`` runs it); a multiplexed deck still raises before any data is read."""
    cfg = _deck()
    if option == "detailed_breakdown":
        cfg["plotting"]["detailed_breakdown"] = True
        cfg["optimizer"]["num_epochs"] = 1
        record = {}
        fitter.fit(cfg, device="cpu", record=record)
        ele = record["fits"]["ele"]
        assert list(ele["spec_comps"]) == [(0, 1)] and ele["spec_comps"][(0, 1)].shape == (2, 1, 5120, 10)
        assert ele["IRF"].shape == (2, 1024) and ele["detailed_axis"][(0, 1)].shape == (2, 5120)
        assert all(np.isfinite(a).all() for a in (ele["spec_comps"][(0, 1)], ele["IRF"], ele["detailed_axis"][(0, 1)]))
        assert np.abs(ele["IRF"]).max() > 0.0
        return
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    cfg["data"]["shotnum"] = [-1, -2]  # a multiplexed deck stops before any data is read, where the JAX package's fails
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fitter.fit(cfg, device="cpu")
    cfg["data"]["shotnum"] = -1  # one image: the angular fit is ported and goes on to read its shot
    with pytest.raises(LookupError, match="No data found for shotnumber -1"):
        fitter.fit(cfg, device="cpu")
