"""The port's copy of the host data pipeline against the JAX package's, on shot 101675's real data.

Every stage gets the same inputs in both packages and must give the same
outputs to 1e-12 relative (the code is the same numpy and scipy, so in
practice they are bit for bit equal): ``read_sds`` on every committed shot
file, ``loadData`` for the three instruments, ``get_calibrations`` in every
shot range of the three spectypes, ``correctThroughput``, ``get_shot_bg`` (no
background shot, a "Shot" background, the ARTS "Fit" gain model), and
``prepare_data`` (through ``fitter.load_data_for_fitting``, the deck's one
shot) on the whole-shot deck at 128 lineouts (pixels 300:812:4):
the lineouts, their amplitudes and noise, the scattering angles, the axes, and
the config fields ``prepare_data`` writes (``npts``, ``lamrangE``,
``lamrangI``, ``widIRF``, ``CCDsize``).  The raw-data visualizer draws into an
open run where matplotlib imports and is skipped, with one log line and the
run's ``figures`` tag, where it does not; the feature detector has its own tests
(``tests/test_torch_feature_detector.py``).

scipy's Levenberg-Marquardt ``curve_fit`` (1.17) is not deterministic on the
streak background's two-exponential fit: the model is symmetric under
(a, b) <-> (c, d), and depending on the process's memory state the fit ends in
one of two mirror solutions that differ by ~1e-5 of the background, in the JAX
package as in the port.  Where both pipelines run, ``same_scipy_fits`` hands
them the same fit for the same inputs (computed once), so the comparison
holds what the port's code does, not which branch scipy took.
"""

import contextlib
import copy
import json
import os
from pathlib import Path

import numpy as np
import pytest
import scipy.optimize as spopt
import yaml

from tsadar_tpu.utils.config import merge_configs
from tsadar_tpu.utils.data_handling import calibration as jax_calibration
from tsadar_tpu.utils.data_handling.hdf4 import read_sds as jax_read_sds
from tsadar_tpu.utils.data_handling.load_ts_data import loadData as jax_loadData
from tsadar_tpu.utils.process.correct_throughput import correctThroughput as jax_correct
from tsadar_tpu.utils.process.evaluate_background import get_shot_bg as jax_shot_bg
from tsadar_tpu.utils.process.prepare import prepare_data as jax_prepare
from tsadar_tpu_torch.inverse.fitter import _lineout_selection, load_data_for_fitting
from tsadar_tpu_torch.utils import calibration
from tsadar_tpu_torch.utils.data_handling.hdf4 import read_sds
from tsadar_tpu_torch.utils.data_handling.load_ts_data import DATA_DIR, loadData
from tsadar_tpu_torch.utils.process.correct_throughput import correctThroughput
from tsadar_tpu_torch.utils.process.evaluate_background import get_shot_bg
from tsadar_tpu_torch.utils.process.prepare import prepare_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOT_FILES = sorted(f for f in os.listdir(DATA_DIR) if f.endswith(".hdf"))
REL_TOL = 1e-12


def _same(got, want, what=""):
    """Equal to REL_TOL of the largest |entry| (exactly, for non-float values)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    if want.dtype.kind not in "fc" or want.size == 0:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(float(np.abs(want).max()), np.finfo(float).tiny)
    assert float(np.abs(got - want).max()) <= REL_TOL * scale, what


@contextlib.contextmanager
def same_scipy_fits():
    """``scipy.optimize.curve_fit``, which both packages call as ``spopt.curve_fit``, memoized by
    (model name, inputs, start values, options) for the duration of the block."""
    real, memo = spopt.curve_fit, {}

    def fit(f, xdata, ydata, p0=None, *args, **kwargs):
        key = (f.__name__, np.asarray(xdata).tobytes(), np.asarray(ydata).tobytes(),
               None if p0 is None else np.asarray(p0, float).tobytes(), repr(args), repr(sorted(kwargs.items())))
        if key not in memo:
            memo[key] = real(f, xdata, ydata, p0, *args, **kwargs)
        return tuple(np.copy(v) for v in memo[key])

    spopt.curve_fit = fit
    try:
        yield
    finally:
        spopt.curve_fit = real


def _deck(start=300, end=812, skip=4, batch_size=128):
    decks = [yaml.safe_load(open(os.path.join(ROOT, "tests", "configs", f"time_test_{n}.yaml"))) for n in ("defaults", "inputs")]
    cfg = merge_configs(*decks)
    cfg["data"]["launch_data_visualizer"] = False  # a figure: tests/test_torch_figures.py
    cfg["data"]["lineouts"].update(start=start, end=end, skip=skip)
    cfg["optimizer"]["batch_size"] = batch_size
    return _lineout_selection(cfg)


def test_the_shot_files_are_the_repositorys():
    assert len(SHOT_FILES) == 11 and "EPW-s101675.hdf" in SHOT_FILES
    assert os.path.samefile(DATA_DIR, os.path.join(ROOT, "tsadar_tpu", "external", "data"))


@pytest.mark.parametrize("name", SHOT_FILES)
def test_read_sds(name):
    got = read_sds(os.path.join(DATA_DIR, name))
    assert got.shape == (2, 1024, 1024) and got.dtype.kind == "u"
    np.testing.assert_array_equal(got, jax_read_sds(os.path.join(DATA_DIR, name)))


@pytest.mark.parametrize(
    "shot, ion, timing",
    [(101675, True, True), (101675, False, False), (111411, True, False), (112059, True, False), (94475, False, False)],
    ids=["temporal_timed", "temporal_epw", "temporal_111411", "imaging", "angular"],
)
def test_load_data(shot, ion, timing):
    specs = {"load_ion_spec": ion, "load_ele_spec": True, "absolute_timing": timing}
    got_specs, want_specs = dict(specs), dict(specs)
    got, want = loadData(shot, False, got_specs), jax_loadData(shot, False, want_specs)
    assert got_specs == want_specs
    for k, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, np.ndarray):
            _same(g, w, f"output {k}")
        else:
            assert g == w, f"output {k}"


CALIBRATION_SHOTS = {
    "temporal": [98615, 101675, 106000, 108970, 111420, 115000, 120000],
    "imaging": [103000, 106310, 107625, 112059, 120000],
    "angular": [94000, 104000],
}


@pytest.mark.parametrize("tstype", sorted(CALIBRATION_SHOTS))
def test_get_calibrations(tstype):
    for shot in CALIBRATION_SHOTS[tstype]:
        got = calibration.get_calibrations(shot, tstype, [12.0, 37.0], [1024, 1024])
        want = jax_calibration.get_calibrations(shot, tstype, [12.0, 37.0], [1024, 1024])
        for k in (0, 1, 2, 3):
            _same(got[k], want[k], f"{tstype} {shot} axis {k}")
        assert got[4] == want[4] and got[5] == want[5]


@pytest.mark.parametrize("tstype, shot", [("temporal", 101675), ("imaging", 112059), ("angular", 94475), ("angular", 104000)])
def test_correct_throughput(tstype, shot):
    rng = np.random.default_rng(0)
    data = rng.uniform(0.0, 1000.0, (1024, 1024))
    axisy = calibration.get_calibrations(shot, tstype, [0.0, 0.0], [1024, 1024])[2]
    _same(correctThroughput(data, tstype, axisy, shot), jax_correct(data, tstype, axisy, shot))


@pytest.mark.parametrize("bg", ["pixel", "shot", "arts_fit"])
def test_get_shot_bg(bg):
    cfg = _deck(500, 510, 5, 2)
    shot, spectype = 101675, "temporal"
    if bg == "shot":
        cfg["data"]["background"].update(type="Shot", slice=111411)
    elif bg == "arts_fit":
        cfg["data"]["background"].update(type="Fit", slice=94477)
        shot, spectype = 94475, "angular"
    cfg["other"]["extraoptions"].update(spectype=spectype, load_ion_spec=bg == "shot")
    axisyE = calibration.get_calibrations(shot, spectype, [0.0, 0.0], [1024, 1024])[2]
    elec = np.random.default_rng(1).uniform(0.0, 2000.0, (1024, 1024))
    got = get_shot_bg(copy.deepcopy(cfg), shot, axisyE, elec)
    want = jax_shot_bg(copy.deepcopy(cfg), shot, axisyE, elec)
    for g, w in zip(got, want):
        _same(g, w, bg)
    if bg != "pixel":
        assert np.ndim(got[0]) == 2


@pytest.fixture(scope="module")
def prepared():
    """(port's (all_data, sa, axes), its config, JAX's (all_data, sa, axes), its config) at 128 lineouts."""
    cfg = _deck()
    port_cfg, jax_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    assert port_cfg["data"]["shotnum"] == 101675
    with same_scipy_fits():
        return load_data_for_fitting(port_cfg), port_cfg, jax_prepare(jax_cfg, 101675), jax_cfg


def test_prepare_data(prepared):
    (data, sa, axes), cfg, (jdata, jsa, jaxes), jcfg = prepared
    assert data["e_data"].shape == (128, 1024) and np.all(np.isfinite(data["e_data"]))
    assert cfg["data"]["lineouts"]["val"] == list(range(300, 812, 4))
    assert sorted(data) == sorted(jdata) and sorted(sa) == sorted(jsa) and sorted(axes) == sorted(jaxes)
    for k in jdata:
        _same(data[k], jdata[k], k)
    for k in jsa:
        _same(sa[k], jsa[k], k)
    for k in jaxes:
        _same(axes[k], jaxes[k], k)
    assert cfg["other"]["npts"] == jcfg["other"]["npts"] == 5120
    for key in ("lamrangE", "lamrangI", "CCDsize"):
        _same(cfg["other"][key], jcfg["other"][key], key)
    assert cfg["other"]["PhysParams"]["widIRF"] == jcfg["other"]["PhysParams"]["widIRF"]
    for key in ("pixelE", "pixelI"):
        _same(cfg["data"]["lineouts"][key], jcfg["data"]["lineouts"][key], key)


def test_the_visualizer_is_logged_and_skipped(tmp_path, monkeypatch):
    """Where matplotlib cannot be imported (the card's machine) the raw-data visualizer is skipped: the run
    logs one line for it, its tag ``figures`` says why, and the data are those prepared with it off.  Where
    matplotlib imports, the run gets the raw frames' figures (``tests/test_torch_figures.py`` holds their
    pixels to the JAX package's) and the same data."""
    from tsadar_tpu_torch.utils import mlflow_shim as mlflow
    from tsadar_tpu_torch.utils import plotting

    lines = []
    monkeypatch.setattr(plotting, "log_info", lines.append)
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path))
    cfg = _deck(500, 510, 5, 2)
    cfg["data"]["launch_data_visualizer"] = True
    missing = ImportError("No module named 'matplotlib'", name="matplotlib")
    with same_scipy_fits():  # the streak background's fit lands on one of two mirror solutions (module docstring)
        off = prepare_data(_deck(500, 510, 5, 2), 101675)
        with monkeypatch.context() as m:
            m.setattr(plotting, "_import", {"error": missing, "module": None})
            with mlflow.start_run(run_name="no-matplotlib") as skipped:
                on = prepare_data(copy.deepcopy(cfg), 101675)
        with mlflow.start_run(run_name="matplotlib") as drawn:
            again = prepare_data(cfg, 101675)
    assert lines == ["figures not drawn: matplotlib cannot be imported (No module named 'matplotlib')"]
    assert json.loads((Path(skipped.run_dir) / "run.json").read_text())["tags"] == {
        "figures": "not drawn: No module named 'matplotlib'"}
    assert not (Path(skipped.run_dir) / "artifacts" / "electron_raw_data.png").exists()
    assert json.loads((Path(drawn.run_dir) / "run.json").read_text())["tags"] == {"figures": "drawn"}
    assert (Path(drawn.run_dir) / "artifacts" / "electron_raw_data.png").is_file()
    np.testing.assert_equal(on, off)
    np.testing.assert_equal(again, off)


def test_multiplexed_shots_raise():
    """A list of shots raises before any data is read, with the JAX package's message for a deck that is not
    ``angular_full`` and, for one that is, where the JAX package's ``prepare_data`` fails, naming that fault
    (``tests/test_torch_multiplex.py`` holds both packages to it)."""
    cfg = _deck(500, 510, 5, 2)
    cfg["data"]["shotnum"] = [101675, 101676]
    with pytest.raises(NotImplementedError, match="^Multiplexed data fitting is only available for angular data$"):
        load_data_for_fitting(cfg)
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    with pytest.raises(NotImplementedError, match="loads data.shotnum, not shotNum"):
        load_data_for_fitting(cfg)


def test_lineout_selection_drops_the_ragged_batch():
    cfg = _deck(300, 812, 4, 100)
    assert cfg["data"]["lineouts"]["val"] == list(range(300, 700, 4))
