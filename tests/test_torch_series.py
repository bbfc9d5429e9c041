"""The forward and series modes of the port against the JAX package's ``calc_series.forward_pass``, on the CPU
in float64, each package under its own ``TSADAR_RUNS_DIR`` and with its own copy of the deck.

* ``configs/1d_series``, cut to its first 3 entries (of 7) to keep the test
  short: the ``Sim`` arrays of both features to 1e-8 of each spectrum's
  peak, the series values and the wavelength coordinates equal, the ``.nc``
  files read back equal to the ``.npz`` files; the sweep sets ``Z`` for two
  ion species an entry, so the two-species tail runs;
* the deck changes ``forward_pass`` makes, as the JAX function makes them;
* the angular arm on ``configs/arts-2d`` at the sizes of
  ``test_torch_arts_forward.py`` (a 256 x 256 CCD, npts 256, nvx 32, nvr 32;
  the deck as written names no ``flm_type`` for its spherical-harmonic EDF,
  which both packages need: the Mora-Yahi f1 of
  ``tests/configs/arts2d_test_inputs.yaml`` is added), to 1e-10 of the peak.
"""

import copy
import glob
import json
import os

import numpy as np
import pytest
import yaml

from tsadar_tpu.forward import calc_series as jax_series
from tsadar_tpu.utils import mlflow_shim as jax_mlflow
from tsadar_tpu_torch.forward import calc_series
from tsadar_tpu_torch.utils import mlflow_shim as port_mlflow
from tsadar_tpu_torch.utils.config import merge_configs
from tsadar_tpu_torch.utils.ncwriter import read_dataset

from .torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SERIES_ENTRIES = 3


def _deck(name):
    return merge_configs(*[yaml.safe_load(open(os.path.join(ROOT, "configs", name, f"{k}.yaml"))) for k in ("defaults", "inputs")])


def series_deck(entries=SERIES_ENTRIES):
    cfg = _deck("1d_series")
    cfg["series"] = {k: (v[:entries] if isinstance(v, list) else v) for k, v in cfg["series"].items()}
    return cfg


def arts_deck(size=256, nvx=32, nvr=32):
    """``configs/arts-2d`` at reduced size, with the spherical-harmonic f1 that the deck leaves unnamed."""
    cfg = _deck("arts-2d")
    cfg["other"]["CCDsize"] = [size, size]
    fe = cfg["parameters"]["electron"]["fe"]
    fe["nvx"] = nvx
    fe["params"].update(nvr=nvr, flm_type="mora-yahi", LTx=225000.0, LTy=400000.0)
    return cfg


def _run_both(tmp_path, monkeypatch, cfg):
    """Each package's ``forward_pass`` on its own copy of ``cfg`` inside a run of its own tracker:
    {package: (artifact directory, the deck after the call, run.json metrics)}."""
    out = {}
    for name, ml, forward, kw in (("jax", jax_mlflow, jax_series.forward_pass, {}),
                                  ("port", port_mlflow, calc_series.forward_pass, {"device": "cpu"})):
        monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / name))
        monkeypatch.setitem(ml._state, "experiment", "series-test")
        deck = copy.deepcopy(cfg)
        with ml.start_run(run_name=name) as run:
            forward(deck, **kw)
        metrics = json.loads((tmp_path / name / "series-test" / os.path.basename(run.run_dir) / "run.json").read_text())["metrics"]
        out[name] = (os.path.join(run.run_dir, "artifacts"), deck, metrics)
    return out


@pytest.fixture(scope="module")
def series_runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield _run_both(tmp_path_factory.mktemp("series"), mp, series_deck())
    finally:
        mp.undo()


@pytest.mark.parametrize("feature", ["electron", "ion"])
def test_series_spectra_match_the_jax_package(series_runs, feature):
    jax_dir, port_dir = series_runs["jax"][0], series_runs["port"][0]
    want = np.load(os.path.join(jax_dir, "binary", f"{feature}_data.npz"), allow_pickle=True)
    got = np.load(os.path.join(port_dir, "binary", f"{feature}_data.npz"), allow_pickle=True)
    assert sorted(got.files) == sorted(want.files) == ["Sim", "Wavelength", "series"]
    assert got["Sim"].shape == want["Sim"].shape == (SERIES_ENTRIES, 1, 1024)
    peak = np.abs(want["Sim"]).max(axis=-1, keepdims=True)
    assert np.all(peak > 0) and np.all(np.isfinite(got["Sim"]))
    assert float((np.abs(got["Sim"] - want["Sim"]) / peak).max()) <= 1e-8
    np.testing.assert_allclose(got["Wavelength"], want["Wavelength"], rtol=1e-14, atol=0)
    assert got["series"].tolist() == want["series"].tolist() == series_deck()["series"]["vals1"]
    # the entries differ from one another: each entry's parameters reached the model
    assert float(np.abs(np.diff(got["Sim"], axis=0)).max()) > 1e-3 * float(peak.max())


@pytest.mark.parametrize("feature", ["electron", "ion"])
def test_series_netcdf_reads_back_as_the_npz(series_runs, feature):
    for package in ("jax", "port"):
        base = os.path.join(series_runs[package][0], "binary", f"{feature}_data")
        npz = np.load(base + ".npz", allow_pickle=True)
        variables, coords = read_dataset(base + ".nc")
        np.testing.assert_array_equal(variables["Sim"], np.squeeze(npz["Sim"]))
        np.testing.assert_array_equal(coords["Wavelength"], np.squeeze(npz["Wavelength"]))
        np.testing.assert_array_equal(coords["series"], np.arange(SERIES_ENTRIES))  # a list an entry: an index axis
    want, _ = read_dataset(os.path.join(series_runs["jax"][0], "binary", f"{feature}_data.nc"))
    got, _ = read_dataset(os.path.join(series_runs["port"][0], "binary", f"{feature}_data.nc"))
    peak = np.abs(want["Sim"]).max(axis=-1, keepdims=True)
    assert float((np.abs(got["Sim"] - want["Sim"]) / peak).max()) <= 1e-8


def test_series_changes_the_deck_as_the_jax_package_does(series_runs):
    (_, jax_deck, jax_metrics), (_, port_deck, port_metrics) = series_runs["jax"], series_runs["port"]
    assert port_deck == jax_deck
    assert port_deck["other"]["npts"] == 5120 and port_deck["optimizer"]["batch_size"] == 1
    last = series_deck()["series"]
    assert [port_deck["parameters"][f"ion-{i}"]["Z"]["val"] for i in (1, 2)] == last["vals1"][-1]
    assert port_deck["parameters"]["electron"]["Te"]["val"] == last["vals2"][-1]
    assert set(port_metrics) == set(jax_metrics) == {"spectrum_calc_time"}


def test_series_files_are_the_jax_packages_but_the_figures(series_runs):
    """The same files, the figure ``plots/simulated_data.png`` included since the port draws it too
    (``tests/test_torch_figures.py`` holds its pixels to the JAX package's)."""
    def files(root):
        return {os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"), recursive=True) if os.path.isfile(p)}

    jax_files = files(series_runs["jax"][0])
    assert files(series_runs["port"][0]) == jax_files
    assert {f for f in jax_files if f.startswith("plots")} == {"plots/simulated_data.png"}


def test_set_series_param_spreads_lists_over_the_ion_species():
    params = series_deck()["parameters"]
    calc_series._set_series_param(params, "Z", [2.5, 1.5])
    calc_series._set_series_param(params, "Ti", 0.07)
    calc_series._set_series_param(params, "amp1", 0.5)
    assert [params[f"ion-{i}"]["Z"]["val"] for i in (1, 2)] == [2.5, 1.5]
    # a scalar goes to the first species that has it; ion-2's Ti is tied to ion-1's ("same") only when the
    # parameters are made, so its deck value stays
    assert params["ion-1"]["Ti"]["val"] == 0.07 and params["ion-2"]["Ti"]["val"] == 0.04
    assert params["general"]["amp1"]["val"] == 0.5
    with pytest.raises(KeyError, match="not found"):
        calc_series._set_series_param(params, "nothing", 1.0)


def test_the_angular_arm_matches_the_jax_package(tmp_path, monkeypatch):
    runs = _run_both(tmp_path, monkeypatch, arts_deck())
    want = np.load(os.path.join(runs["jax"][0], "binary", "angular_fit_and_data.npz"))
    got = np.load(os.path.join(runs["port"][0], "binary", "angular_fit_and_data.npz"))
    lineouts = runs["port"][1]["data"]["lineouts"]
    assert got["fit"].shape == want["fit"].shape and got["fit"].shape[0] == min(lineouts["end"], 256) - lineouts["start"]
    np.testing.assert_array_equal(got["data"], want["data"])
    assert float(np.abs(got["fit"] - want["fit"]).max()) <= 1e-10 * float(np.abs(want["fit"]).max())
    assert runs["port"][1]["other"]["extraoptions"]["spectype"] == runs["jax"][1]["other"]["extraoptions"]["spectype"] == "angular_full"
    # the EDF that the JAX package draws into distribution_function.png, written as data
    fe = np.load(os.path.join(runs["port"][0], "binary", "distribution_function.npz"))["fe"]
    assert fe.shape == (32, 32) and np.all(np.isfinite(fe)) and fe.min() >= 0
