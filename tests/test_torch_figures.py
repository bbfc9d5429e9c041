"""The port's figures (``tsadar_tpu_torch.utils.plotting``, ``utils.data_handling.data_visualizer``) against the JAX
package's, on the CPU, where matplotlib is installed.

* Each figure function and its JAX counterpart, on the same seeded inputs,
  each into a directory of its own: the same file names, and every PNG (and
  every frame of the EDF movie) decodes to the same pixels.  The files the
  JAX functions also write (CSV, ``.npz``, ``.nc``) come from
  ``utils.artifacts`` in the port, as in the postprocess.
* End to end: the main deck (``tests/configs/time_test_*``, 3 L-BFGS-B
  iterations, float64, sigmas and ``plotting.detailed_breakdown``, the
  raw-data visualizer on) through both packages' ``fitter.fit`` inside a run
  of each one's tracker, and the 1D series deck and the ARTS forward through
  both ``calc_series.forward_pass``: the same file names; each figure of the
  port's run is the JAX function's figure of the port's inputs, pixel for
  pixel (the general group's sigma bands come from the port's column names,
  ROADMAP.md §3); the inputs of the two runs' figures agree to 1e-6 of
  their largest entry (the sigmas, inverses of Hessians, to 1e-4).  The
  two runs' PNGs are compared directly too, and the share of equal pixels
  is reported; where the two fits' numbers part in the last digits,
  matplotlib's tight layout may move a figure by a pixel (the JAX function
  against itself at inputs 1e-12 apart does so, ``test_the_layout_moves_
  with_the_last_digits``), so that comparison is held to the shape within
  one pixel.
* The rule: a run is tagged ``figures`` (``drawn``, or ``not drawn: <why>``
  with one log line), figures are drawn only inside a run of the writing
  rank, and a figure function called where matplotlib cannot be imported
  raises.  In a child process where ``import matplotlib`` fails, as on the
  card's machine, every module of the port imports, the forward mode and a
  1-iteration fit of the main deck write the files they write with
  matplotlib (byte for byte) and no PNG, and ``plot_dist`` raises.
"""

import copy
import json
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import matplotlib.image as mimage
import numpy as np
import pytest
import yaml
from PIL import Image, ImageSequence

import chip_smoke
from tsadar_tpu.forward import calc_series as jax_series
from tsadar_tpu.inverse import fitter as jax_fitter
from tsadar_tpu.utils import mlflow_shim as jax_mlflow
from tsadar_tpu.utils.data_handling import data_visualizer as jax_visualizer
from tsadar_tpu.utils.plotting import edf_movie as jax_movie
from tsadar_tpu.utils.plotting import lineout_plot as jax_lineout
from tsadar_tpu.utils.plotting import plotters as jax_plotters
from tsadar_tpu_torch.forward import calc_series
from tsadar_tpu_torch.inverse import fitter
from tsadar_tpu_torch.parallel import dist as par
from tsadar_tpu_torch.utils import artifacts, plotting
from tsadar_tpu_torch.utils import mlflow_shim as mlflow
from tsadar_tpu_torch.utils.config import merge_configs
from tsadar_tpu_torch.utils.data_handling import data_visualizer
from tsadar_tpu_torch.utils.plotting import edf_movie, lineout_plot, plotters
from tsadar_tpu_torch.utils.process import prepare

from .test_torch_checkpoint import _fit as arts_snapshot_fit
from .test_torch_data_pipeline import same_scipy_fits
from .test_torch_series import _run_both, arts_deck, series_deck
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "tests" / "configs"
N, L = 4, 40
SIGMA_TOL = 1e-4  # of the largest sigma: 1.6e-5 measured on the main deck after 3 iterations
FIGURES = ("plot_loss_hist", "plot_ts_data", "detailed_lineouts", "plot_final_params", "plot_data_angular",
           "plot_ang_lineouts", "plot_dist")


def _dirs(tmp_path):
    out = {}
    for name in ("jax", "port"):
        for sub in ("plots", "binary", "csv"):
            os.makedirs(tmp_path / name / sub, exist_ok=True)
        out[name] = str(tmp_path / name)
    return out


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs}


def _pixels(path):
    return mimage.imread(path)


def _frames(path):
    return [np.asarray(frame.convert("RGBA")) for frame in ImageSequence.Iterator(Image.open(path))]


def same_figures(got_root, want_root, names=None):
    """The same files under both roots (or ``names``' PNGs alone), each PNG and GIF decoding to equal pixels:
    the names of the figures compared."""
    got_files, want_files = _files(got_root), _files(want_root)
    if names is None:
        assert got_files == want_files
        names = {f for f in want_files if f.endswith((".png", ".gif"))}
    assert names and names <= got_files and names <= want_files
    for f in sorted(names):
        read = _frames if f.endswith(".gif") else _pixels
        got, want = read(os.path.join(got_root, f)), read(os.path.join(want_root, f))
        if f.endswith(".gif"):
            assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want)), f
        else:
            assert got.shape == want.shape and np.array_equal(got, want), f
    return names


def _axes(n=N, length=L):
    return {"epw_x": np.linspace(2000.0, 2600.0, 600), "epw_y": np.linspace(400.0, 650.0, length),
            "iaw_x": np.linspace(2000.0, 2600.0, 600), "iaw_y": np.linspace(525.0, 528.0, length), "x_label": "Time (ps)"}


def _config(pixels=(100, 200, 300, 400)):
    return {"data": {"lineouts": {"pixelE": list(pixels), "pixelI": list(pixels), "start": 1, "end": 3}},
            "plotting": {"data_cbar_l": "data", "data_cbar_u": "data"}, "other": {"extraoptions": {}}}


def _spectra(rng, n=N, length=L):
    x = np.linspace(-3, 3, length)
    data = np.exp(-(x[None, :] - rng.uniform(-1, 1, (n, 1))) ** 2) + 0.05 * rng.uniform(size=(n, length))
    return data, data + 0.02 * rng.standard_normal((n, length))


# -- the figure functions, one by one ------------------------------------------------------------------------------


def test_colormaps():
    for name in ("TScmap", "_spectrum_cmap"):
        got, want = getattr(plotters, name)(), getattr(jax_plotters, name)()
        assert got.name == want.name and got.N == want.N
        np.testing.assert_array_equal(got.colors, want.colors)


@pytest.mark.parametrize("limits", [("data", "data"), (0.2, 0.9)])
def test_plot_2D_data_vs_fit(tmp_path, limits):
    rng = np.random.default_rng(1)
    dirs = _dirs(tmp_path)
    cfg = {"plotting": {"data_cbar_l": limits[0], "data_cbar_u": limits[1]}}
    x, y = np.meshgrid(np.linspace(0.0, 3.0, 6), np.linspace(400.0, 650.0, L))
    data, fit = _spectra(rng, 6)
    for module, root in ((jax_plotters, dirs["jax"]), (plotters, dirs["port"])):
        module.plot_2D_data_vs_fit(cfg, x, y, data.T, fit.T, root, xlabel="Angle (degrees)", name="two_panels.png")
    assert same_figures(dirs["port"], dirs["jax"]) == {"plots/two_panels.png"}


def test_plot_loss_hist(tmp_path):
    rng = np.random.default_rng(2)
    dirs = _dirs(tmp_path)
    init, final = rng.uniform(1, 9, 16), rng.uniform(0.5, 3, 16)
    red = {name: module.plot_loss_hist({}, init, final, 2.0, dirs[name])
           for name, module in (("jax", jax_plotters), ("port", plotters))}
    np.testing.assert_array_equal(red["port"], red["jax"])
    assert same_figures(dirs["port"], dirs["jax"]) == {"plots/loss_histograms.png"}


@pytest.mark.parametrize("case", ["both", "electron_only", "no_axes", "off_axis_shape"])
def test_plot_ts_data(tmp_path, case):
    rng = np.random.default_rng(3)
    dirs = _dirs(tmp_path)
    e_data, e_fit = _spectra(rng)
    i_data, i_fit = _spectra(rng)
    if case == "electron_only":
        i_data, i_fit = np.zeros((N, 1)), np.zeros((N, 1))
    all_data = {"e_data": e_data, "i_data": i_data}
    fits = {"ele": {"total_spec": e_fit}, "ion": {"total_spec": i_fit}}
    axes = {} if case == "no_axes" else _axes(length=L + 1 if case == "off_axis_shape" else L)
    jax_plotters.plot_ts_data(_config(), fits, all_data, axes, dirs["jax"])
    plotters.plot_ts_data(_config(), fits, all_data, axes, dirs["port"])
    artifacts.plot_ts_data(_config(), fits, all_data, axes, dirs["port"])
    names = same_figures(dirs["port"], dirs["jax"])
    want = {"both": {"ele", "ion"}, "electron_only": {"ele"}}.get(case, set())
    assert {f for f in names if "fit_and_data_" in f} == {f"plots/fit_and_data_{s}.png" for s in want}
    assert "plots/ele_data_vs_fit.png" in names


def _breakdown(rng, axis):
    """``fits`` with the breakdown filed by batch of 2, as the postprocess files it."""
    data, fit = _spectra(rng)
    G, Lm, A = 2, 64, 3
    fits = {"ele": {"total_spec": fit, "IRF": 0.1 * fit, "spec_comps": {}}, "ion": {"total_spec": np.zeros((N, 1))}}
    rows = {"per_lineout": lambda b: np.linspace(500, 560, Lm)[None, :] + np.arange(2)[:, None],
            "one_axis": lambda b: np.linspace(500, 560, Lm)}
    if axis in rows:
        fits["ele"]["detailed_axis"] = {}
    for b in range(N // 2):
        inds = (2 * b, 2 * b + 1)
        fits["ele"]["spec_comps"][inds] = rng.uniform(size=(2, G, Lm, A))
        if axis in rows:
            fits["ele"]["detailed_axis"][inds] = rows[axis](b)
    if axis == "legacy_short":  # a single array without a row for every lineout: the overlay is skipped
        fits["ele"]["detailed_axis"] = np.tile(np.linspace(500, 560, Lm), (2, 1))
    return {"e_data": data, "i_data": np.zeros((N, 1))}, fits


@pytest.mark.parametrize("axis", ["none", "per_lineout", "one_axis", "legacy_short", "no_breakdown"])
def test_detailed_lineouts(tmp_path, axis):
    rng = np.random.default_rng(4)
    dirs = _dirs(tmp_path)
    all_data, fits = _breakdown(rng, axis)
    if axis == "no_breakdown":
        del fits["ele"]["spec_comps"]
    losses = rng.uniform(1, 5, N)
    sqdevs = {"ele": rng.uniform(size=(N, L)), "ion": np.zeros((N, 1))}
    for module, root in ((jax_plotters, dirs["jax"]), (plotters, dirs["port"])):
        module.detailed_lineouts({}, all_data, {}, fits, losses, losses, sqdevs, root)
    names = same_figures(dirs["port"], dirs["jax"])
    assert {"plots/best_ele_lineouts.png", "plots/worst_ele_lineouts.png"} <= names
    assert len([f for f in names if "breakdown_" in f]) == (0 if axis == "no_breakdown" else 4)


def test_plot_final_params(tmp_path):
    rng = np.random.default_rng(5)
    dirs = _dirs(tmp_path)
    all_params = {"electron": {"Te": rng.uniform(0.5, 1, N), "ne": rng.uniform(0.1, 0.3, N), "fe": rng.uniform(size=(N, 8))},
                  "general": {"amp1": rng.uniform(size=N), "lam": 524 + rng.uniform(size=N)}, "ion-1": {}}
    sigma_ds = {"sigmas": 0.01 * rng.standard_normal((N, 3)), "names": ["electron.Te", "general.lam", "general.amp1"]}
    for module, root in ((jax_plotters, dirs["jax"]), (plotters, dirs["port"])):
        module.plot_final_params({}, all_params, sigma_ds, root)
    names = same_figures(dirs["port"], dirs["jax"])
    assert names == {f"plots/{s}_{k}.png" for s, k in (("electron", "Te"), ("electron", "ne"), ("general", "amp1"),
                                                          ("general", "lam"))}


@pytest.mark.parametrize("axes", [True, False])
def test_angular_figures(tmp_path, axes):
    rng = np.random.default_rng(6)
    dirs = _dirs(tmp_path)
    data = rng.uniform(size=(6, L))
    fit = data[1:4] + 0.01 * rng.standard_normal((3, L))
    cfg = {"data": {"lineouts": {"start": 1, "end": 4}}, "plotting": {}}
    all_axes = {"epw_x": np.linspace(20, 60, 6), "epw_y": np.linspace(400, 650, L)} if axes else {}
    want = jax_plotters.plot_data_angular(cfg, {"ele": fit}, {"e_data": data}, all_axes, dirs["jax"])
    jax_plotters.plot_ang_lineouts(5, {"ele": fit}, 1.0, {}, all_axes, want, dirs["jax"])
    plotters.plot_data_angular(cfg, {"ele": fit}, {"e_data": data}, all_axes, dirs["port"])
    got = artifacts.plot_data_angular(cfg, {"ele": fit}, {"e_data": data}, all_axes, dirs["port"])
    plotters.plot_ang_lineouts(5, {"ele": fit}, 1.0, {}, all_axes, got, dirs["port"])
    names = same_figures(dirs["port"], dirs["jax"])
    assert ("plots/fit_and_data.png" in names) == axes and "plots/angular_lineouts.png" in names


@pytest.mark.parametrize("edf", ["1v", "2v", "2v_not_square", "none"])
def test_plot_dist(tmp_path, edf):
    rng = np.random.default_rng(7)
    dirs = _dirs(tmp_path)
    v = np.linspace(-6, 6, 24)
    final = {"1v": {"fe": np.exp(-(v**2) / 2)[None, :]},
             "2v": {"fvxvy": np.exp(-(v[None, :] ** 2 + v[:, None] ** 2) / 2) * rng.uniform(0.9, 1.1, (24, 24))},
             "2v_not_square": {"f": rng.uniform(size=(3, 24))},
             "none": {"Te_electron": np.ones(2)}}[edf]
    for module, root in ((jax_plotters, dirs["jax"]), (plotters, dirs["port"])):
        module.plot_dist({}, "electron", final, None, root)
    if edf == "none":
        assert _files(dirs["port"]) == _files(dirs["jax"]) == set()
    else:
        assert same_figures(dirs["port"], dirs["jax"]) == {"plots/distribution_function.png"}


def test_lineout_plot(tmp_path):
    rng = np.random.default_rng(8)
    dirs = _dirs(tmp_path)
    data, fit = _spectra(rng, 3)
    args = (list(data), list(fit), list((data - fit) ** 2), np.linspace(400, 650, L), [2505.0, 2530.0, 2555.0], "Time (ps)",
            [0, 5, 10], [L, 35, 30])
    jax_lineout.lineout_plot(*args, dirs["jax"], "worst")
    lineout_plot.lineout_plot(*args, dirs["port"], "worst")
    assert same_figures(dirs["port"], dirs["jax"]) == {"lineouts_worst.png"}


@pytest.mark.parametrize("kind", ["pixel", "range"])
def test_data_visualizer(tmp_path, monkeypatch, kind):
    """The raw frames with their fit windows and lineouts, logged into a run of each package's tracker."""
    rng = np.random.default_rng(9)
    elec, ion = rng.uniform(0, 100, (128, 96)), rng.uniform(0, 100, (128, 96))
    all_axes = {"epw_x": np.arange(96.0), "epw_y": np.linspace(700, 400, 128), "iaw_x": np.arange(96.0),
                "iaw_y": np.linspace(529, 524, 128), "x_label": "px"}
    fit_rng = {"blue_min": 450.0, "blue_max": 510.0, "red_min": 540.0, "iaw_min": 525.5, "iaw_max": 527.5}
    config = {"data": {"fit_rng": fit_rng, "lineouts": {"type": kind, "val": list(range(10, 90, 3))}}}
    roots = {}
    for name, ml, visualize in (("jax", jax_mlflow, jax_visualizer.launch_data_visualizer),
                                ("port", mlflow, data_visualizer.launch_data_visualizer)):
        monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / name))
        ml.set_experiment("figures")
        with ml.start_run(run_name=name) as run:
            visualize(elec, ion, all_axes, config)
        roots[name] = os.path.join(run.run_dir, "artifacts")
    assert same_figures(roots["port"], roots["jax"]) == {"electron_raw_data.png", "ion_raw_data.png"}


def _snapshots(tmp_path, which):
    v = np.linspace(-6, 6, 48)
    snaps = {"1v": {e: {"electron": {"fe": np.exp(-(v**2) / (2 * (1 + 0.1 * i)))}} for i, e in enumerate([0, 10, 20])},
             "2v": {e: {"electron": {"f": np.exp(-(v[None, :] ** 2 + v[:, None] ** 2) / (2 + e))}} for e in (0, 5)},
             "flm": {e: {"electron": {"flm": {0: {0: np.exp(-(v**2) / (2 + e))}, 1: {0: v}}}} for e in (0, 4)},
             "empty": {0: {"electron": {}}}}[which]
    path = tmp_path / f"state_weights_{which}.txt"
    path.write_bytes(pickle.dumps(snaps))
    return path


@pytest.mark.parametrize("which", ["1v", "2v", "flm"])
def test_edf_movie(tmp_path, which):
    path = _snapshots(tmp_path, which)
    dirs = _dirs(tmp_path)
    for module, root in ((jax_movie, dirs["jax"]), (edf_movie, dirs["port"])):
        assert module.make_edf_movie(str(path), os.path.join(root, "edf.gif"), fps=2) == os.path.join(root, "edf.gif")
    same_figures(dirs["port"], dirs["jax"], {"edf.gif"})
    assert len(_frames(os.path.join(dirs["port"], "edf.gif"))) == {"1v": 3, "2v": 2, "flm": 2}[which]


def test_edf_movie_rejects_snapshots_without_an_edf(tmp_path):
    path = _snapshots(tmp_path, "empty")
    for module in (jax_movie, edf_movie):
        with pytest.raises(ValueError, match="no distribution snapshots"):
            module.make_edf_movie(str(path), str(tmp_path / "nope.gif"))


def test_edf_movie_of_the_port_loop_from_the_command_line(tmp_path, monkeypatch):
    """The snapshots that the port's angular loop pickles (``optimizer.save_state``) are what the movie reads:
    ``python -m tsadar_tpu_torch.utils.plotting.edf_movie IN OUT`` makes the JAX package's movie of them."""
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    mlflow.set_experiment("figures")
    with mlflow.start_run(run_name="snapshots") as run:
        arts_snapshot_fit("adam", 6, save_state=True, save_state_freq=4)
    path = Path(run.run_dir) / "artifacts" / "state_weights.txt"
    dirs = _dirs(tmp_path)
    jax_movie.make_edf_movie(str(path), os.path.join(dirs["jax"], "edf.gif"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-m", "tsadar_tpu_torch.utils.plotting.edf_movie", str(path),
                          os.path.join(dirs["port"], "edf.gif")], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    same_figures(dirs["port"], dirs["jax"], {"edf.gif"})
    assert len(_frames(os.path.join(dirs["port"], "edf.gif"))) == 2  # epochs 0 and 4


# -- the rule ------------------------------------------------------------------------------------------------------


def _tags(run_dir):
    return json.loads((Path(run_dir) / "run.json").read_text())["tags"]


def test_the_figures_rule(tmp_path, monkeypatch):
    lines = []
    monkeypatch.setattr(plotting, "log_info", lines.append)
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path))
    assert plotting.available() == (True, "")
    assert plotting.figures() is False and lines == []  # no run: nothing would keep a figure
    with mlflow.start_run(run_name="drawn") as run:
        assert plotting.figures() and plotting.figures()
    assert _tags(run.run_dir) == {"figures": "drawn"} and lines == []
    missing = ImportError("No module named 'matplotlib'", name="matplotlib")
    monkeypatch.setattr(plotting, "_import", {"error": missing, "module": None})
    assert plotting.available() == (False, "No module named 'matplotlib'")
    for _ in range(2):
        with mlflow.start_run(run_name="not-drawn") as run:
            assert not plotting.figures() and not plotting.figures()
        assert _tags(run.run_dir) == {"figures": "not drawn: No module named 'matplotlib'"}
    assert lines == ["figures not drawn: matplotlib cannot be imported (No module named 'matplotlib')"] * 2
    for call in (plotting.mpl, plotting.subplots, lambda: plotters.plot_dist({}, "electron", {"fe": np.ones(4)}, None, ".")):
        with pytest.raises(ImportError, match="No module named 'matplotlib'") as e:
            call()
        assert e.value.name == "matplotlib"


@pytest.mark.parametrize("rank", [0, 1])
def test_only_the_writing_rank_draws(tmp_path, monkeypatch, rank):
    """A rank other than 0 opens no run (``mlflow_shim.writer``): it draws nothing; rank 0 draws the run's
    figure once."""
    drawn = []
    subplots = plotting.subplots
    monkeypatch.setattr(plotting, "subplots", lambda *a, **k: drawn.append(a) or subplots(*a, **k))
    monkeypatch.setattr(par, "rank", lambda: rank)
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path))
    cfg = merge_configs(*[yaml.safe_load((ROOT / "configs" / "1d" / f"{k}.yaml").read_text()) for k in ("defaults", "inputs")])
    with mlflow.start_run(run_name="forward") as run:
        calc_series.forward_pass(cfg, device="cpu")
    assert len(drawn) == (1 if rank == 0 else 0)
    if rank == 0:
        assert _files(Path(run.run_dir) / "artifacts" / "plots") == {"simulated_data.png"}
    else:
        assert run is None and not any(tmp_path.iterdir())


def test_chip_smoke_figures_check(tmp_path, monkeypatch):
    """``chip_smoke.figures_check`` on the forward mode's runs: ``drawn`` with ``plots/simulated_data.png``, or,
    with matplotlib unimportable, ``not drawn`` naming it and no PNG; a missing figure or a wrong tag fails."""
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path))
    cfg = merge_configs(*[yaml.safe_load((ROOT / "configs" / "1d" / f"{k}.yaml").read_text()) for k in ("defaults", "inputs")])
    missing = ImportError("No module named 'matplotlib'", name="matplotlib")
    reports = {}
    for name in ("drawn", "not_drawn"):
        with monkeypatch.context() as m:
            if name == "not_drawn":
                m.setattr(plotting, "_import", {"error": missing, "module": None})
            with mlflow.start_run(run_name=name) as run:
                calc_series.forward_pass(copy.deepcopy(cfg), device="cpu")
            meta = json.loads((Path(run.run_dir) / "run.json").read_text())
            reports[name] = chip_smoke.figures_check(run.run_dir, meta)
            assert not chip_smoke.figures_check(run.run_dir, {"tags": {}})[1]
    assert reports["drawn"] == ({"tag": "drawn", "matplotlib": True, "pngs": 1, "missing": []}, True)
    assert reports["not_drawn"] == ({"tag": "not drawn: No module named 'matplotlib'", "matplotlib": False, "pngs": 0,
                                     "missing": []}, True)
    (png,) = Path(tmp_path).rglob("simulated_data.png")
    png.unlink()
    run_dir = png.parent.parent.parent
    report, ok = chip_smoke.figures_check(run_dir, json.loads((run_dir / "run.json").read_text()))
    assert not ok and report["missing"] == ["plots/simulated_data.png"]


# -- end to end ----------------------------------------------------------------------------------------------------


def _recording(monkeypatch, modules, calls):
    """Wrap each named function of each module: its calls record their arguments in ``calls``, then run."""
    for module, names in modules:
        for name in names:
            real = getattr(module, name)

            def record(*args, _real=real, _name=name, **kwargs):
                calls.append((_name, copy.deepcopy(args), copy.deepcopy(kwargs)))
                return _real(*args, **kwargs)

            monkeypatch.setattr(module, name, record)


def _same_inputs(got, want, where, rtol=1e-6):
    """Arrays to ``rtol`` of the largest entry, containers entry by entry, anything else equal."""
    if isinstance(want, dict):
        assert set(map(str, got)) == set(map(str, want)), where
        by_name = {str(k): v for k, v in got.items()}
        for k, v in want.items():
            _same_inputs(by_name[str(k)], v, f"{where}.{k}", rtol)
    elif isinstance(want, (list, tuple)) and any(isinstance(v, (dict, list, tuple)) for v in want):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_inputs(g, w, f"{where}[{i}]", rtol)
    elif isinstance(want, str) or want is None:
        assert got == want, where
    else:
        g, w = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
        assert g.shape == w.shape, where
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(float(np.abs(w).max(initial=0.0)), 1e-300), err_msg=where)


def _redraw(calls, root, monkeypatch):
    """Each recorded call of the port's figures made again with the JAX function, into ``root`` (the JAX
    package's raw-data visualizer inside a run of its tracker)."""
    for sub in ("plots", "binary", "csv"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for name, args, kwargs in calls:
        if name == "launch_data_visualizer":
            monkeypatch.setenv("TSADAR_RUNS_DIR", str(root.parent / "redraw_runs"))
            with jax_mlflow.start_run(run_name="redraw") as run:
                jax_visualizer.launch_data_visualizer(*args, **kwargs)
            for f in _files(os.path.join(run.run_dir, "artifacts")):
                os.replace(os.path.join(run.run_dir, "artifacts", f), os.path.join(root, f))
            continue
        getattr(jax_plotters, name)(*args[:-1], str(root), **kwargs)  # the directory is the last argument


def _direct(got_root, want_root):
    """{figure: share of equal pixels, or both shapes where they differ} of the two runs' PNGs, each pair's
    shapes within one pixel."""
    shares = {}
    for f in sorted(f for f in _files(want_root) if f.endswith(".png")):
        got, want = _pixels(os.path.join(got_root, f)), _pixels(os.path.join(want_root, f))
        assert all(abs(g - w) <= 1 for g, w in zip(got.shape, want.shape)) and got.shape[2:] == want.shape[2:], f
        shares[f] = float(np.all(got == want, axis=-1).mean()) if got.shape == want.shape else [got.shape, want.shape]
    return shares


def _main_deck():
    cfg = merge_configs(*[yaml.safe_load((CONFIGS / f"time_test_{n}.yaml").read_text()) for n in ("defaults", "inputs")])
    cfg["optimizer"]["num_epochs"] = 3
    cfg["other"]["calc_sigmas"] = True
    cfg["plotting"]["detailed_breakdown"] = True
    assert cfg["data"]["launch_data_visualizer"]
    return cfg


def test_main_deck_fit_draws_the_jax_packages_figures(tmp_path, monkeypatch):
    calls = {"jax": [], "port": []}
    _recording(monkeypatch, [(jax_plotters, FIGURES), (jax_visualizer, ["launch_data_visualizer"])], calls["jax"])
    _recording(monkeypatch, [(plotters, FIGURES), (prepare, ["launch_data_visualizer"])], calls["port"])
    roots = {}
    with same_scipy_fits():  # one fit of the streak background for both packages (its two mirror solutions)
        for name, ml, fit in (("jax", jax_mlflow, lambda: jax_fitter.fit(config=_main_deck())),
                              ("port", mlflow, lambda: fitter.fit(_main_deck(), device="cpu"))):
            monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / name))
            ml.set_experiment("figures")
            with ml.start_run(run_name=name) as run:
                fit()
            roots[name] = os.path.join(run.run_dir, "artifacts")
    assert _files(roots["port"]) == _files(roots["jax"])
    figures = {f for f in _files(roots["port"]) if f.endswith(".png")}
    assert {"electron_raw_data.png", "plots/loss_histograms.png", "plots/ele_data_vs_fit.png", "plots/fit_and_data_ele.png",
            "plots/best_ele_lineouts.png", "plots/worst_ele_lineouts.png", "plots/general_lam.png",
            "plots/electron_Te.png"} <= figures
    assert len([f for f in figures if "breakdown_" in f]) == 3  # ele lineouts 0 and 1; ion lineout 0 (its unloaded data: one row of zeros)
    assert _tags(os.path.dirname(roots["port"]))["figures"] == "drawn"
    # chip_smoke.py's names for a run's figures, read from its other files (the breakdown's are not among them)
    assert chip_smoke.jax_figure_names(roots["jax"]) == {f for f in figures if f.startswith("plots/") and "breakdown_" not in f}

    # the two runs handed their figures the same inputs; the sigma columns keep the port's names (ROADMAP.md §3)
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]]
    for (name, got, _), (_, want, _) in zip(calls["port"], calls["jax"]):
        skip = {0, len(want) - 1} if name != "launch_data_visualizer" else {3}  # the deck, the directory
        for i, (g, w) in enumerate(zip(got, want)):
            if i in skip:
                continue
            if name == "plot_final_params" and i == 2:  # the sigmas: the inverse of Hessians that agree to 5e-8
                _same_inputs(g["sigmas"], w["sigmas"], f"{name}[{i}]", rtol=SIGMA_TOL)
                continue
            _same_inputs(g, w, f"{name}[{i}]")

    # each of the port's figures is the JAX function's figure (its calls recorded too) of the port's inputs
    _redraw(calls["port"], tmp_path / "redrawn", monkeypatch)
    assert same_figures(roots["port"], str(tmp_path / "redrawn"), figures) == figures

    shares = _direct(roots["port"], roots["jax"])
    print("main deck, share of equal pixels:", json.dumps(shares))
    assert set(shares) == figures


def _replay(monkeypatch, outputs):
    """The JAX package's ``forward_pass`` with its diagnostic replaced: each call returns the port's next entry
    (ThryE, ThryI, lamAxisE, lamAxisI), so the JAX function draws the port's spectra."""
    entries = iter(zip(*outputs))
    monkeypatch.setattr(jax_series, "ThomsonScatteringDiagnostic", lambda *a, **k: lambda params, batch: next(entries))
    monkeypatch.setattr(jax_series, "jax", types.SimpleNamespace(jit=lambda f: f, device_get=lambda x: x))


@pytest.mark.parametrize("mode", ["series", "arts_forward"])
def test_forward_modes_draw_the_jax_packages_figures(tmp_path, monkeypatch, mode):
    """``plots/simulated_data.png`` of the 1D series deck (3 entries, two ion species), and the ARTS forward's
    image beside its (zero) data and its EDF (no ``fit_and_data.png``: the forward's data are the whole
    camera's zeros, whose shape is not the window's, in both packages).  The port writes the EDF as data as
    well (``binary/distribution_function.npz``, a file of its own)."""
    calls, outputs = [], []
    _recording(monkeypatch, [(plotters, FIGURES)], calls)
    forward = calc_series.forward_pass
    monkeypatch.setattr(calc_series, "forward_pass", lambda *a, **k: outputs.append(forward(*a, **k)) or outputs[-1])
    deck = series_deck() if mode == "series" else arts_deck()
    runs = _run_both(tmp_path, monkeypatch, deck)
    port_root, jax_root = runs["port"][0], runs["jax"][0]
    figures = {f for f in _files(jax_root) if f.endswith(".png")}
    assert figures == ({"plots/simulated_data.png"} if mode == "series" else
                       {"plots/angular_data_vs_fit.png", "plots/distribution_function.png"})
    own = set() if mode == "series" else {"binary/distribution_function.npz"}
    assert _files(port_root) == _files(jax_root) | own
    assert chip_smoke.jax_figure_names(port_root) == figures  # chip_smoke.py's names, read from the run's other files

    # each of the port's figures is the JAX package's figure of the port's spectra
    redrawn = tmp_path / "redrawn"
    if mode == "series":  # drawn inside forward_pass: the JAX function itself, its diagnostic replaying the port's
        _replay(monkeypatch, outputs[0])
        monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "redraw_runs"))
        with jax_mlflow.start_run(run_name="redraw") as run:
            jax_series.forward_pass(copy.deepcopy(deck))
        redrawn = Path(run.run_dir) / "artifacts"
    else:
        _redraw(calls, redrawn, monkeypatch)
    assert same_figures(port_root, str(redrawn), figures) == figures
    shares = _direct(port_root, jax_root)
    print(f"{mode}, share of equal pixels:", json.dumps(shares))
    assert set(shares) == figures


def test_the_layout_moves_with_the_last_digits(tmp_path):
    """Why the two runs' PNGs are compared within a pixel: the JAX package's own histogram of two losses
    moves when the losses change by 1e-12 of their value (tight layout, then Agg's pixel snapping)."""
    dirs = _dirs(tmp_path)
    losses = np.array([46.2, 54.4]) + np.random.default_rng(0).uniform(-1, 1, 2)
    jax_plotters.plot_loss_hist({}, losses, losses, 1.0, dirs["jax"])
    jax_plotters.plot_loss_hist({}, losses * (1 + 1e-12), losses * (1 + 1e-12), 1.0, dirs["port"])
    got, want = (_pixels(os.path.join(dirs[n], "plots", "loss_histograms.png")) for n in ("port", "jax"))
    assert got.shape == want.shape and not np.array_equal(got, want)
    plotters.plot_loss_hist({}, losses, losses, 1.0, dirs["port"])
    same_figures(dirs["port"], dirs["jax"], {"plots/loss_histograms.png"})


# -- without matplotlib --------------------------------------------------------------------------------------------

WITHOUT_MATPLOTLIB = r"""
import importlib, json, os, pkgutil, runpy, sys
sys.modules["matplotlib"] = None  # as on the card's machine: import matplotlib fails
import tsadar_tpu_torch
from tsadar_tpu_torch import cli
from tsadar_tpu_torch.utils import plotting
from tsadar_tpu_torch.utils.plotting import plotters
from tests.test_torch_data_pipeline import same_scipy_fits

modules = [m.name for m in pkgutil.walk_packages(tsadar_tpu_torch.__path__, "tsadar_tpu_torch.")
           if not m.name.endswith("__main__")]
for name in modules:
    importlib.import_module(name)
print("IMPORTED", len(modules), flush=True)
try:
    plotters.plot_dist({}, "electron", {"fe": [1.0, 2.0]}, None, ".")
except ImportError as e:
    print("RAISED", json.dumps(str(e)), flush=True)

def both(tag):
    os.environ["TSADAR_RUNS_DIR"] = os.path.join(os.getcwd(), tag)
    sys.argv = ["tsadar_tpu_torch", "--cfg", "configs/1d", "--mode", "forward", "--device", "cpu"]
    runpy.run_module("tsadar_tpu_torch", run_name="__main__", alter_sys=True)
    cli.main(["--cfg", "fit_deck", "--mode", "fit", "--device", "cpu"])

with same_scipy_fits():
    both("without")
    print("MATPLOTLIB", "matplotlib" in sys.modules and sys.modules["matplotlib"] is not None, flush=True)
    del sys.modules["matplotlib"]
    plotting._import.clear()
    both("with")
"""


def test_runs_without_matplotlib(tmp_path):
    """The forward mode (``python -m tsadar_tpu_torch``) and a 1-iteration fit of the main deck in a process where
    matplotlib cannot be imported, then again in the same process with it: the same files but the PNGs,
    byte for byte, and no PNG; each run tagged ``not drawn`` with one log line."""
    defaults, inputs = (yaml.safe_load((CONFIGS / f"time_test_{n}.yaml").read_text()) for n in ("defaults", "inputs"))
    defaults["optimizer"]["num_epochs"] = 1
    defaults["other"]["calc_sigmas"] = True
    deck = tmp_path / "fit_deck"
    deck.mkdir()
    for name, d in (("defaults", defaults), ("inputs", inputs)):
        (deck / f"{name}.yaml").write_text(yaml.safe_dump(d))
    os.symlink(ROOT / "configs", tmp_path / "configs")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MLFLOW_EXPORT")}
    env |= {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", WITHOUT_MATPLOTLIB], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    stdout = out.stdout.splitlines()
    modules = [p for p in (ROOT / "tsadar_tpu_torch").rglob("*.py") if p.name != "__main__.py"]
    assert f"IMPORTED {len(modules) - 1}" in stdout, stdout  # every module but the package's own __init__
    assert 'RAISED "import of matplotlib halted; None in sys.modules"' in stdout
    assert "MATPLOTLIB False" in stdout
    reason = "import of matplotlib halted; None in sys.modules"
    assert [ln for ln in out.stderr.splitlines() if "figures not drawn" in ln] == [
        f"figures not drawn: matplotlib cannot be imported ({reason})"] * 2
    runs = {tag: {p.parent.parent.name + "/" + p.parent.name.rsplit("-", 1)[0]: p.parent
                  for p in (tmp_path / tag).rglob("run.json")} for tag in ("without", "with")}
    assert len(runs["without"]) == 2 and runs["without"].keys() == runs["with"].keys()
    for name, without in runs["without"].items():
        with_ = runs["with"][name]
        assert json.loads((without / "run.json").read_text())["tags"]["figures"] == f"not drawn: {reason}"
        assert json.loads((with_ / "run.json").read_text())["tags"]["figures"] == "drawn"
        bare, drawn = _files(without / "artifacts"), _files(with_ / "artifacts")
        assert not any(f.endswith(".png") for f in bare)
        assert bare == {f for f in drawn if not f.endswith(".png")} and bare != drawn
        for f in bare:
            assert (without / "artifacts" / f).read_bytes() == (with_ / "artifacts" / f).read_bytes(), f
