"""The port's artifact writers (``utils.artifacts``) against the JAX package's ``plotters`` on the same inputs.

``get_final_params``, ``plot_ts_data``, ``save_sigmas_params``,
``plot_data_angular`` and ``save_sigmas_fe`` write into a directory each;
every file the JAX package writes but its figures (``plots/``) must be
there: the CSVs byte for byte (pandas' ``to_csv`` layout, which the port
writes with the ``csv`` module) and parsed to the same header, index and
values, the ``.npz`` and ``.nc`` equal.  The sigma columns are mapped by
name: the port names each after the leaf in its place
(``postprocess.sigma_names``), the JAX package permutes the ``general.*``
names (ROADMAP.md §3).
"""

import csv
import os

import numpy as np
import pandas as pd
import pytest
import yaml

from tsadar_tpu.utils.plotting import plotters
import tsadar_tpu_torch as port
from tsadar_tpu_torch.utils import artifacts
from tsadar_tpu_torch.utils.config import merge_configs
from tsadar_tpu_torch.utils.ncwriter import read_dataset
from tsadar_tpu_torch.utils.process.postprocess import sigma_names

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, L = 4, 40


def _dirs(tmp_path):
    out = {}
    for name in ("jax", "port"):
        for sub in ("plots", "binary", "csv") if name == "jax" else ("binary", "csv"):
            os.makedirs(tmp_path / name / sub, exist_ok=True)
        out[name] = str(tmp_path / name)
    return out


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs}


def _same_files(dirs):
    """Every file of the JAX package's but its figures, equal in the port's directory."""
    jax_files = {f for f in _files(dirs["jax"]) if not f.startswith("plots")}
    assert _files(dirs["port"]) == jax_files
    for f in sorted(jax_files):
        got, want = os.path.join(dirs["port"], f), os.path.join(dirs["jax"], f)
        if f.endswith(".csv"):
            with open(got) as g, open(want) as w:
                assert list(csv.reader(g)) == list(csv.reader(w)), f
            assert open(got, "rb").read() == open(want, "rb").read(), f
            pd.testing.assert_frame_equal(pd.read_csv(got, index_col=0), pd.read_csv(want, index_col=0))
        elif f.endswith(".npz"):
            g, w = np.load(got, allow_pickle=True), np.load(want, allow_pickle=True)
            assert sorted(g.files) == sorted(w.files), f
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{f}:{k}")
                assert g[k].dtype == w[k].dtype
        elif f.endswith(".nc"):
            (gv, gc), (wv, wc) = read_dataset(got), read_dataset(want)
            np.testing.assert_equal((gv, gc), (wv, wc))
            assert open(got, "rb").read() == open(want, "rb").read(), f
    return jax_files


def _config(load_ion_spec=True, spectype="temporal"):
    cfg = merge_configs(*[yaml.safe_load(open(os.path.join(ROOT, "tests", "configs", f"time_test_{n}.yaml")))
                          for n in ("defaults", "inputs")])
    cfg["other"]["extraoptions"].update(load_ion_spec=load_ion_spec, spectype=spectype)
    cfg["data"]["lineouts"].update(pixelE=[10, 12, 14, 16], pixelI=[3, 5, 7, 9], start=1, end=3)
    return cfg


def _axes():
    return {"x_label": "Time (ps)", "epw_x": np.arange(20) * 2.5 - 7.0, "iaw_x": np.arange(20) * 3.0,
            "epw_y": np.linspace(400.0, 700.0, L), "iaw_y": np.linspace(525.0, 528.0, L)}


def _params(dtype, fe=None):
    rng = np.random.default_rng(5)
    out = {"electron": {"Te": rng.uniform(0.3, 0.9, N).astype(dtype), "ne": rng.uniform(0.1, 0.3, N).astype(dtype),
                        "m": rng.uniform(2.0, 4.0, N).astype(dtype)},
           "ion-1": {}, "general": {"amp1": rng.uniform(0.5, 1.5, N).astype(dtype), "lam": 524.0 + rng.normal(size=N)}}
    if fe is not None:
        out["electron"]["fe"] = fe
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("load_ion_spec, spectype, fe_shape", [(True, "temporal", None), (False, "temporal", (32,)),
                                                               (False, "imaging", (6, 6)), (False, "angular_full", None)])
def test_final_params_csvs(tmp_path, dtype, load_ion_spec, spectype, fe_shape):
    dirs = _dirs(tmp_path)
    cfg, axes = _config(load_ion_spec, spectype), _axes()
    fe = None if fe_shape is None else np.random.default_rng(1).uniform(size=fe_shape)
    want = plotters.get_final_params(cfg, _params(dtype, fe), axes, dirs["jax"])
    got = artifacts.get_final_params(cfg, _params(dtype, fe), axes, dirs["port"])
    files = _same_files(dirs)
    assert ("csv/learned_dist.csv" in files) == (fe is not None)
    lead = [] if spectype == "angular_full" else ["lineout pixel", "Time (ps)"]
    assert list(got) == lead + list(want)  # the port's dict carries the CSV's leading columns too
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
    if lead:
        pixels = cfg["data"]["lineouts"]["pixelI" if load_ion_spec else "pixelE"]
        np.testing.assert_array_equal(got["lineout pixel"], pixels)
        np.testing.assert_array_equal(got["Time (ps)"], axes["iaw_x" if load_ion_spec else "epw_x"][pixels])


def test_final_params_without_axes_write_no_leading_columns(tmp_path):
    dirs = _dirs(tmp_path)
    cfg = _config()
    want = plotters.get_final_params(cfg, _params(np.float64), {}, dirs["jax"])
    got = artifacts.get_final_params(cfg, _params(np.float64), {}, dirs["port"])
    _same_files(dirs)
    assert list(got) == list(want)


def _spectra(rng, rows=N):
    return {"e_data": rng.uniform(0.0, 1.0, (rows, L)), "i_data": rng.uniform(0.0, 1.0, (rows, L))}


@pytest.mark.parametrize("case", ["both", "electron_only", "no_axes", "off_axis_shape"])
def test_data_and_fits(tmp_path, case):
    rng = np.random.default_rng(7)
    dirs = _dirs(tmp_path)
    cfg, axes, data = _config(), _axes(), _spectra(rng)
    fits = {"ele": {"total_spec": rng.uniform(size=(N, L))}, "ion": {"total_spec": rng.uniform(size=(N, L))}}
    if case == "electron_only":
        data["i_data"] = np.zeros(N)
        fits["ion"] = np.zeros((N, 1))
    elif case == "no_axes":
        axes = {}
    elif case == "off_axis_shape":
        axes["epw_y"] = axes["epw_y"][:-1]
    want = plotters.plot_ts_data(cfg, fits, data, axes, dirs["jax"])
    got = artifacts.plot_ts_data(cfg, fits, data, axes, dirs["port"])
    files = _same_files(dirs)
    assert got.keys() == want.keys()
    np.testing.assert_equal(got, want)
    nc = {"both": {"binary/ele_fit_and_data.nc", "binary/ion_fit_and_data.nc"}, "electron_only": {"binary/ele_fit_and_data.nc"},
          "no_axes": set(), "off_axis_shape": {"binary/ion_fit_and_data.nc"}}[case]
    assert {f for f in files if f.endswith(".nc")} == nc


def test_sigmas_are_named_by_the_leaf_in_their_place(tmp_path):
    """The same sigma matrix through both writers: the port's column i is named after the i-th active leaf
    in the Hessian's (ravel) order, the JAX package's after the i-th fitted parameter in reporting order;
    the values by position are the same, the ``general.*`` names are permuted."""
    dirs = _dirs(tmp_path)
    cfg, axes = _config(load_ion_spec=False), _axes()
    weights = port.ThomsonParams.create(cfg["parameters"], N, activate=True, device="cpu")
    fitted, num_params = weights.get_fitted_params(cfg["parameters"])
    all_params = {g: {k: v.detach().numpy() for k, v in d.items()} for g, d in fitted.items()}
    names = sigma_names(cfg, weights)
    sigmas = np.random.default_rng(2).uniform(1e-3, 1e-1, (N, num_params))
    want = plotters.save_sigmas_params(cfg, all_params, sigmas, axes, dirs["jax"])
    got = artifacts.save_sigmas_params(cfg, names, sigmas, axes, dirs["port"])
    assert got["names"] == names == ["electron.Te", "electron.ne", "electron.m", "general.amp1", "general.amp2", "general.lam"]
    assert want["names"] == ["electron.Te", "electron.ne", "electron.m", "general.lam", "general.amp1", "general.amp2"]
    np.testing.assert_array_equal(got["sigmas"], want["sigmas"])
    port_csv = pd.read_csv(os.path.join(dirs["port"], "csv", "sigmas.csv"), index_col=0)
    jax_csv = pd.read_csv(os.path.join(dirs["jax"], "csv", "sigmas.csv"), index_col=0)
    assert list(port_csv.columns) == names and list(jax_csv.columns) == want["names"]
    np.testing.assert_array_equal(port_csv.to_numpy(), jax_csv.to_numpy())  # by position
    port_nc, port_coords = read_dataset(os.path.join(dirs["port"], "sigmas.nc"))
    jax_nc, jax_coords = read_dataset(os.path.join(dirs["jax"], "sigmas.nc"))
    np.testing.assert_equal(port_coords, jax_coords)
    for i, (p, j) in enumerate(zip(names, want["names"])):
        np.testing.assert_array_equal(port_nc[p.replace(".", "_")], jax_nc[j.replace(".", "_")])
        np.testing.assert_array_equal(port_nc[p.replace(".", "_")], sigmas[:, i])
    # with the names given in the JAX package's order, the files are the JAX package's, byte for byte
    dirs = _dirs(tmp_path / "same")
    plotters.save_sigmas_params(cfg, all_params, sigmas, axes, dirs["jax"])
    artifacts.save_sigmas_params(cfg, want["names"], sigmas, axes, dirs["port"])
    assert _same_files(dirs) == {"binary/sigmas.npz", "csv/sigmas.csv", "sigmas.nc"}


def test_sigmas_past_the_names_and_without_axes(tmp_path):
    dirs = _dirs(tmp_path)
    cfg = _config(load_ion_spec=False)
    sigmas = np.random.default_rng(4).normal(size=(N, 4))
    names = ["electron.Te", "electron.ne"]
    plotters.save_sigmas_params(cfg, {"electron": {"Te": np.ones(N), "ne": np.ones(N)}}, sigmas, {}, dirs["jax"])
    got = artifacts.save_sigmas_params(cfg, names, sigmas, {}, dirs["port"])
    assert _same_files(dirs) == {"binary/sigmas.npz", "csv/sigmas.csv", "sigmas.nc"} and got["names"] == names


@pytest.mark.parametrize("window", [(1, 3), (0, N)])
def test_angular_data_and_fit(tmp_path, window):
    rng = np.random.default_rng(9)
    dirs = _dirs(tmp_path)
    cfg = _config(load_ion_spec=False, spectype="angular_full")
    cfg["data"]["lineouts"].update(start=window[0], end=window[1])
    axes = {"epw_x": np.linspace(20.0, 140.0, N), "epw_y": np.linspace(400.0, 700.0, L)}
    data = {"e_data": rng.uniform(size=(N, L))}
    fits = {"ele": rng.uniform(size=(window[1] - window[0], L))}
    want = plotters.plot_data_angular(cfg, fits, data, axes, dirs["jax"])
    got = artifacts.plot_data_angular(cfg, fits, data, axes, dirs["port"])
    assert _same_files(dirs) == {"binary/angular_fit_and_data.npz", "binary/fit_and_data.nc"}
    np.testing.assert_equal(got, want)


def test_sigmas_of_the_edf(tmp_path):
    dirs = _dirs(tmp_path)
    sigmas = np.random.default_rng(3).uniform(size=(1, 64))
    want = plotters.save_sigmas_fe({}, None, sigmas, dirs["jax"])
    got = artifacts.save_sigmas_fe({}, None, sigmas, dirs["port"])
    assert _same_files(dirs) == {"binary/sigmas_fe.npz", "binary/sigma-fe.nc"}
    np.testing.assert_array_equal(got, want)


def test_the_edf_that_the_jax_package_plots(tmp_path):
    fe = np.random.default_rng(8).uniform(size=(1, 16, 16))
    os.makedirs(tmp_path / "binary")
    np.testing.assert_array_equal(artifacts.save_dist({"fvxvy": fe, "other": 1}, str(tmp_path)), fe[0])
    np.testing.assert_array_equal(np.load(tmp_path / "binary" / "distribution_function.npz")["fe"], fe[0])
    assert artifacts.save_dist({"Te": 1.0}, str(tmp_path / "none")) is None


def test_write_csv_is_pandas_to_csv(tmp_path):
    columns = {"lineout pixel": np.array([500, 504, 508]), "x, with comma": np.array([0.1, 1 / 3, np.nan]),
               "f32": np.array([0.641, 2.5e-9, 1e5], np.float32), "short": np.array([1.0, 2.0])}
    artifacts.write_csv(str(tmp_path / "port.csv"), columns)
    pd.DataFrame({k: pd.Series(v) for k, v in columns.items()}).to_csv(tmp_path / "pandas.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_the_postprocess_writes_the_files(tmp_path, monkeypatch):
    """``postprocess.process_data`` with a directory: the CSVs, data and fits, and sigmas of the fit."""
    from tsadar_tpu_torch.utils.process import postprocess

    cfg = _config(load_ion_spec=False)
    cfg["other"].update(calc_sigmas=False, refit=False)
    cfg["optimizer"]["batch_size"] = 2
    weights = [port.ThomsonParams.create(cfg["parameters"], 2, activate=True, device="cpu") for _ in range(2)]
    rng = np.random.default_rng(0)
    all_data = {"e_data": rng.uniform(size=(N, L)), "i_data": np.zeros(N), "e_amps": np.ones((N, 1)),
                "i_amps": np.ones((N, 1)), "noiseE": np.zeros((N, L)), "noiseI": np.zeros(N)}
    fits = {"ele": {"total_spec": rng.uniform(size=(N, L))}, "ion": {"total_spec": np.zeros((N, 1))}}

    def recalculate(config, sa, indices, data, loss_fn, calc_sigma, fitted, record=None):
        all_params = {k: {} for k in config["parameters"]}
        for w in fitted:
            for g, d in w.get_fitted_params(config["parameters"])[0].items():
                for name, v in d.items():
                    all_params[g].setdefault(name, []).append(v.detach().numpy())
        all_params = {g: {k: np.concatenate(v) for k, v in d.items()} for g, d in all_params.items()}
        return np.zeros(N), {}, 6, fits, np.ones((N, 6)), all_params

    monkeypatch.setattr(postprocess, "recalculate_with_chosen_weights", recalculate)
    for sub in ("binary", "csv"):
        os.makedirs(tmp_path / sub)
    _, final = postprocess.process_data(cfg, np.arange(N), all_data, _axes(), None, weights, None, [], 0.0, str(tmp_path))
    assert _files(str(tmp_path)) == {"csv/learned_parameters.csv", "csv/sigmas.csv", "binary/sigmas.npz", "sigmas.nc",
                                     "binary/ele_fit_and_data.npz", "binary/ele_fit_and_data.nc"}
    table = pd.read_csv(tmp_path / "csv" / "learned_parameters.csv", index_col=0)
    assert list(table.columns) == list(final) and len(table) == N
    np.testing.assert_array_equal(table["Te_electron"], final["Te_electron"])
