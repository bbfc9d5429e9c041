"""The port's command line and runner: ``python -m tsadar_tpu_torch`` and ``tsadar_tpu_torch.runner``, on the CPU.

* ``--help`` and the missing ``--cfg`` (ports of ``tests/test_utils/test_cli.py``);
* without ``--device cpu`` and with no GPU the command fails with
  ``resolve_device``'s message, before a run is registered;
* the fit of ``test_runner_paths._small_decks()`` (2 lineouts, adam, 10
  epochs) through ``python -m tsadar_tpu_torch --mode fit --device cpu``: the
  run holds the JAX package's stage metrics and files; and through
  ``cli.main`` in this process, where its ``learned_parameters.csv`` equals
  ``fitter.fit(cfg, device="cpu")``'s final parameters to 1e-12 (the two share
  one fit of the streak background: ``same_scipy_fits``);
* ports of ``run_job`` and ``run_for_app`` from ``test_runner_paths.py``;
* the forward mode of ``configs/1d``, the profile option, and what happens
  before any work: ``TSADAR_MULTIHOST`` starts the process group once, before
  the run is registered, and nothing starts it without the variable (the
  contract of the JAX package's hook, ``tests/test_parallel/test_multihost_hook.py``,
  probed in a child process with ``init_process_group`` wrapped); an
  optimizer the angular fit does not take and an unknown mode raise;
* slow: a whole ``runner.run`` of the JAX package against the port's command
  line on the same decks.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from tsadar_tpu_torch import cli, runner
from tsadar_tpu_torch.inverse import fitter
from tsadar_tpu_torch.utils import mlflow_shim as mlflow
from tsadar_tpu_torch.utils.config import merge_configs
from tsadar_tpu_torch.utils.schema import ConfigError

from .test_torch_data_pipeline import same_scipy_fits
from .test_utils.test_runner_paths import DATA_DIR, _small_decks
from .torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
STAGE_METRICS = {"setup_time", "fit_time", "postprocess_time", "overall loss", "batch loss", "fit_lossfn_init_time",
                 "fit_param_init_time", "fit_first_dispatch_time", "refitting time", "recalc_arrayloss_time",
                 "recalc_hessian_time", "postprocessing time", "plotting time", "total_time", "num_cores"}


def _env(tmp_path):
    """The child's environment: the repository on its path, its own runs directory, and one intra-op thread
    (as this module's tests have: the same arithmetic, and no oversubscription beside other test workers)."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MLFLOW_EXPORT")}
    return env | {"TSADAR_RUNS_DIR": str(tmp_path / "runs"), "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}


def _module(args, tmp_path, cwd=None):
    return subprocess.run([sys.executable, "-m", "tsadar_tpu_torch", *args], cwd=cwd or tmp_path, env=_env(tmp_path),
                          capture_output=True, text=True, timeout=600)


def _write_decks(directory, defaults, inputs):
    directory.mkdir(parents=True, exist_ok=True)
    for name, deck in (("defaults", defaults), ("inputs", inputs)):
        with open(directory / f"{name}.yaml", "w") as fi:
            yaml.dump(deck, fi)
    return directory


def _run_dir(root, run_id):
    found = [p.parent for p in Path(root).rglob("run.json") if p.parent.name.endswith(run_id)]
    assert len(found) == 1, found
    return found[0]


def test_cli_help_exits_zero(tmp_path):
    out = _module(["--help"], tmp_path)
    assert out.returncode == 0
    assert "--cfg" in out.stdout and "--mode" in out.stdout and "--device {cuda,cpu}" in out.stdout


def test_cli_requires_cfg_or_run_id(tmp_path):
    out = _module([], tmp_path)
    assert out.returncode != 0 and "--cfg" in out.stderr


def test_cli_refuses_to_fall_back_to_the_cpu(tmp_path, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is reachable")
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    cfg = _write_decks(tmp_path / "cfg", *_small_decks())
    for argv in (["--cfg", str(cfg)], ["--cfg", str(cfg), "--device", "cuda"], ["--run_id", "abc"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code != 0
        assert "runs on a CUDA device unless told otherwise" in capsys.readouterr().err
    assert not (tmp_path / "runs").exists()  # nothing registered
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.run(str(cfg), "fit")


def test_cli_fit_child_process_writes_the_run(tmp_path):
    """``python -m tsadar_tpu_torch --mode fit`` in a process of its own: exit 0, the run's record (status, stage
    metrics, parameters, the ``figures`` tag), its files and figures and its stored decks; the CSV's columns and
    pixels."""
    defaults, inputs = _small_decks()
    _write_decks(tmp_path / "cfg", defaults, inputs)
    out = _module(["--cfg", "cfg", "--mode", "fit", "--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr
    (run_dir,) = [p.parent for p in (tmp_path / "runs").rglob("run.json")]
    table = pd.read_csv(run_dir / "artifacts" / "csv" / "learned_parameters.csv", index_col=0)
    assert list(table.columns)[:2] == ["lineout pixel", "Time (ps)"] and len(table) == 2
    np.testing.assert_array_equal(table["lineout pixel"], [500, 502])
    meta = json.loads((run_dir / "run.json").read_text())
    assert meta["tags"]["status"] == "completed" and STAGE_METRICS <= set(meta["metrics"])
    assert meta["params"]["optimizer.method"] == "adam"
    files = {str(p.relative_to(run_dir / "artifacts")) for p in (run_dir / "artifacts").rglob("*") if p.is_file()}
    # and, matplotlib being installed here, the JAX package's figures (tests/test_torch_figures.py holds their pixels)
    figures = {f"plots/{n}.png" for n in ("loss_histograms", "ele_data_vs_fit", "fit_and_data_ele", "best_ele_lineouts",
                                          "worst_ele_lineouts", "electron_Te", "electron_ne", "electron_m",
                                          "general_amp1", "general_amp2", "general_lam")} | {"electron_raw_data.png"}
    assert files == {"defaults.yaml", "inputs.yaml", "csv/learned_parameters.csv", "csv/sigmas.csv", "binary/sigmas.npz",
                     "sigmas.nc", "binary/ele_fit_and_data.npz", "binary/ele_fit_and_data.nc"} | figures
    assert meta["tags"]["figures"] == "drawn"
    assert yaml.safe_load((run_dir / "artifacts" / "defaults.yaml").read_text()) == defaults


def test_cli_fit_writes_the_fitters_parameters(tmp_path, monkeypatch):
    """The command line's fit (``cli.main`` in this process) and ``fitter.fit`` on the same deck, sharing one fit
    of the streak background (``same_scipy_fits``: scipy's ``curve_fit`` ends it in either of two mirror
    solutions from one process to the next): the CSV holds the fitter's parameters to 1e-12."""
    defaults, inputs = _small_decks()
    cfg = _write_decks(tmp_path / "cfg", defaults, inputs)
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    with same_scipy_fits():
        run_id = cli.main(["--cfg", str(cfg), "--mode", "fit", "--device", "cpu"])
        want, _ = fitter.fit(merge_configs(defaults, inputs), device="cpu")
    table = pd.read_csv(_run_dir(tmp_path / "runs", run_id) / "artifacts" / "csv" / "learned_parameters.csv", index_col=0)
    assert list(table.columns) == list(want) and len(table) == 2
    for k, v in want.items():
        np.testing.assert_allclose(table[k].to_numpy(), v, rtol=1e-12, atol=0, err_msg=k)


def test_run_job_resumes_from_stored_decks(tmp_path, monkeypatch):
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    cfg_dir = _write_decks(tmp_path / "cfg", *_small_decks())
    run_id, decks = runner.load_and_make_folders(str(cfg_dir))  # queue time: the decks stored as artifacts
    assert decks == dict(zip(("defaults", "inputs"), _small_decks()))
    monkeypatch.chdir(tmp_path)
    runner.run_job(run_id, mode="fit", nested=False, device="cpu")  # a later process: the run id alone
    run_dir = _run_dir(tmp_path / "runs", run_id)
    meta = json.loads((run_dir / "run.json").read_text())
    assert meta["tags"]["status"] == "completed"
    assert (run_dir / "artifacts" / "csv" / "learned_parameters.csv").is_file()


def test_run_job_nested_puts_the_outer_run_back(tmp_path, monkeypatch):
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    cfg_dir = _write_decks(tmp_path / "cfg", *_decks("1d"))
    run_id, _ = runner.load_and_make_folders(str(cfg_dir))
    mlflow.set_experiment("outer")
    with mlflow.start_run(run_name="outer") as outer:
        mlflow.log_metrics({"before": 1.0})
        runner.run_job(run_id, mode="forward", nested=True, device="cpu")
        mlflow.log_metrics({"after": 2.0})
    meta = json.loads((Path(outer.run_dir) / "run.json").read_text())
    assert set(meta["metrics"]) == {"before", "after"} and meta["tags"] == {}
    inner = json.loads((_run_dir(tmp_path / "runs", run_id) / "run.json").read_text())
    assert inner["tags"]["status"] == "completed" and "spectrum_calc_time" in inner["metrics"]


def test_run_for_app_fits_from_artifact_data(tmp_path, monkeypatch):
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    config = merge_configs(*_small_decks())
    epw_name = "EPW-s101675.hdf"
    config["data"]["filenames"] = {"epw": epw_name, "iaw": None}
    mlflow.set_experiment("app-test")
    with mlflow.start_run(run_name="app") as run:
        artifacts = os.path.join(run.run_dir, "artifacts")
        with open(os.path.join(artifacts, "config.yaml"), "w") as fi:
            yaml.dump(config, fi)
        shutil.copy(os.path.join(DATA_DIR, epw_name), artifacts)
        run_id = run.info.run_id
    monkeypatch.chdir(tmp_path)
    assert runner.run_for_app(run_id, device="cpu") == run_id
    meta = json.loads((_run_dir(tmp_path / "runs", run_id) / "run.json").read_text())
    assert meta["tags"]["status"] == "completed"
    assert meta["params"]["data.filenames.epw-local"] == os.path.join(artifacts, epw_name)


def _decks(name):
    return [yaml.safe_load((ROOT / "configs" / name / f"{k}.yaml").read_text()) for k in ("defaults", "inputs")]


def test_forward_mode_writes_one_spectrum_a_feature(tmp_path, monkeypatch):
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    monkeypatch.chdir(ROOT)
    run_id = runner.run("configs/1d", "forward", device="cpu")
    run_dir = _run_dir(tmp_path / "runs", run_id)
    for feature in ("electron", "ion"):
        sim = np.load(run_dir / "artifacts" / "binary" / f"{feature}_data.npz", allow_pickle=True)["Sim"]
        assert sim.shape == (1, 1, 1024) and np.all(np.isfinite(sim)) and sim.max() > 0
    meta = json.loads((run_dir / "run.json").read_text())
    assert meta["tags"]["status"] == "completed" and "spectrum_calc_time" in meta["metrics"]


def test_the_profile_option_logs_a_torch_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    defaults, inputs = _decks("1d")
    defaults["other"]["profile"] = True
    run_id = runner.run(str(_write_decks(tmp_path / "cfg", defaults, inputs)), "forward", device="cpu")
    trace = _run_dir(tmp_path / "runs", run_id) / "artifacts" / "torch_trace" / "trace.json"
    assert trace.is_file() and "traceEvents" in json.loads(trace.read_text())
    # the port's spans are named ranges in the user's trace: the layers show
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"diagnostic", "form_factor", "spectrum", "irf", "series", "series.entry"} <= names


# the child of the multihost case: init_process_group wrapped to count its calls and to note whether a run was
# registered before it (then joined as a group of one through a file store), then runner.run of configs/1d
_MULTIHOST_PROBE = """
import os, sys
import torch.distributed as dist
calls, real = [], dist.init_process_group
def init(*args, **kwargs):
    calls.append(os.path.exists(os.environ["TSADAR_RUNS_DIR"]))
    real(*args, **dict(kwargs, init_method="file://" + sys.argv[1], world_size=1, rank=0))
dist.init_process_group = init
from tsadar_tpu_torch import runner
runner.run("configs/1d", "forward", device="cpu")
print("INIT_CALLS", len(calls), "RUN_BEFORE", any(calls), "UP_AFTER", dist.is_initialized())
"""


def _multihost_probe(tmp_path, multihost):
    env = _env(tmp_path) | {"TSADAR_RUNS_DIR": str(tmp_path / "probe_runs")}
    env.pop("TSADAR_MULTIHOST", None)
    env.pop("WORLD_SIZE", None)
    if multihost:
        env["TSADAR_MULTIHOST"] = "1"
    out = subprocess.run([sys.executable, "-c", _MULTIHOST_PROBE, str(tmp_path / f"store{int(multihost)}")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("case", ["multihost", "angular_fit", "unknown_mode"])
def test_what_the_port_cannot_run_raises_before_any_work(tmp_path, monkeypatch, case):
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    monkeypatch.chdir(ROOT)
    if case == "multihost":  # runs now: the hook's contract, as the JAX package's test holds its own
        assert "INIT_CALLS 1 RUN_BEFORE False UP_AFTER False" in _multihost_probe(tmp_path, True)
        assert "INIT_CALLS 0 RUN_BEFORE False UP_AFTER False" in _multihost_probe(tmp_path, False)
    elif case == "angular_fit":  # an angular fit runs (tests/test_torch_arts_fit.py), with every optax optimizer;
        # an optax callable that is no optimizer, which the JAX package's schema takes, does not
        defaults, inputs = _decks("arts-2d")
        inputs["optimizer"] = {"method": "chain"}
        with pytest.raises(ConfigError, match="the port takes these optax optimizers"):
            runner.run(str(_write_decks(tmp_path / "cfg", defaults, inputs)), "fit", device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="not implemented"):
            runner.run("configs/1d", "plot", device="cpu")
    assert not (tmp_path / "runs").exists()


@pytest.mark.slow
def test_a_whole_run_of_the_jax_package_against_the_ports_command_line(tmp_path, monkeypatch):
    """``tsadar_tpu.runner.run`` in-process and ``python -m tsadar_tpu_torch`` on the same decks (the small
    deck with sigmas): the same CSV columns and pixels, parameters within 2e-3, every file but the figures
    (``.png``: ``plots/`` and the raw-data visualizer's ``electron_raw_data.png``)."""
    from tsadar_tpu import runner as jax_runner

    defaults, inputs = _small_decks()
    defaults["other"]["calc_sigmas"] = True
    _write_decks(tmp_path / "cfg", defaults, inputs)
    out = _module(["--cfg", "cfg", "--mode", "fit", "--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "jax_runs"))
    monkeypatch.chdir(tmp_path)
    jax_runner.run("cfg", "fit")
    (port_dir,) = [p.parent / "artifacts" for p in (tmp_path / "runs").rglob("run.json")]
    (jax_dir,) = [p.parent / "artifacts" for p in (tmp_path / "jax_runs").rglob("run.json")]
    got = pd.read_csv(port_dir / "csv" / "learned_parameters.csv", index_col=0)
    want = pd.read_csv(jax_dir / "csv" / "learned_parameters.csv", index_col=0)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=2e-3)
    files = lambda d: {str(p.relative_to(d)) for p in d.rglob("*") if p.is_file() and p.suffix != ".png"}  # noqa: E731
    assert files(port_dir) == files(jax_dir)
