"""The port's netCDF writer, run tracker, export and queue script against the JAX package's.

* ``utils.ncwriter``: a round trip, and a file written by either package read
  by the other;
* ``utils.mlflow_shim``: one sequence of the calls the port makes -- a run
  with its config, metrics, parameters, tags and artifacts, a nested run
  inside it, calls outside any run, the run resumed by id -- leaves the same
  ``run.json`` files and artifacts from both trackers, timestamps and ids
  aside;
* ``utils.export``: the bucket's key layout and the ingestion marker;
* ``tsadar_tpu_torch.queue``: the job script around the base template.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tsadar_tpu.utils import export as jax_export
from tsadar_tpu.utils import mlflow_shim as jax_mlflow
from tsadar_tpu.utils import ncwriter as jax_nc
from tsadar_tpu_torch import queue as port_queue
from tsadar_tpu_torch.utils import export as port_export
from tsadar_tpu_torch.utils import mlflow_shim as port_mlflow
from tsadar_tpu_torch.utils import ncwriter as port_nc

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from queue_tsadar_tpu import load_and_queue as jax_load_and_queue  # noqa: E402

PACKAGES = {"jax": (jax_mlflow, jax_nc, jax_export), "port": (port_mlflow, port_nc, port_export)}


def _dataset():
    rng = np.random.default_rng(3)
    x, y = np.linspace(0.0, 1.0, 5), np.linspace(400.0, 700.0, 7)
    return {"fit": rng.normal(size=(5, 7)), "data": rng.normal(size=(5, 7))}, [("Time (ps)", x), ("Wavelength", y)]


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_ncwriter_files_read_back_in_either_package(tmp_path, writer, reader):
    variables, coords = _dataset()
    path = str(tmp_path / "ds.nc")
    PACKAGES[writer][1].write_dataset(path, variables, coords)
    got_vars, got_coords = PACKAGES[reader][1].read_dataset(path)
    assert got_vars.keys() == variables.keys() and set(got_coords) == {name for name, _ in coords}
    for k, v in variables.items():
        np.testing.assert_array_equal(got_vars[k], v)
    for name, vals in coords:
        np.testing.assert_array_equal(got_coords[name], vals)


def test_ncwriter_writes_the_jax_packages_bytes(tmp_path):
    variables, coords = _dataset()
    for name, (_, nc, _) in PACKAGES.items():
        nc.write_dataset(str(tmp_path / f"{name}.nc"), variables, coords)
    assert (tmp_path / "port.nc").read_bytes() == (tmp_path / "jax.nc").read_bytes()


def test_ncwriter_refuses_a_shape_that_misses_the_coords(tmp_path):
    with pytest.raises(ValueError, match="expected"):
        port_nc.write_dataset(str(tmp_path / "bad.nc"), {"v": np.zeros((2, 3))}, [("a", np.arange(3)), ("b", np.arange(2))])


def _sequence(ml, tmp):
    """One sequence of tracker calls; returns the outer run's id."""
    (tmp / "top").mkdir()
    (tmp / "top" / "artifact.txt").write_text("A")
    tree = tmp / "tree" / "sub"
    tree.mkdir(parents=True)
    (tree / "b.txt").write_text("B")
    ml.set_experiment("exp")
    ml.log_metrics({"outside": 1.0})  # no run is open: no file shows it
    ml.set_tag("outside", "x")
    with ml.start_run(run_name="outer") as outer:
        ml.log_config({"a": {"b": 1, "c": [1, 2]}, "d": "x", "e": {"f": 2.5}})
        ml.log_metrics({"m": 1.5, "n": 2})
        ml.log_metric("m", 2.5, step=1)
        ml.log_params({"p": 3})
        ml.set_tag("status", "running")
        ml.set_tag("k", "v")
        ml.log_artifacts(str(tmp / "top"))
        ml.log_artifacts(str(tmp / "tree"), "copied")
        with ml.start_run(run_name="inner", nested=True):
            ml.log_metrics({"inner": 1.0})
            ml.set_tag("status", "inner")
            assert ml.active_run() is not None
        ml.log_metrics({"after": 2.0}, step=3)
        run_id = outer.info.run_id
    assert ml.active_run() is None
    ml.log_metrics({"between": 1.0})
    with ml.start_run(run_id=run_id):  # resumed by id: its directory and recorded state again
        ml.log_metrics({"m": 3.5}, step=2)
        ml.set_tag("status", "completed")
    return run_id


def _runs(root):
    """{(experiment, run name): (run.json without timestamps, {artifact path: bytes})} under ``root``."""
    out = {}
    for exp in sorted(os.listdir(root)):
        for name in sorted(os.listdir(root / exp)):
            run_dir = root / exp / name
            meta = json.loads((run_dir / "run.json").read_text())
            for entries in meta["metrics"].values():
                for e in entries:
                    assert isinstance(e.pop("ts"), float)
            files = {str(p.relative_to(run_dir / "artifacts")): p.read_bytes()
                     for p in sorted((run_dir / "artifacts").rglob("*")) if p.is_file()}
            out[(exp, name.rsplit("-", 1)[0])] = (meta, files)
    return out


def test_both_trackers_write_the_same_runs(tmp_path, monkeypatch):
    if port_mlflow.HAVE_MLFLOW:
        pytest.skip("the file-backed tracker is taken only where MLflow is not installed")
    runs = {}
    for name, (ml, _, _) in PACKAGES.items():
        work = tmp_path / name
        work.mkdir()
        monkeypatch.setenv("TSADAR_RUNS_DIR", str(work / "runs"))
        for key, fresh in (("experiment", "default"), ("metrics", {}), ("params", {}), ("tags", {})):
            monkeypatch.setitem(ml._state, key, fresh)  # put back after the test: the state is module-global
        run_id = _sequence(ml, work)
        assert ml._find_run_dir(run_id).endswith(f"outer-{run_id}")
        runs[name] = _runs(work / "runs")
    assert set(runs["port"]) == {("exp", "outer"), ("exp", "inner")}
    assert runs["port"] == runs["jax"]
    outer = runs["port"][("exp", "outer")][0]
    assert outer["tags"] == {"status": "completed", "k": "v"} and "inner" not in outer["metrics"]
    assert [e["value"] for e in outer["metrics"]["m"]] == [1.5, 2.5, 3.5]
    assert outer["params"] == {"a.b": 1, "a.c": [1, 2], "d": "x", "e.f": 2.5, "p": 3}
    assert set(runs["port"][("exp", "outer")][1]) == {"artifact.txt", "copied/sub/b.txt"}


def _layout(staging, run_id):
    """{key with the run id replaced: bytes} of a staging bucket."""
    return {str(p.relative_to(staging)).replace(run_id, "<run_id>"): p.read_bytes()
            for p in sorted(staging.rglob("*")) if p.is_file()}


def test_export_uploads_the_jax_packages_key_layout_and_marker(tmp_path, monkeypatch):
    if port_mlflow.HAVE_MLFLOW:
        pytest.skip("the file-backed tracker is taken only where MLflow is not installed")
    layouts = {}
    for name, (ml, _, export) in PACKAGES.items():
        work = tmp_path / name
        work.mkdir()
        monkeypatch.setenv("TSADAR_RUNS_DIR", str(work / "runs"))
        monkeypatch.setenv("TSADAR_S3_STAGING_DIR", str(work / "staging"))
        (work / "plots").mkdir()
        (work / "plots" / "plot.png").write_text("png")
        ml.set_experiment("exp1")
        with ml.start_run(run_name="job") as run:
            ml.log_params({"k": "v"})
            ml.log_artifacts(str(work / "plots"))
            run_id = run.info.run_id
        export.export_run(run_id, step=0)
        export.upload_dir_to_s3(str(work / "runs"), "bucket-x", "artifacts/rid42", "rid42", prefix="ingest", step=3)
        layout = _layout(work / "staging", run_id)
        meta = json.loads(layout.pop("remote-mlflow-staging/artifacts/<run_id>/run.json"))
        assert meta.pop("run_id") == run_id
        layouts[name] = (layout, meta)
    layout, meta = layouts["port"]
    assert layout["remote-mlflow-staging/ingest-<run_id>-0.txt"] == b"ready"
    assert layout["bucket-x/ingest-rid42-3.txt"] == b"ready"
    assert layout["remote-mlflow-staging/artifacts/<run_id>/artifacts/plot.png"] == b"png"
    assert meta["params"] == {"k": "v"}
    assert set(layout) == set(layouts["jax"][0]) and meta == layouts["jax"][1]
    assert {k: v for k, v in layout.items() if "run.json" not in k} == {
        k: v for k, v in layouts["jax"][0].items() if "run.json" not in k}


def _queue(tmp_path, monkeypatch, name, queue, machine):
    work = tmp_path / name
    work.mkdir()
    template = work / "base_job.sh"
    template.write_text("#!/bin/bash\n#SBATCH -t 01:00:00\n")
    monkeypatch.setenv(f"{machine.upper()}_BASE_JOB_FILE", str(template))
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(work / "runs"))
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(cmd))
    monkeypatch.chdir(work)
    run_id = queue(os.path.join(ROOT, "configs", "1d"), mode="series", machine=machine)
    decks = sorted(p.name for p in (work / "runs").rglob("*.yaml"))
    return (work / "new_job.sh").read_text(), run_id, calls, decks


@pytest.mark.parametrize("machine", ["gpu", "cpu"])
def test_queue_writes_the_job_script_and_sbatches_it(tmp_path, monkeypatch, machine):
    text, run_id, calls, decks = _queue(tmp_path, monkeypatch, "port", port_queue.load_and_queue, machine)
    jax_text, jax_id, jax_calls, jax_decks = _queue(tmp_path, monkeypatch, "jax", jax_load_and_queue, machine)
    device = " --device cpu" if machine == "cpu" else ""
    assert text == f"#!/bin/bash\n#SBATCH -t 01:00:00\n\nsrun python -m tsadar_tpu_torch --run_id {run_id} --mode series{device}\n"
    assert text == jax_text.replace(f"python run_tsadar_tpu.py --run_id {jax_id}",
                                    f"python -m tsadar_tpu_torch --run_id {run_id}").replace("series\n", f"series{device}\n")
    assert calls == jax_calls == [["sbatch", "new_job.sh"]]
    assert decks == jax_decks == ["defaults.yaml", "inputs.yaml"]


def test_queue_needs_its_template(tmp_path, monkeypatch):
    monkeypatch.delenv("GPU_BASE_JOB_FILE", raising=False)
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    with pytest.raises(EnvironmentError, match="GPU_BASE_JOB_FILE"):
        port_queue.load_and_queue(os.path.join(ROOT, "configs", "1d"), mode="fit")
    assert not (tmp_path / "runs").exists()  # nothing registered


def test_queue_module_runs_from_the_command_line():
    out = subprocess.run([sys.executable, "-m", "tsadar_tpu_torch.queue", "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "--machine" in out.stdout and "{cpu,gpu}" in out.stdout
