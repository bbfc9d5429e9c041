"""Experiment tracking: real MLflow when it can be imported, a file-backed tracker otherwise.

A copy of ``tsadar_tpu.utils.mlflow_shim`` with the same call sites, metric
names and files.  Without MLflow a run is recorded under
``$TSADAR_RUNS_DIR/<experiment>/<run name>-<run id>/`` (default
``./tsadar_runs``): ``run.json`` holds its metrics (every value with its step
and time), parameters and tags, ``artifacts/`` its files.  A run started with
the id of an existing one reopens its directory and recorded state; a nested
run puts the outer run's state back when it ends.

The state is module-global.  Calls made while no run is open are dropped
(the JAX package keeps them in memory, where no file ever shows them), so
nothing logged between two runs of one process reaches either.

In a process group rank 0 keeps the run and writes its files (``writer``):
the other ranks open no run, their calls are dropped, and they see no open
run.  The entry points, the fit's postprocess and its checkpoints read the
same rule.
"""

import contextlib
import json
import os
import shutil
import time
import uuid

from ..parallel import dist as par
from . import trace

try:  # pragma: no cover - taken only where mlflow is installed
    import mlflow as _mlflow

    HAVE_MLFLOW = True
except ImportError:
    _mlflow = None
    HAVE_MLFLOW = False

_state = {"experiment": "default", "run_dir": None, "metrics": {}, "params": {}, "tags": {}}


def writer():
    """Whether this process keeps the run and writes its files: a process outside a process group, or its rank 0."""
    return par.rank() == 0


def _root():
    return os.environ.get("TSADAR_RUNS_DIR", os.path.join(os.getcwd(), "tsadar_runs"))


def set_experiment(experiment_name=None, **kw):
    if HAVE_MLFLOW:
        return _mlflow.set_experiment(experiment_name, **kw)
    _state["experiment"] = experiment_name or "default"


class _Run:
    def __init__(self, run_dir, run_id):
        self.run_dir = run_dir
        self.info = type("info", (), {"run_id": run_id})()


def _find_run_dir(run_id):
    """The directory ``<experiment>/<name>-<run_id>`` of an existing run, in any experiment."""
    root = _root()
    if not os.path.isdir(root):
        return None
    for experiment in sorted(os.listdir(root)):
        exp_dir = os.path.join(root, experiment)
        if not os.path.isdir(exp_dir):
            continue
        for name in sorted(os.listdir(exp_dir)):
            if name == run_id or name.endswith(f"-{run_id}"):
                return os.path.join(exp_dir, name)
    return None


@contextlib.contextmanager
def start_run(run_name=None, run_id=None, nested=False, log_system_metrics=False, **kw):
    if not writer():
        yield None
        return
    if HAVE_MLFLOW:
        with _mlflow.start_run(
            run_name=run_name, run_id=run_id, nested=nested, log_system_metrics=log_system_metrics, **kw
        ) as run:
            yield run
        return
    rid = run_id or uuid.uuid4().hex[:16]
    # a run resumed by id (run_job, run_for_app) reopens its directory and recorded state, as MLflow does
    run_dir = _find_run_dir(rid) if run_id else None
    state = {"metrics": {}, "params": {}, "tags": {}}
    if run_dir is None:
        run_dir = os.path.join(_root(), _state["experiment"], f"{run_name or 'run'}-{rid}")
    else:
        try:
            with open(os.path.join(run_dir, "run.json")) as f:
                prior = json.load(f)
            state = {k: prior.get(k, {}) for k in ("metrics", "params", "tags")}
        except (OSError, ValueError):
            pass
    os.makedirs(os.path.join(run_dir, "artifacts"), exist_ok=True)
    # the outer run's whole state, not only its directory: a nested run (run_job(..., nested=True)) would
    # otherwise leave its metrics behind, and the outer run's next call would write them into its run.json
    prev = {k: _state[k] for k in ("run_dir", "metrics", "params", "tags")}
    _state.update(run_dir=run_dir, **state)
    try:
        yield _Run(run_dir, rid)
    finally:
        _flush()
        _state.update(prev)


def _flush():
    """Write the open run's ``run.json`` anew: the span ``tracker.write``, its bytes counted in ``tracker.bytes``."""
    if _state["run_dir"] is None:
        return
    with trace.span("tracker.write"), open(os.path.join(_state["run_dir"], "run.json"), "w") as f:
        json.dump({"metrics": _state["metrics"], "params": _state["params"], "tags": _state["tags"]}, f, indent=1, default=str)
        trace.count("tracker.bytes", f.tell())


def log_metrics(metrics, step=0, **kw):
    if not writer():
        return
    if HAVE_MLFLOW:
        return _mlflow.log_metrics(metrics, step=step, **kw)
    if _state["run_dir"] is None:
        return
    for k, v in metrics.items():
        _state["metrics"].setdefault(k, []).append({"step": step, "value": float(v), "ts": time.time()})
    _flush()


def log_metric(key, value, step=0, **kw):
    log_metrics({key: value}, step=step, **kw)


def log_params(params, **kw):
    if not writer():
        return
    if HAVE_MLFLOW:
        return _mlflow.log_params(params, **kw)
    if _state["run_dir"] is None:
        return
    _state["params"].update({str(k): v for k, v in params.items()})
    _flush()


def set_tag(key, value):
    if not writer():
        return
    if HAVE_MLFLOW:
        return _mlflow.set_tag(key, value)
    if _state["run_dir"] is None:
        return
    _state["tags"][str(key)] = value
    _flush()


def log_artifact(path, artifact_path=None):
    if not writer():
        return
    if HAVE_MLFLOW:
        return _mlflow.log_artifact(path, artifact_path)
    if _state["run_dir"] is None:
        return
    dst = os.path.join(_state["run_dir"], "artifacts", artifact_path or "")
    os.makedirs(dst, exist_ok=True)
    shutil.copy(path, dst)


def log_artifacts(path, artifact_path=None):
    if not writer():
        return
    if HAVE_MLFLOW:
        return _mlflow.log_artifacts(path, artifact_path)
    if _state["run_dir"] is None:
        return
    dst = os.path.join(_state["run_dir"], "artifacts", artifact_path or "")
    shutil.copytree(path, dst, dirs_exist_ok=True)


def active_run():
    """The open run, or None: files logged outside a run are dropped, so their writers need not run."""
    if not writer():
        return None
    if HAVE_MLFLOW:
        return _mlflow.active_run()
    if _state["run_dir"] is None:
        return None
    return _Run(_state["run_dir"], os.path.basename(_state["run_dir"]))


def log_config(config):
    """The flattened config, ``a.b.c`` keys, as parameters in chunks of 100."""
    from .config import flatten

    items = list({".".join(map(str, k)): v for k, v in flatten(config).items()}.items())
    for i in range(0, len(items), 100):
        log_params(dict(items[i : i + 100]))
