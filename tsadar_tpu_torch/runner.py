"""Run orchestration: the two decks, the run tracker, and the fit, forward and series modes.

Counterpart of ``tsadar_tpu.runner``.  ``run`` registers a run with its decks
as artifacts (``load_and_make_folders``), merges and validates them
(``utils.schema``) and runs the mode inside the run (``_run_``); ``run_job``
resumes a queued run from the decks it stored; ``run_for_app`` runs the
hosted app's fit from the ``config.yaml`` and shot files stored with its run.

Every entry point runs on the card unless ``device="cpu"`` is given.  Two
settings of the JAX package change form: ``other.profile: true`` records a
``torch.profiler`` trace of the mode, logged as the artifact directory
``torch_trace``; ``TSADAR_MULTIHOST`` (the JAX package's hook that calls
``jax.distributed.initialize()`` for multi-host TPU slices) starts the
process group (``parallel.dist``, from ``torchrun``'s variables) at the start
of an entry point, before any work, once; a ``torchrun`` launch of more than
one rank (``WORLD_SIZE > 1``) starts it too.  In a process group rank 0
registers the run, reads its decks and writes every file; the other ranks
share the fit and end with it, and the group is destroyed as the entry point
returns or raises.  Every run is tagged ``figures``: ``drawn`` where
matplotlib imports, else ``not drawn: <why>`` (``utils.plotting``; the
card's machine has no matplotlib).  ``_configure_jax`` has no counterpart.
A deck that fails validation and a device the port cannot reach raise
before a run is registered (the JAX package registers first).
"""

import contextlib
import multiprocessing as mp
import os
import tempfile
import time

import yaml

from .device import resolve_device
from .forward import calc_series
from .inverse import fitter
from .parallel import dist as par
from .utils import mlflow_shim as mlflow
from .utils import plotting, trace
from .utils.config import merge_configs
from .utils.console import log_info
from .utils.schema import validate_config

BASE_TEMPDIR = os.environ.get("BASE_TEMPDIR", None)
MODES = ("fit", "forward", "series")


def _load_decks(cfg_path):
    """``{"defaults": ..., "inputs": ...}`` from ``<cfg_path>/{defaults,inputs}.yaml`` (relative to the working
    directory)."""
    basedir = os.path.join(os.getcwd(), f"{cfg_path}")
    all_configs = {}
    for k in ("defaults", "inputs"):
        with open(f"{os.path.join(basedir, k)}.yaml", "r") as fi:
            all_configs[k] = yaml.safe_load(fi)
    return all_configs


def _register(all_configs):
    """A new run of the decks' experiment, holding the decks as artifacts: its id."""
    if "mlflow" in all_configs["inputs"]:
        experiment = all_configs["inputs"]["mlflow"]["experiment"]
        run_name = all_configs["inputs"]["mlflow"]["run"]
    else:
        experiment = all_configs["defaults"]["mlflow"]["experiment"]
        run_name = all_configs["defaults"]["mlflow"]["run"]
    mlflow.set_experiment(experiment)
    with mlflow.start_run(run_name=run_name) as mlflow_run:
        with tempfile.TemporaryDirectory(dir=BASE_TEMPDIR) as td:
            for k in ("defaults", "inputs"):
                with open(os.path.join(td, f"{k}.yaml"), "w") as fi:
                    yaml.dump(all_configs[k], fi)
            mlflow.log_artifacts(td)
    return mlflow_run.info.run_id


def load_and_make_folders(cfg_path):
    """Register a run and store its two decks as artifacts: ``(run id, {"defaults", "inputs"})``."""
    all_configs = _load_decks(cfg_path)
    return _register(all_configs), all_configs


def _check_mode(mode):
    if mode.casefold() not in MODES:
        raise NotImplementedError(f"Mode {mode} not implemented (use fit, forward, or series)")


def _check_start(mode, device):
    """Raise, before any work is done, for a mode that does not exist and a device the port cannot reach."""
    _check_mode(mode)
    resolve_device(device)


def _on_rank0(fn, *args):
    """``fn(*args)`` on rank 0, its result on every rank of a process group (decks, run ids)."""
    if not par.initialized():
        return fn(*args)
    return par.broadcast_object(fn(*args) if par.rank() == 0 else None)


def run(cfg_path, mode, device=None, record=None):
    """Run the decks in ``cfg_path`` in ``mode`` (fit, forward or series) inside a new tracked run: its id.

    ``record`` (a dict), if given, gets what the mode records
    (``fitter.fit``'s stage seconds and the postprocess's, or the series'
    ``entry_seconds``) and ``tracker_bytes``, the bytes the tracker wrote for
    the mode (``utils.trace``'s counter ``tracker.bytes``).
    """
    _check_start(mode, device)
    with par.process_group(device):
        all_configs = _on_rank0(_load_decks, cfg_path)
        config = merge_configs(all_configs["defaults"], all_configs["inputs"])
        validate_config(config, mode=mode)
        run_id = _on_rank0(_register, all_configs)
        with mlflow.start_run(run_id=run_id, log_system_metrics=True):
            _run_(config, mode=mode, device=device, record=record)
    return run_id


@contextlib.contextmanager
def _profile(config, device):
    """A ``torch.profiler`` trace of the mode, with ``other.profile: true``, in which the port's spans
    (``utils.trace``) are named ranges; else nothing (None)."""
    if not config.get("other", {}).get("profile", False):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if resolve_device(device).type == "cuda" else [])
    with profile(activities=activities) as prof, trace.named():
        yield prof


def _run_(config, mode="fit", device=None, record=None):
    """The mode, inside the open run: the config as parameters, the tag ``figures`` (``utils.plotting.figures``),
    ``total_time``, ``num_cores``, status ``completed``."""
    mlflow.log_config(config)
    plotting.figures()
    t0 = time.time()
    written = trace.counters().get("tracker.bytes", 0)
    with _profile(config, device) as prof:
        if mode.casefold() == "fit":
            fitter.fit(config, device=device, record=record)
        else:
            calc_series.forward_pass(config, device=device, record=record)
    if record is not None:  # the tracker's run.json rewrites of the mode, in bytes
        record["tracker_bytes"] = trace.counters().get("tracker.bytes", 0) - written
    if prof is not None:
        with tempfile.TemporaryDirectory(dir=BASE_TEMPDIR) as td:
            prof.export_chrome_trace(os.path.join(td, "trace.json"))
            log_info(f"profile of the {mode} mode logged as torch_trace/trace.json")
            mlflow.log_artifacts(td, "torch_trace")
    mlflow.log_metrics({"total_time": time.time() - t0, "num_cores": int(mp.cpu_count())})
    mlflow.set_tag("status", "completed")


def _stored_decks(mlflow_run):
    """``{"defaults": ..., "inputs": ...}`` from the artifacts of an open run."""
    artifacts = os.path.join(getattr(mlflow_run, "run_dir", ""), "artifacts")
    all_configs = {}
    for k in ("defaults", "inputs"):
        with open(os.path.join(artifacts, f"{k}.yaml")) as fi:
            all_configs[k] = yaml.safe_load(fi)
    return all_configs


def run_job(run_id, mode, nested, device=None):
    """Resume a queued run whose decks are stored in its artifacts."""
    _check_start(mode, device)
    with par.process_group(device), mlflow.start_run(run_id=run_id, nested=nested) as run:
        all_configs = _on_rank0(_stored_decks, run)
        config = merge_configs(all_configs["defaults"], all_configs["inputs"])
        validate_config(config, mode=mode)
        _run_(config, mode, device=device)


def _app_config(mlflow_run):
    """The hosted app's config stored in an open run's artifacts, its shot files named by their local paths."""
    artifacts = os.path.join(getattr(mlflow_run, "run_dir", ""), "artifacts")
    with open(os.path.join(artifacts, "config.yaml")) as fi:
        config = yaml.safe_load(fi)
    for spec in ("epw", "iaw"):
        if config["data"]["filenames"].get(spec) is not None:
            config["data"]["filenames"][f"{spec}-local"] = os.path.join(artifacts, config["data"]["filenames"][spec])
    return config


def run_for_app(run_id, device=None):
    """The hosted app's fit: the config and the shot files stored in the run's artifacts, the run's id."""
    _check_start("fit", device)
    with par.process_group(device), mlflow.start_run(run_id=run_id, log_system_metrics=True) as mlflow_run:
        _run_(_on_rank0(_app_config, mlflow_run), mode="fit", device=device)
    return run_id if mlflow_run is None else mlflow_run.info.run_id
