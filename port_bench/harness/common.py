"""What every part of the harness shares: where things are, the manifest, the environment, the device.

The harness is driven by data.  ``BENCHMARK.json`` names each workload's
configuration and traffic mix; their files are found by name:

* ``configs/<config>.json``: the decks as they are run, their source, the shapes that the
  roofline counts read, and what was assumed (the seed's band of start values);
* ``traffic/<traffic>.json``: the kind of unit the window repeats and its parameters;
* ``limits/<workload>.json``: each number that decides ``correct``, with its limit;
* ``metrics/<metric>.py``: one reader a per-layer metric (``read(ctx)``, None where it finds nothing).
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent  # the checkout: BENCHMARK.json and the program beside this folder
FORBIDDEN = ("jax", "jaxlib", "flax", "tsadar_tpu")  # top-level module names, compared whole


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest():
    return load_json(ROOT / "BENCHMARK.json")


def workload(name, bench=None):
    """(workload entry, its configuration file, its traffic file, its limits file) by the workload's name in
    ``bench`` (by default ``BENCHMARK.json``)."""
    bench = manifest() if bench is None else bench
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return (w, load_json(BENCH / "configs" / f"{w['config']}.json"), load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            load_json(BENCH / "limits" / f"{name}.json"))


def metrics_of(name, kind, bench=None):
    """The manifest's ``end_to_end`` or ``per_layer`` metrics that workload ``name`` reports."""
    bench = manifest() if bench is None else bench
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def reader(metric_name):
    """The module ``metrics/<metric_name>.py`` (a name may hold dots, so it is loaded by path)."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric_name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def set_environment():
    """Fixed cache directories: Triton's inside the checkout, the tracked runs under TMPDIR.  The port builds
    its CUDA libraries into ``tsadar_tpu_torch/_build`` inside the checkout by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".port_bench_cache" / "triton")
    tmp = Path(os.environ.get("TMPDIR", "/tmp"))
    os.environ["TSADAR_RUNS_DIR"] = str(tmp / "port_bench_runs")
    os.environ["USE_FLAX"] = "0"
    return tmp / "port_bench_work"


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of FORBIDDEN, as a whole word."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def port_kernel_names():
    """The ``__global__`` function names of the port's CUDA sources: the kernels written for it."""
    names = set()
    for src in (ROOT / "tsadar_tpu_torch" / "csrc").glob("*.cu"):
        text = re.sub(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)", "", src.read_text())
        names.update(re.findall(r"__global__\s+void\s+(\w+)", text))
    return names


def smi():
    """The card as ``nvidia-smi`` reads it: name, power limit, SM clock, its maximum, temperature (one CSV line)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
                               "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def emit(obj, stream=sys.stdout):
    print(json.dumps(obj), file=stream, flush=True)
