"""Each cell rehearsed on the CPU at a small size (four lineouts, the whole 200 epochs), sound and with each fault of
``harness/faults.py`` planted underneath the timed path; and the command's refusals.

On the CPU the program runs its float64 plain forms, the reference's own code, so a sound run reads
rounding alone and a fault reads what it breaks.  The limits are the cells' own (``limits/``).
``arts_1v_fit`` is not listed in ``BENCHMARK.json`` yet (PERF.md §7): it is rehearsed under a manifest
that adds its entry in place of the file's.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run  # noqa: E402
from harness import common  # noqa: E402
from harness.faults import FAULTS  # noqa: E402

EPOCHS = 200  # the cells' own count: fewer leave the credited best loss far from the answer's
SEED = 2**31 + 29
ARTS = {"name": "arts_1v_fit", "config": "arts_1v_94475", "traffic": "run_with_sigmas", "chips": 1}


def manifest(bench):
    """``BENCHMARK.json`` with ``arts_1v_fit`` added, as a stand-in for ``common.manifest``."""
    bench["workloads"] = bench["workloads"] + [ARTS]
    return lambda: bench


def small(config, traffic):
    config["decks"]["inputs"]["optimizer"]["num_epochs"] = EPOCHS
    traffic["warmup_epochs"] = 2
    traffic["checked_units"] = 1
    if "lineouts" in traffic:
        traffic["lineouts"] = {"start": 500, "end": 504, "skip": 1}


def rehearse(workload, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(common, "manifest", manifest(common.manifest()))
    out, table = run.bench(workload, SEED, 0.1, False, device="cpu", adjust=small)
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(out)[-1] == "checks" and out["attempted"] == 1 and out["failed"] == 0
    return out, table


@pytest.mark.parametrize("workload", ["whole_shot_every_pixel", "arts_1v_fit"])
def test_sound_rehearsal_is_correct(workload, tmp_path, monkeypatch):
    out, table = rehearse(workload, tmp_path, monkeypatch)
    assert out["correct"], table
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["whole_shot_every_pixel", "arts_1v_fit"])
def test_a_planted_fault_is_not_correct(workload, fault, tmp_path, monkeypatch):
    with FAULTS[fault]():
        out, table = rehearse(workload, tmp_path, monkeypatch)
    assert not out["correct"], table


def test_no_result_without_a_card():
    done = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "whole_shot_every_pixel", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == "" and "CUDA" in done.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = "import sys; sys.path.insert(0, 'port_bench'); import run; run.bench('whole_shot_every_pixel', 1, 1, False, 'cpu')"
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and "tsadar_tpu_torch" in done.stderr and '"correct"' not in done.stdout
