"""BENCHMARK.json against the rules of its format (names, units, keys, sizes), and every file it names found by name."""

import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import common  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names(bench):
    assert set(bench) == KEYS["top"]
    assert bench["command"] == ["python3", "port_bench/run.py"] and bench["paths"] == ["port_bench"]
    assert all(PATH.match(p) for p in bench["paths"]) and 1 <= bench["run_seconds"] <= 51
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
        for e in bench[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert line(e[k]), (e["name"], k)
    assert len((BENCH.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:  # the end-to-end metric it moves is reported in each of its cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in cells:  # every cell: setup_s, another end-to-end metric and a per-layer one
        assert len(common.metrics_of(w, "end_to_end", bench)) >= 2 and common.metrics_of(w, "per_layer", bench)


def test_files_resolve_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json" and (BENCH.parent / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        entry, config, traffic, limits = common.workload(w["name"], bench)
        assert traffic["unit"] in ("fit", "run") and config["decks"]["inputs"] and limits
        assert set(config["kernels"]) and set(config["assumed"]["start_band"])
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("m", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert callable(module.read)
        assert module.read({"trace": None, "traced": [], "units": [], "setup": {}, "kernels": {}, "B": 1}) is None
