"""The port's spans and counters (``tsadar_tpu_torch.utils.trace``), on the CPU.

* With no profiler a span is the shared null context: it records nothing and opens no ``record_function`` range;
  a timed span measures itself all the same.
* Under ``torch.profiler`` (CPU activity) a short adam fit of the small 1D deck records ``fit`` -> ``fit.step`` x
  epochs -> ``loss.forward`` / ``loss.backward`` / ``optimizer.step`` / ``fit.best``, each child inside its
  parent, every self time >= 0; a span opened on another thread while ``loss.backward`` is open (autograd's device
  thread on the card) is its child.
* The records are bounded, and what they drop is counted; ``named()`` opens a ``record_function`` range a span.
* ``ops.launches[<C function>]`` counts each launch in ``ops.build.launch``; ``tracker.bytes`` each write of a
  run's ``run.json``.
"""

import collections
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import __graft_entry__ as ge
import tsadar_tpu_torch as port
from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_
from tsadar_tpu_torch.utils import trace

from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


@pytest.fixture(autouse=True)
def empty_records():
    trace.clear()
    yield
    trace.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(records):
    by_index = {r["index"]: r for r in records}
    children = collections.defaultdict(list)
    for r in records:
        children[r["parent"]].append(r)
    return by_index, children


def test_without_a_profiler_nothing_is_recorded_and_no_range_opened(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: opened.append(a))
    with trace.named():
        with trace.span("fit", B=2) as s:
            with trace.span("fit.step"):
                pass
        with trace.timed("fit.init") as t:
            pass
    assert s is None and trace.spans() == [] and opened == [] and trace.dropped() == 0
    assert t.seconds >= 0.0 and t.index is None
    assert trace.span("a") is trace.span("b")  # one shared null context


def test_an_adam_fit_under_the_profiler_records_its_layers():
    epochs = 3
    cfg = ge._small_config(2)
    cfg["optimizer"].update(method="adam", learning_rate=1e-2, num_epochs=epochs, chunk_size=2)
    batch = ge._make_batch(2)
    loss_fn = port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu")
    record = {}
    with _cpu_profile():
        _1d_adam_loop_(cfg, loss_fn, None, batch, record=record)
    records = trace.spans()
    by_index, children = _tree(records)
    roots = children[None]
    assert [r["name"] for r in roots] == ["fit"] and roots[0]["attrs"] == {"method": "adam", "B": 2}
    fit = roots[0]
    assert [r["name"] for r in children[fit["index"]]] == ["fit.init", "fit.chunk", "fit.chunk"]
    first, last = (children[c["index"]] for c in children[fit["index"]][1:])
    # the first step read back for its dispatch time, then each chunk's losses
    assert [r["name"] for r in first] == ["fit.step", "fit.readback", "fit.step", "fit.readback"]
    assert [r["name"] for r in last] == ["fit.step", "fit.readback"]
    steps = [r for r in records if r["name"] == "fit.step"]
    assert len(steps) == epochs == len(record["losses"])
    assert {by_index[s["parent"]]["name"] for s in steps} == {"fit.chunk"}
    for s in steps:
        assert [c["name"] for c in children[s["index"]]] == ["loss.forward", "loss.backward", "optimizer.step",
                                                             "fit.best"]
    forward = [r for r in records if r["name"] == "loss.forward"]
    assert all([c["name"] for c in children[f["index"]]] == ["diagnostic", "loss.reduce"] for f in forward)
    assert {by_index[r["parent"]]["name"] for r in records if r["name"] == "form_factor"} == {"spectrum"}
    # every span inside its parent, of its root, on this thread, closed; self times >= 0
    for r in records:
        assert r["root"] == fit["index"] and r["thread"] == threading.get_ident() and r["end_ns"] >= r["start_ns"]
        if r["parent"] is not None:
            p = by_index[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]
        covered = sum(c["end_ns"] - c["start_ns"] for c in children[r["index"]])
        assert covered <= r["end_ns"] - r["start_ns"]
    # the record's chunk seconds are the chunk spans'
    chunks = [r for r in records if r["name"] == "fit.chunk"]
    assert record["chunk_steps"] == [2, 1]
    assert record["chunk_seconds"] == pytest.approx([(c["end_ns"] - c["start_ns"]) * 1e-9 for c in chunks], abs=1e-3)


def test_a_span_on_another_thread_takes_the_open_backward_as_parent(monkeypatch):
    """Autograd's device thread inherits the caller's profiler state; a plain thread does not, so the probe is
    made to answer yes on both."""
    seen = []

    def device_thread():
        with trace.span("ops.launch", fn="k"):
            seen.append(threading.get_ident())

    monkeypatch.setattr(trace, "_profiling", lambda: True)
    with trace.span("fit"):
        with trace.span("loss.backward"):
            worker = threading.Thread(target=device_thread)
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    (fit, backward, launch), = [trace.spans()]
    assert launch["parent"] == backward["index"] and launch["root"] == fit["index"] == backward["root"]
    assert launch["thread"] == seen[0] != backward["thread"]


def test_the_records_are_bounded_and_count_what_they_drop(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with _cpu_profile():
        with trace.span("fit"):
            for _ in range(4):
                with trace.span("fit.step"):
                    with trace.span("loss.forward"):
                        pass
    # fit, its first step and that step's forward fit; three steps and their forwards do not
    assert [r["name"] for r in trace.spans()] == ["fit", "fit.step", "loss.forward"]
    assert trace.dropped() == 6
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_the_records_hold_nothing_for_the_cyclic_gc(monkeypatch):
    """Spans store ints and strings and one shared dict per set of attributes: a traced unit's thousands of spans
    leave no object behind for a full collection to walk (on the card one took 0.19-0.27 s)."""
    import gc

    with _cpu_profile():
        gc.collect()
        before = len(gc.get_objects())
        with trace.span("fit", method="adam", B=2):
            for k in range(2000):
                with trace.span("fit.step"), trace.span("ops.launch", fn=("lin_lookup_fwd", "pv_tables_fwd")[k % 2]):
                    pass
        gc.collect()
        after = len(gc.get_objects())
    assert len(trace.spans()) == 4001 and after - before <= 8


def test_named_spans_open_record_function_ranges():
    with _cpu_profile() as prof:
        with trace.named():
            with trace.span("diagnostic"), trace.span("ops.launch", fn="lin_lookup_fwd"):
                torch.ones(3).sum()
        with trace.span("form_factor"):  # outside named(): recorded, but no range
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert {"diagnostic", "ops.launch[lin_lookup_fwd]"} <= names and "form_factor" not in names
    assert [r["name"] for r in trace.spans()] == ["diagnostic", "ops.launch", "form_factor"]


def test_each_launch_is_counted_by_its_c_function(monkeypatch):
    from tsadar_tpu_torch.ops import build

    def lin_lookup_fwd(*args):
        return 0

    monkeypatch.setattr(build, "_on_stream", lambda fn, args, device: fn(*args))
    for _ in range(3):
        build.launch(lin_lookup_fwd, 1, 2, device=None)
    with _cpu_profile():
        build.launch(lin_lookup_fwd, device=None)
    assert trace.counters()["ops.launches[lin_lookup_fwd]"] == 4
    (launch,) = trace.spans()
    assert launch["name"] == "ops.launch" and launch["attrs"] == {"fn": "lin_lookup_fwd"}
    monkeypatch.setattr(build, "_on_stream", lambda fn, args, device: 7)
    with pytest.raises(RuntimeError, match="lin_lookup_fwd failed with CUDA error 7"):
        build.launch(lin_lookup_fwd, device=None)
    assert trace.counters()["ops.launches[lin_lookup_fwd]"] == 5


def test_the_tracker_counts_the_bytes_it_writes(tmp_path, monkeypatch):
    from tsadar_tpu_torch.utils import mlflow_shim

    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path))
    monkeypatch.setattr(mlflow_shim, "HAVE_MLFLOW", False)
    with mlflow_shim.start_run(run_name="t") as run, _cpu_profile():
        mlflow_shim.log_metrics({"x": 1.0})
        (path,) = tmp_path.glob(f"*/t-{run.info.run_id}/run.json")
        written = path.stat().st_size
        assert trace.counters()["tracker.bytes"] == written
    assert [r["name"] for r in trace.spans()] == ["tracker.write"]


def test_a_run_records_the_bytes_its_tracker_wrote(tmp_path, monkeypatch):
    from pathlib import Path

    from tsadar_tpu_torch import runner

    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path))
    record = {}
    run_id = runner.run(str(Path(__file__).resolve().parent.parent / "configs" / "1d"), "forward", device="cpu",
                        record=record)
    (path,) = tmp_path.glob(f"*/*-{run_id}/run.json")
    # every metric and tag rewrites the whole run.json: the mode's writes (the config logged before it, the run's
    # total time and status after it) hold the config's parameters at least once
    assert path.stat().st_size / 2 < record["tracker_bytes"]
