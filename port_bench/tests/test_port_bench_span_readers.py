"""The readers of host time by layer (``metrics/*.host_ms_per_step.fit.py``) on made-up span records: their values,
nothing without a ``fit`` span, nothing where the steps are not the traced units' epochs, nothing where spans were
left out."""

import importlib.util
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import spans  # noqa: E402
from tsadar_tpu_torch.utils import trace  # noqa: E402

READERS = ("loop.host_ms_per_step.fit", "forward.host_ms_per_step.fit", "backward.host_ms_per_step.fit",
           "optimizer.host_ms_per_step.fit", "kernels.launch_host_ms_per_step.fit")
MS = 1_000_000  # nanoseconds


def reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Records:
    """Span records as ``trace.spans()`` gives them, made by hand: ``add(name, start ms, end ms, parent)``."""

    def __init__(self):
        self.records = []

    def add(self, name, start, end, parent=None, thread=1):
        i = len(self.records)
        root = i if parent is None else self.records[parent]["root"]
        self.records.append({"index": i, "name": name, "attrs": {}, "start_ns": start * MS, "end_ns": end * MS,
                             "parent": parent, "root": root, "thread": thread})
        return i


def fit_of(steps, root="fit"):
    """A fit of ``steps`` steps of 10 ms: forward 4, backward 5 (a launch of 0.5 on the device thread inside it),
    optimizer 0.6 and best 0.2, a launch of 0.3 inside the forward; a read-back of 1 ms after each step."""
    r = Records()
    r.add("fit.lossfn_init", 0, 2)
    fit = r.add(root, 2, 3 + 11 * steps)
    r.add("fit.init", 2, 3, fit)
    chunk = r.add("fit.chunk", 3, 3 + 11 * steps, fit)
    for k in range(steps):
        t = 3 + 11 * k
        step = r.add("fit.step", t, t + 10, chunk)
        fwd = r.add("loss.forward", t, t + 4, step)
        diag = r.add("diagnostic", t, t + 3.5, fwd)
        r.add("ops.launch", t + 1, t + 1.3, diag)
        bwd = r.add("loss.backward", t + 4, t + 9, step)
        r.add("ops.launch", t + 5, t + 5.5, bwd, thread=2)
        r.add("optimizer.step", t + 9, t + 9.6, step)
        r.add("fit.best", t + 9.6, t + 9.8, step)
        r.add("fit.readback", t + 10, t + 11, chunk)
    return r.records


@pytest.fixture
def records(monkeypatch):
    found = {"records": [], "dropped": 0}
    monkeypatch.setattr(trace, "spans", lambda: found["records"])
    monkeypatch.setattr(trace, "dropped", lambda: found["dropped"])
    return found


def ctx_of(*epochs):
    return {"trace": {"busy_s": 1.0, "window_s": 2.0}, "traced": [{"epochs": e} for e in epochs], "units": [],
            "setup": {}, "kernels": {}, "B": 4}


def test_the_readers_values(records):
    records["records"] = fit_of(3)
    got = {name: reader(name)(ctx_of(3)) for name in READERS}
    want = {"loop.host_ms_per_step.fit": 10.0, "forward.host_ms_per_step.fit": 4.0,
            "backward.host_ms_per_step.fit": 5.0, "optimizer.host_ms_per_step.fit": 0.8,
            "kernels.launch_host_ms_per_step.fit": 0.8}
    assert got == pytest.approx(want)


def test_spans_outside_the_fit_spans_steps_are_not_read(records):
    """A second root without a ``fit`` span (a forward mode) and the fit's own read-backs count nowhere."""
    r = fit_of(2)
    other = len(r)
    r.append({"index": other, "name": "fit.step", "attrs": {}, "start_ns": 0, "end_ns": 50 * MS, "parent": None,
              "root": other, "thread": 1})
    records["records"] = r
    assert reader("loop.host_ms_per_step.fit")(ctx_of(2)) == pytest.approx(10.0)
    assert spans.layers(r, 2)["ms"].get("fit.readback") is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_fit_span(records, name):
    records["records"] = fit_of(3, root="series")
    assert reader(name)(ctx_of(3)) is None


@pytest.mark.parametrize("name", READERS)
def test_the_steps_must_be_the_traced_units_epochs(records, name):
    records["records"] = fit_of(3)
    assert reader(name)(ctx_of(3)) is not None
    assert reader(name)(ctx_of(4)) is None
    assert reader(name)(ctx_of(1, 2)) is not None  # two traced units: their epochs summed


@pytest.mark.parametrize("name", READERS)
def test_nothing_where_spans_were_left_out(records, name):
    records["records"] = fit_of(3)
    records["dropped"] = 1
    assert reader(name)(ctx_of(3)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_traced_units(records, name):
    records["records"] = fit_of(3)
    assert reader(name)(ctx_of()) is None
