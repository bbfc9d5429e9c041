"""The reader of ``loop.graph_replay_share.fit`` on made-up span records: the share of steps that hold a replay,
nothing where no step replayed (a program without the graph), nothing where the steps are not the traced units'
epochs, nothing without a ``fit`` span."""

import importlib.util
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

MS = 1_000_000  # nanoseconds


def share():
    name = "loop.graph_replay_share.fit"
    spec = importlib.util.spec_from_file_location("reader_graph_share", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.share


def fit_of(steps, eager, root="fit"):
    """Span records of a fit of ``steps`` steps: ``eager`` eager steps, then a step with the capture and a replay,
    then a replay a step."""
    records = []

    def add(name, start, end, parent=None):
        records.append({"index": len(records), "name": name, "attrs": {}, "start_ns": start * MS, "end_ns": end * MS,
                        "parent": parent, "root": 0, "thread": 1})
        return len(records) - 1

    fit = add(root, 0, 10 * steps + 1)
    chunk = add("fit.chunk", 1, 10 * steps + 1, fit)
    for k in range(steps):
        step = add("fit.step", 1 + 10 * k, 10 * (k + 1), chunk)
        if k == eager:
            add("fit.capture", 1 + 10 * k, 5 + 10 * k, step)
        if k >= eager:
            add("fit.replay", 6 + 10 * k, 7 + 10 * k, step)
        else:
            add("loss.forward", 1 + 10 * k, 5 + 10 * k, step)
        add("fit.readback", 10 * (k + 1), 10 * (k + 1) + 0.5, chunk)
    return records


@pytest.mark.parametrize("steps, eager, want", [(200, 1, 99.5), (16, 1, 93.75), (5, 2, 60.0)])
def test_the_share_of_steps_that_replayed(steps, eager, want):
    assert share()(fit_of(steps, eager), steps) == pytest.approx(want)


def test_nothing_without_a_replay_a_fit_span_or_the_epochs():
    assert share()(fit_of(200, 200), 200) is None  # every step eager: a program without the graph
    assert share()(fit_of(200, 1, root="series"), 200) is None
    assert share()(fit_of(200, 1), 199) is None
