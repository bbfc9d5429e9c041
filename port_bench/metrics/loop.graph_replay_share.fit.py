"""The share (%) of the traced whole-shot fit's steps that replayed the step's CUDA graph: the ``fit.step`` spans
inside ``fit`` spans that hold a ``fit.replay`` span (the program's spans).  None where the program recorded no
replay (a program without the graph), spans were left out for want of room, or the steps are not the traced
units' epochs."""

from harness.spans import STEP

REPLAY = "fit.replay"


def share(records, epochs):
    """The share of ``records``' steps that hold a replay, or None."""
    in_fit, steps, replayed = set(), set(), set()
    for r in records:  # a parent opens, and so is recorded, before its children
        i, p, name = r["index"], r["parent"], r["name"]
        if r["end_ns"] is None:
            continue
        if name == "fit" or p in in_fit:
            in_fit.add(i)
        if name == STEP and i in in_fit:
            steps.add(i)
        elif name == REPLAY and p in steps:
            replayed.add(p)
    if not replayed or len(steps) != epochs:
        return None
    return 100.0 * len(replayed) / len(steps)


def read(ctx):
    if not ctx.get("traced"):
        return None
    try:
        from tsadar_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    if trace.dropped():
        return None
    return share(trace.spans(), sum(u["epochs"] for u in ctx["traced"]))
