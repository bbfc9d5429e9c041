"""Host time by layer from the program's own spans (``tsadar_tpu_torch.utils.trace``), for the readers of
``*.host_ms_per_step.fit``.

The port records its spans only while a profiler runs, that is over the traced unit of a ``--trace 1`` run,
each with its parent.  The readers take the spans inside the ``fit`` spans' ``fit.step`` spans: every step's
host time, and each layer's host time summed over the steps (both threads: a launch on autograd's device
thread is parented to the ``loss.backward`` that waits for it).  A checkout whose program has no such module,
a traced unit with no ``fit`` span, spans left out for want of room, or a count of steps other than the traced
units' epochs give nothing, and each reader then gives None.
"""

STEP = "fit.step"


def fit_layers(ctx):
    """``layers`` of the program's records over the traced units, or None where there is nothing to read."""
    if not ctx.get("traced"):
        return None
    try:
        from tsadar_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    if trace.dropped():
        return None
    return layers(trace.spans(), sum(u["epochs"] for u in ctx["traced"]))


def layers(records, epochs):
    """{"steps": the count of ``fit.step`` spans inside ``fit`` spans, "step_ms": the mean step, "ms": {name: host
    milliseconds of the spans of that name inside the steps}}; None where the steps are none or not ``epochs``."""
    in_fit, in_step, step_ms, ms = set(), set(), [], {}
    for r in records:  # a parent opens, and so is recorded, before its children
        i, p, name = r["index"], r["parent"], r["name"]
        if r["end_ns"] is None:
            continue
        took = (r["end_ns"] - r["start_ns"]) * 1e-6
        if name == "fit" or p in in_fit:
            in_fit.add(i)
        if p in in_step:
            in_step.add(i)
            ms[name] = ms.get(name, 0.0) + took
        elif name == STEP and i in in_fit:
            in_step.add(i)
            step_ms.append(took)
    if not step_ms or len(step_ms) != epochs:
        return None
    return {"steps": len(step_ms), "step_ms": sum(step_ms) / len(step_ms), "ms": ms}


def per_step(ctx, *names):
    """The host milliseconds a step of the spans named ``names``, or None."""
    found = fit_layers(ctx)
    return None if found is None else sum(found["ms"].get(n, 0.0) for n in names) / found["steps"]


def step_ms(ctx):
    """The mean host milliseconds of a step, or None."""
    found = fit_layers(ctx)
    return None if found is None else found["step_ms"]
