"""What the per-layer metric readers share.  A reader takes the run's context and returns a number, or None
where it finds nothing to read (no trace, no steps, no port kernel), and the metric is then left out.

The context (``run.py``): ``trace`` (``devtrace.summarize`` of the traced units, or None), ``traced`` (those
units' results), ``units`` (every unit of the window), ``setup`` ({"prepare_s"}), ``kernels`` (the
configuration's), ``B`` (the batch).
"""

from . import roofline
from .devtrace import OTHER, PORT


def traced_steps(ctx):
    return sum(u["epochs"] for u in ctx["traced"]) if ctx.get("trace") else 0


def idle_share(ctx):
    """100 (1 - the union of device operations / the traced window)."""
    t = ctx.get("trace")
    return None if not t else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernels_roofline(ctx):
    """The least seconds of the port's kernel work in the traced units over the device seconds of its kernels."""
    t, steps = ctx.get("trace"), traced_steps(ctx)
    if not t or not steps or not t["seconds"][PORT]:
        return None
    least = roofline.least_seconds(ctx["kernels"], ctx["B"], steps, len(ctx["traced"]))
    return 100.0 * least / t["seconds"][PORT]


def eager_ms_per_step(ctx):
    """Device milliseconds a step of every operation that is not one of the port's kernels."""
    t, steps = ctx.get("trace"), traced_steps(ctx)
    return None if not t or not steps else 1e3 * t["seconds"][OTHER] / steps


def launches_per_step(ctx):
    """Device kernels launched in the traced units over their steps."""
    t, steps = ctx.get("trace"), traced_steps(ctx)
    return None if not t or not steps else t["launches"] / steps


def mean_of(ctx, key):
    """The mean of a unit's ``key`` over the window's units, where every unit has it."""
    values = [u.get(key) for u in ctx["units"]]
    return None if not values or any(v is None for v in values) else sum(values) / len(values)
