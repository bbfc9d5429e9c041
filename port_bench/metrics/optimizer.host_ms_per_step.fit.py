"""Host milliseconds a step of the optimizer and its best-so-far update (``optimizer.step`` and ``fit.best``)."""

from harness.spans import per_step


def read(ctx):
    return per_step(ctx, "optimizer.step", "fit.best")
