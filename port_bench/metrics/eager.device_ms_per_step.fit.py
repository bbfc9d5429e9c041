"""Device milliseconds a step of the operations that are not the port's kernels: the eager loss, forward, spectrum and form factor."""

from harness.layers import eager_ms_per_step


def read(ctx):
    return eager_ms_per_step(ctx)
