"""Device kernel launches a step in the traced whole-shot fits."""

from harness.layers import launches_per_step


def read(ctx):
    return launches_per_step(ctx)
