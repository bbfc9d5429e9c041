"""Device kernel launches a step in the traced runs (their set-up and postprocess included)."""

from harness.layers import launches_per_step


def read(ctx):
    return launches_per_step(ctx)
