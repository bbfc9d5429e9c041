"""The device's idle share of the traced window, in the run through the entry point (%)."""

from harness.layers import idle_share


def read(ctx):
    return idle_share(ctx)
