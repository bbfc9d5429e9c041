"""The device's idle share of the traced window, in the whole-shot fit (%)."""

from harness.layers import idle_share


def read(ctx):
    return idle_share(ctx)
