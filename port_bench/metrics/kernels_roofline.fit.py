"""The port's kernels' least time over their device time, in the whole-shot fit (%)."""

from harness.layers import kernels_roofline


def read(ctx):
    return kernels_roofline(ctx)
