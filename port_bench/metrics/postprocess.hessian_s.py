"""Host seconds of the float64 sigma-Hessian a run, over the window's runs (the program's record)."""

from harness.layers import mean_of


def read(ctx):
    return mean_of(ctx, "hessian_seconds")
