"""Host seconds of a run's data preparation (its record's setup_seconds), over the window's runs."""

from harness.layers import mean_of


def read(ctx):
    return mean_of(ctx, "setup_seconds")
