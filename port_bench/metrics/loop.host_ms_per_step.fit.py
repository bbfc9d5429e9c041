"""Host milliseconds of a step of the traced whole-shot fit: the mean ``fit.step`` span, read-backs excluded (the program's spans)."""

from harness.spans import step_ms


def read(ctx):
    return step_ms(ctx)
