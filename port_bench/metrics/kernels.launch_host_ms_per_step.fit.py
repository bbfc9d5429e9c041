"""Host milliseconds a step inside the port's C launchers (``ops.launch`` spans, on both threads)."""

from harness.spans import per_step


def read(ctx):
    return per_step(ctx, "ops.launch")
