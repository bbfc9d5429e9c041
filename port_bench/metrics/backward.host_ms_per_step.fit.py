"""Host milliseconds a step of autograd's backward (``loss.backward``: the caller's wait for autograd's engine and its launches)."""

from harness.spans import per_step


def read(ctx):
    return per_step(ctx, "loss.backward")
