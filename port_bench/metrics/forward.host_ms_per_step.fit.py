"""Host milliseconds a step of the loss's forward (``loss.forward``: the eager ops' dispatch and the forward kernels' launches)."""

from harness.spans import per_step


def read(ctx):
    return per_step(ctx, "loss.forward")
