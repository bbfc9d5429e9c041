"""Uniform-grid lookups: the plain PyTorch forms and the dispatch to the kernels.

Two per-row lookups carry the 1V hot path, each with a hand-written CUDA
kernel in ``tsadar_tpu_torch/ops``:

* ``lin_lookup``: linear interpolation with ``jnp.interp`` edge clamping (the
  chi_R pole table at the electron phase velocities); the math of
  ``tsadar_tpu.core.physics.interp.interp1d_linear_uniform``, row by row.
* ``cubic_lookup``: the C1 cubic Hermite with finite-difference slopes and
  unclamped-t edge extrapolation (the log-EDF at the phase velocities); the
  math of ``interp1d_cubic_blocked``'s forward.

Dispatch: a CPU tensor takes the plain form below, a CUDA tensor the kernel --
there is no fallback from one to the other.  ``interp1d_cubic_matmul`` (the
EDF on the fixed 1024-point xi grid) stays a plain matmul, as in JAX.
"""

import torch
import torch.nn.functional as F

from ...ops.build import on_card


def lin_lookup_plain(q, table, x0, dx):
    """(value, f[i0+1] - f[i0]) of per-row tables [B, n] at queries [B, Q].

    The grid is x0 + dx * arange(n) for every row; pos is clipped to [0, n-1]
    and i0 to <= n-2, so queries beyond either end take the end value.
    """
    n = table.shape[-1]
    # x0 and dx as tensors: PyTorch divides by a Python-scalar divisor through
    # its reciprocal, which moves pos by an ulp and can flip i0 at a cell edge
    # against the kernel's true division
    x0, dx = (torch.as_tensor(v, dtype=q.dtype, device=q.device) for v in (x0, dx))
    pos = torch.clamp((q - x0) / dx, 0.0, n - 1.0)
    i0 = torch.clamp(torch.floor(pos), max=n - 2.0)
    w = pos - i0
    idx = i0.long()
    f0 = torch.gather(table, -1, idx)
    f1 = torch.gather(table, -1, idx + 1)
    return f0 * (1.0 - w) + f1 * w, f1 - f0


def _cubic_weights(t, first, last, d=False):
    """Per-offset cubic Hermite x FD-slope weights (c_m1, c_0, c_p1, c_p2).

    One-sided second-order slope stencils in the first/last cells; with
    ``d=True`` the d/dt of each weight.
    """
    t2 = t * t
    if not d:
        t3 = t2 * t
        h00 = 2.0 * t3 - 3.0 * t2 + 1.0
        h10 = t3 - 2.0 * t2 + t
        h01 = -2.0 * t3 + 3.0 * t2
        h11 = t3 - t2
    else:
        h00 = 6.0 * t2 - 6.0 * t
        h10 = 3.0 * t2 - 4.0 * t + 1.0
        h01 = 6.0 * t - 6.0 * t2
        h11 = 3.0 * t2 - 2.0 * t
    c_m1 = torch.where(first, 0.0, torch.where(last, -0.5 * h10 + 0.5 * h11, -0.5 * h10))
    c_0 = torch.where(first, h00 - 1.5 * h10 - 0.5 * h11, torch.where(last, h00 - 2.0 * h11, h00 - 0.5 * h11))
    c_p1 = torch.where(first, h01 + 2.0 * h10, torch.where(last, h01 + 0.5 * h10 + 1.5 * h11, h01 + 0.5 * h10))
    c_p2 = torch.where(first, -0.5 * h10 + 0.5 * h11, torch.where(last, 0.0, 0.5 * h11))
    return c_m1, c_0, c_p1, c_p2


def cubic_lookup_plain(q, table, meta):
    """(value, d value/dt) of per-row tables [B, n] at queries [B, Q].

    ``meta`` [B, 3] holds each row's grid (x0, dx, n).  i0 = clip(floor(pos),
    0, n-2) and t = pos - i0 is NOT clamped: the edge cells extrapolate their
    polynomial.  The taps i0-1 and i0+2 that fall outside the table carry a
    zero weight and read a zero pad.
    """
    x0, dx, nf = meta[:, 0:1], meta[:, 1:2], meta[:, 2:3]
    pos = (q - x0) / dx
    i0 = torch.minimum(torch.clamp(torch.floor(pos), min=0.0), nf - 2.0)
    t = pos - i0
    first, last = i0 == 0.0, i0 == nf - 2.0
    padded = F.pad(table, (1, 2))  # padded[:, j + 1] = table[:, j]
    idx = i0.long()
    taps = [torch.gather(padded, -1, idx + k) for k in range(4)]
    val = sum(c * f for c, f in zip(_cubic_weights(t, first, last), taps))
    dval = sum(c * f for c, f in zip(_cubic_weights(t, first, last, d=True), taps))
    return val, dval


def lin_lookup(q, table, x0, dx):
    """``lin_lookup_plain`` on the CPU; the ``lin_lookup_fwd`` kernel on the card."""
    if on_card(q, table):
        from ...ops.lin_lookup import lin_lookup_fwd

        return lin_lookup_fwd(q, table, x0, dx)
    return lin_lookup_plain(q, table, x0, dx)


def cubic_lookup(q, table, meta):
    """``cubic_lookup_plain`` on the CPU; the ``cubic_lookup_fwd`` kernel on the card."""
    if on_card(q, table, meta):
        from ...ops.cubic_lookup import cubic_lookup_fwd

        return cubic_lookup_fwd(q, table, meta)
    return cubic_lookup_plain(q, table, meta)


def _cubic_W(xq, x):
    """[Q, N] banded cubic-Hermite weight matrix (4 nonzeros per row)."""
    n = x.shape[0]
    pos = (xq.reshape(-1) - x[0]) / (x[1] - x[0])
    i = torch.clamp(torch.floor(pos), 0.0, n - 2.0)
    t = pos - i
    c_m1, c_0, c_p1, c_p2 = _cubic_weights(t, i == 0.0, i == n - 2.0)
    cols = torch.arange(n, device=x.device)
    iq = i.long()[:, None]
    return (
        c_m1[:, None] * (cols == iq - 1)
        + c_0[:, None] * (cols == iq)
        + c_p1[:, None] * (cols == iq + 1)
        + c_p2[:, None] * (cols == iq + 2)
    )


def interp1d_cubic_matmul(xq, x, f, fill):
    """Cubic Hermite of tables f [..., N] on the uniform grid x at xq [Q], as f @ W(xq)^T.

    ``fill = (lo, hi)`` replaces the values at queries beyond the grid's ends.
    """
    out = torch.matmul(f, _cubic_W(xq, x).to(f.dtype).T)
    lo, hi = fill
    out = torch.where(xq < x[0], lo, out)
    return torch.where(xq > x[-1], hi, out)
