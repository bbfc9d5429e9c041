"""Uniform-grid lookups: the plain PyTorch forms and the dispatch to the kernels.

Two per-row lookups carry the 1V hot path and one fused lookup the 2V (ARTS)
path, each with a hand-written CUDA kernel in ``tsadar_tpu_torch/ops``:

* ``lin_lookup``: linear interpolation with ``jnp.interp`` edge clamping (the
  chi_R pole table at the electron phase velocities); the math of
  ``tsadar_tpu.core.physics.interp.interp1d_linear_uniform``, row by row.
* ``cubic_lookup``: the C1 cubic Hermite with finite-difference slopes and
  unclamped-t edge extrapolation (the log-EDF at the phase velocities); the
  math of ``interp1d_cubic_blocked``'s forward.

* ``chi_bilinear_lookup``: the stacked (f1d | df1d | chi_R) angle tables of the
  2V path at (beta, |xi_e|): periodic linear interpolation over the rows, then
  clamped linear interpolation inside each column segment; the math of
  ``periodic_linear_rowmix`` followed by ``select_columns_linear``.

* ``interp1d_linear_pallas``: the linear lookup on a zero-padded table with its
  grid in a device tensor, the semantics of the JAX package's wrapper of the same
  name (which leaves it unwired; the port drives it on the chi_R operands).

``lin_lookup``, ``cubic_lookup``, ``interp1d_linear_pallas`` and ``chi_bilinear_lookup`` are the
differentiable lookups of ``tsadar_tpu_torch/ops``: a CPU tensor takes the
plain forms, a CUDA tensor the kernels, forward and backward -- there is no
fallback from one to the other.  ``interp1d_cubic_matmul`` (the
EDF on the fixed 1024-point xi grid) stays a plain matmul, as in JAX.
"""

import math

import torch
import torch.nn.functional as F


def lin_cell(q, x0, dx, n):
    """(raw position, i0, w) of the linear lookup on the grid x0 + dx * arange(n).

    pos = raw clipped to [0, n-1], i0 = min(floor(pos), n-2), w = pos - i0.
    """
    # x0 and dx as tensors: PyTorch divides by a Python-scalar divisor through
    # its reciprocal, which moves pos by an ulp and can flip i0 at a cell edge
    # against the kernel's true division
    x0, dx = (torch.as_tensor(v, dtype=q.dtype, device=q.device) for v in (x0, dx))
    raw = (q - x0) / dx
    pos = torch.clamp(raw, 0.0, n - 1.0)
    i0 = torch.clamp(torch.floor(pos), max=n - 2.0)
    return raw, i0.long(), pos - i0


def lin_lookup_plain(q, table, x0, dx):
    """(value, f[i0+1] - f[i0]) of per-row tables [B, n] at queries [B, Q].

    The grid is x0 + dx * arange(n) for every row; pos is clipped to [0, n-1]
    and i0 to <= n-2, so queries beyond either end take the end value.
    """
    _, idx, w = lin_cell(q, x0, dx, table.shape[-1])
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


def cubic_cell(q, meta):
    """(i0, t, first, last) of the cubic lookup; ``meta`` [B, 3] holds each row's grid (x0, dx, n).

    i0 = clip(floor(pos), 0, n-2), t = pos - i0 unclamped; first/last mark the edge cells.
    """
    x0, dx, nf = meta[:, 0:1], meta[:, 1:2], meta[:, 2:3]
    pos = (q - x0) / dx
    i0 = torch.minimum(torch.clamp(torch.floor(pos), min=0.0), nf - 2.0)
    return i0.long(), pos - i0, i0 == 0.0, i0 == nf - 2.0


def cubic_lookup_plain(q, table, meta):
    """(value, d value/dt) of per-row tables [B, n] at queries [B, Q].

    ``meta`` [B, 3] holds each row's grid (x0, dx, n).  i0 = clip(floor(pos),
    0, n-2) and t = pos - i0 is NOT clamped: the edge cells extrapolate their
    polynomial.  The taps i0-1 and i0+2 that fall outside the table carry a
    zero weight and read a zero pad.
    """
    idx, t, first, last = cubic_cell(q, meta)
    padded = F.pad(table, (1, 2))  # padded[:, j + 1] = table[:, j]
    taps = [torch.gather(padded, -1, idx + k) for k in range(4)]
    val = sum(c * f for c, f in zip(_cubic_weights(t, first, last), taps))
    dval = sum(c * f for c, f in zip(_cubic_weights(t, first, last, d=True), taps))
    return val, dval


def lin_lookup(q, table, x0, dx):
    """Differentiable linear lookup value [B, Q]: ``ops.lin_lookup.LinLookup``
    (the plain forms on the CPU, the K1/K2 kernels on the card)."""
    from ...ops.lin_lookup import LinLookup

    return LinLookup.apply(q, table, x0, dx)


PAD_BLOCK = 8  # the padded table's length is the next multiple of this above n


def interp1d_linear_pallas(xq, x, f):
    """Linear interpolation of f on the uniform grid x at xq, clamped to the end values.

    ``f`` [n] with ``xq`` of any shape, or per-row tables ``f`` [B, n] with
    ``xq`` [B, ...]; the result has the shape of ``xq``.  ``f`` is zero-padded to
    a multiple of PAD_BLOCK (at least n + 1 entries) and the grid (x0, dx, n)
    goes to the lookup as a device tensor: ``ops.lin_lookup.LinLookupPadded``,
    the K10 kernel and its backward on the card, the plain forms on the CPU.
    Differentiable in xq (g slope / dx strictly inside the grid, 0 at and
    beyond its ends) and in f; x gets no cotangent.
    """
    from ...ops.lin_lookup import LinLookupPadded

    n = x.shape[0]
    rows = f if f.dim() == 2 else f[None]
    q = xq.reshape(rows.shape[0], -1)
    fpad = F.pad(rows, (0, (n // PAD_BLOCK + 1) * PAD_BLOCK - n))
    x = x.detach()
    meta = torch.stack([x[0], x[1] - x[0], torch.full_like(x[0], n)]).to(f.dtype)
    return LinLookupPadded.apply(q, fpad, meta).reshape(xq.shape)


def cubic_lookup(q, table, meta):
    """Differentiable cubic lookup value [B, Q]: ``ops.cubic_lookup.CubicLookup``
    (the plain forms on the CPU, the K3/K4 kernels on the card)."""
    from ...ops.cubic_lookup import CubicLookup

    return CubicLookup.apply(q, table, meta)


def rowmix_indices(R, beta_q):
    """(ib0, ib1, wb): the two rows of a periodic grid 2 pi r / R around beta_q, and the weight of the second.

    The remainder takes the divisor's sign, so negative angles wrap upwards;
    where (beta mod 2 pi) R / 2 pi rounds up to R itself the rows are (0, 1)
    with weight 0.
    """
    bpos = torch.remainder(beta_q, 2.0 * math.pi) * (R / (2.0 * math.pi))
    ifl = torch.floor(bpos)
    ib0 = torch.remainder(ifl.long(), R)
    return ib0, torch.remainder(ib0 + 1, R), bpos - ifl


def col_cell(v_q, v0, dv, ns):
    """(iv0, wv, inside) of the clamped linear lookup on the grid v0 + dv * arange(ns).

    ``inside`` (in the dtype of v_q) is 1 strictly inside the grid and 0 where
    the position was clamped.  ``v0`` and ``dv`` are tensors, for true division
    (see ``lin_cell``).
    """
    raw = (v_q - v0) / dv
    vpos = torch.clamp(raw, 0.0, ns - 1.0)
    iv0 = torch.clamp(torch.floor(vpos), max=ns - 2.0)
    return iv0.long(), vpos - iv0, ((raw > 0.0) & (raw < ns - 1.0)).to(v_q.dtype)


def periodic_linear_rowmix(T, beta_q):
    """Row-interpolate T [R, C] at the angles beta_q [Q]: out[q] = lerp(T[ib0], T[ib1], wb), [Q, C]."""
    ib0, ib1, wb = rowmix_indices(T.shape[0], beta_q.reshape(-1))
    out = (1.0 - wb)[:, None] * T[ib0] + wb[:, None] * T[ib1]
    return out.reshape(beta_q.shape + T.shape[1:])


def select_columns_linear(S, v0, dv, v_q):
    """Per-row linear column interpolation: out[q] = lerp(S[q, iv0], S[q, iv0 + 1], wv), clamped at the ends."""
    v0, dv = (torch.as_tensor(v, dtype=S.dtype, device=S.device) for v in (v0, dv))
    iv0, wv, _ = col_cell(v_q, v0, dv, S.shape[-1])
    f0 = torch.gather(S, -1, iv0[..., None])[..., 0]
    f1 = torch.gather(S, -1, iv0[..., None] + 1)[..., 0]
    return f0 * (1.0 - wv) + f1 * wv


def chi_bilinear_lookup(Tcat, beta_q, xq, v0x, dvx, v0p, dvp):
    """Differentiable fused lookup (fe, dfe, chiR), each shaped like beta_q, of the stacked 2V tables
    Tcat [R, 3 nvx - 2]: ``ops.chi_bilinear.ChiBilinear`` (the plain forms on the CPU, the K7/K8
    kernels on the card).  (v0x, dvx) is the velocity grid, (v0p, dvp) the pole grid; they get no gradient."""
    from ...ops.chi_bilinear import ChiBilinear

    meta = torch.stack([torch.as_tensor(v, dtype=Tcat.dtype, device=Tcat.device) for v in (v0x, dvx, v0p, dvp)])
    return ChiBilinear.apply(Tcat, beta_q, xq, meta.detach())


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
