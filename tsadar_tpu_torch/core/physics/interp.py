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

* ``interp2d_cubic``: bicubic Hermite at scattered points (the multiplexed
  angular loss's EDF rotation, ``utils.vector_tools.rotate_edf``, and the 2V
  rotate projection, ``FormFactor.rotate``); plain tensor code, as the JAX
  package's is.  ``bicubic_slopes`` and ``bicubic_at`` are its two halves,
  for callers that evaluate one table at many query sets.

* ``interp1d``: ``jnp.interp`` (clamped linear interpolation on an increasing
  grid, the end values held or replaced by ``left``/``right``; the radial
  profiles of the spherical-harmonic EDF, the exact 2V mode's projections).

``lin_lookup``, ``cubic_lookup``, ``interp1d_linear_pallas`` and ``chi_bilinear_lookup`` are the
differentiable lookups of ``tsadar_tpu_torch/ops``: a CPU tensor takes the
plain forms, a CUDA tensor the kernels, forward and backward -- there is no
fallback from one to the other.  ``interp1d_cubic_matmul`` (the
EDF on the fixed 1024-point xi grid) stays a plain matmul, as in JAX.

Inside ``plain_forms()`` (the counterpart of the JAX package's
``pallas_disabled``) these lookups, ``ratint.pv_tables`` and the 1V spectrum
tail call their plain forms directly, with no ``torch.autograd.Function`` in
between, so that autograd can differentiate them twice (the sigma-Hessian of
``utils.process.postprocess``); they take CPU tensors only there.
"""

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

_PLAIN_FORMS = False


@contextlib.contextmanager
def plain_forms():
    """Route the kernel-backed functions to their plain PyTorch forms (CPU tensors only) inside the block."""
    global _PLAIN_FORMS
    prev, _PLAIN_FORMS = _PLAIN_FORMS, True
    try:
        yield
    finally:
        _PLAIN_FORMS = prev


def plain_forms_on(*tensors):
    """Whether ``plain_forms()`` is active; inside it every operand must lie on the CPU (no kernel is bypassed)."""
    if _PLAIN_FORMS and any(t.device.type != "cpu" for t in tensors):
        raise ValueError("plain_forms() takes CPU tensors: the card runs the kernels")
    return _PLAIN_FORMS


@functools.lru_cache(maxsize=64)
def _number(v, dtype, device):
    """The number ``v`` as a 0-d tensor, uploaded once per (value, dtype, device): no call copies it from the host."""
    return torch.as_tensor(v, dtype=dtype, device=device)


def lin_cell(q, x0, dx, n):
    """(raw position, i0, w) of the linear lookup on the grid x0 + dx * arange(n).

    pos = raw clipped to [0, n-1], i0 = min(floor(pos), n-2), w = pos - i0.
    """
    # x0 and dx as tensors: PyTorch divides by a Python-scalar divisor through
    # its reciprocal, which moves pos by an ulp and can flip i0 at a cell edge
    # against the kernel's true division
    x0, dx = (torch.as_tensor(v, dtype=q.dtype, device=q.device) if torch.is_tensor(v) else _number(v, q.dtype, q.device)
              for v in (x0, dx))
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

    if plain_forms_on(q, table):
        return lin_lookup_plain(q, table, x0, dx)[0]
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
    from ...ops.lin_lookup import LinLookupPadded, plain_meta

    n = x.shape[0]
    rows = f if f.dim() == 2 else f[None]
    q = xq.reshape(rows.shape[0], -1)
    fpad = F.pad(rows, (0, (n // PAD_BLOCK + 1) * PAD_BLOCK - n))
    x = x.detach()
    meta = torch.stack([x[0], x[1] - x[0], torch.full_like(x[0], n)]).to(f.dtype)
    if plain_forms_on(q, fpad):
        return plain_meta(q, fpad, meta)[0].reshape(xq.shape)
    return LinLookupPadded.apply(q, fpad, meta).reshape(xq.shape)


def cubic_lookup(q, table, meta):
    """Differentiable cubic lookup value [B, Q]: ``ops.cubic_lookup.CubicLookup``
    (the plain forms on the CPU, the K3/K4 kernels on the card)."""
    from ...ops.cubic_lookup import CubicLookup

    if plain_forms_on(q, table):
        return cubic_lookup_plain(q, table, meta)[0]
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


def chi_tables(f1d, df1d, chiR):
    """(T, T4): the stacked table T [R, 3 nvx - 2] = (f1d | df1d | chiR) and, on the card, its quad layout
    T4 [R, 3 nvx - 2, 4] for K7, both from one launch (``ops.chi_bilinear.ChiTables``); T4 is None on the CPU,
    whose plain lookup reads T."""
    from ...ops.chi_bilinear import ChiTables

    if plain_forms_on(f1d, df1d, chiR) or f1d.device.type == "cpu":
        return torch.cat([f1d, df1d, chiR], dim=-1), None
    return ChiTables.apply(f1d, df1d, chiR)


def chi_bilinear_lookup(Tcat, beta_q, xq, v0x, dvx, v0p, dvp, T4=None):
    """Differentiable fused lookup (fe, dfe, chiR), each shaped like beta_q, of the stacked 2V tables
    Tcat [R, 3 nvx - 2]: ``ops.chi_bilinear.ChiBilinear`` (the plain forms on the CPU, the K7/K8
    kernels on the card, K7 reading the quad layout T4 that ``chi_tables`` gives beside Tcat).  (v0x, dvx) is the
    velocity grid, (v0p, dvp) the pole grid; they get no gradient."""
    from ...ops.chi_bilinear import ChiBilinear, plain_fwd

    meta = torch.stack([torch.as_tensor(v, dtype=Tcat.dtype, device=Tcat.device) for v in (v0x, dvx, v0p, dvp)])
    if plain_forms_on(Tcat, beta_q, xq):
        out = plain_fwd(beta_q.reshape(-1), xq.reshape(-1), Tcat, meta.detach())
        return tuple(o.view(beta_q.shape) for o in out[:3])
    return ChiBilinear.apply(Tcat, beta_q, xq, meta.detach(), T4)


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


def _fd_slopes_1d(x, f):
    """Second-order finite-difference slopes of f [..., N] along its last axis on the grid x [N]: the weighted
    central difference inside, the one-sided second-order formulas at the two ends."""
    h = x[1:] - x[:-1]
    s = (f[..., 1:] - f[..., :-1]) / h
    hl, hr = h[:-1], h[1:]
    d_int = (s[..., 1:] * hl + s[..., :-1] * hr) / (hl + hr)
    d0 = ((2.0 * h[0] + h[1]) * s[..., 0] - h[0] * s[..., 1]) / (h[0] + h[1])
    dn = ((2.0 * h[-1] + h[-2]) * s[..., -1] - h[-1] * s[..., -2]) / (h[-1] + h[-2])
    return torch.cat([d0[..., None], d_int, dn[..., None]], dim=-1)


def _locate(xq, x):
    """The cell i with x[i] <= xq < x[i + 1], clipped to [0, N - 2]."""
    i = torch.searchsorted(x, xq.contiguous(), right=True) - 1
    return torch.clamp(i, 0, x.shape[0] - 2)


def _hermite_eval(t, h, f0, f1, d0, d1):
    """Cubic Hermite on one cell, t normalized to [0, 1] (unclamped: it extrapolates)."""
    t2 = t * t
    t3 = t2 * t
    h00 = 2.0 * t3 - 3.0 * t2 + 1.0
    h10 = t3 - 2.0 * t2 + t
    h01 = -2.0 * t3 + 3.0 * t2
    h11 = t3 - t2
    return h00 * f0 + h10 * h * d0 + h01 * f1 + h11 * h * d1


def interp1d(x, xp, fp, left=None, right=None):
    """``jnp.interp(x, xp, fp, left, right)`` on an increasing grid xp [N]: linear inside, fp[0] (or ``left``) to
    the left of the grid, fp[-1] (or ``right``) to its right.  fp [..., N] with x [...]: one query a row."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    if fp.dim() == 1:
        f0, f1 = fp[i - 1], fp[i]
    else:
        f0, f1 = torch.gather(fp, -1, (i - 1)[..., None])[..., 0], torch.gather(fp, -1, i[..., None])[..., 0]
    f = f0 + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (f1 - f0)
    f = torch.where(x < xp[0], fp[..., 0] if left is None else left, f)
    return torch.where(x > xp[-1], fp[..., -1] if right is None else right, f)


def bicubic_slopes(x, y, f):
    """(fx, fy, fxy) [Nx, Ny]: the finite-difference slopes of f along both axes and the cross slope."""
    fx = _fd_slopes_1d(x, f.movedim(0, -1)).movedim(-1, 0)
    return fx, _fd_slopes_1d(y, f), _fd_slopes_1d(y, fx)


def interp2d_cubic(xq, yq, x, y, f, extrap=True):
    """Bicubic Hermite interpolation of f [Nx, Ny] (f[i, j] = f(x[i], y[j])) at the scattered points (xq, yq).

    The JAX package's ``interp2d_cubic``, in plain tensors as there (it
    reaches no kernel): finite-difference slopes along both axes and their
    cross slope, the cell's four corners gathered, Hermite along x, then
    along y.  ``extrap=True`` extrapolates the edge cells' polynomials; a
    number fills the queries outside the grid instead.  Differentiable in f
    and in the query coordinates.
    """
    return bicubic_at(xq, yq, x, y, f, *bicubic_slopes(x, y, f), extrap=extrap)


def bicubic_at(xq, yq, x, y, f, fx, fy, fxy, extrap=True):
    """``interp2d_cubic`` of f with its slopes given (``bicubic_slopes``)."""
    ix, iy = _locate(xq, x), _locate(yq, y)
    hx, hy = x[ix + 1] - x[ix], y[iy + 1] - y[iy]
    tx, ty = (xq - x[ix]) / hx, (yq - y[iy]) / hy

    # each cell's (f, fx, fy, fxy) at its corners (i, j), (i + 1, j), (i, j + 1), (i + 1, j + 1) side by side: one
    # gather a query, whose backward is one scatter of 16-wide rows (sixteen gathers would sort the queries 16 times)
    cells = torch.stack([c for a in (f, fx, fy, fxy) for c in (a[:-1, :-1], a[1:, :-1], a[:-1, 1:], a[1:, 1:])], dim=-1)
    (f00, f10, f01, f11, fx00, fx10, fx01, fx11, fy00, fy10, fy01, fy11,
     fxy00, fxy10, fxy01, fxy11) = cells[ix, iy].unbind(-1)
    g0 = _hermite_eval(tx, hx, f00, f10, fx00, fx10)
    g1 = _hermite_eval(tx, hx, f01, f11, fx01, fx11)
    gy0 = _hermite_eval(tx, hx, fy00, fy10, fxy00, fxy10)
    gy1 = _hermite_eval(tx, hx, fy01, fy11, fxy01, fxy11)
    out = _hermite_eval(ty, hy, g0, g1, gy0, gy1)
    if extrap is not True:
        inside = (xq >= x[0]) & (xq <= x[-1]) & (yq >= y[0]) & (yq <= y[-1])
        out = torch.where(inside, out, extrap)
    return out
