"""K7 and K8, the fused bilinear lookup of the 2V chi tables and its cotangent: ``csrc/chi_bilinear.cu`` through ctypes.

``chi_bilinear_fwd`` replaces ``tsadar_tpu/ops/bilinear_kernel.py::chi_bilinear_pallas``
and ``chi_bilinear_bwd`` its ``chi_bilinear_pallas_bwd``.  Their plain twins are
``plain_fwd`` and ``plain_bwd`` (the index math of ``core.physics.interp``, then
gathers and ``index_put_``, any dtype, any device); the bounds on the card and
the designs are in the header of the CUDA source.  ``ChiBilinear`` is the
differentiable lookup: kernels for CUDA tensors, the plain twins for CPU
tensors, the same formulas around them.

The stacked table T [R, 3 nvx - 2] holds (f1d | df1d | chi_R) side by side;
``meta`` [4] = (v0x, dvx, v0p, dvp) holds the velocity grid of the first two
segments and the pole grid of the third, as a tensor beside the table, so that
a launch reads no value back from the device.  K7 reads T in a quad layout,
T4 [R, C, 4] (each entry with its right and lower neighbours: one 16-B load a
segment, the f1d and df1d quads of one column side by side);
``chi_bilinear_pack`` writes T and T4 in one launch from the three segment
tables, ``plain_pack`` is its twin, and ``ChiTables`` is the differentiable
stacking (its cotangent is dT's three column slices).
"""

import ctypes
import math

import torch

from . import build
from ..core.physics.interp import col_cell, rowmix_indices

__all__ = ["ChiBilinear", "ChiTables", "chi_bilinear_fwd", "chi_bilinear_bwd", "chi_bilinear_pack", "plain_fwd",
           "plain_bwd", "plain_pack", "segments"]

_FWD_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_float, ctypes.c_void_p)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (ctypes.c_float, ctypes.c_void_p)
_PACK_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,)


def segments(nvx, meta):
    """(first column, number of columns, v0, dv) of the three stacked segments."""
    v0x, dvx, v0p, dvp = meta.unbind(0)
    return (0, nvx, v0x, dvx), (nvx, nvx, v0x, dvx), (2 * nvx, nvx - 2, v0p, dvp)


def _check(bq, xq, T, meta, extra=(), table_rank=2):
    """(Q, R, nvx) of a launch on the table T [R, C] (or its quad layout [R, C, 4], ``table_rank`` 3)."""
    build.check_input(bq, "bq", 1)
    build.check_input(xq, "xq", 1)
    build.check_input(T, "T4" if table_rank == 3 else "T", table_rank)
    build.check_input(meta, "meta", 1)
    R, C = T.shape[:2]
    if C % 3 != 1 or C < 7 or R < 2 or meta.shape[0] != 4 or xq.shape != bq.shape or T.shape[2:] not in ((), (4,)):
        raise ValueError(f"T {tuple(T.shape)}, meta {tuple(meta.shape)}, bq {tuple(bq.shape)}, xq {tuple(xq.shape)} do not fit")
    if len({t.device for t in (bq, xq, T, meta, *extra)}) != 1:
        raise ValueError("all operands must lie on one device")
    return bq.shape[0], R, (C + 2) // 3


def chi_bilinear_fwd(bq, xq, T4, meta):
    """[6, Q]: (fe, dfe, chiR) at the queries (bq, xq) [Q] and their three d/dxq, from the quad layout
    T4 [R, C, 4] of the stacked table (``chi_bilinear_pack``)."""
    Q, R, nvx = _check(bq, xq, T4, meta, table_rank=3)
    out = torch.empty((6, Q), dtype=torch.float32, device=bq.device)
    fn = build.c_function("chi_bilinear", "chi_bilinear_fwd", _FWD_ARGTYPES)
    build.launch(fn, bq.data_ptr(), xq.data_ptr(), T4.data_ptr(), meta.data_ptr(), out.data_ptr(), Q, R, nvx,
                 R / (2.0 * math.pi), device=bq.device)
    return out


def chi_bilinear_bwd(bq, xq, T, meta, g):
    """(dT [R, C], dbeta [Q]) of the lookup for the cotangents g [3, Q] of (fe, dfe, chiR)."""
    build.check_input(g, "g", 2)
    Q, R, nvx = _check(bq, xq, T, meta, (g,))
    if g.shape != (3, Q):
        raise ValueError(f"g {tuple(g.shape)} does not fit {Q} queries")
    dT = torch.zeros_like(T)
    dbeta = torch.empty_like(bq)
    fn = build.c_function("chi_bilinear", "chi_bilinear_bwd", _BWD_ARGTYPES)
    build.launch(fn, bq.data_ptr(), xq.data_ptr(), T.data_ptr(), meta.data_ptr(), g.data_ptr(), dT.data_ptr(),
                 dbeta.data_ptr(), Q, R, nvx, R / (2.0 * math.pi), device=bq.device)
    return dT, dbeta


def chi_bilinear_pack(f1d, df1d, chiR):
    """(T [R, 3 nvx - 2], T4 [R, 3 nvx - 2, 4]): the stacked table and its quad layout (``plain_pack``), from the
    segment tables f1d [R, nvx], df1d [R, nvx] and chiR [R, nvx - 2], whose rows may lie apart (a column slice)."""
    for t, name in ((f1d, "f1d"), (df1d, "df1d"), (chiR, "chiR")):
        build.check_input(t, name, 2, strided_rows=True)
    R, nvx = f1d.shape
    if df1d.shape != (R, nvx) or chiR.shape != (R, nvx - 2) or nvx < 3 or R < 2:
        raise ValueError(f"f1d {tuple(f1d.shape)}, df1d {tuple(df1d.shape)}, chiR {tuple(chiR.shape)} do not stack")
    if len({f1d.device, df1d.device, chiR.device}) != 1:
        raise ValueError("all operands must lie on one device")
    C = 3 * nvx - 2
    T = torch.empty((R, C), dtype=torch.float32, device=f1d.device)
    T4 = torch.empty((R, C, 4), dtype=torch.float32, device=f1d.device)
    fn = build.c_function("chi_bilinear", "chi_bilinear_pack", _PACK_ARGTYPES)
    build.launch(fn, f1d.data_ptr(), df1d.data_ptr(), chiR.data_ptr(), f1d.stride(0), df1d.stride(0), chiR.stride(0),
                 T.data_ptr(), T4.data_ptr(), R, nvx, device=f1d.device)
    return T, T4


def launch_floor(device):
    """Launch an empty kernel the way every kernel of the port is launched: a launch's device-time floor."""
    build.launch(build.c_function("chi_bilinear", "launch_floor", (ctypes.c_void_p,)), device=device)


def plain_pack(f1d, df1d, chiR):
    """The plain form of ``chi_bilinear_pack``: T = (f1d | df1d | chiR) and T4[r, j] = (T[r, c], T[r, c1],
    T[r1, c], T[r1, c1]) for r1 = r + 1 mod R, c1 = min(c + 1, C - 1) and the column c whose quad position j
    holds: f1d's and df1d's quads of one column side by side (j = 2 c, 2 c + 1), then chi_R's (j = c)."""
    T = torch.cat([f1d, df1d, chiR], dim=-1)
    nvx, C = f1d.shape[1], T.shape[1]
    v = torch.arange(nvx, device=T.device)
    c = torch.cat([torch.stack([v, nvx + v], dim=1).reshape(-1), torch.arange(2 * nvx, C, device=T.device)])
    c1 = torch.clamp(c + 1, max=C - 1)
    T1 = torch.roll(T, -1, dims=0)
    return T, torch.stack([T[:, c], T[:, c1], T1[:, c], T1[:, c1]], dim=-1)


def plain_fwd(bq, xq, T, meta):
    """The plain form of ``chi_bilinear_fwd``: rows mixed first, then the two columns of each segment."""
    ib0, ib1, wb = rowmix_indices(T.shape[0], bq)
    vals, ders = [], []
    for c0, ns, v0, dv in segments((T.shape[1] + 2) // 3, meta):
        iv0, wv, inside = col_cell(xq, v0, dv, ns)
        f0 = (1.0 - wb) * T[ib0, c0 + iv0] + wb * T[ib1, c0 + iv0]
        f1 = (1.0 - wb) * T[ib0, c0 + iv0 + 1] + wb * T[ib1, c0 + iv0 + 1]
        vals.append(f0 * (1.0 - wv) + f1 * wv)
        ders.append((f1 - f0) / dv * inside)
    return torch.stack(vals + ders)


def plain_bwd(bq, xq, T, meta, g):
    """The plain form of ``chi_bilinear_bwd``: twelve ``index_put_`` deposits per query, and dbeta."""
    R, C = T.shape
    ib0, ib1, wb = rowmix_indices(R, bq)
    dT = torch.zeros(R * C, dtype=T.dtype, device=T.device)
    dbeta = torch.zeros_like(bq)
    for gs, (c0, ns, v0, dv) in zip(g, segments((C + 2) // 3, meta)):
        iv0, wv, _ = col_cell(xq, v0, dv, ns)
        col = c0 + iv0
        g0, g1 = gs * (1.0 - wv), gs * wv
        for row, wr in ((ib0, 1.0 - wb), (ib1, wb)):
            dT.index_put_((row * C + col,), wr * g0, accumulate=True)
            dT.index_put_((row * C + col + 1,), wr * g1, accumulate=True)
        dbeta = dbeta + gs * ((T[ib1, col] - T[ib0, col]) * (1.0 - wv) + (T[ib1, col + 1] - T[ib0, col + 1]) * wv)
    return dT.view(R, C), dbeta * (R / (2.0 * math.pi))


class ChiTables(torch.autograd.Function):
    """(T, T4) = ChiTables.apply(f1d, df1d, chiR) on the card: ``chi_bilinear_pack``.  Differentiable in the
    three tables through T (their cotangents are dT's column slices); T4 is a copy for K7 and gets none."""

    @staticmethod
    def forward(ctx, f1d, df1d, chiR):
        T, T4 = chi_bilinear_pack(f1d, df1d, chiR)
        ctx.mark_non_differentiable(T4)
        ctx.nvx = f1d.shape[1]
        return T, T4

    @staticmethod
    def backward(ctx, gT, _):
        nvx = ctx.nvx
        return gT[:, :nvx], gT[:, nvx : 2 * nvx], gT[:, 2 * nvx :]


class ChiBilinear(torch.autograd.Function):
    """(fe, dfe, chiR) = ChiBilinear.apply(T [R, C], beta_q, xq, meta [4], T4), each shaped like beta_q.

    Differentiable in T, beta_q and xq.  On the card the values come from K7 on
    T's quad layout T4 [R, C, 4] (``ChiTables``), which the caller passes; on
    the CPU T4 is None and ``plain_fwd`` reads T.  The table and angle
    cotangents are ``chi_bilinear_bwd`` on the card and ``plain_bwd`` on the
    CPU; the query cotangent is the sum of g_s times the forward's own
    derivative outputs.  The grids in ``meta`` get no gradient (nothing trains
    a velocity grid).
    """

    @staticmethod
    def forward(ctx, T, beta_q, xq, meta, T4=None):
        on_card = build.on_card(T, beta_q, xq, meta)
        bq, xf, T, meta = beta_q.reshape(-1).contiguous(), xq.reshape(-1).contiguous(), T.contiguous(), meta.contiguous()
        if on_card:
            if T4 is None:
                raise ValueError("the card's lookup reads T's quad layout T4: stack the tables with ChiTables")
            out = chi_bilinear_fwd(bq, xf, T4, meta)
        else:
            out = plain_fwd(bq, xf, T, meta)
        ctx.save_for_backward(T, bq, xf, meta, out[3:])
        ctx.on_card = on_card
        return tuple(o.view(beta_q.shape) for o in out[:3])

    @staticmethod
    def backward(ctx, *gs):
        T, bq, xf, meta, ders = ctx.saved_tensors
        shape = gs[0].shape
        g = torch.stack([gi.reshape(-1) for gi in gs])
        dT = dbeta = dxq = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dT, dbeta = (chi_bilinear_bwd if ctx.on_card else plain_bwd)(bq, xf, T, meta, g)
            dbeta = dbeta.view(shape)
        if ctx.needs_input_grad[2]:
            dxq = torch.sum(g * ders, dim=0).view(shape)
        return dT, dbeta, dxq, None, None
