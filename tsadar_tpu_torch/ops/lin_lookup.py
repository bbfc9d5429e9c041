"""K1, K2 and K10, the chi_R table lookups and their table cotangents: ``csrc/lin_lookup.cu`` through ctypes.

``lin_lookup_fwd`` replaces ``tsadar_tpu/ops/interp_kernel2.py::lin_interp_pallas2``
and ``lin_lookup_bwd`` its ``lin_interp_pallas2_bwd``.  Their plain twins are
``plain`` (``core.physics.interp.lin_lookup_plain``) and ``plain_bwd``; the
bounds on the card and the designs are in the header of the CUDA source.
``LinLookup`` is the differentiable lookup: kernels for CUDA tensors, the
plain twins for CPU tensors, the same formulas around them.

``lin_lookup_meta_fwd`` (K10) replaces ``tsadar_tpu/ops/interp_kernel.py::lin_interp_pallas``:
the same lookup on zero-padded tables [B, npad] with the grid (x0, dx, n) in a
device tensor; ``lin_lookup_meta_bwd`` is K2 on that layout.  Their twins are
``plain_meta`` and ``plain_meta_bwd``, and ``LinLookupPadded`` is the
differentiable form behind ``core.physics.interp.interp1d_linear_pallas``.
"""

import ctypes

import torch

from . import build
from ..core.physics.interp import lin_cell as _cell
from ..core.physics.interp import lin_lookup_plain as plain

__all__ = [
    "LinLookup", "LinLookupPadded", "lin_lookup_fwd", "lin_lookup_bwd", "lin_lookup_meta_fwd", "lin_lookup_meta_bwd",
    "plain", "plain_bwd", "plain_meta", "plain_meta_bwd",
]

_FWD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 2 + (ctypes.c_void_p,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 2 + (ctypes.c_void_p,)
_META_FWD_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
_META_BWD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def lin_lookup_fwd(q, table, x0, dx):
    """(value, f[i0+1] - f[i0]) [B, Q] of per-row tables [B, n] on the grid x0 + dx * i."""
    build.check_input(q, "q", 2)
    build.check_input(table, "table", 2)
    B, Q = q.shape
    n = table.shape[1]
    if table.shape[0] != B or n < 2 or table.device != q.device:
        raise ValueError(f"table {tuple(table.shape)} on {table.device} does not fit queries {tuple(q.shape)}")
    val, slope = torch.empty_like(q), torch.empty_like(q)
    fn = build.c_function("lin_lookup", "lin_lookup_fwd", _FWD_ARGTYPES)
    build.launch(
        fn, q.data_ptr(), table.data_ptr(), val.data_ptr(), slope.data_ptr(), B, Q, n, float(x0), float(dx),
        device=q.device,
    )
    lin_lookup_fwd.launches += 1
    return val, slope


lin_lookup_fwd.launches = 0


def lin_lookup_bwd(q, g, x0, dx, n):
    """Table cotangent [B, n]: every query adds g (1 - w) to entry i0 and g w to i0 + 1 of its row."""
    build.check_input(q, "q", 2)
    build.check_input(g, "g", 2)
    B, Q = q.shape
    if g.shape != q.shape or g.device != q.device or n < 2:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} does not fit queries {tuple(q.shape)}, n = {n}")
    dtable = torch.zeros((B, n), dtype=q.dtype, device=q.device)
    fn = build.c_function("lin_lookup", "lin_lookup_bwd", _BWD_ARGTYPES)
    build.launch(fn, q.data_ptr(), g.data_ptr(), dtable.data_ptr(), B, Q, n, float(x0), float(dx), device=q.device)
    lin_lookup_bwd.launches += 1
    return dtable


lin_lookup_bwd.launches = 0


def plain_bwd(q, g, x0, dx, n):
    """The plain form of ``lin_lookup_bwd``: the forward twin's index math, then ``scatter_add_``."""
    _, i0, w = _cell(q, x0, dx, n)
    dtable = torch.zeros(q.shape[:-1] + (n,), dtype=g.dtype, device=g.device)
    dtable.scatter_add_(-1, i0, g * (1.0 - w))
    dtable.scatter_add_(-1, i0 + 1, g * w)
    return dtable


class LinLookup(torch.autograd.Function):
    """value [B, Q] = LinLookup.apply(q [B, Q], table [B, n], x0, dx), differentiable in q and table.

    The query cotangent is g slope / dx strictly inside the grid and 0 at and
    beyond its ends (the value is clamped there); the table cotangent is
    ``lin_lookup_bwd`` on the card and ``plain_bwd`` on the CPU.
    """

    @staticmethod
    def forward(ctx, q, table, x0, dx):
        on_card = build.on_card(q, table)
        val, slope = (lin_lookup_fwd if on_card else plain)(q.contiguous(), table.contiguous(), x0, dx)
        ctx.save_for_backward(q, slope)
        ctx.grid = (x0, dx, table.shape[-1])
        ctx.on_card = on_card
        return val

    @staticmethod
    def backward(ctx, g):
        q, slope = ctx.saved_tensors
        x0, dx, n = ctx.grid
        g_q = g_table = None
        if ctx.needs_input_grad[0]:
            raw = _cell(q, x0, dx, n)[0]
            g_q = torch.where((raw > 0.0) & (raw < n - 1.0), g * slope / dx, 0.0)
        if ctx.needs_input_grad[1]:
            g_table = (lin_lookup_bwd if ctx.on_card else plain_bwd)(q.contiguous(), g.contiguous(), x0, dx, n)
        return g_q, g_table, None, None


def _check_meta(q, table_or_g, meta, name):
    build.check_input(q, "q", 2)
    build.check_input(table_or_g, name, 2)
    build.check_input(meta, "meta", 1)
    if meta.numel() != 3 or table_or_g.shape[0] != q.shape[0] or not q.device == table_or_g.device == meta.device:
        raise ValueError(f"{name} {tuple(table_or_g.shape)}, meta {tuple(meta.shape)} do not fit queries {tuple(q.shape)}")


def lin_lookup_meta_fwd(q, table, meta):
    """(value, f[i0+1] - f[i0]) [B, Q] of zero-padded per-row tables [B, npad] on the grid
    meta = (x0, dx, n), a 3-float device tensor; the caller keeps 2 <= n <= npad - 1."""
    _check_meta(q, table, meta, "table")
    B, Q = q.shape
    npad = table.shape[1]
    if npad < 3:
        raise ValueError(f"a padded table needs at least 3 entries, got {npad}")
    val, slope = torch.empty_like(q), torch.empty_like(q)
    fn = build.c_function("lin_lookup", "lin_lookup_meta_fwd", _META_FWD_ARGTYPES)
    build.launch(fn, q.data_ptr(), table.data_ptr(), meta.data_ptr(), val.data_ptr(), slope.data_ptr(), B, Q, npad,
                 device=q.device)
    lin_lookup_meta_fwd.launches += 1
    return val, slope


lin_lookup_meta_fwd.launches = 0


def lin_lookup_meta_bwd(q, g, meta, npad):
    """Table cotangent [B, npad] of ``lin_lookup_meta_fwd``: K2's deposits, zero from n on."""
    _check_meta(q, g, meta, "g")
    if g.shape != q.shape or npad < 3:
        raise ValueError(f"g {tuple(g.shape)} does not fit queries {tuple(q.shape)}, npad = {npad}")
    B, Q = q.shape
    dtable = torch.zeros((B, npad), dtype=q.dtype, device=q.device)
    fn = build.c_function("lin_lookup", "lin_lookup_meta_bwd", _META_BWD_ARGTYPES)
    build.launch(fn, q.data_ptr(), g.data_ptr(), meta.data_ptr(), dtable.data_ptr(), B, Q, npad, device=q.device)
    lin_lookup_meta_bwd.launches += 1
    return dtable


lin_lookup_meta_bwd.launches = 0


def _meta_grid(meta):
    """(x0, dx) as tensors and n as an int: the plain forms read n back to the host."""
    return meta[0], meta[1], int(meta[2])


def plain_meta(q, table, meta):
    """The plain form of ``lin_lookup_meta_fwd``: ``plain`` on the first n entries of each row."""
    x0, dx, n = _meta_grid(meta)
    return plain(q, table[:, :n], x0, dx)


def plain_meta_bwd(q, g, meta, npad):
    """The plain form of ``lin_lookup_meta_bwd``: ``plain_bwd`` padded with zeros to npad."""
    x0, dx, n = _meta_grid(meta)
    return torch.nn.functional.pad(plain_bwd(q, g, x0, dx, n), (0, npad - n))


class LinLookupPadded(torch.autograd.Function):
    """value [B, Q] = LinLookupPadded.apply(q [B, Q], table [B, npad], meta [3]), differentiable in q and table.

    The grid (x0, dx, n) gets no cotangent.  The query cotangent is g slope / dx
    strictly inside the grid and 0 at and beyond its ends; the table cotangent
    is ``lin_lookup_meta_bwd`` on the card and ``plain_meta_bwd`` on the CPU.
    """

    @staticmethod
    def forward(ctx, q, table, meta):
        on_card = build.on_card(q, table, meta)
        val, slope = (lin_lookup_meta_fwd if on_card else plain_meta)(q.contiguous(), table.contiguous(), meta)
        ctx.save_for_backward(q, slope, meta)
        ctx.npad = table.shape[-1]
        ctx.on_card = on_card
        return val

    @staticmethod
    def backward(ctx, g):
        q, slope, meta = ctx.saved_tensors
        g_q = g_table = None
        if ctx.needs_input_grad[0]:
            raw = (q - meta[0]) / meta[1]
            g_q = torch.where((raw > 0.0) & (raw < meta[2] - 1.0), g * slope / meta[1], 0.0)
        if ctx.needs_input_grad[1]:
            bwd = lin_lookup_meta_bwd if ctx.on_card else plain_meta_bwd
            g_table = bwd(q.contiguous(), g.contiguous(), meta, ctx.npad)
        return g_q, g_table, None
