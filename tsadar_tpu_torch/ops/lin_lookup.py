"""K1 and K2, the chi_R table lookup and its table cotangent: ``csrc/lin_lookup.cu`` through ctypes.

``lin_lookup_fwd`` replaces ``tsadar_tpu/ops/interp_kernel2.py::lin_interp_pallas2``
and ``lin_lookup_bwd`` its ``lin_interp_pallas2_bwd``.  Their plain twins are
``plain`` (``core.physics.interp.lin_lookup_plain``) and ``plain_bwd``; the
bounds on the card and the designs are in the header of the CUDA source.
``LinLookup`` is the differentiable lookup: kernels for CUDA tensors, the
plain twins for CPU tensors, the same formulas around them.
"""

import ctypes

import torch

from . import build
from ..core.physics.interp import lin_cell as _cell
from ..core.physics.interp import lin_lookup_plain as plain

__all__ = ["LinLookup", "lin_lookup_fwd", "lin_lookup_bwd", "plain", "plain_bwd"]

_FWD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 2 + (ctypes.c_void_p,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 2 + (ctypes.c_void_p,)


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
