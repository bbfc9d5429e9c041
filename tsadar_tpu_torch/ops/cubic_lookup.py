"""K3 and K4, the log-EDF lookup and its table cotangent: ``csrc/cubic_lookup.cu`` through ctypes.

``cubic_lookup_fwd`` replaces ``tsadar_tpu/ops/interp_kernel2.py::cubic_interp_pallas2``
and ``cubic_lookup_bwd`` its ``cubic_interp_pallas2_bwd``.  Their plain twins
are ``plain`` (``core.physics.interp.cubic_lookup_plain``) and ``plain_bwd``;
the bounds on the card and the designs are in the header of the CUDA source.
``CubicLookup`` is the differentiable lookup: kernels for CUDA tensors, the
plain twins for CPU tensors, the same formulas around them.
"""

import ctypes

import torch

from . import build
from ..core.physics.interp import cubic_cell as _cell
from ..core.physics.interp import cubic_lookup_plain as plain
from ..core.physics.interp import _cubic_weights

__all__ = ["CubicLookup", "cubic_lookup_fwd", "cubic_lookup_bwd", "plain", "plain_bwd"]

_FWD_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def _check(q, other, other_name, meta, n):
    build.check_input(q, "q", 2)
    build.check_input(other, other_name, 2)
    build.check_input(meta, "meta", 2)
    B = q.shape[0]
    if other.shape[0] != B or n < 4 or meta.shape != (B, 3) or len({q.device, other.device, meta.device}) != 1:
        raise ValueError(
            f"{other_name} {tuple(other.shape)} / meta {tuple(meta.shape)} / n = {n} do not fit queries {tuple(q.shape)}"
        )


def cubic_lookup_fwd(q, table, meta):
    """(value, d value/dt) [B, Q] of per-row tables [B, n]; ``meta`` [B, 3] = (x0, dx, n) per row."""
    n = table.shape[-1]
    _check(q, table, "table", meta, n)
    B, Q = q.shape
    val, dval = torch.empty_like(q), torch.empty_like(q)
    fn = build.c_function("cubic_lookup", "cubic_lookup_fwd", _FWD_ARGTYPES)
    build.launch(
        fn, q.data_ptr(), table.data_ptr(), meta.data_ptr(), val.data_ptr(), dval.data_ptr(), B, Q, n,
        device=q.device,
    )
    return val, dval


def cubic_lookup_bwd(q, g, meta, n):
    """Table cotangent [B, n]: every query adds g times its four stencil weights to entries i0-1 .. i0+2 of its row."""
    _check(q, g, "g", meta, n)
    B, Q = q.shape
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match queries {tuple(q.shape)}")
    dtable = torch.zeros((B, n), dtype=q.dtype, device=q.device)
    fn = build.c_function("cubic_lookup", "cubic_lookup_bwd", _BWD_ARGTYPES)
    build.launch(fn, q.data_ptr(), g.data_ptr(), meta.data_ptr(), dtable.data_ptr(), B, Q, n, device=q.device)
    return dtable


def plain_bwd(q, g, meta, n):
    """The plain form of ``cubic_lookup_bwd``: the forward twin's index math, then ``scatter_add_``.

    The taps i0-1 (first cell) and i0+2 (last cell) that fall outside the
    table carry zero weight; they land in a pad that is cut off.
    """
    i0, t, first, last = _cell(q, meta)
    padded = torch.zeros(q.shape[:-1] + (n + 3,), dtype=g.dtype, device=g.device)  # padded[:, j + 1] = dtable[:, j]
    for k, c in enumerate(_cubic_weights(t, first, last)):
        padded.scatter_add_(-1, i0 + k, g * c)
    return padded[..., 1 : n + 1].contiguous()


class CubicLookup(torch.autograd.Function):
    """value [B, Q] = CubicLookup.apply(q [B, Q], table [B, n], meta [B, 3]), differentiable in q and table.

    The query cotangent is g (d value/dt) / dx everywhere (the edge cells
    extrapolate their polynomial, so nothing is masked); the table cotangent
    is ``cubic_lookup_bwd`` on the card and ``plain_bwd`` on the CPU.  ``meta``
    gets no gradient.
    """

    @staticmethod
    def forward(ctx, q, table, meta):
        on_card = build.on_card(q, table, meta)
        q, meta = q.contiguous(), meta.contiguous()
        val, dval = (cubic_lookup_fwd if on_card else plain)(q, table.contiguous(), meta)
        ctx.save_for_backward(q, dval, meta)
        ctx.n = table.shape[-1]
        ctx.on_card = on_card
        return val

    @staticmethod
    def backward(ctx, g):
        q, dval, meta = ctx.saved_tensors
        g_q = g_table = None
        if ctx.needs_input_grad[0]:
            g_q = g * dval / meta[:, 1:2]
        if ctx.needs_input_grad[1]:
            g_table = (cubic_lookup_bwd if ctx.on_card else plain_bwd)(q, g.contiguous(), meta, ctx.n)
        return g_q, g_table, None
