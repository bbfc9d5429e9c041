"""K9, the chi_R pole tables and their transpose: ``csrc/pv_tables.cu`` through ctypes.

``pv_tables_fwd`` replaces ``tsadar_tpu/ops/pv_kernel.py::pv_tables_pallas`` (in the
precombined form the JAX package wires instead, ``ratint.pv_tables_matmul``) and
writes the midpoint and node tables interleaved; ``pv_tables_bwd`` is its
transpose, which the TPU kernel does not have.  Their plain twins are ``plain``
and ``plain_bwd``: ``ratint.pv_tables_matmul`` with the dense matrices built once
from the kernel's own coefficient vectors (``ratint.pv_dense``).  The bound on the card and the design are
in the header of the CUDA source.  ``PvTables`` is the differentiable table:
kernels for CUDA tensors, the twins for CPU tensors.
"""

import ctypes

import torch

from . import build
from ..core.physics.ratint import pv_dense, pv_tables_matmul

__all__ = ["PvTables", "pv_tables_fwd", "pv_tables_bwd", "plain", "plain_bwd"]

_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,)


def _check(x, coef, width_of_m, name):
    build.check_input(x, name, 2)
    build.check_input(coef, "coef", 2)
    m = coef.shape[1] // 4
    if coef.shape != (2, 4 * m) or m < 2 or x.shape[1] != width_of_m(m) or coef.device != x.device:
        raise ValueError(f"{name} {tuple(x.shape)} does not fit the coefficients {tuple(coef.shape)} on {coef.device}")
    return x.shape[0], m


def pv_tables_fwd(f, coef):
    """Interleaved pole table [B, 2m - 1] of integrands f [B, m + 2]; coef [2, 4m] from ``ratint.pv_coefficients``."""
    B, m = _check(f, coef, lambda m: m + 2, "f")
    out = torch.empty((B, 2 * m - 1), dtype=f.dtype, device=f.device)
    fn = build.c_function("pv_tables", "pv_tables_fwd", _ARGTYPES)
    build.launch(fn, f.data_ptr(), coef.data_ptr(), out.data_ptr(), B, m, device=f.device)
    pv_tables_fwd.launches += 1
    return out


pv_tables_fwd.launches = 0


def pv_tables_bwd(g, coef):
    """Cotangent [B, m + 2] of the integrands from that of the interleaved table g [B, 2m - 1]."""
    B, m = _check(g, coef, lambda m: 2 * m - 1, "g")
    gf = torch.empty((B, m + 2), dtype=g.dtype, device=g.device)
    fn = build.c_function("pv_tables", "pv_tables_bwd", _ARGTYPES)
    build.launch(fn, g.data_ptr(), coef.data_ptr(), gf.data_ptr(), B, m, device=g.device)
    pv_tables_bwd.launches += 1
    return gf


pv_tables_bwd.launches = 0


def _dense(coef):
    # coef is ``ratint.pv_coefficients``'s operand, a function of (m, dtype) alone: its dense pair is
    # built once and cached, so the twin is two matmuls
    return pv_dense(coef.shape[1] // 4, coef.dtype, coef.device)


def plain(f, coef):
    """The plain form of ``pv_tables_fwd``: two matmuls with the dense matrices, interleaved."""
    mid, node = pv_tables_matmul(f, *_dense(coef))
    out = torch.empty(f.shape[:-1] + (mid.shape[-1] + node.shape[-1],), dtype=mid.dtype, device=mid.device)
    out[..., 0::2], out[..., 1::2] = mid, node
    return out


def plain_bwd(g, coef):
    """The plain form of ``pv_tables_bwd``: g_mid @ K_mid^T + [g_node, 0] @ K_node^T."""
    kmid, knode = _dense(coef)
    return g[..., 0::2] @ kmid.T + g[..., 1::2] @ knode[:, :-1].T


class PvTables(torch.autograd.Function):
    """table [B, 2m - 1] = PvTables.apply(f [B, m + 2], coef [2, 4m]), differentiable in f.

    Linear in f: the backward is the transposed mode, ``pv_tables_bwd`` on the
    card and ``plain_bwd`` on the CPU.
    """

    @staticmethod
    def forward(ctx, f, coef):
        ctx.on_card = build.on_card(f, coef)
        ctx.save_for_backward(coef)
        return (pv_tables_fwd if ctx.on_card else plain)(f.contiguous(), coef)

    @staticmethod
    def backward(ctx, g):
        (coef,) = ctx.saved_tensors
        g_f = None
        if ctx.needs_input_grad[0]:
            g_f = (pv_tables_bwd if ctx.on_card else plain_bwd)(g.contiguous(), coef)
        return g_f, None
