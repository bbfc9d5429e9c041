"""K1, the chi_R table lookup: ``csrc/lin_lookup.cu`` bound through ctypes.

Replaces ``tsadar_tpu/ops/interp_kernel2.py::lin_interp_pallas2``.  Its plain
twin is ``plain`` (``core.physics.interp.lin_lookup_plain``); the bound on the
card and the design are in the header of the CUDA source.
"""

import ctypes

import torch

from . import build
from ..core.physics.interp import lin_lookup_plain as plain

__all__ = ["lin_lookup_fwd", "plain"]

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 2 + (ctypes.c_void_p,)


def lin_lookup_fwd(q, table, x0, dx):
    """(value, f[i0+1] - f[i0]) [B, Q] of per-row tables [B, n] on the grid x0 + dx * i."""
    build.check_input(q, "q", 2)
    build.check_input(table, "table", 2)
    B, Q = q.shape
    n = table.shape[1]
    if table.shape[0] != B or n < 2 or table.device != q.device:
        raise ValueError(f"table {tuple(table.shape)} on {table.device} does not fit queries {tuple(q.shape)}")
    val, slope = torch.empty_like(q), torch.empty_like(q)
    fn = build.c_function("lin_lookup", "lin_lookup_fwd", _ARGTYPES)
    build.launch(
        fn, q.data_ptr(), table.data_ptr(), val.data_ptr(), slope.data_ptr(), B, Q, n, float(x0), float(dx),
        device=q.device,
    )
    lin_lookup_fwd.launches += 1
    return val, slope


lin_lookup_fwd.launches = 0
