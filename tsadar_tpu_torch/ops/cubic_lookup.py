"""K3, the log-EDF lookup: ``csrc/cubic_lookup.cu`` bound through ctypes.

Replaces ``tsadar_tpu/ops/interp_kernel2.py::cubic_interp_pallas2``.  Its
plain twin is ``plain`` (``core.physics.interp.cubic_lookup_plain``); the
bound on the card and the design are in the header of the CUDA source.
"""

import ctypes

import torch

from . import build
from ..core.physics.interp import cubic_lookup_plain as plain

__all__ = ["cubic_lookup_fwd", "plain"]

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def cubic_lookup_fwd(q, table, meta):
    """(value, d value/dt) [B, Q] of per-row tables [B, n]; ``meta`` [B, 3] = (x0, dx, n) per row."""
    build.check_input(q, "q", 2)
    build.check_input(table, "table", 2)
    build.check_input(meta, "meta", 2)
    B, Q = q.shape
    n = table.shape[1]
    if table.shape[0] != B or n < 4 or meta.shape != (B, 3) or len({q.device, table.device, meta.device}) != 1:
        raise ValueError(
            f"table {tuple(table.shape)} / meta {tuple(meta.shape)} do not fit queries {tuple(q.shape)}"
        )
    val, dval = torch.empty_like(q), torch.empty_like(q)
    fn = build.c_function("cubic_lookup", "cubic_lookup_fwd", _ARGTYPES)
    build.launch(
        fn, q.data_ptr(), table.data_ptr(), meta.data_ptr(), val.data_ptr(), dval.data_ptr(), B, Q, n,
        device=q.device,
    )
    cubic_lookup_fwd.launches += 1
    return val, dval


cubic_lookup_fwd.launches = 0
