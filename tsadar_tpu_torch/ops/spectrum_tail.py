"""K5, the fused 1V spectrum tail: ``csrc/spectrum_tail.cu`` bound through ctypes.

Replaces ``tsadar_tpu/ops/spectrum_kernel.py::spectrum_tail_pallas``.  Its
plain twin is ``plain`` (``core.physics.form_factor._reduced_tail``), which
takes the same arguments; the bound on the card and the design are in the
header of the CUDA source.
"""

import ctypes
import functools

import torch

from . import build
from ..core.physics.form_factor import _reduced_tail as plain
from ..core.physics.zprime import _GAUSS32

__all__ = ["spectrum_tail_fwd", "plain"]

MAX_SPECIES = 8  # kMaxSpecies in the CUDA source
_ARGTYPES = (ctypes.c_void_p,) * 16 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


@functools.cache
def _gauss(device):
    """The float32 Rybicki weights of ``zprime.dawsn``, uploaded once per device."""
    return torch.as_tensor(_GAUSS32, dtype=torch.float32, device=device)


def spectrum_tail_fwd(lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, weights, sarad, omgs):
    """Reduced spectrum [B, L]; the arguments are those of ``_reduced_tail``.

    lf, chiERraw [B,G,L,A]; ne/Te [B,G]; lam/Va/ud [B]; A/Z/Ti/fract [B,S];
    weights a scalar or [A]; sarad [A]; omgs [L].
    """
    build.check_input(lf, "lf", 4)
    build.check_input(chiERraw, "chiERraw", 4)
    B, G, L, NA = lf.shape
    S = A.shape[-1]
    if chiERraw.shape != lf.shape:
        raise ValueError(f"chiERraw {tuple(chiERraw.shape)} does not match lf {tuple(lf.shape)}")
    if not 1 <= S <= MAX_SPECIES:
        raise ValueError(f"the kernel takes 1..{MAX_SPECIES} ion species, got {S}")
    shapes = {
        "ne": (ne, (B, G)), "Te": (Te, (B, G)), "lam": (lam, (B,)), "Va": (Va, (B,)), "ud": (ud, (B,)),
        "A": (A, (B, S)), "Z": (Z, (B, S)), "Ti": (Ti, (B, S)), "fract": (fract, (B, S)),
        "sarad": (sarad, (NA,)), "omgs": (omgs, (L,)),
    }
    for name, (t, shape) in shapes.items():
        build.check_input(t, name, len(shape))
        if t.shape != shape or t.device != lf.device:
            raise ValueError(f"{name} must be {shape} on {lf.device}, got {tuple(t.shape)} on {t.device}")
    if weights.numel() not in (1, NA):
        raise ValueError(f"weights must be a scalar or have {NA} entries, got {tuple(weights.shape)}")
    weight = weights.reshape(-1).expand(NA).contiguous()
    build.check_input(weight, "weights", 1)
    cos_sa = torch.cos(sarad)
    gauss = _gauss(lf.device)
    out = torch.empty((B, L), dtype=lf.dtype, device=lf.device)
    fn = build.c_function("spectrum_tail", "spectrum_tail_fwd", _ARGTYPES)
    ptrs = [t.data_ptr() for t in (lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, cos_sa, weight, omgs, gauss, out)]
    build.launch(fn, *ptrs, B, G, L, NA, S, device=lf.device)
    spectrum_tail_fwd.launches += 1
    return out


spectrum_tail_fwd.launches = 0
