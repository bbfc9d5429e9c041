"""K5 and K6, the fused 1V spectrum tail and its cotangents: ``csrc/spectrum_tail{,_bwd}.cu`` through ctypes.

``spectrum_tail_fwd`` replaces ``tsadar_tpu/ops/spectrum_kernel.py::spectrum_tail_pallas``
and ``spectrum_tail_bwd`` its ``spectrum_tail_pallas_bwd``.  Their plain twins
are ``plain`` (``core.physics.form_factor._reduced_tail``, same arguments) and
``plain_bwd`` (``torch.autograd`` of it); the bounds on the card and the
designs are in the headers of the CUDA sources.  ``SpectrumTail`` is the
differentiable tail: kernels for CUDA tensors, the plain twins for CPU tensors.
The last argument, ``lfc`` [B] (the shift of each lineout's log f_e, so that
log f_e = lf + lfc; ``None`` for 0), carries no gradient.
"""

import ctypes
import functools

import torch

from . import build
from ..core.physics.form_factor import _reduced_tail as plain
from ..core.physics.zprime import _GAUSS32

__all__ = ["SpectrumTail", "spectrum_tail_fwd", "spectrum_tail_bwd", "plain", "plain_bwd"]

MAX_SPECIES = 8  # kMaxSpecies in the CUDA source
_FWD_ARGTYPES = (ctypes.c_void_p,) * 17 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 28 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
# the differentiable arguments of the tail, in the order the cotangents come back
GRAD_NAMES = ("lf", "chiERraw", "ne", "Te", "lam", "Va", "ud", "Z", "Ti", "fract")


@functools.cache
def _gauss(device):
    """The float32 Rybicki weights of ``zprime.dawsn``, uploaded once per device."""
    return torch.as_tensor(_GAUSS32, dtype=torch.float32, device=device)


def _operands(lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, weights, sarad, omgs, lfc=None):
    """Check the tail's arguments; returns the kernels' operand list and (B, G, L, NA, S)."""
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
    if lfc is None:
        lfc = torch.zeros((B,), dtype=lf.dtype, device=lf.device)
    shapes["lfc"] = (lfc, (B,))
    for name, (t, shape) in shapes.items():
        build.check_input(t, name, len(shape))
        if t.shape != shape or t.device != lf.device:
            raise ValueError(f"{name} must be {shape} on {lf.device}, got {tuple(t.shape)} on {t.device}")
    if weights.numel() not in (1, NA):
        raise ValueError(f"weights must be a scalar or have {NA} entries, got {tuple(weights.shape)}")
    weight = weights.reshape(-1).expand(NA).contiguous()
    build.check_input(weight, "weights", 1)
    operands = [lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, torch.cos(sarad), weight, omgs, _gauss(lf.device), lfc]
    return operands, (B, G, L, NA, S)


def spectrum_tail_fwd(lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, weights, sarad, omgs, lfc=None):
    """Reduced spectrum [B, L]; the arguments are those of ``_reduced_tail``.

    lf, chiERraw [B,G,L,A]; ne/Te [B,G]; lam/Va/ud [B]; A/Z/Ti/fract [B,S];
    weights a scalar or [A]; sarad [A]; omgs [L]; lfc [B] or None.
    """
    operands, dims = _operands(lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, weights, sarad, omgs, lfc)
    out = torch.empty((dims[0], dims[2]), dtype=lf.dtype, device=lf.device)
    fn = build.c_function("spectrum_tail", "spectrum_tail_fwd", _FWD_ARGTYPES)
    build.launch(fn, *(t.data_ptr() for t in (*operands, out)), *dims, device=lf.device)
    return out


def spectrum_tail_bwd(g, lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, weights, sarad, omgs, lfc=None):
    """Every cotangent of ``spectrum_tail_fwd`` from g [B, L], in the order of ``GRAD_NAMES``.

    g_lf, g_chiERraw [B,G,L,A]; g_ne, g_Te [B,G]; g_lam, g_Va, g_ud [B];
    g_Z, g_Ti, g_fract [B,S].  A, weights, sarad, omgs and lfc are constants.
    """
    operands, dims = _operands(lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, weights, sarad, omgs, lfc)
    B, G, L, NA, S = dims
    build.check_input(g, "g", 2)
    if g.shape != (B, L) or g.device != lf.device:
        raise ValueError(f"g must be {(B, L)} on {lf.device}, got {tuple(g.shape)} on {g.device}")
    new = lambda *shape: torch.empty(shape, dtype=lf.dtype, device=lf.device)  # noqa: E731
    outs = (torch.empty_like(lf), torch.empty_like(lf), new(B, G), new(B, G), new(B), new(B), new(B), new(B, S), new(B, S),
            new(B, S))
    # the blocks of a lineout add their partial sums over wavelengths and angles here, in float64
    sums = torch.zeros((B, 2 * G + 2 + 3 * S), dtype=torch.float64, device=lf.device)
    fn = build.c_function("spectrum_tail_bwd", "spectrum_tail_bwd", _BWD_ARGTYPES)
    build.launch(fn, *(t.data_ptr() for t in (*operands, g, *outs, sums)), *dims, device=lf.device)
    return outs


def plain_bwd(g, lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, weights, sarad, omgs, lfc=None):
    """The plain form of ``spectrum_tail_bwd``: ``torch.autograd.grad`` of ``_reduced_tail``."""
    diff = [t.detach().requires_grad_(True) for t in (lf, chiERraw, ne, Te, lam, Va, ud, Z, Ti, fract)]
    with torch.enable_grad():
        out = plain(*diff[:7], A, *diff[7:], weights, sarad, omgs, lfc)
        return torch.autograd.grad(out, diff, g)


class SpectrumTail(torch.autograd.Function):
    """reduced [B, L] = SpectrumTail.apply(*the arguments of ``_reduced_tail``, lfc optional).

    Differentiable in the arguments named in ``GRAD_NAMES``; A, weights, sarad,
    omgs and lfc get no gradient.  Nothing but the inputs is saved: the backward
    recomputes the forward per point.
    """

    @staticmethod
    def forward(ctx, *args):
        on_card = build.on_card(*args)
        args = tuple(a.contiguous() for a in args)
        ctx.save_for_backward(*args)
        ctx.on_card = on_card
        return (spectrum_tail_fwd if on_card else plain)(*args)

    @staticmethod
    def backward(ctx, g):
        grads = (spectrum_tail_bwd if ctx.on_card else plain_bwd)(g.contiguous(), *ctx.saved_tensors)
        grads = [gr if need else None for gr, need in zip(grads, (*ctx.needs_input_grad[:7], *ctx.needs_input_grad[8:11]))]
        return (*grads[:7], None, *grads[7:], None, None, None) + (None,) * (len(ctx.saved_tensors) - 14)
