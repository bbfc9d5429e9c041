"""Z'(xi) of the Maxwellian plasma dispersion function, through the Dawson integral.

    Re Z'(xi) = -2 (1 - 2 xi D(xi)),   Im Z'(xi) = -2 sqrt(pi) xi exp(-xi^2)

D is Rybicki's sampling series in its centered form: with n0 the odd multiple
of h nearest x and u = x - n0 h, D(x) = exp(-u^2)/sqrt(pi) * sum_j
exp(-4 h^2 j^2) B^j / (n0 + 2j), B = exp(4 h u).  Two dtype branches, as in
the JAX package:

* float64: h = 0.25 with 29 terms, uniformly accurate (~7e-18) for every x;
* float32: h = 0.36 with 15 terms on x clipped to [-6.5, 6.5], and the 6-term
  asymptotic (2n-1)!! series above |x| = 6.

Forward only for now: the gradient (D' = 1 - 2 x D) comes with the fit slice.
"""

import math

import numpy as np
import torch

_H32 = 0.36
_J32 = np.arange(-7.0, 8.0)
_GAUSS32 = np.exp(-4.0 * _H32**2 * _J32**2)
_H64 = 0.25
_J64 = np.arange(-14.0, 15.0)
_GAUSS64 = np.exp(-4.0 * _H64**2 * _J64**2)


def _dawsn_rybicki(x):
    if x.dtype == torch.float64:
        h, jgrid, gauss = _H64, _J64, _GAUSS64
    else:
        h, jgrid, gauss = _H32, _J32, _GAUSS32
    j = torch.as_tensor(jgrid, dtype=x.dtype, device=x.device)
    g = torch.as_tensor(gauss, dtype=x.dtype, device=x.device)
    n0 = 2.0 * torch.floor(x / (2.0 * h)) + 1.0  # odd, u = x - n0 h in [-h, h)
    u = x - n0 * h
    b_pow = torch.exp(4.0 * h * u[..., None] * j)
    k = n0[..., None] + 2.0 * j
    series = torch.sum(g * b_pow / k, dim=-1)
    return torch.exp(-(u**2)) * series / math.sqrt(math.pi)


def _dawsn_asymptotic(x):
    # D(x) ~ 1/(2x) * sum_n (2n-1)!! (1/(2x^2))^n, 6 terms
    xs = torch.where(torch.abs(x) > 1.0, x, torch.ones_like(x))  # guard the unused branch
    s = 1.0 / (2.0 * xs * xs)
    series = 1.0 + s * (1.0 + s * (3.0 + s * (15.0 + s * (105.0 + s * (945.0 + s * 10395.0)))))
    return series / (2.0 * xs)


def dawsn(x):
    """Dawson integral D(x) = exp(-x^2) int_0^x exp(t^2) dt, elementwise."""
    if x.dtype == torch.float64:
        return _dawsn_rybicki(x)
    small = torch.abs(x) <= 6.0
    return torch.where(small, _dawsn_rybicki(torch.clamp(x, -6.5, 6.5)), _dawsn_asymptotic(x))


def zprime(xi):
    """(Re Z'(xi), Im Z'(xi)), each shaped like ``xi``."""
    re = -2.0 * (1.0 - 2.0 * xi * dawsn(xi))
    im = -2.0 * math.sqrt(math.pi) * xi * torch.exp(-(xi**2))
    return re, im
