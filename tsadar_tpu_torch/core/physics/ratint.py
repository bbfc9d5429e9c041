"""Principal-value pole tables of the electron susceptibility.

For a uniform grid and a piecewise-linear integrand the PV integral at a pole
is an exact contraction with a static Toeplitz matrix (the log form is the
exact antiderivative).  Two pole grids are used: the interval midpoints
(``pv_integral_uniform``) and the interior nodes
(``pv_integral_uniform_nodes``); both are the float64 oracles of the tables.

Both tables are linear in the integrand, so the finite-difference stencils and
the Toeplitz contraction collapse into one matrix each, table = f @ K
(``pv_combined_kernel_np``: the same matrix as
``tsadar_tpu.core.physics.ratint.pv_combined_kernel_np``).  Writing
W(e) = 1 + (delta - e) T(e) for e = i - p (delta 0 for midpoint poles, 0.5
for node poles), K depends on j - p alone except in its first row and its last
two: K[j, p] = c[j - p] for 0 < j < m, K[0, p] = a(-p), K[m, p] = b(m - 1 - p),
K[m + 1] = 0, with a = T/2 - W, b = T/2 + W and c[d] = a(d) + b(d - 1)
(``pv_coefficients``).  The K9 kernel (``ops.pv_tables``) reads those vectors,
~4m floats per table, instead of two dense [N, M] matrices; its plain twin
builds the dense matrices from the same vectors by the same index rule.

The pole-aware integration of a piecewise-linear f / g (``ratcen``,
``ratintn``, and ``pv_integral`` for a batch of poles; the counterpart of the
JAX package's, after Ed Williams' newlip) serves the 2V exact mode: each
interval is integrated in closed form, by the smooth rational form where
|gdif| < 1e-4 |gav| and by the real part of the log form near a pole.  Both
branches are computed with guarded denominators, so that the untaken one
stays finite and reverse-mode AD NaN-free.
"""

import functools

import numpy as np
import torch


def _toeplitz_entries(e, delta):
    """T(e) in float64 for integer offsets e = i - p: log|e + 1/2| - log|e - 1/2| (midpoint
    poles, delta 0) or log|e| - log|e - 1| with T(0) = T(1) = 0 (node poles, delta 0.5)."""
    if delta == 0.0:
        return np.log(np.abs(e + 0.5)) - np.log(np.abs(e - 0.5))
    en = e - 1
    with np.errstate(divide="ignore"):
        T = np.log(np.abs(en + 1.0)) - np.log(np.abs(en).clip(min=1e-300))
    T[(en == 0) | (en == -1)] = 0.0
    return T


def _check_delta(delta):
    # delta doubles as the table selector; any other offset would build a node-type
    # Toeplitz matrix inconsistent with the requested pole positions
    if delta not in (0.0, 0.5):
        raise ValueError(f"delta must be 0.0 (midpoint poles) or 0.5 (node poles), got {delta}")


def pv_coefficient_vector(n_intervals, delta):
    """The float64 coefficients [4m] of one table, m = ``n_intervals``.

    [0, 2m - 1): the interior coefficient c[d] at index d + m - 1 (index 0,
    d = 1 - m, is never read and holds 0); [2m - 1]: 0; [2m, 3m): row 0 of K;
    [3m, 4m): row m of K.
    """
    _check_delta(delta)
    m = n_intervals
    e = np.arange(-(m - 1), m)  # i - p, at index e + m - 1
    T = _toeplitz_entries(e, delta)
    W = 1.0 + (delta - e) * T
    a, b = 0.5 * T - W, 0.5 * T + W  # node j as the left end of interval j, as the right end of interval j - 1
    p = np.arange(m)
    out = np.zeros(4 * m)
    out[1 : 2 * m - 1] = a[1:] + b[:-1]  # c[d] = a(d) + b(d - 1), d = 2 - m .. m - 1
    out[2 * m : 3 * m] = a[m - 1 - p]  # K[0, p] = a(-p)
    out[3 * m :] = b[2 * m - 2 - p]  # K[m, p] = b(m - 1 - p)
    return out


def dense_from_coefficients(coef):
    """K [m + 2, m] of one table from its coefficient vector [4m] (numpy or torch), by the K9 kernel's index rule."""
    m = coef.shape[-1] // 4
    j, p = np.arange(1, m)[:, None], np.arange(m)[None, :]
    idx = j - p + m - 1
    if isinstance(coef, torch.Tensor):
        idx = torch.as_tensor(idx, device=coef.device)
        zero = torch.zeros((1, m), dtype=coef.dtype, device=coef.device)
        return torch.cat([coef[2 * m : 3 * m][None], coef[idx], coef[3 * m :][None], zero])
    return np.concatenate([coef[None, 2 * m : 3 * m], coef[idx], coef[None, 3 * m :], np.zeros((1, m))])


def pv_combined_kernel_np(n_intervals, delta):
    """Fully precombined PV-table matrix K [N, M] (host float64): table = f @ K.

    ``delta`` 0.0 gives the midpoint-pole table, 0.5 the node-pole table.
    """
    return dense_from_coefficients(pv_coefficient_vector(n_intervals, delta))


@functools.lru_cache(maxsize=8)
def pv_coefficients(n_intervals, dtype, device):
    """The K9 kernel's operand [2, 4m]: the midpoint table's coefficients, then the node table's."""
    vecs = np.stack([pv_coefficient_vector(n_intervals, delta) for delta in (0.0, 0.5)])
    return torch.as_tensor(vecs, dtype=dtype, device=device)


@functools.lru_cache(maxsize=8)
def pv_dense(n_intervals, dtype, device):
    """The plain twin's (K_mid, K_node) [m + 2, m]: ``pv_coefficients``'s operand expanded by the
    K9 kernel's index rule, once per (m, dtype, device)."""
    coef = pv_coefficients(n_intervals, dtype, device)
    return dense_from_coefficients(coef[0]), dense_from_coefficients(coef[1])


def pv_tables_matmul(f, kmid, knode):
    """Midpoint + node PV tables: f [..., N] -> ([..., M], [..., M-1])."""
    return f @ kmid, (f @ knode)[..., : kmid.shape[1] - 1]


def pv_tables(f, coef):
    """Differentiable interleaved pole table [B, 2M - 1] (midpoint poles at even, node poles at
    odd entries) of integrands f [B, N]: ``ops.pv_tables.PvTables`` (the plain twin on the CPU,
    the K9 kernel, forward and transposed, on the card)."""
    from ...ops.pv_tables import PvTables, plain
    from .interp import plain_forms_on

    if plain_forms_on(f, coef):
        return plain(f, coef)
    return PvTables.apply(f, coef)


# ------------------------------------------------------------------ pole-aware integration

_BRANCH_RTOL = 1.0e-4  # the far/near split of an interval, as the JAX package (and its reference) sets it


def _safe(x, cond):
    """``x`` where ``cond`` holds, 1 elsewhere (the entries of the branch that is not taken)."""
    return torch.where(cond, x, torch.ones_like(x))


def _ratcen_terms(fav, fdif, gav, gdif):
    """The real part of the rationally centred integrand of each interval [..., N] from the averages and
    differences of f and g there."""
    tmp = fav * gdif - gav * fdif
    # far from a pole (|gdif| < rtol |gav|): the smooth rational form
    far = torch.abs(gdif) < _BRANCH_RTOL * torch.abs(gav)
    gav_safe = _safe(gav, far)
    rf = fav / gav_safe + tmp * gdif / (12.0 * gav_safe**3)
    # near a pole: log|gav + gdif/2| - log|gav - gdif/2| (the real part of the complex log; its i pi residue is
    # dropped, the principal value), floored at the dtype's tiny so that a pole on a node stays finite in AD
    gdif_safe = _safe(gdif, ~far)
    tiny = torch.finfo(gav.dtype).tiny
    ap = torch.clamp(torch.abs(gav + 0.5 * gdif), min=tiny)
    am = torch.clamp(torch.abs(gav - 0.5 * gdif), min=tiny)
    rfn = fdif / gdif_safe + tmp * (torch.log(ap) - torch.log(am)) / gdif_safe**2
    return torch.where(far, rf, rfn)


def ratcen(f, g):
    """Per-interval values [..., N - 2] of f [..., N] over g [N]: the intervals (i, i + 1), i = 0..N - 3 (the last
    interval dropped, as in the reference)."""
    fdif = f[..., 1:-1] - f[..., 0:-2]
    gdif = g[1:-1] - g[0:-2]
    fav = 0.5 * (f[..., 1:-1] + f[..., 0:-2])
    gav = 0.5 * (g[1:-1] + g[0:-2])
    return _ratcen_terms(fav, fdif, gav, gdif)


def ratintn(f, g, z):
    """int f / g dz with f, g piecewise linear on the grid z [N]: f [N] -> a scalar, f [..., N] -> [...]."""
    squeeze = f.dim() == 1
    f = f[None] if squeeze else f
    out = torch.sum(ratcen(f, g) * (z[1:-1] - z[0:-2]), dim=-1)
    return out[0] if squeeze else out


def pv_integral(f, z, poles):
    """PV int f(z') / (z' - p) dz' for every pole p of ``poles`` (any shape), f piecewise linear on the grid z [N].

    f [N] serves all poles; f [..., N] broadcasts against the poles flattened to [P, 1] (f [P, N] with poles
    [P]: one pole a row).  One [P, N - 2] evaluation of ``_ratcen_terms``.
    """
    p = poles.reshape(-1)[:, None]
    zmid, zdif = 0.5 * (z[1:-1] + z[0:-2]), z[1:-1] - z[0:-2]
    fav = 0.5 * (f[..., 1:-1] + f[..., 0:-2])
    fdif = f[..., 1:-1] - f[..., 0:-2]
    gav = zmid - p
    vals = _ratcen_terms(fav, fdif, gav, torch.broadcast_to(zdif, gav.shape))
    return torch.sum(vals * zdif, dim=-1).reshape(poles.shape)


# ------------------------------------------------------------------ float64 oracles


def pv_toeplitz_kernel(n_intervals):
    """T[p, i] = L(i - p), L(d) = log|d + 1/2| - log|d - 1/2| (float64, numpy): midpoint poles."""
    d = np.arange(n_intervals)[None, :] - np.arange(n_intervals)[:, None]
    return _toeplitz_entries(d, 0.0)


def pv_node_kernel(n_intervals):
    """Tn[q, i] = Ln(i - q - 1), Ln(d) = log|d + 1| - log|d| with Ln(0) = Ln(-1) = 0 (float64, numpy): node poles."""
    d = np.arange(n_intervals)[None, :] - np.arange(n_intervals)[:, None]
    return _toeplitz_entries(d, 0.5)


def _fav_fdif(f):
    return 0.5 * (f[..., 1:-1] + f[..., 0:-2]), f[..., 1:-1] - f[..., 0:-2]


def pv_integral_uniform(f, z, kernel=None):
    """(midpoint poles [N-2], PV integrals [..., N-2]) of f [..., N] on the uniform grid z [N].

    out[p] = sum_i fdif_i + T @ (fav - i fdif) + p (T @ fdif), the two-stage Toeplitz form.
    """
    fav, fdif = _fav_fdif(f)
    m = fav.shape[-1]
    T = torch.as_tensor(pv_toeplitz_kernel(m) if kernel is None else kernel, dtype=f.dtype, device=f.device)
    idx = torch.arange(m, dtype=f.dtype, device=f.device)
    out = torch.sum(fdif, dim=-1, keepdim=True) + (fav - idx * fdif) @ T.T + idx * (fdif @ T.T)
    return 0.5 * (z[1:-1] + z[0:-2]), out


def pv_integral_uniform_nodes(f, z, kernel=None):
    """(node poles [N-3], PV integrals [..., N-3]) of f [..., N] on the uniform grid z [N], poles at z[1:-2]."""
    fav, fdif = _fav_fdif(f)
    m = fav.shape[-1]
    Tn = torch.as_tensor(pv_node_kernel(m) if kernel is None else kernel, dtype=f.dtype, device=f.device)
    idx = torch.arange(m, dtype=f.dtype, device=f.device)
    out = torch.sum(fdif, dim=-1, keepdim=True) + (fav - (idx + 0.5) * fdif) @ Tn.T + (idx + 1.0) * (fdif @ Tn.T)
    return z[1:m], out[..., : m - 1]
