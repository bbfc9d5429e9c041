"""Spectral density S(k, omega): 1V distributions reduced over angles, and 2V (ARTS) distributions.

The counterpart of ``tsadar_tpu.core.physics.form_factor`` for the 1V
non-angular path (``FormFactor.reduced_1v``) and the 2V table mode
(``FormFactor.calc_in_2D``).  Where JAX vmaps one lineout,
every function here carries the lineout batch as its leading dimension:
fields are [B, G, L, A] (lineout, gradient point, wavelength, angle) and ion
species ride a trailing [S] axis.  The 2V path is unbatched, as in JAX: it
runs the same field functions with B = 1 and returns [G, L, A].

The front half (``_lookups_1v``) forms the electron phase velocities xi_e,
looks up log f_e there (cubic Hermite), builds the chi_R principal-value pole
table of the EDF (``ratint.pv_tables``: the K9 kernel on the card) and looks
chi_R up on it (linear); the tail (``_reduced_tail``) is kinematics, ion susceptibility,
the electron Landau term, the S(k, omega) assembly and the weighted
angle/gradient sum.  On the card both lookups and the whole tail run as
hand-written CUDA kernels, forward and backward (``tsadar_tpu_torch/ops``), as does the pole table;
on the CPU the plain functions below run, and they are the kernels' oracles.

The 2V path (``calc_in_2D``) projects the 2D EDF onto a dense periodic angle
grid once per call (a Radon transform by the Fourier slice theorem:
``_project_all_nudft`` on the card, ``_project_all_fourier`` on the CPU, the
JAX package's own rule by backend), builds the chi_R pole table of every
projection with one matmul, and looks all three tables up at every
(wavelength, angle) point through ``interp.chi_bilinear_lookup``: the K7/K8
kernels on the card, their plain twins on the CPU.

The unreduced 1V ``unreduced_1v`` (the per-component spectra of a breakdown)
and ``__call__`` (the ARTS 1V deck, unbatched) run the same two lookups and the
tail's plain form without its reduction.

``projection="rotate"`` builds the same tables from per-angle bicubic
rotations of the EDF (``rotate``, ``_project``), summed over the
perpendicular axis, on every device, in chunks of ``ROTATE_CHUNK`` angles that
the backward recomputes.  ``mode="exact"`` skips the tables: every point
projects the EDF along its own beta (``calc_chi_vals``: the rotation, its
gradient, ``jnp.interp`` of both at |xi_e| and the pole-aware
``ratint.pv_integral``), in chunks of ``EXACT_CHUNK`` points whose
intermediates the backward recomputes (``torch.utils.checkpoint``); plain
tensor code on every device, as the JAX package's is plain ``jnp``.  The
gradient reaches Te, ne, lam, Va and ud through each point's rotation angle.

``shard_points=True`` splits table mode's evaluation points between the ranks
of a process group (``parallel.dist``), the JAX package's point sharding: each
rank looks up its contiguous slice of the flattened (beta, |xi_e|, k lambda_De)
in the replicated tables (the layout step and K7 on the card), and
``gather_points`` returns the whole chi arrays to every rank, where the
spectrum's assembly runs replicated, as the JAX package re-replicates them.
Backward, K8 runs on the rank's slice, the tables' cotangent is summed over
the ranks and the queries' gathered (``replicated_input``, ``scatter_points``):
every rank's gradient is the unsharded one.  The exact mode ignores the flag,
and so does a process of one rank or none.
"""

import functools
import math

import numpy as np
import torch

from . import ratint
from .constants import C, ME_KEV, MP_KEV, RE_CM, PLASMA_FREQ_CONST
from ...parallel import dist as par
from torch.utils.checkpoint import checkpoint

from .interp import (bicubic_at, bicubic_slopes, chi_bilinear_lookup, chi_tables, cubic_lookup, interp1d,
                     interp1d_cubic_matmul, lin_lookup, plain_forms_on)
from .zprime import zprime

# probe angular-frequency numerator: omgL = OMGL_NUM / lam  (lam in nm, omgL in 1/s)
OMGL_NUM = 2.0 * np.pi * 1.0e7 * C
ROTATE_CHUNK = 32  # angles a chunk of the rotate projection's tables (the JAX package maps 32 at a time)
# points a chunk of the exact mode: the JAX package maps 128 at a time; the card takes more, for fewer launches
# (at nvx 128 a chunk's recomputed backward holds ~40 tensors of 1024 x 128 x 128 floats, ~2.7 GB)
EXACT_CHUNK = {"cpu": 128, "cuda": 1024}


def _nudft_args(betas, n):
    """Host float64 phase arguments of the NUDFT central slice, P = 2n:
    argx, argy [len(betas), P, n] = 2 pi r_k (cos, sin)(beta_b) (j - c) / P."""
    P = 2 * n
    r = np.fft.fftfreq(P) * P
    idx = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    argx = (2.0 * np.pi / P) * np.cos(betas)[:, None, None] * r[None, :, None] * idx[None, None, :]
    argy = (2.0 * np.pi / P) * np.sin(betas)[:, None, None] * r[None, :, None] * idx[None, None, :]
    return argx, argy


def _trig_tables(betas, n, dtype, device):
    argx, argy = _nudft_args(betas, n)
    nb, P = len(betas), 2 * n
    host = (np.cos(argx).reshape(nb * P, n), np.sin(argx).reshape(nb * P, n), np.cos(argy), np.sin(argy))
    return tuple(torch.as_tensor(t, dtype=dtype, device=device) for t in host)


@functools.lru_cache(maxsize=4)
def _nudft_trig_tables(B, n, dtype=torch.float64, device="cpu"):
    """NUDFT central-slice trig tables on the dense angle grid linspace(0, 2 pi, B, endpoint=False).

    (ex_r, ex_i) [B * P, n] and (ey_r, ey_i) [B, P, n] for P = 2n.  They depend
    only on the sizes: computed once on the host in float64, then rounded to
    ``dtype`` and kept on ``device`` (treat them as read-only).
    """
    return _trig_tables(np.linspace(0.0, 2.0 * np.pi, B, endpoint=False), n, dtype, device)


@functools.lru_cache(maxsize=4)
def _nudft_trig_tables_quarter(B, n, dtype=torch.float64, device="cpu"):
    """The rows k = 0..B/4 (inclusive) of ``_nudft_trig_tables``: the first quadrant.

    beta -> pi - beta flips cos(beta) only and beta -> 2 pi - beta flips
    sin(beta) only, so every other row is a sign recombination of these
    (``_project_all_nudft``): a quarter of the table and of the projection's
    matmul.  At B = 256, n = 128 the four tables hold 34 MB in float32.
    """
    if B % 4:
        raise ValueError(f"the quarter tables need B % 4 == 0, got {B}")
    return _trig_tables(np.linspace(0.0, 2.0 * np.pi, B, endpoint=False)[: B // 4 + 1], n, dtype, device)


def _slice_spectrum_full(DF, B):
    """(real, imag) [B, 2n] of the EDF's central-slice spectrum at every angle of the grid, from the
    full trig tables: one [B P, n] @ [n, n] product over x and an elementwise contraction over y."""
    n = DF.shape[0]
    ex_r, ex_i, ey_r, ey_i = _nudft_trig_tables(B, n, DF.dtype, DF.device)
    inner_r = (ex_r @ DF.T).reshape(B, 2 * n, n)
    inner_i = (-ex_i @ DF.T).reshape(B, 2 * n, n)
    return torch.sum(ey_r * inner_r + ey_i * inner_i, dim=-1), torch.sum(ey_r * inner_i - ey_i * inner_r, dim=-1)


def _slice_spectrum_quarter(DF, B):
    """``_slice_spectrum_full`` from the first-quadrant tables, for B % 4 == 0.

    With a = cos(beta), s = sin(beta) and inner[b, k, y] = sum_x DF[y, x] e^{-i w a r_k x~},
    beta -> 2 pi - beta (s -> -s) and beta -> pi - beta (a -> -a) turn the four partial sums
      A = sum_y ey_r inner_r   Bm = sum_y ey_i inner_i   C = sum_y ey_r inner_i   D = sum_y ey_i inner_r
    of the first-quadrant rows into all B slice spectra:
      S[k] = (A+Bm) + i(C-D)      S[B/2-k] = (A-Bm) + i(-C-D)
      S[B/2+k] = (A+Bm) + i(-C+D)  S[B-k] = (A-Bm) + i(C+D)
    """
    n, Q = DF.shape[0], B // 4
    ex_r, ex_i, ey_r, ey_i = _nudft_trig_tables_quarter(B, n, DF.dtype, DF.device)
    inner_r = (ex_r @ DF.T).reshape(Q + 1, 2 * n, n)
    inner_i = (-ex_i @ DF.T).reshape(Q + 1, 2 * n, n)
    A = torch.sum(ey_r * inner_r, dim=-1)
    Bm = torch.sum(ey_i * inner_i, dim=-1)
    Cc = torch.sum(ey_r * inner_i, dim=-1)
    D = torch.sum(ey_i * inner_r, dim=-1)
    apb, amb, cmd, cpd = A + Bm, A - Bm, Cc - D, Cc + D
    flip = lambda x: torch.flip(x, dims=(0,))  # noqa: E731
    S_r = torch.cat([apb[: Q + 1], flip(amb[1:Q]), apb[:Q], flip(amb[1 : Q + 1])])
    S_i = torch.cat([cmd[: Q + 1], flip(-cpd[1:Q]), (-cmd)[:Q], flip(cpd[1 : Q + 1])])
    return S_r, S_i


@functools.lru_cache(maxsize=8)
def _pv_midpoint_kernel(n_intervals, dtype, device):
    return torch.as_tensor(ratint.pv_combined_kernel_np(n_intervals, 0.0), dtype=dtype, device=device)


def _gradient_last(f, h):
    """jnp.gradient(f, h, axis=-1): central differences inside, one-sided at the two ends."""
    return torch.cat([f[..., 1:2] - f[..., :1], (f[..., 2:] - f[..., :-2]) * 0.5, f[..., -1:] - f[..., -2:-1]], dim=-1) / h


def _kinematics_fields(sarad, omgs, ne, Te, lam, Va, ud):
    """Scattering kinematics fields.

    sarad [A], omgs [L], ne/Te [B, G], lam/Va/ud [B] ->
    (omgL [B,1,1,1], k, omgdop [B,G,L,A], vTe [B,G,1,1], klde, xie [B,G,L,A]).
    """
    omgL = OMGL_NUM / lam[:, None, None, None]
    omgpe = PLASMA_FREQ_CONST * torch.sqrt(ne[..., None, None])
    w = omgs[:, None]
    omg = w - omgL

    ks = torch.sqrt(w**2 - omgpe**2) / C
    kL = torch.sqrt(omgL**2 - omgpe**2) / C
    k = torch.sqrt(ks**2 + kL**2 - 2.0 * ks * kL * torch.cos(sarad))

    omgdop = omg - k * Va[:, None, None, None]

    vTe = torch.sqrt(Te[..., None, None] / ME_KEV)
    klde = (vTe / omgpe) * k
    xie = omgdop / (k * vTe) - ud[:, None, None, None] / vTe
    return omgL, k, omgdop, vTe, klde, xie


def _ion_fields(omgdop, k_mag, ne, Z, Ti, fract, A):
    """Real/imag ion susceptibility summed over species, with xii [B,G,L,A,S],
    vTi and Zbar [B,1,1,1,(1|S)]; species arrays are [B, S]."""
    sp = lambda x: x[:, None, None, None, :]  # noqa: E731
    Z, Ti, fract, A = sp(Z), sp(Ti), sp(fract), sp(A)
    Mi = A * MP_KEV
    Zbar = torch.sum(Z * fract, dim=-1, keepdim=True)
    ni = fract * ne[..., None, None, None] / Zbar  # [B,G,1,1,S]
    omgpi = PLASMA_FREQ_CONST * Z * torch.sqrt(ni * ME_KEV / Mi)
    vTi = torch.sqrt(Ti / Mi)
    kldi = (vTi / omgpi) * k_mag[..., None]
    xii = (omgdop / k_mag)[..., None] / (math.sqrt(2.0) * vTi)
    ZpiR, ZpiI = zprime(xii)
    ciR = torch.sum(-0.5 / (kldi**2) * ZpiR, dim=-1)
    ciI = torch.sum(-0.5 / (kldi**2) * ZpiI, dim=-1)
    return ciR, ciI, xii, vTi, Zbar


def _assemble_fields(k_mag, ceR, ceI, ciR, ciI, fe_vphi, vTe, xii, vTi, Z, fract, Zbar, omgdop, omgL, ne, lams):
    """S(k, omega) in wavelength units [B,G,L,A] from real/imag susceptibilities."""
    epsR = 1.0 + ceR + ciR
    epsI = ceI + ciI
    E2 = epsR**2 + epsI**2
    AE2 = ceR**2 + ceI**2  # |chiE|^2
    BI2 = (1.0 + ciR) ** 2 + ciI**2  # |1 + chiI|^2

    icf = fract[:, None, None, None, :] * Z[:, None, None, None, :] ** 2 / Zbar / vTi
    ion_comp = icf * (AE2[..., None] * torch.exp(-(xii**2)) / math.sqrt(2.0 * math.pi))
    ele_comp = BI2 * fe_vphi / vTe

    SKW_ion = torch.sum(1.0 / k_mag[..., None] * ion_comp / E2[..., None], dim=-1)
    SKW_ele = 1.0 / k_mag * ele_comp / E2

    # PsOmg = SKW (1 + 2 omgdop / omgL) RE^2 ne, times 2 pi C / lams^2 for wavelength units.  The
    # constant factors are gathered first: multiplied onto the spectrum one by one, their float32
    # cotangents overflow in the backward (g / lams^2 * 2 pi C * ne reaches 1e39)
    scale = (RE_CM**2 * 2.0 * math.pi * C) * ne[..., None, None] / lams[:, None] ** 2
    return (SKW_ion + SKW_ele) * (1.0 + 2.0 * omgdop / omgL) * scale


def _spectrum_tail(lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, sarad, omgs, lfc=None):
    """The unreduced 1V spectrum [B, G, L, A] from the two lookups: kinematics, ion susceptibility,
    the electron Landau term and the S(k, omega) assembly.  Shapes as in ``_reduced_tail``."""
    omgL, k, omgdop, vTe, klde, xie = _kinematics_fields(sarad, omgs, ne, Te, lam, Va, ud)
    ciR, ciI, xii, vTi, Zbar = _ion_fields(omgdop, k, ne, Z, Ti, fract, A)

    fe_vphi = torch.exp(lf if lfc is None else lf + lfc[:, None, None, None])
    if lf.dtype == torch.float64:  # the digits to subtract the two f_e directly, as the JAX package does
        dfe = torch.diff(fe_vphi, dim=2)
    else:
        # f_e[l + 1] - f_e[l] = f_e[l] expm1(lf[l + 1] - lf[l]), as the kernels form it: at the ion window
        # neighbouring xi_e differ by ~1e-5 and f_e by ~1e-7 of itself, below float32's resolution of f_e
        dfe = fe_vphi[:, :, :-1] * torch.expm1(torch.diff(lf, dim=2))
    df = dfe / torch.diff(xie, dim=2)
    df = torch.cat([df, torch.zeros_like(fe_vphi[:, :, :1])], dim=2)  # 0 at the last wavelength (and at L = 1)
    # electron Landau term with the Kramers-Kronig-consistent MINUS sign
    # (the JAX package's documented fix of the reference's +pi)
    ceR = -1.0 / (klde**2) * chiERraw
    ceI = -math.pi / (klde**2) * df

    lams = 2.0 * math.pi * C / omgs
    return _assemble_fields(k, ceR, ceI, ciR, ciI, fe_vphi, vTe, xii, vTi, Z, fract, Zbar, omgdop, omgL, ne, lams)


def _reduced_tail(lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, weights, sarad, omgs, lfc=None):
    """Angle-weighted, gradient-averaged spectrum [B, L] from the two lookups.

    lf, chiERraw [B,G,L,A]; ne/Te [B,G]; lam/Va/ud [B]; A/Z/Ti/fract [B,S];
    weights a scalar or [A]; sarad [A]; omgs [L]; lfc [B] or None (0): the
    shift of each lineout's log f_e, log f_e = lf + lfc.  The plain form of
    the ``spectrum_tail_fwd`` kernel.
    """
    PsLam = _spectrum_tail(lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, sarad, omgs, lfc)
    return torch.sum(torch.mean(PsLam, dim=1) * weights, dim=-1)


def _linspace_rows(half_pct, num):
    """Per-row jnp.linspace(1 - p/200, 1 + p/200, num) for p [B] -> [B, num]."""
    start = 1.0 - half_pct / 200.0
    if num == 1:
        return start[:, None]
    stop = 1.0 + half_pct / 200.0
    step = torch.arange(num - 1, dtype=half_pct.dtype, device=half_pct.device) / (num - 1)
    out = start[:, None] * (1 - step) + stop[:, None] * step
    return torch.cat([out, stop[:, None]], dim=1)


def _batch_of_one(params):
    """Unbatched physical parameters as a batch of one lineout: a leading axis on everything
    but the velocity grid and a 2D EDF (a 1D EDF [nv] becomes [1, nv])."""
    lead = lambda k, v: v if k == "v" or (k == "fe" and v.dim() == 2) else v[None]  # noqa: E731
    return {g: {k: lead(k, v) for k, v in d.items()} for g, d in params.items()}


class FormFactor:
    """Spectral density on one wavelength range: 1V for a batch of lineouts, 2V for one image.

    Args:
        lambda_range: (start, end) wavelengths [nm].
        npts: number of wavelength points.
        lam_shift: spectral shift applied to the probe wavelength [nm].
        scattering_angles: dict with "sa" (angles, degrees).
        num_grad_points: number of plasma-gradient sample points.
        device, dtype: where and in which precision the tables live.
        ud_ang, va_ang: angles of electron drift and ion flow from the x axis [deg] (2V only).
        num_beta: angle-grid resolution of the 2V projection tables.
        mode: "table" (the projections tabulated on the angle grid, then looked up) or "exact" (each point's
            own projection, the reference's semantics) (2V only).
        projection: "fourier" (the slice theorem: NUDFT on the card, fft2 on the CPU) or "rotate" (bicubic
            rotations of the EDF on every device): how table mode projects (2V only).
        shard_points: split table mode's chi evaluation points between the ranks of a process group (2V only).
    """

    def __init__(self, lambda_range, npts, lam_shift, scattering_angles, num_grad_points, device, dtype,
                 ud_ang=None, va_ang=None, num_beta=256, mode="table", projection="fourier", shard_points=False):
        if mode not in ("table", "exact"):
            raise ValueError(f"2V mode must be 'table' or 'exact', got {mode!r}")
        if projection not in ("fourier", "rotate"):
            raise ValueError(f"2V projection must be 'fourier' or 'rotate', got {projection!r}")
        self.ud_angle, self.va_angle, self.num_beta = ud_ang, va_ang, num_beta
        self.mode, self.projection, self.shard_points = mode, projection, shard_points
        as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
        lamAxis = np.linspace(lambda_range[0], lambda_range[1], npts)
        self.omgs = as_t(2.0e7 * np.pi * C / lamAxis)  # scattered frequency axis [L], 1/s

        # xi grid of the chi_R pole sweep and the coefficients of its PV tables;
        # interleaved midpoint + node poles give a table of 2 h1 - 5 entries
        minmax, h1 = 8.2, 1024
        xi1 = np.linspace(-minmax - math.sqrt(2.0) / h1, minmax + math.sqrt(2.0) / h1, h1)
        self.xi1 = as_t(xi1)
        self.dxi1 = float(xi1[1] - xi1[0])
        self._pv_coef = ratint.pv_coefficients(h1 - 2, dtype, device)
        mid_poles = 0.5 * (xi1[1:-1] + xi1[0:-2])
        node_poles = xi1[1 : h1 - 2]
        poles = np.zeros(mid_poles.size + node_poles.size)
        poles[0::2], poles[1::2] = mid_poles, node_poles
        self.pv_poles = as_t(poles)  # [2 h1 - 5], the chi_R table's grid
        self.pv_x0 = float(self.pv_poles[0])
        self.pv_dx = float(self.pv_poles[1] - self.pv_poles[0])

        self.lam_shift = lam_shift
        self.sarad = as_t(np.asarray(scattering_angles["sa"]) * np.pi / 180.0)
        self.num_grad_points = num_grad_points

    def _gradients(self, params):
        """ne [B, G], Te [B, G] profiles from the gradient percentages."""
        g = params["general"]
        ne = 1.0e20 * params["electron"]["ne"][:, None] * _linspace_rows(g["ne_gradient"], self.num_grad_points)
        Te = params["electron"]["Te"][:, None] * _linspace_rows(g["Te_gradient"], self.num_grad_points)
        return ne, Te

    @staticmethod
    def _ion_arrays(params):
        """Per-species ion parameters stacked to [B, S]: (A, Z, Ti, fract)."""
        keys = [k for k in params.keys() if "ion" in k]
        return tuple(torch.stack([params[k][name] for k in keys], dim=-1) for name in ("A", "Z", "Ti", "fract"))

    def _lookup_inputs_1v(self, params):
        """The two lookups' operands and the tail's parameters: (xie [B, G, L, A], log_fe [B, nv],
        cubic meta [B, 3], chi_R pole table [B, 2 h1 - 5], (ne, Te, lam, Va, ud, A, Z, Ti, fract))."""
        ne, Te = self._gradients(params)
        lam = params["general"]["lam"] + self.lam_shift
        Va = params["general"]["Va"] * 1e6  # 1e6 cm/s
        ud = params["general"]["ud"] * 1e6
        fe = params["electron"]["fe"]  # [B, nv]
        vx = params["electron"]["v"]  # [nv], shared by all lineouts
        xie = _kinematics_fields(self.sarad, self.omgs, ne, Te, lam, Va, ud)[-1]
        B = xie.shape[0]

        # the floor must be representable in the working dtype, or log(0) = -inf
        # from an exact zero in the EDF tail would spread through the matmul
        log_fe = torch.log(torch.clamp(fe, min=torch.finfo(fe.dtype).tiny)).contiguous()
        meta = torch.stack([vx[0], vx[1] - vx[0], torch.full_like(vx[0], vx.shape[0])]).expand(B, 3).contiguous()

        table = ratint.pv_tables(self._pv_integrand(log_fe, vx), self._pv_coef)  # K9 on the card
        return xie, log_fe, meta, table, (ne, Te, lam, Va, ud, *self._ion_arrays(params))

    def _pv_integrand(self, log_fe, vx):
        """d f_e / d xi [B, h1] on the pole sweep's grid xi1: the integrand of the PV tables."""
        ratmod = torch.exp(interp1d_cubic_matmul(self.xi1, vx, log_fe, (-50.0, -50.0)))
        return _gradient_last(ratmod, self.dxi1).contiguous()

    def _lookups_1v(self, params):
        """The lookups' outputs and the tail's parameters: (lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract,
        lfc).  In float32 lf is looked up on each lineout's log f_e less its largest entry lfc [B] (log f_e =
        lf + lfc, the interpolation being exact for constants): near the EDF's peak lf is then small, and so
        are its rounding errors, which the Landau term's difference of neighbouring f_e would otherwise
        amplify at the ion window.  In float64 lfc is 0, and the values are the JAX package's.  lfc carries
        no gradient: the tail depends on lf + lfc alone."""
        xie, log_fe, meta, table, rest = self._lookup_inputs_1v(params)
        vx = params["electron"]["v"]
        q = xie.reshape(xie.shape[0], -1)
        lfc = torch.amax(log_fe, dim=1).detach() if log_fe.dtype == torch.float32 else log_fe.new_zeros(log_fe.shape[0])
        lf = cubic_lookup(q, (log_fe - lfc[:, None]).contiguous(), meta)
        lf = torch.where((q < vx[0]) | (q > vx[-1]), -50.0 - lfc[:, None], lf)
        chiERraw = lin_lookup(q, table, self.pv_x0, self.pv_dx)
        return lf.view_as(xie), chiERraw.view_as(xie), *rest, lfc

    def tail_args(self, params, weights):
        """The fifteen arguments of ``_reduced_tail`` (and of the K5/K6 kernels) for ``params``."""
        *inputs, lfc = self._lookups_1v(params)
        return (*inputs, weights, self.sarad, self.omgs, lfc)

    def reduced_1v(self, params, weights):
        """(reduced spectrum [B, L], wavelength axis [L] in cm) through the spectrum tail.

        The tail is ``ops.spectrum_tail.SpectrumTail``: ``_reduced_tail`` and
        its autograd on the CPU, the K5/K6 kernels on the card.
        """
        args = self.tail_args(params, weights)
        reduced = _reduced_tail(*args)
        return reduced, 2.0 * math.pi * C / self.omgs

    def unreduced_1v(self, params):
        """(S(k, omega) [B, G, L, A], wavelength axis [L] in cm) of a batch of lineouts, unreduced.

        The two lookups (K1 and K3, with K9's pole table, on the card), then
        the tail in plain tensor code, as the JAX package leaves it to XLA:
        what the per-component spectra of a breakdown and the ARTS 1V deck need.
        """
        *inputs, lfc = self._lookups_1v(params)
        return _spectrum_tail(*inputs, self.sarad, self.omgs, lfc), 2.0 * math.pi * C / self.omgs

    def __call__(self, params):
        """(S(k, omega) [G, L, A], wavelength axis [L] in cm) for a 1D EDF, unreduced; ``params`` are unbatched
        (the angular spectrum's, one weight per camera angle and fine angle)."""
        skw, lam_axis = self.unreduced_1v(_batch_of_one(params))
        return skw[0], lam_axis

    # -------------------------------------------------------------------- 2V

    def _project_all_fourier(self, vx, DF, betas):
        """All 1D projections [len(betas), nvx] of the EDF by the Fourier slice theorem.

        The projection's 1D spectrum is the EDF's 2D spectrum along the line at
        angle beta: one zero-padded fft2, a bilinear sample of the de-ramped
        spectrum at len(betas) x 4 nvx points, the cell-centre phase, and a
        batch of inverse FFTs.  The CPU's projection, as in the JAX package.
        """
        n = vx.shape[0]
        P = 4 * n  # zero padding: wraparound + k-space interpolation density
        dv = vx[1] - vx[0]
        c = (n - 1) / 2.0  # v = (idx - c) dv on both axes

        F = torch.fft.fft2(DF, s=(P, P))  # DF indexed [y, x]
        r = torch.fft.fftfreq(P, dtype=DF.dtype, device=DF.device) * P  # signed frequency per unshifted index
        # the EDF is centred mid-array, so F carries a phase ramp that turns ~pi per sample: divide it
        # out on the grid and put it back at the fractional sample coordinates
        ramp = torch.polar(torch.ones_like(r), 2.0 * math.pi * c * r / P)
        G = F * ramp[:, None] * ramp[None, :]

        m_y = r[None, :] * torch.sin(betas)[:, None]  # [B, P] signed fractional k-space coordinates
        m_x = r[None, :] * torch.cos(betas)[:, None]
        fy, fx = torch.floor(m_y), torch.floor(m_x)
        iy0, ix0 = torch.remainder(fy.long(), P), torch.remainder(fx.long(), P)
        iy1, ix1 = torch.remainder(iy0 + 1, P), torch.remainder(ix0 + 1, P)
        wy, wx = m_y - fy, m_x - fx
        S = (
            G[iy0, ix0] * (1 - wy) * (1 - wx)
            + G[iy0, ix1] * (1 - wy) * wx
            + G[iy1, ix0] * wy * (1 - wx)
            + G[iy1, ix1] * wy * wx
        )
        phase = torch.polar(torch.ones_like(r), -2.0 * math.pi * r * c / P)
        p = torch.fft.ifft(S * phase[None, :], dim=-1).real * dv  # [B, P]
        return p[:, :n]

    def _project_all_nudft(self, vx, DF):
        """All 1D projections [num_beta, nvx] by an exact non-uniform DFT of the central slice.

        The angle grid is the fixed linspace(0, 2 pi, num_beta, endpoint=False)
        of ``_chi_tables``, baked into the host-built trig tables.  The slice
        spectrum S[b, k] = sum_{y,x} DF[y, x] exp(-2 pi i r_k (sin(b)(y - c) +
        cos(b)(x - c)) / P) separates into one matmul over x and an elementwise
        contraction over y (``_slice_spectrum_full``, or a quarter of it by
        symmetry): no k-space interpolation and no gather, so the backward is
        transposed matmuls.  The card's projection.
        """
        n = vx.shape[0]
        P = 2 * n  # alias-free: the projection's support spans fewer than P samples
        dv = vx[1] - vx[0]
        c = (n - 1) / 2.0
        slice_spectrum = _slice_spectrum_full if self.num_beta % 4 else _slice_spectrum_quarter
        S_r, S_i = slice_spectrum(DF, self.num_beta)
        r = torch.fft.fftfreq(P, dtype=DF.dtype, device=DF.device) * P
        phase = torch.polar(torch.ones_like(r), -2.0 * math.pi * r * c / P)
        p = torch.fft.ifft(torch.complex(S_r, S_i) * phase[None, :], dim=-1).real * dv  # [B, P]
        return p[:, :n]

    @staticmethod
    def _rotated(vx, DF, slopes, angle_deg):
        """The EDF DF [n, n] on the square grid vx, rotated by each angle of ``angle_deg`` [P] (degrees):
        [P, n, n], out[p, a, b] = DF at R(angle_p) (vx[a], vx[b]), so that index a runs along the angle.
        ``slopes``: ``bicubic_slopes(vx, vx, DF)``.  Differentiable in DF and in the angles."""
        beta = angle_deg * (math.pi / 180.0)
        c, s = torch.cos(beta)[:, None, None], torch.sin(beta)[:, None, None]
        S, T = vx[:, None], vx[None, :]  # meshgrid(vx, vx, indexing="ij"): S[a, b] = vx[a] along the angle
        xq, yq = c * S - s * T, s * S + c * T
        # DF is indexed [vy, vx]: the interpolation's rows are y, its columns x
        return bicubic_at(yq, xq, vx, vx, DF, *slopes)

    def rotate(self, vx, df, angle_deg):
        """The 2D EDF df [n, n] rotated so that its new x axis lies along ``angle_deg`` (degrees): out[a, b] is df at
        R(angle) (vx[a], vx[b]) in the EDF's own frame (bicubic, edge polynomials extrapolated).  The axis
        convention of the JAX package's ``FormFactor.rotate``, not ``utils.vector_tools.rotate_edf``'s."""
        angle = torch.as_tensor(angle_deg, dtype=df.dtype, device=df.device).reshape(1)
        return self._rotated(vx, df, bicubic_slopes(vx, vx, df), angle)[0]

    def _project(self, vx, DF, beta):
        """The 1D projection [n] of the EDF along the direction ``beta`` (radians): its line integrals over the
        perpendicular axis, on the vx grid."""
        return torch.sum(self.rotate(vx, DF, beta * 180.0 / math.pi), dim=1) * (vx[1] - vx[0])

    def _project_many(self, vx, DF, slopes, betas):
        """``_project`` at every angle of ``betas`` [P]: [P, n]."""
        return torch.sum(self._rotated(vx, DF, slopes, betas * 180.0 / math.pi), dim=-1) * (vx[1] - vx[0])

    def _project_all_rotate(self, vx, DF, betas):
        """All projections [len(betas), n] by rotation, ROTATE_CHUNK angles at a time; under autograd each
        chunk's rotations are recomputed in the backward instead of kept."""
        slopes = bicubic_slopes(vx, vx, DF)
        chunks = torch.split(betas, ROTATE_CHUNK)
        if torch.is_grad_enabled():
            return torch.cat([checkpoint(self._project_many, vx, DF, slopes, b, use_reentrant=False) for b in chunks])
        return torch.cat([self._project_many(vx, DF, slopes, b) for b in chunks])

    def _chi_tables(self, vx, DF):
        """Projections and chi tables on the dense periodic angle grid.

        Returns (betas [B] on [0, 2 pi), f1d [B, nvx], df1d [B, nvx], pole_grid
        [nvx - 2] (the midpoints), chiR_tab [B, nvx - 2] = PV int df/(v - p) dv).
        """
        betas = torch.arange(self.num_beta, dtype=DF.dtype, device=DF.device) * (2.0 * math.pi / self.num_beta)
        if self.projection == "rotate":
            f1d = self._project_all_rotate(vx, DF, betas)
        elif DF.device.type == "cuda":
            # the JAX package's rule by backend, keyed on the tensor's device: the exact NUDFT on the
            # accelerator, the fft2 slice on the CPU
            f1d = self._project_all_nudft(vx, DF)
        else:
            f1d = self._project_all_fourier(vx, DF, betas)
        df1d = _gradient_last(f1d, vx[1] - vx[0])
        # chi_R on the midpoint-pole grid: one [B, N] @ [N, M] product with the precombined PV matrix
        kernel = _pv_midpoint_kernel(vx.shape[0] - 2, DF.dtype, DF.device)
        pole_grid = 0.5 * (vx[1:-1] + vx[0:-2])
        return betas, f1d, df1d, pole_grid, df1d @ kernel

    def _chi_vals_exact(self, vx, DF, fx, fy, fxy, beta, xie_mag, klde_mag):
        """(fe_vphi, chiEI, chiERrat) [P] of P points, each from the EDF's projection along its own beta [P]."""
        dvx = vx[1] - vx[0]
        fe_1d = self._project_many(vx, DF, (fx, fy, fxy), beta)  # [P, n]
        df = _gradient_last(fe_1d, dvx)
        fe_vphi = interp1d(xie_mag, vx, fe_1d)
        dfe = interp1d(xie_mag, vx, df)
        # electron Landau term with the Kramers-Kronig-consistent MINUS sign (see ``_reduced_tail``)
        chiEI = -math.pi / (klde_mag**2) * dfe
        chiERrat = -1.0 / (klde_mag**2) * ratint.pv_integral(df, vx, xie_mag)
        return fe_vphi, chiEI, chiERrat

    def calc_chi_vals(self, vx, DF, inputs):
        """Exact mode at one point: (fe_vphi, chiEI, chiERrat) from ``inputs`` = (beta, xie_mag, klde_mag), 0-d."""
        one = [torch.as_tensor(a, dtype=DF.dtype, device=DF.device).reshape(1) for a in inputs]
        return tuple(o[0] for o in self._chi_vals_exact(vx, DF, *bicubic_slopes(vx, vx, DF), *one))

    def _all_chi_vals_exact(self, vx, DF, beta, xie_mag, klde_mag):
        """``_chi_vals_exact`` over every point, EXACT_CHUNK at a time; under autograd each chunk is recomputed
        in the backward (each point rotates the whole EDF: at the ARTS deck's full width the intermediates of
        all chunks together would take hundreds of GB)."""
        slopes = bicubic_slopes(vx, vx, DF)
        size = EXACT_CHUNK.get(DF.device.type, EXACT_CHUNK["cpu"])
        chunks = zip(*(torch.split(a.reshape(-1), size) for a in (beta, xie_mag, klde_mag)))
        if torch.is_grad_enabled():
            outs = [checkpoint(self._chi_vals_exact, vx, DF, *slopes, *c, use_reentrant=False) for c in chunks]
        else:
            outs = [self._chi_vals_exact(vx, DF, *slopes, *c) for c in chunks]
        return tuple(torch.cat(o).reshape(beta.shape) for o in zip(*outs))

    def calc_all_chi_vals(self, vx, DF, beta, xie_mag, klde_mag):
        """(fe at the phase velocity, chiEI, chiERrat) at every evaluation point.

        Table mode: one fused lookup of the stacked (f1d | df1d | chi_R)
        tables, ``interp.chi_bilinear_lookup`` (the K7/K8 kernels on the
        card), on this rank's slice of the points with ``shard_points``.
        Exact mode: each point's own projection (``calc_chi_vals``).
        """
        if self.mode == "exact":
            return self._all_chi_vals_exact(vx, DF, beta, xie_mag, klde_mag)
        _, f1d, df1d, pole_grid, chiR_tab = self._chi_tables(vx, DF)
        Tcat, T4 = chi_tables(f1d, df1d, chiR_tab)  # [B, 3 nvx - 2], and its quad layout on the card
        ranks = par.point_ranks() if self.shard_points else None
        shape = beta.shape
        if ranks is not None:  # this rank's slice of the points; the tables' cotangent summed over the ranks
            beta, xie_mag, klde_mag = par.scatter_points(torch.stack([beta, xie_mag, klde_mag], -1).reshape(-1, 3),
                                                         ranks).unbind(-1)
            Tcat = par.replicated_input(Tcat, ranks)
        fe_vphi, dfe, chiR_raw = chi_bilinear_lookup(
            Tcat, beta, xie_mag, vx[0], vx[1] - vx[0], pole_grid[0], pole_grid[1] - pole_grid[0], T4
        )
        # electron Landau term with the Kramers-Kronig-consistent MINUS sign (see ``_reduced_tail``)
        chiEI = -math.pi / (klde_mag**2) * dfe
        chiERrat = -1.0 / (klde_mag**2) * chiR_raw
        if ranks is not None:  # the whole arrays on every rank
            out = par.gather_points(torch.stack([fe_vphi, chiEI, chiERrat], -1), ranks, math.prod(shape))
            fe_vphi, chiEI, chiERrat = (o.reshape(shape) for o in out.unbind(-1))
        return fe_vphi, chiEI, chiERrat

    def _fields_2v(self, params):
        """The 2V kinematics of unbatched ``params``, as a batch of one: a dict of the fields [1, G, L, A]
        (and the per-species arrays) that the chi lookup and the assembly take; ``beta`` and ``xie_mag``
        are the lookup's queries."""
        batched = _batch_of_one(params)
        ne, Te = self._gradients(batched)
        gen = batched["general"]
        lam = gen["lam"] + self.lam_shift
        A, Z, Ti, fract = self._ion_arrays(batched)
        Va_mag, ud_mag = gen["Va"] * 1e6, gen["ud"] * 1e6

        va_ang = math.radians(0.0 if self.va_angle is None else self.va_angle)
        ud_ang = math.radians(0.0 if self.ud_angle is None else self.ud_angle)
        bc = lambda x: x[:, None, None, None]  # noqa: E731  [B] -> [B, 1, 1, 1]
        Va = (bc(Va_mag) * math.cos(va_ang), bc(Va_mag) * math.sin(va_ang))
        ud = (bc(ud_mag) * math.cos(ud_ang), bc(ud_mag) * math.sin(ud_ang))

        omgL = bc(OMGL_NUM / lam)
        omgpe = PLASMA_FREQ_CONST * torch.sqrt(ne[..., None, None])  # [B, G, 1, 1]
        w = self.omgs[:, None]  # [L, 1]
        omg = w - omgL

        kL = torch.sqrt(omgL**2 - omgpe**2) / C  # along x
        ks_mag = torch.sqrt(w**2 - omgpe**2) / C
        k = (torch.cos(self.sarad) * ks_mag - kL, torch.sin(self.sarad) * ks_mag)
        k_mag = torch.sqrt(k[0] * k[0] + k[1] * k[1])  # [B, G, L, A]

        omgdop = omg - (k[0] * Va[0] + k[1] * Va[1])
        vTe = torch.sqrt(Te[..., None, None] / ME_KEV)
        klde_mag = (vTe / omgpe) * k_mag
        ciR, ciI, xii, vTi, Zbar = _ion_fields(omgdop, k_mag, ne, Z, Ti, fract, A)

        # electron phase-velocity vectors, their magnitude and their angle from the x axis in [-pi, pi]
        xie = tuple((omgdop / k_mag**2 * kc - uc) / vTe for kc, uc in zip(k, ud))
        return dict(
            k_mag=k_mag, ciR=ciR, ciI=ciI, vTe=vTe, xii=xii, vTi=vTi, Z=Z, fract=fract, Zbar=Zbar, omgdop=omgdop, omgL=omgL,
            ne=ne, klde_mag=klde_mag, xie_mag=torch.sqrt(xie[0] * xie[0] + xie[1] * xie[1]), beta=torch.atan2(xie[1], xie[0]),
        )

    def calc_in_2D(self, params):
        """(S(k, omega) [G, L, A], wavelength axis [L] in cm) for a 2D EDF; ``params`` are unbatched.

        k is a 2-vector: the probe along x, the scattered wave at the scattering
        angle; flow and drift point along ``va_angle`` and ``ud_angle``.  Every
        point's electron susceptibility comes from the EDF's projection along
        its own phase-velocity direction beta, through the angle tables.
        """
        f = self._fields_2v(params)
        fe_vphi, chiEI, chiERrat = self.calc_all_chi_vals(
            params["electron"]["v"], params["electron"]["fe"], f["beta"], f["xie_mag"], f["klde_mag"]
        )
        lams = 2.0 * math.pi * C / self.omgs
        PsLam = _assemble_fields(
            f["k_mag"], chiERrat, chiEI, f["ciR"], f["ciI"], fe_vphi, f["vTe"], f["xii"], f["vTi"], f["Z"], f["fract"],
            f["Zbar"], f["omgdop"], f["omgL"], f["ne"], lams
        )
        return PsLam[0], lams
