"""Spectral density S(k, omega) for 1V electron distributions, reduced over angles.

The counterpart of ``tsadar_tpu.core.physics.form_factor`` for the 1V
non-angular path (``FormFactor.reduced_1v``).  Where JAX vmaps one lineout,
every function here carries the lineout batch as its leading dimension:
fields are [B, G, L, A] (lineout, gradient point, wavelength, angle) and ion
species ride a trailing [S] axis.

The front half (``_lookups_1v``) forms the electron phase velocities xi_e,
looks up log f_e there (cubic Hermite) and chi_R on the PV pole table
(linear); the tail (``_reduced_tail``) is kinematics, ion susceptibility,
the electron Landau term, the S(k, omega) assembly and the weighted
angle/gradient sum.  On the card both lookups and the whole tail run as
hand-written CUDA kernels (``tsadar_tpu_torch/ops``); on the CPU the plain
functions below run, and they are the kernels' oracles.

The 2V (ARTS) path and the unreduced ``__call__`` are not ported yet.
"""

import math

import numpy as np
import torch

from ...ops.build import on_card
from . import ratint
from .constants import C, ME_KEV, MP_KEV, RE_CM, PLASMA_FREQ_CONST
from .interp import cubic_lookup, interp1d_cubic_matmul, lin_lookup
from .zprime import zprime

# probe angular-frequency numerator: omgL = OMGL_NUM / lam  (lam in nm, omgL in 1/s)
OMGL_NUM = 2.0 * np.pi * 1.0e7 * C


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

    PsOmg = (SKW_ion + SKW_ele) * (1.0 + 2.0 * omgdop / omgL) * RE_CM**2 * ne[..., None, None]
    return PsOmg * 2.0 * math.pi * C / lams[:, None] ** 2


def _reduced_tail(lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract, weights, sarad, omgs):
    """Angle-weighted, gradient-averaged spectrum [B, L] from the two lookups.

    lf, chiERraw [B,G,L,A]; ne/Te [B,G]; lam/Va/ud [B]; A/Z/Ti/fract [B,S];
    weights a scalar or [A]; sarad [A]; omgs [L].  The plain form of the
    ``spectrum_tail_fwd`` kernel.
    """
    omgL, k, omgdop, vTe, klde, xie = _kinematics_fields(sarad, omgs, ne, Te, lam, Va, ud)
    ciR, ciI, xii, vTi, Zbar = _ion_fields(omgdop, k, ne, Z, Ti, fract, A)

    fe_vphi = torch.exp(lf)
    df = torch.diff(fe_vphi, dim=2) / torch.diff(xie, dim=2)
    df = torch.cat([df, torch.zeros_like(df[:, :, :1])], dim=2)
    # electron Landau term with the Kramers-Kronig-consistent MINUS sign
    # (the JAX package's documented fix of the reference's +pi)
    ceR = -1.0 / (klde**2) * chiERraw
    ceI = -math.pi / (klde**2) * df

    lams = 2.0 * math.pi * C / omgs
    PsLam = _assemble_fields(k, ceR, ceI, ciR, ciI, fe_vphi, vTe, xii, vTi, Z, fract, Zbar, omgdop, omgL, ne, lams)
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


class FormFactor:
    """1V spectral density on one wavelength range, for a batch of lineouts.

    Args:
        lambda_range: (start, end) wavelengths [nm].
        npts: number of wavelength points.
        lam_shift: spectral shift applied to the probe wavelength [nm].
        scattering_angles: dict with "sa" (angles, degrees).
        num_grad_points: number of plasma-gradient sample points.
        device, dtype: where and in which precision the tables live.
    """

    def __init__(self, lambda_range, npts, lam_shift, scattering_angles, num_grad_points, device, dtype):
        as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
        lamAxis = np.linspace(lambda_range[0], lambda_range[1], npts)
        self.omgs = as_t(2.0e7 * np.pi * C / lamAxis)  # scattered frequency axis [L], 1/s

        # xi grid of the chi_R pole sweep and its precombined PV matrices;
        # interleaved midpoint + node poles give a table of 2 h1 - 5 entries
        minmax, h1 = 8.2, 1024
        xi1 = np.linspace(-minmax - math.sqrt(2.0) / h1, minmax + math.sqrt(2.0) / h1, h1)
        self.xi1 = as_t(xi1)
        self.dxi1 = float(xi1[1] - xi1[0])
        self._pv_kmid, self._pv_knode = ratint.pv_combined_kernels(h1 - 2, dtype, device)
        mid_poles = 0.5 * (xi1[1:-1] + xi1[0:-2])
        node_poles = xi1[1 : h1 - 2]
        poles = np.zeros(mid_poles.size + node_poles.size)
        poles[0::2], poles[1::2] = mid_poles, node_poles
        poles = as_t(poles)
        self.pv_x0 = float(poles[0])
        self.pv_dx = float(poles[1] - poles[0])

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

    def _lookups_1v(self, params):
        """Every input of the spectrum tail: (lf, chiERraw, ne, Te, lam, Va, ud, A, Z, Ti, fract)."""
        ne, Te = self._gradients(params)
        lam = params["general"]["lam"] + self.lam_shift
        Va = params["general"]["Va"] * 1e6  # 1e6 cm/s
        ud = params["general"]["ud"] * 1e6
        fe = params["electron"]["fe"]  # [B, nv]
        vx = params["electron"]["v"]  # [nv], shared by all lineouts
        A, Z, Ti, fract = self._ion_arrays(params)

        xie = _kinematics_fields(self.sarad, self.omgs, ne, Te, lam, Va, ud)[-1]
        B = xie.shape[0]
        q = xie.reshape(B, -1)

        # the floor must be representable in the working dtype, or log(0) = -inf
        # from an exact zero in the EDF tail would spread through the matmul
        log_fe = torch.log(torch.clamp(fe, min=torch.finfo(fe.dtype).tiny)).contiguous()
        meta = torch.stack([vx[0], vx[1] - vx[0], torch.full_like(vx[0], vx.shape[0])])
        lf = cubic_lookup(q, log_fe, meta.expand(B, 3).contiguous())[0]
        lf = torch.where((q < vx[0]) | (q > vx[-1]), -50.0, lf)

        ratmod = torch.exp(interp1d_cubic_matmul(self.xi1, vx, log_fe, (-50.0, -50.0)))  # [B, h1]
        # jnp.gradient: central differences inside, one-sided at the two ends
        ratdf = torch.cat(
            [ratmod[:, 1:2] - ratmod[:, :1], (ratmod[:, 2:] - ratmod[:, :-2]) * 0.5, ratmod[:, -1:] - ratmod[:, -2:-1]],
            dim=-1,
        ) / self.dxi1
        mid_vals, node_vals = ratint.pv_tables_matmul(ratdf, self._pv_kmid, self._pv_knode)
        table = torch.empty((B, mid_vals.shape[1] + node_vals.shape[1]), dtype=mid_vals.dtype, device=mid_vals.device)
        table[:, 0::2], table[:, 1::2] = mid_vals, node_vals
        chiERraw = lin_lookup(q, table, self.pv_x0, self.pv_dx)[0]

        return lf.view_as(xie), chiERraw.view_as(xie), ne, Te, lam, Va, ud, A, Z, Ti, fract

    def reduced_1v(self, params, weights):
        """(reduced spectrum [B, L], wavelength axis [L] in cm) through the spectrum tail.

        The tail is ``_reduced_tail`` on the CPU and the ``spectrum_tail_fwd``
        kernel on the card.
        """
        inputs = self._lookups_1v(params)
        if on_card(inputs[0]):
            from ...ops.spectrum_tail import spectrum_tail_fwd as tail
        else:
            tail = _reduced_tail
        reduced = tail(*inputs, weights, self.sarad, self.omgs)
        return reduced, 2.0 * math.pi * C / self.omgs
