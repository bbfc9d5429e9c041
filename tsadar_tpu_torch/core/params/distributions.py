"""Electron distribution functions as ``nn.Module``s: 1V over a lineout batch, 2V pointwise.

Counterparts of ``tsadar_tpu.core.params.distributions``: ``DLM1V`` (the
Dum-Langdon-Matte super-Gaussian family, differentiable in its shape
parameter m through a projected table), ``Maxwellian1V``, and ``Arbitrary2V``
(a pointwise-learnable f(vx, vy), unbatched).  The trainable value is the
normalized m, one per lineout, or the 2D array ``fval``; grids and tables are
buffers.
"""

import math
from functools import lru_cache

import numpy as np
import torch
from scipy.special import gamma as _gamma
from torch import nn

VMAX_1V = 6.0


def velocity_grid(nvx, vmax=VMAX_1V):
    """Cell-centered velocity grid (numpy f64)."""
    dv = 2.0 * vmax / nvx
    return np.linspace(-vmax + dv / 2, vmax - dv / 2, nvx)


def act(x, activated: bool):
    return torch.sigmoid(x) if activated else x


def inv_act(x, activated: bool):
    """Inverse of ``act`` (a stabilized logit), on host numbers."""
    return np.log(1e-2 + x / (1.0 - x + 1e-2)) if activated else x


@lru_cache(maxsize=16)
def _dlm_projected_table(nvx, vmax=VMAX_1V, n_m=31, m_lo=2.0, m_hi=5.0):
    """Projected super-Gaussian table f1(vx; m) [nvx, n_m], columns of unit integral.

    f1(vx) = 2 pi cst(m) int_{|vx|}^inf exp(-(u/(alpha vth))^m) u du,
    alpha(m) = sqrt(3 Gamma(3/m) / (2 Gamma(5/m))), vth = sqrt(2); built by
    host quadrature, the same construction as the JAX package's table.
    """
    vx = velocity_grid(nvx, vmax)
    ms = np.linspace(m_lo, m_hi, n_m)
    vth = np.sqrt(2.0)

    u = np.linspace(0.0, 4.0 * vmax, 48001)
    table = np.empty((nvx, n_m))
    for j, m in enumerate(ms):
        alpha = np.sqrt(3.0 * _gamma(3.0 / m) / (2.0 * _gamma(5.0 / m)))
        w = np.exp(-((u / (alpha * vth)) ** m)) * u
        # tail integral accumulated from the far end so tiny tails stay accurate
        seg = 0.5 * (w[1:] + w[:-1]) * np.diff(u)
        tail_nodes = np.concatenate([np.cumsum(seg[::-1])[::-1], [0.0]])
        tail = np.interp(np.abs(vx), u, tail_nodes)
        table[:, j] = tail / np.trapezoid(tail, vx)
    return vx, ms, table


def _interp_columns(x, xp, fp):
    """jnp.interp(x[b], xp, fp[i, :]) for every row i and lineout b -> [B, n_rows]."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    lo, hi = fp[:, i - 1].T, fp[:, i].T
    f = lo + ((x - xp[i - 1]) / (xp[i] - xp[i - 1]))[:, None] * (hi - lo)
    f = torch.where((x < xp[0])[:, None], fp[:, :1].T, f)
    return torch.where((x > xp[-1])[:, None], fp[:, -1:].T, f)


class DLM1V(nn.Module):
    """Super-Gaussian EDF family, one shape parameter m per lineout."""

    m_scale = 3.0
    m_shift = 2.0

    def __init__(self, dist_cfg, num_params, activate, batch=True):
        super().__init__()
        self.activated = bool(activate and dist_cfg.get("active", False))
        normed = inv_act((dist_cfg["params"]["m"]["val"] - self.m_shift) / self.m_scale, self.activated)
        self.normed_m = nn.Parameter(torch.full((num_params,) if batch else (), float(normed), dtype=torch.float64))
        vx, ms, table = _dlm_projected_table(dist_cfg["nvx"])
        self.register_buffer("vx", torch.as_tensor(vx))
        self.register_buffer("m_ax", torch.as_tensor(ms))
        self.register_buffer("f_vx_m", torch.as_tensor(table))

    def _unnormed_m(self):
        return act(self.normed_m, self.activated) * self.m_scale + self.m_shift

    def get_unnormed_params(self):
        return {"m": self._unnormed_m()}

    def forward(self):
        m = self._unnormed_m()
        fdlm = _interp_columns(m.reshape(-1), self.m_ax, self.f_vx_m)
        dv = self.vx[1] - self.vx[0]
        fe = fdlm / torch.sum(fdlm, dim=-1, keepdim=True) / dv
        return fe if m.dim() else fe[0]  # unbatched: one EDF [nvx]


class Maxwellian1V(nn.Module):
    """Closed-form Maxwellian, no trainables."""

    def __init__(self, dist_cfg, num_params, activate, batch=True):
        super().__init__()
        self.num_params = num_params if batch else None
        self.register_buffer("vx", torch.as_tensor(velocity_grid(dist_cfg["nvx"])))

    def get_unnormed_params(self):
        return {}

    def forward(self):
        dv = self.vx[1] - self.vx[0]
        f = torch.exp(-(self.vx**2) / 2)
        f = f / torch.sum(f) / dv
        return f if self.num_params is None else f.expand(self.num_params, -1)


def gamma(x):
    """Gamma function of a positive tensor, differentiable: exp(lgamma(x))."""
    return torch.exp(torch.lgamma(x))


def _super_gaussian_3d_on_axis(vx, m, vth):
    """3D super-Gaussian of order m (a tensor) evaluated on-axis at the speeds |vx|."""
    alpha = torch.sqrt(3.0 * gamma(3.0 / m) / 2.0 / gamma(5.0 / m))
    cst = m / (4.0 * torch.pi * alpha**3.0 * gamma(3.0 / m))
    return cst / vth**3.0 * torch.exp(-((torch.abs(vx) / alpha / vth) ** m))


class Arbitrary2V(nn.Module):
    """Pointwise-learnable f(vx, vy) on the square grid vx x vx, unbatched.

    ``fval`` [nvx, nvx] holds sqrt(-log10 f) (``learn_log``) or sqrt(f) of a
    super-Gaussian of order ``init_m``; calling the module squares it, undoes
    the logarithm and normalizes to unit integral.
    """

    def __init__(self, dist_cfg, num_params, activate):
        super().__init__()
        vx = torch.as_tensor(velocity_grid(dist_cfg["nvx"]))
        self.learn_log = bool(dist_cfg["params"]["learn_log"])
        m = torch.as_tensor(float(dist_cfg["params"]["init_m"]), dtype=torch.float64)
        vmag = torch.sqrt(vx[:, None] ** 2 + vx[None, :] ** 2)
        fdlm = _super_gaussian_3d_on_axis(vmag, m, vth=math.sqrt(2.0))
        fdlm = fdlm / torch.sum(fdlm) / (vx[1] - vx[0]) ** 2
        if self.learn_log:
            fdlm = -torch.log10(fdlm)
        self.fval = nn.Parameter(torch.sqrt(fdlm))
        self.register_buffer("vx", vx)

    def get_unnormed_params(self):
        return {"f": self()}

    def forward(self):
        f = self.fval**2.0
        if self.learn_log:
            f = torch.pow(10.0, -f)
        dv = self.vx[1] - self.vx[0]
        return f / torch.sum(f) / dv**2.0
