"""1V electron distribution functions as ``nn.Module``s over a lineout batch.

Counterparts of ``tsadar_tpu.core.params.distributions``: ``DLM1V`` (the
Dum-Langdon-Matte super-Gaussian family, differentiable in its shape
parameter m through a projected table) and ``Maxwellian1V``.  The trainable
value is the normalized m, one per lineout; grids and tables are buffers.
"""

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

    def __init__(self, dist_cfg, num_params, activate):
        super().__init__()
        self.activated = bool(activate and dist_cfg.get("active", False))
        normed = inv_act((dist_cfg["params"]["m"]["val"] - self.m_shift) / self.m_scale, self.activated)
        self.normed_m = nn.Parameter(torch.full((num_params,), float(normed), dtype=torch.float64))
        vx, ms, table = _dlm_projected_table(dist_cfg["nvx"])
        self.register_buffer("vx", torch.as_tensor(vx))
        self.register_buffer("m_ax", torch.as_tensor(ms))
        self.register_buffer("f_vx_m", torch.as_tensor(table))

    def forward(self):
        m = act(self.normed_m, self.activated) * self.m_scale + self.m_shift
        fdlm = _interp_columns(m, self.m_ax, self.f_vx_m)
        dv = self.vx[1] - self.vx[0]
        return fdlm / torch.sum(fdlm, dim=-1, keepdim=True) / dv


class Maxwellian1V(nn.Module):
    """Closed-form Maxwellian, no trainables."""

    def __init__(self, dist_cfg, num_params, activate):
        super().__init__()
        self.num_params = num_params
        self.register_buffer("vx", torch.as_tensor(velocity_grid(dist_cfg["nvx"])))

    def forward(self):
        dv = self.vx[1] - self.vx[0]
        f = torch.exp(-(self.vx**2) / 2)
        f = f / torch.sum(f) / dv
        return f.expand(self.num_params, -1)
