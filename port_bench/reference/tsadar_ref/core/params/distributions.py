"""Electron distribution functions as ``nn.Module``s: 1V over a lineout batch, 2V pointwise.

Counterparts of ``tsadar_tpu.core.params.distributions``: ``DLM1V`` (the
Dum-Langdon-Matte super-Gaussian family, differentiable in its shape
parameter m through a projected table), ``Maxwellian1V``, ``Arbitrary1V`` (a
pointwise-learnable f(v) per lineout, smoothed by a second-order Butterworth
filter) and ``Arbitrary2V`` (a pointwise-learnable f(vx, vy), unbatched).  The
trainable value is the normalized m, one per lineout, or the array ``fval``;
grids and tables are buffers.

The Butterworth filter is linear in its input, the initial carry included, so
``second_order_butterworth`` applies it as one fixed matrix: the JAX package's
scan, transcribed in numpy and run in float64 on unit impulses, gives the
matrix, which is cast to the working dtype and applied with one matmul.
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


def _butterworth_scan(signal, f_sampling, f_cutoff, method):
    """The JAX package's ``second_order_butterworth`` in numpy float64, along the last axis."""
    if method == "forward_backward":
        signal = _butterworth_scan(signal, f_sampling, f_cutoff, "forward")
        return _butterworth_scan(signal, f_sampling, f_cutoff, "backward")
    if method == "backward":
        signal = np.flip(signal, axis=-1)
    elif method != "forward":
        raise NotImplementedError(method)
    ita = 1.0 / np.tan(np.pi * f_cutoff / f_sampling)
    q = np.sqrt(2.0)
    b0 = 1.0 / (1.0 + q * ita + ita**2)
    b1, b2 = 2 * b0, b0
    a1 = 2.0 * (ita**2 - 1.0) * b0
    a2 = -(1.0 - q * ita + ita**2) * b0
    x = np.moveaxis(signal, -1, 0)
    x_im1, x_im2, y_im1, y_im2 = x[1], x[0], x[1], x[0]
    ys = []
    for x_i in x[2:]:
        y_i = b0 * x_i + b1 * x_im1 + b2 * x_im2 + a1 * y_im1 + a2 * y_im2
        x_im1, x_im2, y_im1, y_im2 = x_i, x_im1, y_i, y_im1
        ys.append(y_i)
    out = np.moveaxis(np.stack([ys[0], ys[0]] + ys), 0, -1)
    return np.flip(out, axis=-1) if method == "backward" else out


@lru_cache(maxsize=8)
def _butterworth_matrix(n, f_sampling, f_cutoff, method):
    """[n, n] float64: ``signal @ M`` is the filtered signal (row i: the response to the unit impulse at i)."""
    return np.ascontiguousarray(_butterworth_scan(np.eye(n), f_sampling, f_cutoff, method))


def second_order_butterworth(signal, f_sampling=100, f_cutoff=15, method="forward_backward"):
    """The second-order Butterworth filter along the last axis of ``signal`` (zero-phase when forward_backward)."""
    m = _butterworth_matrix(signal.shape[-1], f_sampling, f_cutoff, method)
    return torch.matmul(signal, torch.as_tensor(m, dtype=signal.dtype, device=signal.device))


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


class Arbitrary1V(nn.Module):
    """Pointwise-learnable f(v), one per lineout: ``fval`` [B, nvx] holds sqrt(-log10 f) / 7 of the DLM
    projection of order ``init_m``; calling the module smooths it (Butterworth, cutoff 6 of 100), undoes
    the parameterization and normalizes each EDF to unit integral."""

    def __init__(self, dist_cfg, num_params, activate, batch=True):
        super().__init__()
        vx, ms, table = _dlm_projected_table(dist_cfg["nvx"])
        m0 = float(dist_cfg["params"]["init_m"])
        f0 = np.array([np.interp(m0, ms, row) for row in table])
        f0 = f0 / np.trapezoid(f0, vx)
        fval = np.sqrt(-np.log10(f0)) / 7.0
        self.fval = nn.Parameter(torch.tensor(np.broadcast_to(fval, (num_params, fval.size)) if batch else fval))
        self.register_buffer("vx", torch.as_tensor(velocity_grid(dist_cfg["nvx"])))

    def get_unnormed_params(self):
        return {"f": self()}

    def forward(self):
        smoothed = second_order_butterworth(self.fval, f_sampling=100, f_cutoff=6)
        f = torch.pow(10.0, -((7.0 * smoothed) ** 2.0))
        dv = self.vx[1] - self.vx[0]
        return f / torch.sum(f, dim=-1, keepdim=True) / dv


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
