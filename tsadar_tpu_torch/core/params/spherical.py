"""Spherical-harmonic 2V electron distribution functions.

Counterpart of ``tsadar_tpu.core.params.spherical``:
f(vx, vy) = interp(f00)(|v|) + sum_{l <= Nl, m <= l} flm(|v|) Re Y_lm, with f00 a
super-Gaussian of trainable order m on a radial grid and three flm families:

* ``FLM_NN``: two small MLPs for magnitude and sign, weights and biases trainable;
* ``FLM_MY``: the Mora & Yahi (1982) heat-flux closure with a trainable log10 L_T;
* ``ArbitraryVr``: learnable smoothed magnitude and sign arrays.

The angular convention is the JAX package's: polar angle theta = arctan2(vy, vx),
azimuth phi in {0, pi} by the sign of vy (the even grid has no vy = 0).  Module
and attribute names follow the JAX pytree, so a JAX leaf path names the same
tensor here.  Any order ``Nl`` of the ``nn`` and ``arbitrary`` families; the
Mora-Yahi closure defines l = 1 only and raises beyond it, as in JAX.
"""

import math

import numpy as np
import torch
from torch import nn

from ..physics.interp import interp1d
from .distributions import gamma, inv_act, velocity_grid


def real_sph_harm(l, m, polar, azim):
    """Re Y_lm(polar, azim) for l >= 0, 0 <= m <= l: orthonormal on the sphere, with the Condon-Shortley phase
    (``jax.scipy.special.sph_harm_y``'s).

    The normalized associated Legendre function of x = cos(polar), by the
    stable recurrences P_mm = -sqrt((2k + 1) / 2k) sqrt(1 - x^2) P_(k-1)(k-1)
    from 1 / sqrt(4 pi), P_(m+1)m = sqrt(2m + 3) x P_mm and
    P_lm = a_lm (x P_(l-1)m - P_(l-2)m / a_(l-1)m), a_lm = sqrt((4l^2 - 1) / (l^2 - m^2)),
    in float64, times cos(m azim).  The factor sqrt(1 - x^2), not sin(polar):
    the grid's polar angle arctan2(vy, vx) runs over [-pi, pi].
    """
    if not 0 <= m <= l:
        raise ValueError(f"real_sph_harm needs 0 <= m <= l, got (l, m) = ({l}, {m})")
    x = torch.cos(polar.double())
    pmm = torch.full_like(x, 1.0 / math.sqrt(4.0 * math.pi))
    y = torch.sqrt(1.0 - x * x)
    for k in range(1, m + 1):
        pmm = -math.sqrt((2 * k + 1) / (2 * k)) * y * pmm
    prev, cur = pmm, pmm
    if l > m:
        prev, cur = pmm, math.sqrt(2 * m + 3) * x * pmm
        for n in range(m + 2, l + 1):
            a = math.sqrt((4 * n * n - 1) / (n * n - m * m))
            b = math.sqrt(((n - 1) ** 2 - m * m) / (4 * (n - 1) ** 2 - 1))  # 1 / a_(n-1)m
            prev, cur = cur, a * (x * cur - b * prev)
    return (cur * torch.cos(m * azim.double())).to(polar.dtype)


def _smoothing_matrix(n, window_size):
    """M [n, n] with a @ M = np.convolve(a, hanning(window_size) / sum, mode="same")."""
    window = np.hanning(window_size)
    window = window / np.sum(window)
    return np.stack([np.convolve(row, window, mode="same") for row in np.eye(n)])


class MLP(nn.Module):
    """Small fully-connected net on one input: relu hidden layers, a final activation.

    ``weights[i]`` holds (W, b) of layer i, as the JAX module's tuple of pairs.
    The initial weights are uniform in +-1/sqrt(fan_in) from ``generator``;
    they are not the JAX package's draws (``convert`` carries those over).
    """

    def __init__(self, in_size, out_size, width, depth, final_act, generator):
        super().__init__()
        sizes = [in_size] + [width] * depth + [out_size]
        self.weights = nn.ModuleList()
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            lim = 1.0 / math.sqrt(fan_in)
            W = (torch.rand((fan_out, fan_in), generator=generator, dtype=torch.float64) * 2.0 - 1.0) * lim
            self.weights.append(nn.ParameterList([nn.Parameter(W), nn.Parameter(torch.zeros(fan_out, dtype=torch.float64))]))
        self.final_act = final_act

    def forward(self, x):
        """x [N, in_size] -> [N, out_size]."""
        for i, (W, b) in enumerate(self.weights):
            x = x @ W.T + b
            if i < len(self.weights) - 1:
                x = torch.relu(x)
        if self.final_act == "relu":
            return torch.relu(x)
        if self.final_act == "tanh":
            return torch.tanh(x)
        return x


class FLM_NN(nn.Module):
    def __init__(self, vr):
        super().__init__()
        self.flm_mag = MLP(1, 1, 32, 3, "relu", torch.Generator().manual_seed(0))
        self.flm_sign = MLP(1, 1, 32, 3, "tanh", torch.Generator().manual_seed(42))
        self.register_buffer("vr", vr.clone())

    def forward(self, m_f0, f00):
        mag = torch.pow(10.0, -self.flm_mag(self.vr[:, None])[:, 0]) * f00
        return mag * self.flm_sign(self.vr[:, None])[:, 0]


class FLM_MY(nn.Module):
    """Mora & Yahi 1982 (Phys. Rev. A 26, 2259) heat-flux f1 closure."""

    def __init__(self, vr, LT):
        super().__init__()
        self.log_10_LT = nn.Parameter(torch.as_tensor(float(np.log10(LT)), dtype=torch.float64))
        self.register_buffer("vr", vr.clone())

    def forward(self, m_f0, f00):
        v0 = 1.0
        lambda_e = 1.0  # gradient scale lengths are in units of the mean free path
        ve = gamma(5.0 / m_f0) / 3.0 / gamma(3.0 / m_f0) * v0
        uu = self.vr / v0
        lambda_v = lambda_e * (self.vr / ve) ** 4.0
        coeff = (
            m_f0 / 2 * uu**m_f0 - 5 * m_f0 / 12 * gamma(8 / m_f0) / gamma(6 / m_f0) * uu ** (m_f0 - 2) - 1.5
        ) * lambda_v
        return coeff / 10**self.log_10_LT * f00


class ArbitraryVr(nn.Module):
    def __init__(self, nvr):
        super().__init__()
        self.flm_sign = nn.Parameter(torch.zeros(nvr, dtype=torch.float64))
        self.flm_mag = nn.Parameter(torch.zeros(nvr, dtype=torch.float64))
        self._smooth = None
        self.window = nvr // 4

    def _smooth1d(self, a):
        if self._smooth is None or self._smooth.dtype != a.dtype or self._smooth.device != a.device:
            self._smooth = torch.as_tensor(_smoothing_matrix(a.shape[0], self.window), dtype=a.dtype, device=a.device)
        return a @ self._smooth

    def forward(self, m_f0, f00):
        sign = torch.tanh(self._smooth1d(self.flm_sign))
        mag = -torch.sigmoid(self._smooth1d(self.flm_mag)) * 10
        return 10**mag * sign


class SphericalHarmonics(nn.Module):
    """f(vx, vy) [nvx, nvx] from f00 and the flm on a radial grid of nvr points, unbatched."""

    m_scale = 3.0
    m_shift = 2.0

    def __init__(self, dist_cfg, num_params, activate):
        super().__init__()
        vx = torch.as_tensor(velocity_grid(dist_cfg["nvx"]))
        nvr = dist_cfg["params"]["nvr"]
        vmax = 6.0 * 1.05 * math.sqrt(2.0)
        dvr = vmax / nvr
        vr = torch.as_tensor(np.linspace(dvr / 2, vmax - dvr / 2, nvr))
        VX, VY = torch.meshgrid(vx, vx, indexing="xy")  # VX[i, j] = vx[j], VY[i, j] = vx[i]
        for name, value in (("vx", vx), ("vr", vr), ("th", torch.atan2(VY, VX)), ("phi", torch.acos(VY / torch.abs(VY))),
                            ("vr_vxvy", torch.sqrt(VX**2 + VY**2))):
            self.register_buffer(name, value)

        self.flm_type = dist_cfg["params"]["flm_type"].casefold()
        init_m = dist_cfg["params"]["init_m"]
        self.normed_m = nn.Parameter(
            torch.as_tensor(float(inv_act((init_m - self.m_shift) / self.m_scale, True)), dtype=torch.float64)
        )
        self.lm_list, self.flm = [], nn.ModuleList()
        for l in range(1, dist_cfg["params"]["Nl"] + 1):
            for m in range(l + 1):
                self.lm_list.append((l, m))
                if self.flm_type == "nn":
                    self.flm.append(FLM_NN(vr))
                elif self.flm_type == "mora-yahi":
                    if l != 1:
                        raise NotImplementedError("Mora-Yahi only supports l=1")
                    self.flm.append(FLM_MY(vr, dist_cfg["params"]["LTx" if m == 0 else "LTy"]))
                elif self.flm_type == "arbitrary":
                    self.flm.append(ArbitraryVr(nvr))
                else:
                    raise NotImplementedError(f"Unknown flm_type: {self.flm_type}")

    def get_unnormed_m(self):
        return torch.sigmoid(self.normed_m) * self.m_scale + self.m_shift

    def get_f00(self):
        """The isotropic super-Gaussian component on the radial grid."""
        m = self.get_unnormed_m()
        v0 = 1.0 / torch.sqrt(gamma(5.0 / m) / 3.0 / gamma(3.0 / m))
        cst = m / (4 * math.pi * gamma(3.0 / m))
        f00 = cst / v0**3.0 * torch.exp(-((self.vr / v0) ** m))
        return f00 / (torch.sum(f00 * 4 * math.pi * self.vr**2.0) * (self.vr[1] - self.vr[0]))

    def get_unnormed_params(self):
        f00, m_f0 = self.get_f00(), self.get_unnormed_m()
        flm_dict = {0: {0: f00}}
        for (l, m), mod in zip(self.lm_list, self.flm):
            flm_dict.setdefault(l, {})[m] = mod(m_f0=m_f0, f00=f00)
        return {"m": m_f0, "flm": flm_dict}

    def forward(self):
        f00, m_f0 = self.get_f00(), self.get_unnormed_m()
        fvxvy = interp1d(self.vr_vxvy, self.vr, f00, right=1e-16)
        for (l, m), mod in zip(self.lm_list, self.flm):
            flm_vxvy = interp1d(self.vr_vxvy, self.vr, mod(m_f0=m_f0, f00=f00), right=1e-32)
            fvxvy = fvxvy + flm_vxvy * real_sph_harm(l, m, self.th, self.phi)
        fvxvy = torch.clamp(fvxvy, min=1e-32)
        dv = self.vx[1] - self.vx[0]
        return fvxvy / (torch.sum(fvxvy) * dv * dv)
