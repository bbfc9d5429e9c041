"""Instrument response: Gaussian spectral convolution, 1024-pixel rebin, amplitudes.

Counterpart of ``tsadar_tpu.core.physics.irf`` (electron and ion features)
for a batch of lineouts: spectra are [B, L], the wavelength axis [L] is shared
and per-lineout scalars are [B].
"""

import math

import torch


def _conv_same(signal, kernel):
    """'same'-mode convolution of signal [..., n] with kernel [k] via FFT."""
    n = signal.shape[-1]
    k = kernel.shape[-1]
    full_len = n + k - 1
    fft_len = 1 << (full_len - 1).bit_length()
    fa = torch.fft.rfft(signal, fft_len)
    fb = torch.fft.rfft(kernel, fft_len)
    full = torch.fft.irfft(fa * fb, fft_len)[..., :full_len]
    start = (k - 1) // 2
    return full[..., start : start + n]


def _gaussian(lam_axis, stddev):
    origin = (torch.amax(lam_axis) + torch.amin(lam_axis)) / 2.0
    return (1.0 / (stddev * math.sqrt(2.0 * math.pi))) * torch.exp(-((lam_axis - origin) ** 2.0) / (2.0 * stddev**2.0))


def _masked_max(x, mask):
    return torch.amax(torch.where(mask, x, -torch.inf), dim=-1, keepdim=True)


def _rebin(x):
    """Mean over contiguous groups so the last axis has 1024 pixels."""
    return torch.mean(x.reshape(*x.shape[:-1], 1024, -1), dim=-1)


def add_ion_IRF(config, lamAxisI, modlI, amps, TSins):
    """Ion spectral IRF + 1024-px rebin: lamAxisI [L], modlI [B, L], amps [B] or [B, 1]."""
    stddevI = config["other"]["PhysParams"]["widIRF"]["spect_stddev_ion"]
    if not stddevI:
        return lamAxisI, modlI
    ThryI = _conv_same(modlI, _gaussian(lamAxisI, stddevI))
    ThryI = (torch.amax(modlI, dim=-1, keepdim=True) / torch.amax(ThryI, dim=-1, keepdim=True)) * ThryI
    ThryI = _rebin(ThryI)
    if config["other"]["PhysParams"]["norm"] == 0:
        lamAxisI = _rebin(lamAxisI)
        amp3 = TSins["general"]["amp3"][:, None]
        ThryI = amp3 * amps.reshape(amp3.shape[0], -1) * ThryI / torch.amax(ThryI, dim=-1, keepdim=True)
    return lamAxisI, ThryI


def add_electron_IRF(config, lamAxisE, modlE, amps, TSins):
    """Electron spectral IRF + rebin + amplitude scaling: lamAxisE [L], modlE [B, L]."""
    stddevE = config["other"]["PhysParams"]["widIRF"]["spect_stddev_ele"]
    ThryE = _conv_same(modlE, _gaussian(lamAxisE, stddevE))
    ThryE = (torch.amax(modlE, dim=-1, keepdim=True) / torch.amax(ThryE, dim=-1, keepdim=True)) * ThryE

    lam = TSins["general"]["lam"][:, None]
    amp1, amp2 = TSins["general"]["amp1"][:, None], TSins["general"]["amp2"][:, None]
    if config["other"]["PhysParams"]["norm"] > 0:
        blue = lamAxisE < lam
        ThryE = torch.where(blue, amp1 * (ThryE / _masked_max(ThryE, blue)), amp2 * (ThryE / _masked_max(ThryE, ~blue)))

    ThryE = _rebin(ThryE)
    if config["other"]["PhysParams"]["norm"] == 0:
        lamAxisE = _rebin(lamAxisE)
        ThryE = amps.reshape(ThryE.shape[0], -1) * ThryE / torch.amax(ThryE, dim=-1, keepdim=True)
        ThryE = torch.where(lamAxisE < lam, amp1 * ThryE, amp2 * ThryE)
    return lamAxisE, ThryE
