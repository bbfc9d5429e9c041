"""Top-level forward model: spectra + instrument response + noise, per lineout batch.

Counterpart of ``tsadar_tpu.core.diagnostic.ThomsonScatteringDiagnostic`` for
the temporal, imaging and 1d spectypes: where JAX vmaps the spectrum model
over the lineouts, the batch is the leading dimension of every tensor here.
"""

import torch
from torch import nn

from ..device import resolve_device, working_dtype
from .physics import irf
from .physics.spectrum import SpectrumModel


class ThomsonScatteringDiagnostic(nn.Module):
    """``diag(ts_params, batch) -> (ThryE [B, 1024], ThryI, lamAxisE [B, 1024], lamAxisI)``.

    Runs on the GPU unless ``device="cpu"`` is given; the working dtype is
    float32 on the card and float64 on the CPU.  The model is differentiable
    in the parameters on both: on the card forward and backward run through
    the hand-written kernels, on the CPU through their plain forms.  ``batch``
    entries may be arrays or tensors; tensors already on the device in the
    working dtype are used as they are, so a fit converts its batch once
    (``device_batch``) and pays no copy per call.
    """

    def __init__(self, cfg, scattering_angles, device=None, dtype=None):
        super().__init__()
        spectype = cfg["other"]["extraoptions"]["spectype"]
        if "angular" in spectype:
            raise NotImplementedError(f"spectype {spectype!r} is not ported yet (ROADMAP.md §1 item 12)")
        if not any(s in spectype for s in ("temporal", "imaging", "1d")):
            raise NotImplementedError(f"Unknown spectype: {spectype}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype or working_dtype(self.device)
        self.model = SpectrumModel(cfg, scattering_angles, self.device, self.dtype)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def postprocess_theory(self, modlE, modlI, lamAxisE, lamAxisI, amps, TSins):
        """Instrument broadening, rebin and amplitudes of both features."""
        opts = self.cfg["other"]["extraoptions"]
        ThryI = modlI
        if opts["load_ion_spec"]:
            lamAxisI, ThryI = irf.add_ion_IRF(self.cfg, lamAxisI, modlI, amps["i_amps"], TSins)
        ThryE = modlE
        if opts["load_ele_spec"]:
            lamAxisE, ThryE = irf.add_electron_IRF(self.cfg, lamAxisE, modlE, amps["e_amps"], TSins)
        return ThryE, ThryI, lamAxisE, lamAxisI

    def device_batch(self, batch):
        """``batch`` with every entry as a tensor on the device, in the working dtype."""
        return {k: self._tensor(v) for k, v in batch.items()}

    def forward(self, ts_params, batch):
        return self.spectra(ts_params(), batch)

    def spectra(self, physical_params, batch):
        """The forward model from the physical parameters ``ts_params()``."""
        modlE, modlI, lamAxisE, lamAxisI = self.model(physical_params)
        amps = {k: self._tensor(batch[k]) for k in ("e_amps", "i_amps")}
        ThryE, ThryI, lamAxisE, lamAxisI = self.postprocess_theory(
            modlE, modlI, lamAxisE, lamAxisI, amps, physical_params
        )
        ThryE = ThryE + self._tensor(batch["noise_e"])
        ThryI = ThryI + self._tensor(batch["noise_i"])
        # one wavelength axis per lineout, as the vmapped JAX model returns them
        B = ThryE.shape[0]
        return ThryE, ThryI, lamAxisE.expand(B, -1), lamAxisI.expand(B, -1)
