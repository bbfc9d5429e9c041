"""Top-level forward model: spectra + instrument response + noise.

Counterpart of ``tsadar_tpu.core.diagnostic.ThomsonScatteringDiagnostic``.  For
the temporal, imaging and 1d spectypes, where JAX vmaps the spectrum model
over the lineouts, the batch is the leading dimension of every tensor here.
For ``angular_full`` (ARTS) the model is unbatched: one image [fine angles, L]
gets the 2D instrument response and is block-averaged to the detector's
resolution units.
"""

import torch
from torch import nn

from ..device import resolve_device, working_dtype
from .physics import irf
from .physics.spectrum import SpectrumModel


class ThomsonScatteringDiagnostic(nn.Module):
    """``diag(ts_params, batch) -> (ThryE [B, 1024], ThryI, lamAxisE [B, 1024], lamAxisI)``;
    for ``angular_full``, ThryE [resolution units in the lineout window, wavelengths] and lamAxisE [wavelengths].

    Runs on the GPU unless ``device="cpu"`` is given; the working dtype is
    float32 on the card and float64 on the CPU.  The model is differentiable
    in the parameters on both: on the card forward and backward run through
    the hand-written kernels, on the CPU through their plain forms.  ``batch``
    entries may be arrays or tensors; tensors already on the device in the
    working dtype are used as they are, so a fit converts its batch once
    (``device_batch``) and pays no copy per call.
    """

    def __init__(self, cfg, scattering_angles, device=None, dtype=None, mode_2v="table", shard_2v_points=False):
        super().__init__()
        if mode_2v != "table":
            raise NotImplementedError(f"2V mode {mode_2v!r} is not ported yet (ROADMAP.md §1 item 7: ratcen/ratintn)")
        if shard_2v_points:
            raise NotImplementedError("2V point sharding is not ported yet (ROADMAP.md §1 item 8)")
        spectype = cfg["other"]["extraoptions"]["spectype"]
        self.angular = spectype == "angular_full"
        if "angular" in spectype and not self.angular:
            raise NotImplementedError(f"spectype {spectype!r} is not ported yet: ARTS runs as 'angular_full' (ROADMAP.md §1 item 7)")
        if not self.angular and not any(s in spectype for s in ("temporal", "imaging", "1d")):
            raise NotImplementedError(f"Unknown spectype: {spectype}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype or working_dtype(self.device)
        self.model = SpectrumModel(cfg, scattering_angles, self.device, self.dtype)
        if self.angular:
            self.sas = {"angAxis": self._tensor(scattering_angles["angAxis"])}

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
            if self.angular:
                lamAxisE, ThryE = irf.add_ATS_IRF(self.cfg, self.sas, lamAxisE, modlE, amps["e_amps"], TSins)
            else:
                lamAxisE, ThryE = irf.add_electron_IRF(self.cfg, lamAxisE, modlE, amps["e_amps"], TSins)
        return ThryE, ThryI, lamAxisE, lamAxisI

    @staticmethod
    def _block_mean(a, step, axis):
        """Mean over contiguous blocks of ``step`` along ``axis``; a ragged last block over its own length."""
        a = torch.movedim(a, axis, 0)
        n = a.shape[0]
        n_full = n // step
        full = a[: n_full * step].reshape(n_full, step, *a.shape[1:]).mean(dim=1)
        if n_full * step < n:
            full = torch.cat([full, a[n_full * step :].mean(dim=0, keepdim=True)], dim=0)
        return torch.movedim(full, 0, axis)

    def reduce_ATS_to_resunit(self, ThryE, lamAxisE, TSins, batch):
        """Block-average the image to the detector's resolution units, cut the lineout window, scale."""
        n_ang, n_lam = ThryE.shape
        lam_step = round(n_lam / batch["e_data"].shape[1])
        ang_step = round(n_ang / self.cfg["other"]["CCDsize"][0])
        ThryE = self._block_mean(self._block_mean(ThryE, lam_step, 1), ang_step, 0)
        lamAxisE = self._block_mean(lamAxisE, lam_step, 0)

        lineouts = self.cfg["data"]["lineouts"]
        ThryE = ThryE[lineouts["start"] : lineouts["end"], :]
        ThryE = self._tensor(batch["e_amps"]) * ThryE / torch.amax(ThryE, dim=1, keepdim=True)
        g = TSins["general"]
        return torch.where(lamAxisE < g["lam"], g["amp1"] * ThryE, g["amp2"] * ThryE), lamAxisE

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
        if self.angular:
            ThryE, lamAxisE = self.reduce_ATS_to_resunit(ThryE, lamAxisE, physical_params, batch)
            return ThryE + self._tensor(batch["noise_e"]), ThryI + self._tensor(batch["noise_i"]), lamAxisE, lamAxisI
        ThryE = ThryE + self._tensor(batch["noise_e"])
        ThryI = ThryI + self._tensor(batch["noise_i"])
        # one wavelength axis per lineout, as the vmapped JAX model returns them
        B = ThryE.shape[0]
        return ThryE, ThryI, lamAxisE.expand(B, -1), lamAxisI.expand(B, -1)
