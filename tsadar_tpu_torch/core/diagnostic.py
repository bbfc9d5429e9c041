"""Top-level forward model: spectra + instrument response + noise.

Counterpart of ``tsadar_tpu.core.diagnostic.ThomsonScatteringDiagnostic``.  For
the temporal, imaging and 1d spectypes, where JAX vmaps the spectrum model
over the lineouts, the batch is the leading dimension of every tensor here.
For ``angular_full`` (ARTS) the model is unbatched: one image [fine angles, L]
gets the 2D instrument response and is block-averaged to the detector's
resolution units.  The plain ``angular`` spectype is unbatched too, and takes
the 1D instrument response of one spectrum [L], with no resolution units.

``spectrum_breakdown`` gives what the postprocess's ``detailed_breakdown``
plots: the per-component (unreduced) spectra, and the instrument response
alone, as the fitted spectra's two most prominent peaks
(``scipy.signal.find_peaks`` on the host) put through the same
``postprocess_theory``.

``mode_2v`` ("table" or "exact") is the 2V form factor's mode
(``FormFactor``); ``shard_2v_points`` splits table mode's chi evaluation
points between the ranks of a process group (``FormFactor``'s
``shard_points``; nothing without one).
"""

import numpy as np
import torch
from torch import nn

from ..device import resolve_device, working_dtype
from ..utils import trace
from ..utils.console import log_info
from .physics import irf
from .physics.spectrum import SpectrumModel


class ThomsonScatteringDiagnostic(nn.Module):
    """``diag(ts_params, batch) -> (ThryE [B, 1024], ThryI, lamAxisE [B, 1024], lamAxisI)``;
    for ``angular_full``, ThryE [resolution units in the lineout window, wavelengths] and lamAxisE [wavelengths];
    for ``angular``, ThryE [1024] and lamAxisE [1024].

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
        spectype = cfg["other"]["extraoptions"]["spectype"]
        self.angular = spectype == "angular_full"
        self.batched = "angular" not in spectype
        if self.batched and not any(s in spectype for s in ("temporal", "imaging", "1d")):
            raise NotImplementedError(f"Unknown spectype: {spectype}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype or working_dtype(self.device)
        self.model = SpectrumModel(cfg, scattering_angles, self.device, self.dtype, mode_2v=mode_2v,
                                   shard_2v_points=shard_2v_points)
        if self.angular:
            self.sas = {"angAxis": self._tensor(scattering_angles["angAxis"])}

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def postprocess_theory(self, modlE, modlI, lamAxisE, lamAxisI, amps, TSins):
        """Instrument broadening, rebin and amplitudes of both features; the plain ``angular`` spectype's one
        spectrum [L] goes through the 1D response as a batch of one."""
        if self.batched or self.angular:
            return self._postprocess_theory(modlE, modlI, lamAxisE, lamAxisI, amps, TSins)
        one = {"general": {k: v[None] for k, v in TSins["general"].items()}}
        ThryE, ThryI, lamAxisE, lamAxisI = self._postprocess_theory(modlE[None], modlI[None], lamAxisE, lamAxisI, amps, one)
        return ThryE[0], ThryI[0], lamAxisE, lamAxisI

    def _postprocess_theory(self, modlE, modlI, lamAxisE, lamAxisI, amps, TSins):
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

    @staticmethod
    def _irf_deltas(spectra):
        """[B, n] numpy: ones at each row's two most prominent peaks (prominence 0.1), zeros elsewhere."""
        from scipy.signal import find_peaks

        arr = np.atleast_2d(spectra)
        out = np.zeros_like(arr)
        for i in range(arr.shape[0]):
            try:
                peaks, props = find_peaks(arr[i], prominence=0.1)
                order = np.argsort(props["prominences"])
                out[i, peaks[order[-1]]] = 1.0
                if len(peaks) > 1:
                    out[i, peaks[order[-2]]] = 1.0
            except (ValueError, IndexError):  # no peak: the JAX package's message, and no IRF line
                log_info("Unable to locate peak; IRF may not be plotted")
        return out

    @torch.no_grad()
    def spectrum_breakdown(self, ts_params, batch):
        """The detailed breakdown: ``(modlE, modlI, ThryE, ThryI, eIRF, iIRF, lamAxisE, lamAxisI, lamAxisE_raw,
        lamAxisI_raw)``.

        For a batch of 1V lineouts: modlE/modlI [B, 1024], the total spectra
        through the instrument, with the noise; ThryE/ThryI [B, G, L, A], the
        unreduced component stacks, scaled by each lineout's amplitude over
        the batch's largest entry; eIRF/iIRF [B, 1024], the instrument
        response of the two most prominent peaks of each fitted spectrum,
        scaled the same way; the axes [B, 1024] after the instrument and
        [B, L] before it.  A feature that is off gives zeros [B, 1].  For an
        ``angular_full`` image: modlE the image in the lineout window's
        resolution units (as the forward gives it), ThryE [units, G, L, A]
        (the stack times each unit's amplitude, the JAX package's product),
        eIRF the instrument response of each fine angle's two peaks [fine
        angles, L] scaled by the largest amplitude, the axes unbatched.  The
        JAX package's ``spectrum_breakdown``, with the peak search on the
        host.  Two departures where the JAX package's angular arm fails
        (ROADMAP.md §3): it hands the unreduced stack to
        ``reduce_ATS_to_resunit`` (a [G, L, A] stack is not an image), where
        the port reduces the image, what the 1V arm's modlE is; and it scales
        eIRF's rows by the resolution units' amplitudes, which do not match
        them unless there is one, where the port takes the largest.
        """
        opts = self.cfg["other"]["extraoptions"]
        physical = ts_params()
        amps = {k: self._tensor(batch[k]) for k in ("e_amps", "i_amps")}
        modlE, modlI, ThryE, ThryI, lamE_raw, lamI_raw = self.model.detailed_spectrum(physical)
        modlE, modlI, lamE, lamI = self.postprocess_theory(modlE, modlI, lamE_raw, lamI_raw, amps, physical)

        def deltas(spectra, loaded):
            return self._tensor(self._irf_deltas(spectra.cpu().numpy())) if loaded else torch.zeros_like(spectra)

        eIRF, iIRF = deltas(modlE, opts["load_ele_spec"]), deltas(modlI, opts["load_ion_spec"])
        eIRF, iIRF, lamE, lamI = self.postprocess_theory(eIRF, iIRF, lamE, lamI, amps, physical)
        if self.angular:
            modlE, lamE = self.reduce_ATS_to_resunit(modlE, lamE, physical, batch)
        modlE = modlE + self._tensor(batch["noise_e"])
        modlI = modlI + self._tensor(batch["noise_i"])
        if opts["load_ele_spec"]:
            ThryE = amps["e_amps"].reshape(-1, 1, 1, 1) * ThryE / torch.amax(ThryE)
            # an image's fine-angle rows have no amplitude each: the largest (the JAX package's row-wise product
            # fails there unless e_amps has one entry, and then it is the same)
            e_amps = torch.amax(amps["e_amps"]) if self.angular else amps["e_amps"].reshape(-1, 1)
            eIRF = e_amps * eIRF / torch.amax(eIRF)
        if opts["load_ion_spec"]:
            ThryI = amps["i_amps"].reshape(-1, 1, 1, 1) * ThryI / torch.amax(ThryI)
            iIRF = amps["i_amps"].reshape(-1, 1) * iIRF / torch.amax(iIRF)
        if not self.batched:
            return modlE, modlI, ThryE, ThryI, eIRF, iIRF, lamE, lamI, lamE_raw, lamI_raw
        B = modlE.shape[0]
        per_lineout = lambda a: a.expand(B, -1) if a.dim() == 1 else a  # noqa: E731  one axis a lineout, as JAX's
        return (modlE, modlI, ThryE, ThryI, eIRF, iIRF, *map(per_lineout, (lamE, lamI, lamE_raw, lamI_raw)))

    def forward(self, ts_params, batch):
        return self.spectra(ts_params(), batch)

    def spectra(self, physical_params, batch):
        """The forward model from the physical parameters ``ts_params()``: the span ``diagnostic``, with
        ``spectrum`` and ``irf`` inside it."""
        with trace.span("diagnostic"):
            return self._spectra(physical_params, batch)

    def _spectra(self, physical_params, batch):
        modlE, modlI, lamAxisE, lamAxisI = self.model(physical_params)
        amps = {k: self._tensor(batch[k]) for k in ("e_amps", "i_amps")}
        with trace.span("irf"):
            ThryE, ThryI, lamAxisE, lamAxisI = self.postprocess_theory(
                modlE, modlI, lamAxisE, lamAxisI, amps, physical_params
            )
        if not self.batched:
            if self.angular:
                ThryE, lamAxisE = self.reduce_ATS_to_resunit(ThryE, lamAxisE, physical_params, batch)
            return ThryE + self._tensor(batch["noise_e"]), ThryI + self._tensor(batch["noise_i"]), lamAxisE, lamAxisI
        ThryE = ThryE + self._tensor(batch["noise_e"])
        ThryI = ThryI + self._tensor(batch["noise_i"])
        # one wavelength axis per lineout, as the vmapped JAX model returns them
        B = ThryE.shape[0]
        return ThryE, ThryI, lamAxisE.expand(B, -1), lamAxisI.expand(B, -1)
