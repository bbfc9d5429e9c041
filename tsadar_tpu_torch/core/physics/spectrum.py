"""Spectrum assembly for 1V, non-angular spectypes: EPW + IAW features, notches.

Counterpart of ``tsadar_tpu.core.physics.spectrum.SpectrumModel`` on its
fused-reduce branch (``FormFactor.reduced_1v``), for a batch of lineouts.  The
angular (ARTS) and 2V paths are not ported yet.

Parity quirk kept on purpose: the angle weights are ``weights[0]`` of the
beam's 1-D aperture-weight vector, i.e. ONE scalar that multiplies the plain
angle sum (the reference's ``generate_spectra.py`` indexing, which the JAX
package reproduces).
"""

from typing import Dict

import torch

from .form_factor import FormFactor

PROBE_NOTCH_HALF_WIDTH_NM = 3.0  # iawoff notch about the probe line


class SpectrumModel:
    def __init__(self, config: Dict, scattering_angles: Dict, device, dtype):
        self.config = config
        other = config["other"]
        if config["parameters"]["electron"]["fe"]["dim"] != 1:
            raise NotImplementedError("the PyTorch port runs 1V distributions only so far (ROADMAP.md §1 item 12)")
        if "angular" in other["extraoptions"]["spectype"]:
            raise NotImplementedError("angular (ARTS) spectra are not ported yet (ROADMAP.md §1 item 12)")
        grad_cfg = config["parameters"]["general"]
        if grad_cfg["Te_gradient"]["num_grad_points"] != grad_cfg["ne_gradient"]["num_grad_points"]:
            raise ValueError("Number of gradient points for Te and ne must be the same")
        num_grad_points = grad_cfg["Te_gradient"]["num_grad_points"]

        self.weight = torch.as_tensor(scattering_angles["weights"], dtype=dtype, device=device)[0]

        def build(lam_range, lam_shift):
            return FormFactor(lam_range, other["npts"], lam_shift, scattering_angles, num_grad_points, device, dtype)

        self.electron_form_factor = build(other["lamrangE"], config["data"]["ele_lam_shift"])
        self.ion_form_factor = build(other["lamrangI"], 0) if other["extraoptions"]["load_ion_spec"] else None

    def __call__(self, all_params: Dict):
        """(ele_reduced [B, L], ion_reduced [B, L], lam_axis_ele [L], lam_axis_ion [L]) in nm.

        A feature that is switched off gives zeros of shape [B, 1].
        """
        lam_axis_ion, ion_reduced = self.ion_spectrum(all_params)
        lam_axis_ele, ele_reduced = self.electron_spectrum(all_params)
        return ele_reduced, ion_reduced, lam_axis_ele, lam_axis_ion

    def _off(self, all_params):
        z = torch.zeros_like(all_params["general"]["lam"])[:, None]
        return z, z

    def ion_spectrum(self, all_params):
        if self.ion_form_factor is None:
            return self._off(all_params)
        reduced, lam_axis = self.ion_form_factor.reduced_1v(all_params, self.weight)
        return lam_axis * 1e7, reduced

    def electron_spectrum(self, all_params):
        if not self.config["other"]["extraoptions"]["load_ele_spec"]:
            return self._off(all_params)
        reduced, lam_axis = self.electron_form_factor.reduced_1v(all_params, self.weight)
        lam_axis = lam_axis * 1e7
        reduced = self._probe_notch(reduced, lam_axis, all_params["general"]["lam"])
        band = self._filter_band()
        if band is not None:
            reduced = self._od_filter(reduced, lam_axis, band)
        return lam_axis, reduced

    def _probe_notch(self, spectrum, lam_axis, probe_lam):
        """iawoff: zero the ion feature within 3 nm of each lineout's probe line."""
        if not self.config["other"]["iawoff"]:
            return spectrum
        near_probe = torch.abs(lam_axis - probe_lam[:, None]) < PROBE_NOTCH_HALF_WIDTH_NM
        return torch.where(near_probe, 0.0, spectrum)

    def _filter_band(self):
        """(blue edge, red edge, OD) of the configured iaw notch filter, or None."""
        enabled, od, width, center = self.config["other"]["iawfilter"][:4]
        if not enabled:
            return None
        lam_lo, lam_hi = self.config["other"]["lamrangE"]
        blue, red = center - width / 2, center + width / 2
        if lam_lo >= red or lam_hi <= blue:  # filter entirely outside the range
            return None
        return blue, red, od

    @staticmethod
    def _od_filter(spectrum, lam_axis, band):
        """Multiply the filter band by 10^-OD (physical notch filter)."""
        blue, red, od = band
        in_band = (lam_axis > blue) & (lam_axis < red)
        return torch.where(in_band, spectrum * 10.0 ** (-od), spectrum)
