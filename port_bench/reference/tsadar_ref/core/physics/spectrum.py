"""Spectrum assembly: EPW + IAW features, aperture weighting, notch filters.

Counterpart of ``tsadar_tpu.core.physics.spectrum.SpectrumModel``: its
fused-reduce branch (``FormFactor.reduced_1v``) for a batch of 1V lineouts,
and its composed branch for one angular (ARTS) image: the unreduced spectrum
(``FormFactor.calc_in_2D``, or the unreduced 1V ``FormFactor.__call__``), the
mean over gradient points, and for ``angular_full`` the product with the
fine-angle weight matrix, which gives the [angle, wavelength] image.

The plain ``angular`` spectype is unbatched like ``angular_full`` but reduces
as the 1D spectypes do: the fused tail (1V, a batch of one) or the weighted
angle sum (2V), to one spectrum [L].

``detailed_spectrum`` gives, beside the reduced spectra, the unreduced stacks
of both features ([B, G, L, A] of a 1V batch, ``FormFactor.unreduced_1v``;
[G, L, A] of an angular image, ``FormFactor.__call__`` or ``calc_in_2D``,
whose electron feature reduces to the [fine angle, wavelength] image), with
the iaw notch filter's band pressed down by ``FILTER_SUPPRESSION_OD`` in the
electron stack: what ``ThomsonScatteringDiagnostic.spectrum_breakdown``
plots.

Parity quirk kept on purpose: the angle weights are ``weights[0]`` of the
beam's 1-D aperture-weight vector, i.e. ONE scalar that multiplies the plain
angle sum (the reference's ``generate_spectra.py`` indexing, which the JAX
package reproduces).
"""

from typing import Dict

import torch

from .form_factor import FormFactor, _batch_of_one

PROBE_NOTCH_HALF_WIDTH_NM = 3.0  # iawoff notch about the probe line
FILTER_SUPPRESSION_OD = 9  # the OD of the filter band in the unreduced electron stack of a breakdown


class SpectrumModel:
    def __init__(self, config: Dict, scattering_angles: Dict, device, dtype, mode_2v="table", shard_2v_points=False):
        self.config = config
        other = config["other"]
        self.dim = config["parameters"]["electron"]["fe"]["dim"]
        self.angular_full = other["extraoptions"]["spectype"] == "angular_full"
        self.batched = "angular" not in other["extraoptions"]["spectype"]
        grad_cfg = config["parameters"]["general"]
        if grad_cfg["Te_gradient"]["num_grad_points"] != grad_cfg["ne_gradient"]["num_grad_points"]:
            raise ValueError("Number of gradient points for Te and ne must be the same")
        num_grad_points = grad_cfg["Te_gradient"]["num_grad_points"]

        weights = torch.as_tensor(scattering_angles["weights"], dtype=dtype, device=device)
        self.weight = weights[0]
        # ARTS: the whole [fine angle, angle] weight matrix, for the electron feature's image
        self.weight_matrix = weights if self.angular_full else None
        angles_2v = {} if self.dim < 2 else dict(ud_ang=grad_cfg["ud"]["angle"], va_ang=grad_cfg["Va"]["angle"], mode=mode_2v,
                                                  shard_points=shard_2v_points)

        def build(lam_range, lam_shift):
            return FormFactor(lam_range, other["npts"], lam_shift, scattering_angles, num_grad_points, device, dtype,
                              **angles_2v)

        self.electron_form_factor = build(other["lamrangE"], config["data"]["ele_lam_shift"])
        self.ion_form_factor = build(other["lamrangI"], 0) if other["extraoptions"]["load_ion_spec"] else None

    def _reduced(self, form_factor, all_params, image=False):
        """(reduced spectrum, wavelength axis [L] in nm) of one feature; ``image``: the ARTS
        [fine angle, wavelength] image through the weight matrix instead of the weighted angle sum."""
        if self.dim == 1 and not self.angular_full:
            if self.batched:
                reduced, lam_axis = form_factor.reduced_1v(all_params, self.weight)
                return reduced, lam_axis * 1e7
            reduced, lam_axis = form_factor.reduced_1v(_batch_of_one(all_params), self.weight)
            return reduced[0], lam_axis * 1e7
        skw, lam_axis = self._unreduced(form_factor, all_params)  # [G, L, A]
        grad_averaged = torch.mean(skw, dim=0)
        if image:
            return torch.matmul(self.weight_matrix, grad_averaged.T), lam_axis * 1e7
        return torch.sum(grad_averaged * self.weight, dim=1), lam_axis * 1e7

    def __call__(self, all_params: Dict):
        """(ele_reduced [B, L], ion_reduced [B, L], lam_axis_ele [L], lam_axis_ion [L]) in nm.

        A feature that is switched off gives zeros of shape [B, 1] ([1] for
        unbatched parameters); a 2V ``angular_full`` electron feature is the
        image [fine angles, L].
        """
        lam_axis_ion, ion_reduced = self.ion_spectrum(all_params)
        lam_axis_ele, ele_reduced = self.electron_spectrum(all_params)
        return ele_reduced, ion_reduced, lam_axis_ele, lam_axis_ion

    def _off(self, all_params):
        z = torch.zeros_like(all_params["general"]["lam"])[..., None]
        return z, z

    def ion_spectrum(self, all_params):
        if self.ion_form_factor is None:
            return self._off(all_params)
        reduced, lam_axis = self._reduced(self.ion_form_factor, all_params)
        return lam_axis, reduced

    def electron_spectrum(self, all_params):
        if not self.config["other"]["extraoptions"]["load_ele_spec"]:
            return self._off(all_params)
        reduced, lam_axis = self._reduced(self.electron_form_factor, all_params, image=self.angular_full)
        reduced = self._probe_notch(reduced, lam_axis, all_params["general"]["lam"])
        band = self._filter_band()
        if band is not None:
            reduced = self._od_filter(reduced, lam_axis, band)
        return lam_axis, reduced

    def _probe_notch(self, spectrum, lam_axis, probe_lam):
        """iawoff: zero the ion feature within 3 nm of each lineout's probe line."""
        if not self.config["other"]["iawoff"]:
            return spectrum
        near_probe = torch.abs(lam_axis - probe_lam[..., None]) < PROBE_NOTCH_HALF_WIDTH_NM
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
    def _od_filter(spectrum, lam_axis, band, od=None):
        """Multiply the filter band by 10^-OD (physical notch filter); ``od`` overrides the band's own."""
        blue, red, band_od = band
        in_band = (lam_axis > blue) & (lam_axis < red)
        return torch.where(in_band, spectrum * 10.0 ** (-(band_od if od is None else od)), spectrum)

    # -------- detailed (per-component) variants for the postprocess's breakdown --------

    def detailed_spectrum(self, all_params: Dict):
        """(ele_reduced [B, L], ion_reduced [B, L], ele_stack [B, G, L, A], ion_stack, lam_axis_ele [L],
        lam_axis_ion [L]) of a batch of 1V lineouts; unbatched (an angular image, 1V or 2V) the stacks are
        [G, L, A] and the reduced electron feature of ``angular_full`` is the image [fine angles, L].  A feature
        that is off gives zeros [B, 1] ([1] unbatched) for all three."""
        lam_axis_ion, ion_reduced, ion_stack = self.ion_spectrum_detailed(all_params)
        lam_axis_ele, ele_reduced, ele_stack = self.electron_spectrum_detailed(all_params)
        return ele_reduced, ion_reduced, ele_stack, ion_stack, lam_axis_ele, lam_axis_ion

    def _unreduced(self, form_factor, all_params):
        """The unreduced stack [G, L, A] of unbatched parameters (1V or 2V) and its wavelength axis [L] in cm."""
        return form_factor(all_params) if self.dim == 1 else form_factor.calc_in_2D(all_params)

    def _raw(self, form_factor, all_params):
        """The unreduced stack ([B, G, L, A] of a 1V batch, [G, L, A] unbatched) and its wavelength axis [L] in nm."""
        skw, lam_axis = form_factor.unreduced_1v(all_params) if self.batched else self._unreduced(form_factor, all_params)
        return skw, lam_axis * 1e7

    def _angle_sum(self, skw):
        """The gradient mean and the weighted angle sum of an unreduced stack: [B, L] or [L]."""
        return torch.sum(torch.mean(skw, dim=-3) * self.weight, dim=-1)

    def ion_spectrum_detailed(self, all_params):
        if self.ion_form_factor is None:
            z = self._off(all_params)[0]
            return z, z, z
        skw, lam_axis = self._raw(self.ion_form_factor, all_params)
        return lam_axis, self._angle_sum(skw), skw

    def electron_spectrum_detailed(self, all_params):
        if not self.config["other"]["extraoptions"]["load_ele_spec"]:
            z = self._off(all_params)[0]
            return z, z, z
        skw, lam_axis = self._raw(self.electron_form_factor, all_params)
        if self.angular_full:
            reduced = torch.matmul(self.weight_matrix, torch.mean(skw, dim=0).T)
        else:
            reduced = self._angle_sum(skw)
        reduced = self._probe_notch(reduced, lam_axis, all_params["general"]["lam"])
        band = self._filter_band()
        if band is not None:
            reduced = self._od_filter(reduced, lam_axis, band)
            # the band pressed down hard in the unreduced stack: the component plots show the filtered reality
            skw = self._od_filter(skw, lam_axis[:, None], band, od=FILTER_SUPPRESSION_OD)
        return lam_axis, reduced, skw
