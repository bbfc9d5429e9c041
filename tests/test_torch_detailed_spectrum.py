"""The port's detailed (per-component) spectra and ``zprimeMaxw`` against the JAX package's, on the CPU in float64.

``SpectrumModel.detailed_spectrum`` on the ``1d-*`` decks at B = 2 lineouts
with spread parameters, carried from the JAX ``ThomsonParams`` (the JAX model
vmapped over them): the reduced spectra, the unreduced [B, G, L, A] stacks and
the wavelength axes, each to 1e-10 of its peak, the ion feature's to 1e-8
(measured 3.3-4.7e-9 over three seeds: JAX's unreduced path assembles
|1 + chiE + chiI|^2 from a complex sum, the port from real and imaginary
parts, and at the ion-acoustic resonance that sum cancels ~4 digits; the EPW's
outputs agree to <= 2e-12).  Cases: the deck as written
(the EPW alone, with its iaw notch filter at OD 4, which the electron stack
gets at OD 9), the filter off, and the ion feature on with the iawoff notch;
the electron stack differs from the unfiltered one only inside the band, by
10^-9.  ``zprimeMaxw``: the [2, ...] stack of (Re Z', Im Z') in both dtypes.
"""

import copy
import sys

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import tsadar_tpu.core.physics.zprime  # noqa: F401  (registers the submodule)
from tsadar_tpu.core.physics.spectrum import SpectrumModel as JaxSpectrumModel
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.core.physics import zprime as tzp
from tsadar_tpu_torch.core.physics.spectrum import FILTER_SUPPRESSION_OD, SpectrumModel
from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges

from .test_torch_diagnostic import _decks, _jax_and_port

jzp = sys.modules["tsadar_tpu.core.physics.zprime"]
TOL = 1e-10  # of each output's peak
ION_TOL = 1e-8  # the ion feature's (module docstring)


def _config(case):
    cfg = set_forward_ranges(merge_configs(*_decks("1d-")))
    if case == "filter_off":
        cfg["other"]["iawfilter"][0] = 0
    elif case == "ion_iawoff":
        cfg["other"]["extraoptions"]["load_ion_spec"] = True
        cfg["other"]["iawoff"] = 1
        cfg["parameters"]["general"]["lam"]["val"] = 526.5  # the probe inside the ion window
    return cfg


def _detailed(cfg, seed=4):
    jp, tp = _jax_and_port(copy.deepcopy(cfg), 2, seed)
    want = jax.vmap(JaxSpectrumModel(cfg, jax_angles(cfg)).detailed_spectrum)(jp())
    with torch.no_grad():
        got = SpectrumModel(cfg, port.get_scattering_angles(cfg), torch.device("cpu"), torch.float64).detailed_spectrum(tp())
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("case", ["as_written", "filter_off", "ion_iawoff"])
def test_detailed_spectrum_matches_jax(case):
    cfg = _config(case)
    want, got = _detailed(cfg)
    names = ("ele_reduced", "ion_reduced", "ele_stack", "ion_stack", "lam_axis_ele", "lam_axis_ion")
    for name, w, g in zip(names, want, got):
        if name.startswith("lam_axis") and g.ndim == 1:
            w = w[0]  # one axis a lineout in JAX, all alike; the port keeps one
            np.testing.assert_array_equal(want[names.index(name)], np.broadcast_to(w, want[names.index(name)].shape))
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        tol = ION_TOL if name.startswith("ion") else TOL
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-300), err_msg=name)
    B, G, L, A = got[2].shape
    assert (B, L) == (2, cfg["other"]["npts"]) and A == len(port.get_scattering_angles(cfg)["sa"])
    if case == "ion_iawoff":
        assert got[3].shape == got[2].shape and np.abs(got[1]).max() > 0.0
    else:
        assert got[3].shape == (2, 1) and not got[3].any()  # the ion feature is off: zeros [B, 1]


def test_the_electron_stack_is_suppressed_in_the_filter_band():
    on, off = _detailed(_config("as_written"))[1], _detailed(_config("filter_off"))[1]
    enabled, od, width, center = _config("as_written")["other"]["iawfilter"][:4]
    lam = on[4]
    band = (lam > center - width / 2) & (lam < center + width / 2)
    assert band.any() and (~band).any()
    np.testing.assert_array_equal(on[2][:, :, ~band], off[2][:, :, ~band])
    np.testing.assert_allclose(on[2][:, :, band], off[2][:, :, band] * 10.0**-FILTER_SUPPRESSION_OD, rtol=1e-14)
    np.testing.assert_allclose(on[0][:, band], off[0][:, band] * 10.0**-od, rtol=1e-14)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-14), (np.float32, 3e-6)])
def test_zprimeMaxw_matches_jax(dtype, atol):
    x = np.linspace(-9.0, 9.0, 603).astype(dtype).reshape(3, 201)
    got = tzp.zprimeMaxw(torch.as_tensor(x)).numpy()
    want = np.asarray(jzp.zprimeMaxw(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 3, 201) and got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
