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

The angular breakdown (``spectrum_breakdown`` of an ``angular_full`` image) on
small ARTS 1V and 2V decks (npts 64, nvx 32, a 48-unit window): the JAX
package's own breakdown fails there (it hands the unreduced [G, L, A] stack to
``reduce_ATS_to_resunit``: "too many values to unpack"; and it scales eIRF's
fine-angle rows by the window's amplitudes, which fails for more than one), so
the oracle is its breakdown step by step with its own functions, reducing the
image instead and scaling eIRF by the largest amplitude
(``_jax_angular_breakdown``), which is what the port does (ROADMAP.md §3); the
decks' windows here carry three amplitudes.
Every output to 1e-10 of its peak (1e-9 for the 1V deck, whose unbatched JAX
model takes its cubic lookup as a matmul; ``tests/test_torch_arts_forward.py``).
"""

import copy
import sys

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import tsadar_tpu.core.physics.zprime  # noqa: F401  (registers the submodule)
from tsadar_tpu.core.diagnostic import ThomsonScatteringDiagnostic as JaxDiagnostic
from tsadar_tpu.core.physics.spectrum import SpectrumModel as JaxSpectrumModel
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.core.physics import zprime as tzp
from tsadar_tpu_torch.core.physics.spectrum import FILTER_SUPPRESSION_OD, SpectrumModel
from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges

from .test_torch_arts_forward import ARTS_1V, _batch as _arts_batch, _config as _arts_config, _params as _arts_params
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


def _irf_deltas(spectra):
    """The JAX package's ``spectrum_breakdown._irf_deltas``: ones at each row's two most prominent peaks."""
    from scipy.signal import find_peaks

    arr = np.asarray(spectra)
    out = np.zeros_like(arr)
    for i in range(arr.shape[0]):
        try:
            peaks, props = find_peaks(arr[i], prominence=0.1)
            order = np.argsort(props["prominences"])
            out[i, peaks[order[-1]]] = 1.0
            if len(peaks) > 1:
                out[i, peaks[order[-2]]] = 1.0
        except (ValueError, IndexError):
            pass
    return jnp.asarray(out)


def _jax_angular_breakdown(jdiag, jp, batch):
    """The JAX package's ``spectrum_breakdown`` of an angular image, its steps in its order with its functions,
    but ``reduce_ATS_to_resunit`` given the image (the package hands it the unreduced stack and fails) and eIRF
    scaled by the largest amplitude (the package's row-wise product fails on a window of several)."""
    physical = jp()
    mE, mI, TE, TI, lE_raw, lI_raw = jdiag.model.detailed_spectrum(physical)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    a = {"e_amps": b["e_amps"], "i_amps": b["i_amps"]}
    mE, mI, lE, lI = jdiag._postprocess(mE, mI, lE_raw, lI_raw, a, physical)
    eI, iI = _irf_deltas(np.atleast_2d(np.asarray(mE))), jnp.zeros_like(mI)
    eI, iI, lE, lI = jdiag._postprocess(eI, iI, lE, lI, a, physical)
    mE, lE = jdiag.reduce_ATS_to_resunit(mE, lE, physical, b)
    TE = jnp.reshape(b["e_amps"], (-1, 1, 1, 1)) * TE / jnp.amax(TE)
    eI = jnp.amax(b["e_amps"]) * eI / jnp.amax(eI)  # the package's jnp.reshape(e_amps, (-1, 1)), for a window's amplitudes
    return mE + b["noise_e"], mI + b["noise_i"], TE, TI, eI, iI, lE, lI, lE_raw, lI_raw


@pytest.mark.parametrize("deck", ["arts_2v", "arts_1v"])
def test_angular_breakdown_matches_jax(deck):
    cfg, sas = _arts_config(size=64, decks=ARTS_1V) if deck == "arts_1v" else _arts_config(size=64)
    cfg["data"]["lineouts"].update(start=8, end=56)
    jp, tp = _arts_params(cfg)
    batch = dict(_arts_batch(cfg), e_amps=np.array([[0.8], [1.3], [1.1]]))  # the window's first units' amplitudes
    batch["e_amps"] = np.resize(batch["e_amps"], (48, 1))
    jdiag = JaxDiagnostic(cfg, scattering_angles=sas)
    with pytest.raises(ValueError, match="too many values to unpack"):
        jdiag.spectrum_breakdown(jp, batch)
    want = _jax_angular_breakdown(jdiag, jp, batch)
    got = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu").spectrum_breakdown(tp, batch)
    tol = 1e-9 if deck == "arts_1v" else TOL
    names = ("modlE", "modlI", "ThryE", "ThryI", "eIRF", "iIRF", "lamAxisE", "lamAxisI", "lamAxisE_raw", "lamAxisI_raw")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and np.isfinite(w).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-300), err_msg=name)
    assert got[0].shape == (48, 64) and got[2].shape[0] == 48 and np.abs(got[4].numpy()).max() > 0.0
