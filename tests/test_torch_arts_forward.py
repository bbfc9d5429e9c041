"""The ARTS 2V forward model of the port against the JAX package, on the CPU in float64.

At the sizes the JAX package's own 2V tests run on the CPU (npts 256, a
256 x 256 CCD, nvx 32; ``num_beta`` stays 256 so that the tables have the
real number of rows):

* ``FormFactor.calc_in_2D`` [G, L, A] with flow and drift at angles and two
  gradient points, to 1e-8 relative (the resonance magnifies rounding) plus
  1e-11 of peak;
* ``add_ATS_IRF`` and ``reduce_ATS_to_resunit`` (ragged last block) on seeded
  images, to rounding;
* the whole diagnostic for the arbitrary and the spherical-harmonic EDF
  against the JAX diagnostic, to 1e-10 of peak, and with the card's
  projection (NUDFT) forced on both sides;
* the committed self-golden ``ThryE-arts2v-self.npy`` at that golden's own
  sizes (npts 512, nvx 64) and tolerance;
* the ARTS 1V deck (a DLM EDF through the unreduced 1V spectrum): the JAX
  diagnostic at reduced size to 1e-9 of peak (JAX's CPU path takes the cubic
  lookup as a matmul, the port its blocked form), and the gradient of a scalar
  of the image with respect to Te, ne and m.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from tsadar_tpu.core.diagnostic import ThomsonScatteringDiagnostic as JaxDiagnostic
from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.physics import form_factor as jff
from tsadar_tpu.core.physics import irf as jirf
from tsadar_tpu.utils.data_handling.calibration import get_calibrations as jax_calibrations
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path, thomson_params_from_jax
from tsadar_tpu_torch.core.physics import irf as pirf
from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges

HERE = os.path.dirname(__file__)
CONFIGS = os.path.join(HERE, "configs")
GOLDEN = os.path.join(HERE, "test_forward", "ThryE-arts2v-self.npy")


def _config(size=256, nvx=32, dist_type=None, decks=("arts2v_test_defaults.yaml", "arts2d_test_inputs.yaml")):
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, n))) for n in decks]
    cfg = set_forward_ranges(merge_configs(*decks))
    cfg["other"]["npts"] = size
    cfg["other"]["CCDsize"] = [size, size]
    fe = cfg["parameters"]["electron"]["fe"]
    fe["nvx"] = nvx
    if fe["dim"] == 2:
        fe["params"].setdefault("nvr", 32)
    if dist_type == "arbitrary":
        fe["type"] = "arbitrary"
        fe["params"].update(init_m=2.5, learn_log=True)
    sas = port.get_scattering_angles(cfg)
    jsas = jax_angles(cfg)
    assert all(np.array_equal(sas[k], jsas[k]) for k in jsas)
    spectype = cfg["other"]["extraoptions"]["spectype"]
    axisxE = port.get_calibrations(104000, spectype, 0.0, cfg["other"]["CCDsize"])
    want = jax_calibrations(104000, spectype, 0.0, cfg["other"]["CCDsize"])
    for g, w in zip(axisxE, want):
        assert g == w if isinstance(w, (dict, int)) else np.array_equal(g, w)
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    sas["angAxis"] = axisxE[0]
    return cfg, sas


def _batch(cfg):
    shape = tuple(cfg["other"]["CCDsize"])
    return {"i_data": np.ones(shape), "e_data": np.ones(shape), "noise_e": np.array([0]), "noise_i": np.array([0]),
            "e_amps": np.array([1]), "i_amps": np.array([1])}


def _params(cfg):
    jp = JaxParams.create(cfg["parameters"], num_params=1, batch=False, activate=True)
    return jp, thomson_params_from_jax(cfg["parameters"], leaves_by_path(jp), activate=True, device="cpu")


def test_calc_in_2D_matches_jax():
    cfg, sas = _config(size=64)
    gen = cfg["parameters"]["general"]
    gen["Va"].update(val=3.0, angle=30.0)
    gen["ud"].update(val=-2.0, angle=200.0)
    gen["Te_gradient"].update(val=8.0, num_grad_points=2)
    gen["ne_gradient"].update(val=12.0, num_grad_points=2)
    jp, tp = _params(cfg)
    ff_args = dict(lam_shift=0.0, num_grad_points=2, ud_ang=200.0, va_ang=30.0, num_beta=256)
    want, lam_want = jff.FormFactor(cfg["other"]["lamrangE"], 64, scattering_angles=sas, **ff_args).calc_in_2D(jp())
    pf = port.core.physics.form_factor.FormFactor(cfg["other"]["lamrangE"], 64, scattering_angles=sas, device="cpu",
                                                  dtype=torch.float64, **ff_args)
    with torch.no_grad():
        got, lam_got = pf.calc_in_2D(tp())
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == (2, 64, 241) and np.isfinite(want).all()
    # at the resonance (|epsilon| ~ 0) the rounding of the two frameworks is magnified: 1.8e-9 relative there
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-11 * want.max())
    np.testing.assert_allclose(lam_got.numpy(), np.asarray(lam_want).ravel(), rtol=1e-15)


@pytest.mark.parametrize("norm", [0, 1])
def test_add_ATS_IRF_matches_jax(norm):
    cfg, sas = _config(size=64)
    cfg["other"]["PhysParams"]["norm"] = norm
    rng = np.random.default_rng(0)
    lam = np.linspace(400.0, 700.0, 64)
    modl = rng.uniform(0.1, 1.0, (1024, 64)) * np.exp(-(((lam - 520.0) / 60.0) ** 2))
    TSins = {"general": {"lam": 526.5, "amp1": 0.8, "amp2": 1.3}}
    lam_w, want = jirf.add_ATS_IRF(cfg, {"angAxis": jnp.asarray(sas["angAxis"])}, jnp.asarray(lam), jnp.asarray(modl), 1.0,
                                   {"general": {k: jnp.asarray(v) for k, v in TSins["general"].items()}})
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    lam_g, got = pirf.add_ATS_IRF(cfg, {"angAxis": t(sas["angAxis"])}, t(lam), t(modl), 1.0,
                                  {"general": {k: t(v) for k, v in TSins["general"].items()}})
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13 * want.max())
    np.testing.assert_array_equal(lam_g.numpy(), np.asarray(lam_w))


def test_reduce_ATS_to_resunit_matches_jax_with_a_ragged_last_block():
    cfg, sas = _config(size=64)
    cfg["other"]["CCDsize"] = [103, 64]  # 1024 fine angles in blocks of 10: the last block holds 4
    cfg["data"]["lineouts"].update(start=9, end=95)
    rng = np.random.default_rng(1)
    ThryE, lam = rng.uniform(0.1, 1.0, (1024, 64)), np.linspace(400.0, 700.0, 64)
    batch = {"e_data": np.ones((86, 21)), "e_amps": rng.uniform(0.5, 2.0, (86, 1))}  # 64 wavelengths in blocks of 3
    jp, tp = _params(cfg)
    want, lam_w = JaxDiagnostic(cfg, scattering_angles=sas).reduce_ATS_to_resunit(jnp.asarray(ThryE), jnp.asarray(lam), jp(), batch)
    diag = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")
    got, lam_g = diag.reduce_ATS_to_resunit(torch.tensor(ThryE), torch.tensor(lam), tp(), batch)
    assert tuple(got.shape) == np.shape(want) == (86, 22)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-13)
    np.testing.assert_allclose(lam_g.numpy(), np.asarray(lam_w), rtol=1e-15)
    assert diag._block_mean(torch.arange(7.0), 3, 0).tolist() == [1.0, 4.0, 6.0]


@pytest.mark.parametrize("dist_type", ["arbitrary", "sphericalharmonic"])
def test_arts_diagnostic_matches_jax(dist_type):
    cfg, sas = _config(dist_type=dist_type)
    jp, tp = _params(cfg)
    want = JaxDiagnostic(cfg, scattering_angles=sas, mode_2v="table")(jp, _batch(cfg))
    with torch.no_grad():
        got = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")(tp, _batch(cfg))
    n_units = (cfg["data"]["lineouts"]["end"] - cfg["data"]["lineouts"]["start"])
    assert got[0].shape == (min(n_units, 256 - cfg["data"]["lineouts"]["start"]), 256) and got[0].dtype == torch.float64
    for name, g, w in zip(("ThryE", "ThryI", "lamAxisE", "lamAxisI"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert np.isfinite(w).all() and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10 * max(np.abs(w).max(), 1e-300), err_msg=name)
    assert float(got[0].min()) > 0.0


def test_arts_diagnostic_with_the_nudft_projection_matches_jax(monkeypatch):
    """The card's projection, forced on the CPU in both packages (JAX keys it on the backend's name)."""
    cfg, sas = _config(dist_type="arbitrary")
    jp, tp = _params(cfg)
    jdiag = JaxDiagnostic(cfg, scattering_angles=sas, mode_2v="table")
    ff = jdiag.model.electron_form_factor
    monkeypatch.setattr(ff, "_project_all_fourier", lambda vx, DF, betas: ff._project_all_nudft(vx, DF))
    want = np.asarray(jdiag(jp, _batch(cfg))[0])
    diag = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")
    with torch.no_grad():
        fourier = diag(tp, _batch(cfg))[0].numpy()
        pf = diag.model.electron_form_factor
        monkeypatch.setattr(pf, "_project_all_fourier", lambda vx, DF, betas: pf._project_all_nudft(vx, DF))
        got = diag(tp, _batch(cfg))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * want.max())
    # the two projections are the same Radon transform: their spectra differ by the fft2 slice's k-space interpolation
    assert 0.0 < np.abs(got - fourier).max() < 2e-2 * want.max()


def test_arts_2v_forward_matches_the_committed_golden():
    cfg, sas = _config(size=512, nvx=64)
    tp = port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu", batch=False)
    with torch.no_grad():
        ThryE = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")(tp, _batch(cfg))[0].numpy()
    golden = np.load(GOLDEN)
    assert ThryE.shape == golden.shape
    np.testing.assert_allclose(ThryE, golden, rtol=1e-6, atol=1e-9 * golden.max())
    np.testing.assert_allclose(ThryE, golden, rtol=0, atol=1e-9 * golden.max())


ARTS_1V = ("arts1v_test_defaults.yaml", "arts1v_test_inputs.yaml")


def test_arts_1v_diagnostic_and_gradient_match_jax():
    cfg, sas = _config(size=128, nvx=64, decks=ARTS_1V)
    jp, tp = _params(cfg)
    assert tp.electron.distribution_functions.normed_m.dim() == 0 and tp()["electron"]["fe"].shape == (64,)
    jdiag = JaxDiagnostic(cfg, scattering_angles=sas)
    want = np.asarray(jdiag(jp, _batch(cfg))[0])
    diag = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")
    got = diag(tp, _batch(cfg))[0]
    assert tuple(got.shape) == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-9 * want.max())

    from tsadar_tpu.core.params import combine, partition
    from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec
    from tsadar_tpu_torch.core.params import get_filter_spec

    cot = np.random.default_rng(0).standard_normal(want.shape)
    diff, static = partition(jp, jax_filter_spec(cfg["parameters"], jp))
    g_ref = leaves_by_path(jax.grad(lambda d: jnp.sum(jdiag(combine(d, static), _batch(cfg))[0] * cot))(diff))
    trainable = get_filter_spec(cfg["parameters"], tp)
    assert set(trainable) == set(g_ref) and len(trainable) >= 3  # Te, ne, m
    grads = torch.autograd.grad(torch.sum(got * torch.tensor(cot)), list(trainable.values()))
    for path, g in zip(trainable, grads):
        np.testing.assert_allclose(g.numpy(), g_ref[path], rtol=1e-6, err_msg=path)


def test_arts_1v_forward_matches_the_committed_golden():
    """The golden's own deck at its own sizes (npts 2048, nvx 256, 241 angles), as the JAX package's test runs it."""
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, n))) for n in ARTS_1V]
    cfg = set_forward_ranges(merge_configs(*decks))
    sas = port.get_scattering_angles(cfg)
    sas["angAxis"] = port.get_calibrations(104000, "angular", 0.0, cfg["other"]["CCDsize"])[0]
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    tp = port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu", batch=False)
    with torch.no_grad():
        ThryE = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")(tp, _batch(cfg))[0].numpy()
    golden = np.load(os.path.join(HERE, "test_forward", "ThryE-arts1v-self.npy"))
    assert ThryE.shape == golden.shape == (860, 1024)
    np.testing.assert_allclose(ThryE, golden, rtol=1e-6, atol=1e-9 * golden.max())


def test_what_the_slice_left_out_raises():
    """What raised here until it was ported runs.  2V point sharding (``tests/test_torch_parallel_2v.py`` holds it
    on 2 and 4 ranks to the JAX package's): in one process, with no process group, the flag does nothing, through
    the diagnostic and through the deck's ``other.shard_2v_points`` in ``LossFunction``, the same image to 1e-12 of
    peak.  The exact mode (``tests/test_torch_exact_mode.py`` holds it to the JAX package) and the plain "angular"
    spectype, here on the 2V deck (1024 wavelengths, the 1D instrument response's rebin) against the JAX
    diagnostic to 1e-10 of peak."""
    cfg, sas = _config(size=64)
    _, tp = _params(cfg)
    sharded = copy.deepcopy(cfg)
    sharded["other"]["shard_2v_points"] = True
    with torch.no_grad():  # the model's image [fine angles, wavelengths]
        image = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu").model(tp())[0].numpy()
        flagged = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu", shard_2v_points=True).model(tp())[0].numpy()
        loss_fn = port.LossFunction(sharded, sas, _batch(cfg), device="cpu")
        through_loss = loss_fn.ts_diag.model(tp())[0].numpy()
    assert loss_fn.ts_diag.model.electron_form_factor.shard_points and image.size and np.abs(image).max() > 0
    for got in (flagged, through_loss):
        np.testing.assert_allclose(got, image, rtol=0, atol=1e-12 * np.abs(image).max())
    assert port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu", mode_2v="exact").model.electron_form_factor.mode == "exact"

    plain = copy.deepcopy(cfg)
    plain["other"]["extraoptions"]["spectype"] = "angular"
    plain["other"]["npts"] = 1024
    jp, tp = _params(plain)
    want = JaxDiagnostic(plain, scattering_angles=sas)(jp, _batch(plain))
    with torch.no_grad():
        got = port.ThomsonScatteringDiagnostic(plain, sas, device="cpu")(tp, _batch(plain))
    assert got[0].shape == (1024,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and np.isfinite(w).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10 * max(np.abs(w).max(), 1e-300))
