"""The 2V exact mode and the rotate projection of the port against the JAX package, on the CPU in float64.

* ``FormFactor.rotate`` and ``_project`` at angles of all four quadrants, to
  1e-13 of the EDF's peak (the bicubic rotation in both packages; measured
  ~2e-16);
* the rotate projection's tables (``_chi_tables`` with ``projection="rotate"``:
  the per-angle rotations summed over the perpendicular axis, their gradient,
  the chi_R table) and their gradient with respect to the EDF, against
  ``jax.grad``, to 1e-12 of each output's largest entry;
* the card's NUDFT projection against the rotate projection, within 5e-4 of
  the projection's scale (``test_nudft_projection_matches_rotation``'s bound),
  the check ``chip_smoke.py``'s ``arts_2v_rotate`` makes on the card;
* ``calc_chi_vals`` at single points, and ``calc_in_2D`` in exact mode at
  ``test_2v_table_matches_exact``'s sizes (nv 64, npts 256, three angles)
  with flow and drift at angles: against the JAX exact mode to 1e-8 relative
  plus 1e-11 of peak (the resonance magnifies rounding, as in
  ``test_torch_arts_forward.py``), and against the port's table mode within
  that test's 2e-2 relative / 2e-3 of peak;
* the exact mode's gradient of a seeded scalar of the spectrum with respect
  to the EDF and, through every point's rotation angle beta, to Te, ne, lam,
  Va and ud, against ``jax.grad``, to 1e-7 relative of each (the beta chain
  sums over the resonance);
* the diagnostic and ``LossFunction`` with ``mode_2v="exact"`` on a small
  ARTS 2V deck (npts 32, nvx 32): the image to 1e-9 of peak, the loss to
  1e-10 relative and its gradient with respect to the pointwise EDF to 1e-8
  of its largest entry, against the JAX package's.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.diagnostic import ThomsonScatteringDiagnostic as JaxDiagnostic
from tsadar_tpu.core.physics.form_factor import FormFactor as JaxFormFactor
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu_torch.convert import leaves_by_path
from tsadar_tpu_torch.core.physics.form_factor import FormFactor
import tsadar_tpu_torch as port

from .test_torch_arts_forward import _batch, _config, _params
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

SA = np.array([55.0, 60.0, 65.0])


def _edf(nv=64, vmax=6.0, tilt=0.0):
    """A bi-Maxwellian on the cell-centred grid, normalized; ``tilt`` skews it along vx."""
    dv = 2 * vmax / nv
    vx = np.linspace(-vmax + dv / 2, vmax - dv / 2, nv)
    f = np.exp(-(vx[None, :] ** 2) / 2 - (vx[:, None] ** 2) / (2 * 1.44)) * (1.0 + tilt * vx[None, :] / vmax)
    return vx, f / np.sum(f) / dv**2


def _ff(cls, mode="table", projection="fourier", npts=256, num_beta=256, **kw):
    args = dict(lam_shift=0.0, scattering_angles={"sa": SA}, num_grad_points=1, ud_ang=kw.pop("ud_ang", 0.0),
                va_ang=kw.pop("va_ang", 0.0), num_beta=num_beta, mode=mode, projection=projection)
    if cls is FormFactor:
        return FormFactor([450, 650], npts, device="cpu", dtype=torch.float64, **args)
    return JaxFormFactor([450, 650], npts=npts, **args)


GENERAL = dict(lam=526.5, Va=0.0, ud=0.0, ne_gradient=0.0, Te_gradient=0.0)
ELECTRON = dict(Te=0.5, ne=0.2)


def _jax_params(vx, f, **values):
    g, e = dict(GENERAL), dict(ELECTRON)
    for k, v in values.items():
        (g if k in g else e)[k] = v
    a = jnp.asarray
    return {"electron": {**{k: a(v) for k, v in e.items()}, "fe": a(f), "v": a(vx)},
            "general": {k: a(v) for k, v in g.items()},
            "ion-1": {"A": a(1.0), "Z": a(1.0), "Ti": a(0.2), "fract": a(1.0)}}


def _port_params(vx, f, grad=(), **values):
    """The same parameters as tensors; the names in ``grad`` (and "fe") require grad: {name: tensor}."""
    g, e = dict(GENERAL), dict(ELECTRON)
    for k, v in values.items():
        (g if k in g else e)[k] = v
    leaves = {}

    def t(name, v):
        x = torch.tensor(v, dtype=torch.float64)
        if name in grad:
            leaves[name] = x.requires_grad_()
        return x

    params = {"electron": {**{k: t(k, v) for k, v in e.items()}, "fe": t("fe", f), "v": torch.tensor(vx)},
              "general": {k: t(k, v) for k, v in g.items()},
              "ion-1": {k: torch.tensor(1.0 if k != "Ti" else 0.2, dtype=torch.float64) for k in ("A", "Z", "Ti", "fract")}}
    return params, leaves


@pytest.mark.parametrize("angle", [33.0, 121.0, -100.0, 271.5])
def test_rotate_and_project_match_jax(angle):
    vx, f = _edf(32, tilt=0.3)
    jf, pf = _ff(JaxFormFactor), _ff(FormFactor)
    want = np.asarray(jf.rotate(jnp.asarray(vx), jnp.asarray(f), angle))
    got = pf.rotate(torch.tensor(vx), torch.tensor(f), angle).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * f.max())
    beta = np.deg2rad(angle)
    want = np.asarray(jf._project(jnp.asarray(vx), jnp.asarray(f), jnp.asarray(beta)))
    got = pf._project(torch.tensor(vx), torch.tensor(f), torch.tensor(beta)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())


def test_rotate_projection_tables_and_their_edf_gradient_match_jax():
    vx, f = _edf(32, tilt=0.3)
    jf, pf = _ff(JaxFormFactor, projection="rotate", num_beta=40), _ff(FormFactor, projection="rotate", num_beta=40)
    want = jf._chi_tables(jnp.asarray(vx), jnp.asarray(f))
    DF = torch.tensor(f, requires_grad=True)
    got = pf._chi_tables(torch.tensor(vx), DF)
    for name, g, w in zip(("betas", "f1d", "df1d", "pole_grid", "chiR_tab"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max(), err_msg=name)
    rng = np.random.default_rng(0)
    cots = [rng.standard_normal(np.shape(w)) for w in (want[1], want[4])]

    def jax_scalar(fe):
        _, f1d, _, _, chiR = jf._chi_tables(jnp.asarray(vx), fe)
        return jnp.sum(f1d * cots[0]) + jnp.sum(chiR * cots[1])

    g_want = np.asarray(jax.grad(jax_scalar)(jnp.asarray(f)))
    (g_got,) = torch.autograd.grad(torch.sum(got[1] * torch.tensor(cots[0])) + torch.sum(got[4] * torch.tensor(cots[1])), [DF])
    np.testing.assert_allclose(g_got.numpy(), g_want, rtol=0, atol=1e-12 * np.abs(g_want).max())


def test_the_nudft_projection_matches_the_rotate_projection():
    vx, f = _edf(96)
    pf = _ff(FormFactor, projection="rotate", num_beta=32)
    rot = pf._chi_tables(torch.tensor(vx), torch.tensor(f))[1]
    nudft = pf._project_all_nudft(torch.tensor(vx), torch.tensor(f))
    assert float((nudft - rot).abs().max()) < 5e-4 * float(rot.abs().max())


def test_calc_chi_vals_matches_jax():
    vx, f = _edf(64, tilt=0.3)
    jf, pf = _ff(JaxFormFactor, mode="exact"), _ff(FormFactor, mode="exact")
    for inputs in [(0.7, 1.3, 0.4), (-2.9, 0.05, 0.9), (2.0, 4.2, 0.3), (-0.3, 6.5, 0.5)]:  # the last beyond the grid
        want = jf.calc_chi_vals(jnp.asarray(vx), jnp.asarray(f), tuple(jnp.asarray(v) for v in inputs))
        got = pf.calc_chi_vals(torch.tensor(vx), torch.tensor(f), inputs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-12, atol=1e-15)


def test_exact_calc_in_2D_matches_jax_and_the_table_mode():
    vx, f = _edf(64)
    values = dict(Va=1.5, ud=-1.0)
    kw = dict(ud_ang=200.0, va_ang=30.0)
    want, lam_want = _ff(JaxFormFactor, mode="exact", **kw).calc_in_2D(_jax_params(vx, f, **values))
    params, _ = _port_params(vx, f, **values)
    with torch.no_grad():
        got, lam_got = _ff(FormFactor, mode="exact", **kw).calc_in_2D(params)
        table = _ff(FormFactor, mode="table", **kw).calc_in_2D(params)[0]
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == (1, 256, 3) and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-11 * want.max())
    np.testing.assert_allclose(lam_got.numpy(), np.asarray(lam_want).ravel(), rtol=1e-15)
    np.testing.assert_allclose(table.numpy(), got.numpy(), rtol=2e-2, atol=2e-3 * float(got.max()))


def test_exact_gradient_through_beta_matches_jax():
    vx, f = _edf(32, tilt=0.2)
    values = dict(Va=1.5, ud=-1.0)
    kw = dict(ud_ang=200.0, va_ang=30.0, npts=48)
    names = ("Te", "ne", "lam", "Va", "ud")
    cot = np.random.default_rng(1).standard_normal((1, 48, 3))
    jf = _ff(JaxFormFactor, mode="exact", **kw)

    def jax_scalar(fe, *scalars):
        p = _jax_params(vx, f, **values)
        p["electron"]["fe"] = fe
        for name, s in zip(names, scalars):
            (p["general"] if name in p["general"] else p["electron"])[name] = s
        return jnp.sum(jf.calc_in_2D(p)[0] * cot) * 1e20

    start = [ELECTRON.get(n, values.get(n, GENERAL.get(n))) for n in names]
    want = jax.grad(jax_scalar, argnums=tuple(range(6)))(jnp.asarray(f), *map(jnp.asarray, start))
    params, leaves = _port_params(vx, f, grad=("fe",) + names, **values)
    S = _ff(FormFactor, mode="exact", **kw).calc_in_2D(params)[0]
    got = torch.autograd.grad(torch.sum(S * torch.tensor(cot)) * 1e20, [leaves[n] for n in ("fe",) + names])
    for name, g, w in zip(("fe",) + names, got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all() and np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=name)


def test_diagnostic_and_loss_in_exact_mode_match_jax():
    cfg, sas = _config(size=32, dist_type="arbitrary")
    cfg["data"]["lineouts"].update(start=4, end=28)  # the deck's window, in the 32 resolution units of this CCD
    jp, tp = _params(cfg)
    batch = _batch(cfg)
    want = np.asarray(JaxDiagnostic(cfg, scattering_angles=sas, mode_2v="exact")(jp, batch)[0])
    diag = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu", mode_2v="exact")
    assert diag.model.electron_form_factor.mode == "exact"
    with torch.no_grad():
        got = diag(tp, batch)[0].numpy()
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * want.max())

    # the loss against data 0.9 x this image, as the angular fit sees it
    fit_batch = {"e_data": 0.9 * want, "e_amps": np.ones((want.shape[0], 1)), "i_data": np.ones(1), "i_amps": np.ones(1),
                 "noise_e": np.zeros(1), "noise_i": np.zeros(1)}
    jloss = JaxLoss(cfg, sas, fit_batch, mode_2v="exact")
    from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec, partition

    diff, static = partition(jp, jax_filter_spec(cfg["parameters"], jp))
    (value_w, _), grad_w = jloss._vg_func_(diff, static, {k: jnp.asarray(v) for k, v in fit_batch.items()})
    loss_fn = port.LossFunction(cfg, sas, fit_batch, device="cpu", mode_2v="exact")
    trainable = port.core.params.get_filter_spec(cfg["parameters"], tp)
    (value, _), grads = loss_fn.value_and_grad(tp, fit_batch, trainable)
    np.testing.assert_allclose(float(value), float(value_w), rtol=1e-10)
    g_want = leaves_by_path(grad_w)
    assert set(grads) == set(g_want)
    for path, g in grads.items():
        w = g_want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-8 * np.abs(w).max(), err_msg=path)
