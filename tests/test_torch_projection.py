"""The 2V projection and chi tables of the port against the JAX package, on the CPU in float64.

* the host-built NUDFT trig tables, full and first-quadrant, entry by entry;
* the slice spectrum's quarter-symmetry recombination against the full tables
  (to rounding: mirrored rows differ by ~1 ulp of the trig);
  ``_project_all_nudft`` against JAX's, on both branches; ``_project_all_fourier`` against JAX's; the two methods against each
  other on a smooth EDF (the fft2 slice interpolates in k-space: 1e-2 of peak at
  nvx = 32);
* ``_chi_tables`` (projection by device rule, ``jnp.gradient``, the PV matmul)
  and the gradient of a scalar of all its tables with respect to the EDF.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics import form_factor as jff
from tsadar_tpu_torch.core.physics import form_factor as pff

NVX, NUM_BETA = 32, 128
SA = {"sa": np.linspace(40.0, 80.0, 5), "weights": np.ones(5)}


def _form_factors(num_beta=NUM_BETA):
    jf = jff.FormFactor([400.0, 700.0], 64, 0.0, SA, 1, ud_ang=0.0, va_ang=0.0, num_beta=num_beta)
    pf = pff.FormFactor([400.0, 700.0], 64, 0.0, SA, 1, "cpu", torch.float64, ud_ang=0.0, va_ang=0.0, num_beta=num_beta)
    return jf, pf


def _edf(seed, nvx=NVX):
    """A smooth, off-centre, anisotropic 2D EDF with a little seeded structure, unit integral."""
    rng = np.random.default_rng(seed)
    dv = 12.0 / nvx
    vx = np.linspace(-6.0 + dv / 2, 6.0 - dv / 2, nvx)
    X, Y = np.meshgrid(vx, vx)  # f[i, j] = f(vx = vx[j], vy = vx[i])
    a, b, c = rng.uniform(0.3, 0.8, 3)
    f = np.exp(-0.5 * ((X - a) ** 2 / 1.3 + (Y + b) ** 2 / 0.8)) * (1.0 + 0.2 * np.tanh(c * X * Y))
    return vx, f / f.sum() / dv**2


@pytest.mark.parametrize("quarter", [False, True])
def test_trig_tables_match_jax(quarter):
    want = (jff._nudft_trig_tables_quarter if quarter else jff._nudft_trig_tables)(16, 8, "float64")
    got = (pff._nudft_trig_tables_quarter if quarter else pff._nudft_trig_tables)(16, 8, torch.float64, "cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    # float32 tables are the float64 ones rounded, not recomputed
    got32 = (pff._nudft_trig_tables_quarter if quarter else pff._nudft_trig_tables)(16, 8, torch.float32, "cpu")
    for g, w in zip(got32, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.float32))


@pytest.mark.parametrize("num_beta", [4, 8, 12, NUM_BETA])
def test_slice_spectrum_quarter_matches_full(num_beta):
    """The first-quadrant recombination against the full tables, at the smallest grid it takes too."""
    f = torch.tensor(_edf(7)[1])
    full, quarter = pff._slice_spectrum_full(f, num_beta), pff._slice_spectrum_quarter(f, num_beta)
    scale = float(torch.hypot(*full).max())
    for part, q, w in zip(("real", "imag"), quarter, full):
        assert tuple(q.shape) == (num_beta, 2 * NVX)
        np.testing.assert_allclose(q.numpy(), w.numpy(), rtol=0, atol=1e-13 * scale, err_msg=part)


def test_nudft_projection_matches_jax():
    jf, pf = _form_factors()
    vx, f = _edf(0)
    want = np.asarray(jf._project_all_nudft(jnp.asarray(vx), jnp.asarray(f)))
    quarter = pf._project_all_nudft(torch.tensor(vx), torch.tensor(f)).numpy()
    peak = np.abs(want).max()
    assert want.shape == (NUM_BETA, NVX)
    np.testing.assert_allclose(quarter, want, rtol=0, atol=1e-13 * peak)
    # every projection carries the EDF's whole weight
    np.testing.assert_allclose(quarter.sum(1) * (vx[1] - vx[0]), 1.0, rtol=1e-6)  # but the tails beyond the grid


def test_nudft_projection_without_quarter_symmetry_matches_jax():
    jf, pf = _form_factors(num_beta=6)  # not a multiple of 4: the full-table branch in both
    vx, f = _edf(1)
    want = np.asarray(jf._project_all_nudft(jnp.asarray(vx), jnp.asarray(f)))
    got = pf._project_all_nudft(torch.tensor(vx), torch.tensor(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())


def test_fourier_projection_matches_jax_and_the_nudft():
    jf, pf = _form_factors()
    vx, f = _edf(2)
    betas = np.linspace(0.0, 2.0 * np.pi, NUM_BETA, endpoint=False)
    want = np.asarray(jf._project_all_fourier(jnp.asarray(vx), jnp.asarray(f), jnp.asarray(betas)))
    got = pf._project_all_fourier(torch.tensor(vx), torch.tensor(f), torch.tensor(betas)).numpy()
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * peak)
    nudft = pf._project_all_nudft(torch.tensor(vx), torch.tensor(f)).numpy()
    np.testing.assert_allclose(got, nudft, rtol=0, atol=1e-2 * peak)  # measured 2.9e-3 at nvx = 32


def test_chi_tables_and_their_gradient_match_jax():
    jf, pf = _form_factors()
    vx, f = _edf(3)
    want = jf._chi_tables(jnp.asarray(vx), jnp.asarray(f))
    ft = torch.tensor(f, requires_grad=True)
    got = pf._chi_tables(torch.tensor(vx), ft)
    for name, g, w in zip(("betas", "f1d", "df1d", "pole_grid", "chiR_tab"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max(), err_msg=name)

    rng = np.random.default_rng(4)
    cots = [rng.standard_normal(np.shape(want[i])) for i in (1, 2, 4)]

    def scalar(F):
        tabs = jf._chi_tables(jnp.asarray(vx), F)
        return sum(jnp.sum(tabs[i] * c) for i, c in zip((1, 2, 4), cots))

    g_ref = np.asarray(jax.grad(scalar)(jnp.asarray(f)))
    sum(torch.sum(got[i] * torch.tensor(c)) for i, c in zip((1, 2, 4), cots)).backward()
    np.testing.assert_allclose(ft.grad.numpy(), g_ref, rtol=0, atol=1e-11 * np.abs(g_ref).max())


def test_chi_tables_gradient_through_the_nudft_matches_jax():
    """The card's projection (NUDFT), differentiated on the CPU: value and gradient against JAX's NUDFT."""
    jf, pf = _form_factors()
    vx, f = _edf(5)
    rng = np.random.default_rng(6)
    cot = rng.standard_normal((NUM_BETA, NVX))
    g_ref = np.asarray(jax.grad(lambda F: jnp.sum(jf._project_all_nudft(jnp.asarray(vx), F) * cot))(jnp.asarray(f)))
    ft = torch.tensor(f, requires_grad=True)
    torch.sum(pf._project_all_nudft(torch.tensor(vx), ft) * torch.tensor(cot)).backward()
    np.testing.assert_allclose(ft.grad.numpy(), g_ref, rtol=0, atol=1e-12 * np.abs(g_ref).max())
