"""The port's pole-aware integration (``ratint.ratcen``, ``ratintn``, ``pv_integral``) against the JAX package's,
on the CPU in float64.

* the per-interval values and the integrals on seeded integrands, poles
  between nodes, near a node and far outside the grid (both branches of the
  far/near split), to 1e-13 relative of each output's largest entry (the two
  frameworks round the logs alike; measured <= 3e-16);
* the analytic and quadrature cases of ``tests/test_physics/test_ratint.py``,
  at that file's tolerances (1e-6, 1e-6, 1e-5 relative): a constant and a
  linear numerator, and exp(-z^2), whose PV integral is -2 sqrt(pi) D(p);
* ``pv_integral`` against ``ratintn`` one pole at a time (1e-12), and its
  one-pole-a-row form (f [P, N], poles [P]) against the same;
* gradients: finite with a pole exactly on a node and on a midpoint, and
  equal to ``jax.grad``'s there and for a batch of poles (1e-10 relative; the
  guarded branches make both exact zeros or the same values).
"""

import jax
import numpy as np
import pytest
import scipy.special as sps
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics import ratint as jr
from tsadar_tpu_torch.core.physics import ratint as pr

TOL = 1e-13  # of each output's largest entry


def _grid(n=2001, lo=-4.0, hi=4.0, offset=0.0137):
    return np.linspace(lo + offset, hi + offset, n)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def _integrand(z, seed):
    rng = np.random.default_rng(seed)
    return np.exp(-(z**2)) * (1.0 + 0.3 * z) + 0.05 * rng.standard_normal(z.shape) * np.exp(-(z**2) / 4)


@pytest.mark.parametrize("p", [0.0137 + 1e-9, -1.3, 2.71, 25.0])
def test_ratcen_and_ratintn_match_jax(p):
    """p 0.0137 + 1e-9 sits 1e-9 off a node (the log branch with one tiny side), 25 outside the grid (all far)."""
    z = _grid(401)
    f = np.stack([_integrand(z, s) for s in range(3)])
    _close(pr.ratcen(t(f), t(z - p)), jr.ratcen(jnp.asarray(f), jnp.asarray(z - p)))
    _close(pr.ratintn(t(f), t(z - p), t(z)), jr.ratintn(jnp.asarray(f), jnp.asarray(z - p), jnp.asarray(z)))
    got = pr.ratintn(t(f[0]), t(z - p), t(z))
    assert got.dim() == 0
    _close(got, jr.ratintn(jnp.asarray(f[0]), jnp.asarray(z - p), jnp.asarray(z)))


def test_pv_integral_matches_jax_and_ratintn():
    z = _grid()
    f = _integrand(z, 4)
    poles = np.array([[-2.5, -0.31, 0.0], [0.44, 3.1, float(z[1000])]])
    got = pr.pv_integral(t(f), t(z), t(poles))
    assert tuple(got.shape) == poles.shape
    _close(got, jr.pv_integral(jnp.asarray(f), jnp.asarray(z), jnp.asarray(poles)))
    single = torch.stack([pr.ratintn(t(f), t(z) - p, t(z)) for p in poles.ravel()]).reshape(poles.shape)
    _close(got, single.numpy(), 1e-12)
    rows = np.stack([_integrand(z, s) for s in range(3)])  # one pole a row, as the exact mode calls it
    got = pr.pv_integral(t(rows), t(z), t(poles[0]))
    want = [float(jr.ratintn(jnp.asarray(r), jnp.asarray(z - p), jnp.asarray(z))) for r, p in zip(rows, poles[0])]
    _close(got, want, 1e-12)


def test_constant_numerator_analytic():
    z = _grid()
    a, b = z[0], z[-2]
    for p in [0.0, 0.5, -1.7, 3.9]:
        got = float(pr.ratintn(torch.ones(z.shape, dtype=torch.float64), t(z - p), t(z)))
        np.testing.assert_allclose(got, np.log(abs(b - p)) - np.log(abs(a - p)), rtol=1e-6, atol=1e-8)


def test_linear_numerator_analytic():
    z = _grid()
    a, b = z[0], z[-2]
    for p in [0.2, -2.3]:
        got = float(pr.ratintn(t(z), t(z - p), t(z)))
        np.testing.assert_allclose(got, (b - a) + p * (np.log(abs(b - p)) - np.log(abs(a - p))), rtol=1e-6)


def test_smooth_numerator_vs_the_dawson_function():
    z = _grid(80001, -8.0, 8.0, offset=0.0)
    p = 0.77
    got = float(pr.ratintn(t(np.exp(-(z**2))), t(z - p), t(z)))
    np.testing.assert_allclose(got, -2.0 * np.sqrt(np.pi) * sps.dawsn(p), rtol=1e-5)


@pytest.mark.parametrize("where", ["node", "midpoint"])
def test_gradient_with_a_pole_on_the_grid_is_finite_and_jaxs(where):
    z = _grid(501)
    p0 = z[250] if where == "node" else 0.5 * (z[250] + z[251])

    def jax_loss(p, amp):
        return jr.pv_integral(amp * jnp.exp(-jnp.asarray(z) ** 2), jnp.asarray(z), jnp.stack([p]))[0]

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(p0), jnp.asarray(1.3))
    p, amp = t(p0).requires_grad_(), t(1.3).requires_grad_()
    value = pr.pv_integral(amp * torch.exp(-t(z) ** 2), t(z), p.reshape(1))[0]
    got = torch.autograd.grad(value, [p, amp])
    assert all(bool(torch.isfinite(g)) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-10)


def test_gradient_over_a_batch_of_poles_matches_jax():
    z = _grid(501)
    poles = np.linspace(-3.0, 3.0, 64)
    f0 = _integrand(z, 5)

    def jax_loss(f, ps):
        return jnp.sum(jr.pv_integral(f, jnp.asarray(z), ps) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(f0), jnp.asarray(poles))
    f, ps = t(f0).requires_grad_(), t(poles).requires_grad_()
    got = torch.autograd.grad(torch.sum(pr.pv_integral(f, t(z), ps) ** 2), [f, ps])
    for g, w in zip(got, want):
        _close(g, w, 1e-10)
