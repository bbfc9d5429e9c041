"""``interp2d_cubic`` and ``utils.vector_tools`` against the JAX package's, on the CPU in float64.

* ``interp2d_cubic`` on a non-uniform seeded grid at scattered queries inside
  and beyond it, with ``extrap=True`` (the edge cells' polynomials) and with a
  constant fill, and its gradient with respect to the samples: to 1e-12 of
  the largest entry;
* ``rotate_edf`` of a skewed 2D EDF by 25 degrees (the multiplexed loss's
  ``shot_rot`` in ``tests/test_inverse/test_multiplex.py``) and by -90: the
  values and the gradient of a weighted sum with respect to the EDF to 1e-12
  of the largest entry (the rotation's gathers differentiate as JAX's do);
* the two-vector helpers on tuples, and on a tuple with a scalar.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics.interp import interp2d_cubic as jax_interp2d
from tsadar_tpu.utils import vector_tools as jvt
from tsadar_tpu_torch.core.physics.interp import interp2d_cubic
from tsadar_tpu_torch.utils import vector_tools as vt

TOL = 1e-12


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("extrap", [True, -2.5])
def test_interp2d_cubic_matches_jax(extrap):
    rng = np.random.default_rng(11)
    x, y = np.sort(rng.uniform(0.0, 3.0, 20)), np.sort(rng.uniform(-1.0, 2.0, 15))
    f = np.sin(x)[:, None] * np.cos(2 * y)[None, :] + 0.1 * rng.standard_normal((20, 15))
    xq, yq = rng.uniform(-0.5, 3.5, 300), rng.uniform(-1.5, 2.5, 300)
    weights = rng.standard_normal(300)
    want = jax_interp2d(xq, yq, jnp.asarray(x), jnp.asarray(y), jnp.asarray(f), extrap=extrap)
    g_want = jax.grad(lambda ff: jnp.sum(weights * jax_interp2d(xq, yq, jnp.asarray(x), jnp.asarray(y), ff, extrap=extrap)))(jnp.asarray(f))
    ft = torch.tensor(f, requires_grad=True)
    got = interp2d_cubic(*(torch.tensor(v) for v in (xq, yq, x, y)), ft, extrap=extrap)
    (got * torch.tensor(weights)).sum().backward()
    outside = (xq < x[0]) | (xq > x[-1]) | (yq < y[0]) | (yq > y[-1])
    assert outside.sum() > 30
    if extrap is not True:
        assert np.all(got.detach().numpy()[outside] == extrap)
    _close(got.detach().numpy(), want)
    _close(ft.grad.numpy(), g_want)


@pytest.mark.parametrize("degrees", [25.0, -90.0])
def test_rotate_edf_values_and_gradient_match_jax(degrees):
    angle = degrees * np.pi / 180.0
    vx = np.linspace(-6.0, 6.0, 32)
    f = np.exp(-((vx[None, :] - 0.8) ** 2) / 2.0 - (vx[:, None] ** 2) / 0.8) * (1.0 + 0.2 * vx[None, :])
    weights = np.random.default_rng(5).standard_normal((32, 32))
    want = jvt.rotate_edf(jnp.asarray(f), jnp.asarray(vx), angle)
    g_want = jax.grad(lambda ff: jnp.sum(weights * jvt.rotate_edf(ff, jnp.asarray(vx), angle)))(jnp.asarray(f))
    ft = torch.tensor(f, requires_grad=True)
    got = vt.rotate_edf(ft, torch.tensor(vx), angle)
    (got * torch.tensor(weights)).sum().backward()
    assert got.shape == (32, 32)
    _close(got.detach().numpy(), want)
    _close(ft.grad.numpy(), g_want)
    if degrees == -90.0:  # a quarter turn of the grid's own points: f(x, y) -> f(-y, x), up to the resample's rounding
        np.testing.assert_allclose(got.detach().numpy(), np.rot90(f, k=1), rtol=0, atol=1e-12 * f.max())


def test_two_vector_helpers():
    a, b = (torch.tensor([1.0, 2.0]), torch.tensor(3.0)), (torch.tensor([0.5, 4.0]), torch.tensor(-1.0))
    ja, jb = tuple(jnp.asarray(v.numpy()) for v in a), tuple(jnp.asarray(v.numpy()) for v in b)
    for name in ("vsub", "vadd", "vdot", "vdiv"):
        for args, jargs in (((a, b), (ja, jb)), ((a, 2.0), (ja, 2.0)), ((2.0, b), (2.0, jb))):
            if name in ("vsub", "vadd") and not all(isinstance(v, tuple) for v in args):
                continue
            got, want = getattr(vt, name)(*args), getattr(jvt, name)(*jargs)
            got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
