"""The port's Dawson function and Z' against the JAX package's, in both dtype branches.

Inputs span the float32 branch's switch to the asymptotic series at |x| = 6
and its clip at 6.5.  Tolerances: float64 to a few ulp of the O(1) values
(1e-14 absolute); float32 to ~25 ulp of |Re Z'| <= 2 (3e-6 absolute), since
the two frameworks' exp and summation round differently.
"""

import sys

import numpy as np
import pytest
import torch
from jax import numpy as jnp

import tsadar_tpu.core.physics.zprime  # noqa: F401  (registers the submodule)
from tsadar_tpu_torch.core.physics import zprime as tzp

# the JAX package's __init__ rebinds `zprime` to the function
jzp = sys.modules["tsadar_tpu.core.physics.zprime"]

X = np.concatenate(
    [np.linspace(-9.0, 9.0, 3001), [-6.5, -6.0, 6.0, 6.5, np.nextafter(6.0, 7.0), -np.nextafter(6.0, 7.0), 0.0]]
)
DTYPES = [(np.float64, 1e-14), (np.float32, 3e-6)]


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_dawsn_matches_jax(dtype, atol):
    x = X.astype(dtype)
    got = tzp.dawsn(torch.as_tensor(x)).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, np.asarray(jzp.dawsn(jnp.asarray(x))), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_zprime_matches_jax(dtype, atol):
    x = X.astype(dtype)
    re, im = tzp.zprime(torch.as_tensor(x))
    jre, jim = jzp.zprime(jnp.asarray(x))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=0, atol=atol)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=0, atol=atol)
