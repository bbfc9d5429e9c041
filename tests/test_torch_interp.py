"""The port's lookups against the JAX package's, and the dispatch rule.

* float64: the plain forms against ``interp1d_linear_uniform`` and the blocked
  cubic forward (and ``interp1d_cubic_matmul``), row by row, to 1e-12 of the
  table's max.
* float32: the plain forms against the Pallas kernels ``lin_interp_pallas2``
  and ``cubic_interp_pallas2`` in interpret mode, both outputs, to 2e-6 of the
  table's max in the grid (the Pallas kernels' own gate); the cubic's
  extrapolated edge cells, where the t^3 terms amplify rounding, to the JAX
  test's 3e-3 relative.
* On the CPU the dispatch takes the plain form and never a kernel; the kernel
  wrappers refuse CPU tensors.  Kernel against plain twin runs on the card.

Every query set covers both edge cells and queries beyond both ends.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics.interp import interp1d_cubic_blocked, interp1d_cubic_matmul, interp1d_linear_uniform
from tsadar_tpu.ops.interp_kernel2 import (
    QT,
    cubic_interp_pallas2,
    cubic_segments_for_pallas2,
    lin_interp_pallas2,
    segments_for_pallas2,
)
from tsadar_tpu_torch.core.physics import interp as tin
from tsadar_tpu_torch.ops import cubic_lookup, lin_lookup
from tsadar_tpu_torch.utils import trace


def _queries(rng, B, Q, x0, dx, n, beyond):
    q = rng.uniform(x0 - beyond, x0 + (n - 1) * dx + beyond, (B, Q))
    q[:, :32] = x0 + dx * rng.uniform(0.0, 1.0, (B, 32))  # first cell
    q[:, 32:64] = x0 + dx * (n - 2 + rng.uniform(0.0, 1.0, (B, 32)))  # last cell
    q[:, 64:66] = [x0 - 2 * beyond, x0 + (n - 1) * dx + 2 * beyond]
    return q


def _lin_case(dtype, B=3, Q=QT, n=2043, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(-8.2, 8.2, n).astype(dtype)
    t = rng.standard_normal((B, n)).astype(dtype)
    q = _queries(rng, B, Q, float(x[0]), float(x[1] - x[0]), n, 0.8).astype(dtype)
    return x, t, q


def _cubic_case(dtype, B=3, Q=QT, n=320, seed=1):
    rng = np.random.default_rng(seed)
    x = np.linspace(-7.0, 7.0, n).astype(dtype)
    t = (-(x.astype(np.float64) ** 2) / 2 + 0.1 * rng.standard_normal((B, n))).astype(dtype)
    q = _queries(rng, B, Q, float(x[0]), float(x[1] - x[0]), n, 0.1).astype(dtype)
    meta = np.tile([x[0], x[1] - x[0], n], (B, 1)).astype(dtype)
    return x, t, q, meta


def test_lin_plain_matches_jax_f64():
    x, t, q = _lin_case(np.float64)
    val, slope = tin.lin_lookup_plain(torch.as_tensor(q), torch.as_tensor(t), x[0], x[1] - x[0])
    want = jax.vmap(lambda a, b: interp1d_linear_uniform(a, jnp.asarray(x), b))(q, t)
    np.testing.assert_allclose(val.numpy(), np.asarray(want), rtol=0, atol=1e-12 * np.abs(t).max())
    i0 = np.minimum(np.floor(np.clip((q - x[0]) / (x[1] - x[0]), 0, len(x) - 1)).astype(int), len(x) - 2)
    want_slope = np.take_along_axis(t, i0 + 1, 1) - np.take_along_axis(t, i0, 1)
    np.testing.assert_array_equal(slope.numpy(), want_slope)


def test_cubic_plain_matches_jax_f64():
    x, t, q, meta = _cubic_case(np.float64)
    val, dval = tin.cubic_lookup_plain(torch.as_tensor(q), torch.as_tensor(t), torch.as_tensor(meta))
    fn = jax.vmap(lambda a, b: interp1d_cubic_blocked(a, jnp.asarray(x), b))
    want, vjp = jax.vjp(lambda q_: fn(q_, t), jnp.asarray(q))
    (dq,) = vjp(jnp.ones_like(want))  # d out / d q = (d out / d t) / dx
    scale = np.abs(t).max()
    np.testing.assert_allclose(val.numpy(), np.asarray(want), rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(dval.numpy(), np.asarray(dq) * (x[1] - x[0]), rtol=0, atol=1e-12 * scale)
    matmul = jax.vmap(lambda a, b: interp1d_cubic_matmul(a, jnp.asarray(x), b))(q, t)
    np.testing.assert_allclose(val.numpy(), np.asarray(matmul), rtol=0, atol=1e-12 * scale)
    # and the port's own weight-matrix form (the EDF on the xi grid), with its fill beyond the ends
    xq = torch.as_tensor(q[0])
    got = tin.interp1d_cubic_matmul(xq, torch.as_tensor(x), torch.as_tensor(t), (-50.0, -50.0))
    want = jax.vmap(lambda b: interp1d_cubic_matmul(q[0], x, b, extrap=(-50.0, -50.0)))(t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12 * scale)


def test_lin_plain_matches_pallas_f32():
    x, t, q = _lin_case(np.float32, B=2)
    meta = jnp.stack([x[0], x[1] - x[0], jnp.asarray(float(len(x)), jnp.float32)])
    out, diff = lin_interp_pallas2(jnp.asarray(q), segments_for_pallas2(jnp.asarray(t)), meta, interpret=True)
    val, slope = tin.lin_lookup_plain(torch.as_tensor(q), torch.as_tensor(t), float(x[0]), float(x[1] - x[0]))
    assert val.dtype == torch.float32
    tol = 2e-6 * np.abs(t).max()
    np.testing.assert_allclose(val.numpy(), np.asarray(out), rtol=0, atol=tol)
    np.testing.assert_allclose(slope.numpy(), np.asarray(diff), rtol=0, atol=tol)


def test_cubic_plain_matches_pallas_f32():
    x, t, q, meta = _cubic_case(np.float32, B=2)
    out, dout = cubic_interp_pallas2(jnp.asarray(q), cubic_segments_for_pallas2(jnp.asarray(t)), jnp.asarray(meta),
                                     interpret=True)
    val, dval = tin.cubic_lookup_plain(torch.as_tensor(q), torch.as_tensor(t), torch.as_tensor(meta))
    inside = (q >= x[0]) & (q <= x[-1])
    scale = np.abs(t).max()
    for got, want in ((val.numpy(), np.asarray(out)), (dval.numpy(), np.asarray(dout))):
        np.testing.assert_allclose(got[inside], want[inside], rtol=0, atol=2e-6 * scale)
        np.testing.assert_allclose(got, want, rtol=3e-3, atol=2e-6 * scale)


def test_cpu_dispatch_takes_the_plain_forms():
    x, t, q, meta = _cubic_case(np.float64, Q=256)
    qt, tt, mt = torch.as_tensor(q), torch.as_tensor(t), torch.as_tensor(meta)
    counts = trace.counters()
    # the differentiable lookups return the value alone; its derivative feeds their backward
    torch.testing.assert_close(tin.cubic_lookup(qt, tt, mt), tin.cubic_lookup_plain(qt, tt, mt)[0], rtol=0, atol=0)
    torch.testing.assert_close(
        tin.lin_lookup(qt, tt, x[0], x[1] - x[0]), tin.lin_lookup_plain(qt, tt, x[0], x[1] - x[0])[0], rtol=0, atol=0
    )
    assert trace.counters() == counts  # no kernel launched


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((2, 8), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        lin_lookup.lin_lookup_fwd(q, torch.zeros((2, 16)), 0.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        cubic_lookup.cubic_lookup_fwd(q, torch.zeros((2, 16)), torch.zeros((2, 3)))
    with pytest.raises(ValueError):
        tin.lin_lookup(q, torch.zeros((2, 16), device="meta"), 0.0, 1.0)


@pytest.mark.cuda
def test_lookup_kernels_match_plain_twins_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x, t, q = _lin_case(np.float32)
    qt, tt = torch.tensor(q, device="cuda"), torch.tensor(t, device="cuda")
    x0, dx = float(x[0]), float(x[1] - x[0])
    for got, want in zip(lin_lookup.lin_lookup_fwd(qt, tt, x0, dx), lin_lookup.plain(qt, tt, x0, dx)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(tt.abs().max()))
    x, t, q, meta = _cubic_case(np.float32)
    qt, tt, mt = (torch.tensor(a, device="cuda") for a in (q, t, meta))
    for got, want in zip(cubic_lookup.cubic_lookup_fwd(qt, tt, mt), cubic_lookup.plain(qt, tt, mt)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(tt.abs().max()))
