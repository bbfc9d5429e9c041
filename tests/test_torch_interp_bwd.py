"""The port's lookup cotangents against the JAX package's.

For the linear (chi_R table, n = 2043) and the cubic (log-EDF, n = 320) lookup,
on seeded tables, cotangents and queries that cover both edge cells and lie
beyond both ends:

* float64: ``plain_bwd`` (the table cotangent) and both cotangents of the
  ``LinLookup``/``CubicLookup`` Functions against ``jax.vjp`` of
  ``interp1d_linear_blocked``/``interp1d_cubic_blocked`` on the CPU, to 1e-12
  of each cotangent's max (same sums in another order); the linear query
  cotangent is exactly zero beyond the ends (the ``inside`` mask), the cubic
  one is not masked;
* float32: ``plain_bwd`` against the Pallas kernels ``lin_interp_pallas2_bwd``
  and ``cubic_interp_pallas2_bwd`` in interpret mode, folded as the JAX tests
  fold them, to 1e-4 of max (those kernels carry a hi/lo-bf16 split of g);
* the kernel wrappers refuse CPU tensors; kernel against twin runs on the card.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics.interp import interp1d_cubic_blocked, interp1d_linear_blocked
from tsadar_tpu.ops.interp_kernel2 import QT, cubic_interp_pallas2_bwd, lin_interp_pallas2_bwd
from tsadar_tpu_torch.ops import cubic_lookup, lin_lookup

B, Q, BLK = 3, QT, 8
F64_TOL = 1e-12  # of max |cotangent|
PALLAS_TOL = 1e-4  # of max |cotangent|: the Pallas kernels' bf16 hi/lo split of g


def _queries(rng, x0, dx, n, beyond):
    q = rng.uniform(x0 - beyond, x0 + (n - 1) * dx + beyond, (B, Q))
    q[:, :32] = x0 + dx * rng.uniform(0.0, 1.0, (B, 32))  # first cell
    q[:, 32:64] = x0 + dx * (n - 2 + rng.uniform(0.0, 1.0, (B, 32)))  # last cell
    q[:, 64:66] = [x0 - 2 * beyond, x0 + (n - 1) * dx + 2 * beyond]
    return q


def _fold_lin(D2, n):
    """[B, 2c, K] segment cotangents -> [B, n], as interp._blocked_vjp_bwd folds them."""
    k, c = D2.shape[-1], BLK + 1
    dseg = np.asarray(jnp.swapaxes(D2[..., :c, :] + D2[..., c:, :], -1, -2))
    got = np.zeros((B, k * BLK + 1))
    got[:, : k * BLK] = dseg[..., :BLK].reshape(B, -1)
    got[:, BLK::BLK] += dseg[..., BLK]
    return got[:, :n]


def _fold_cubic(D2, n):
    """[B, K, 2c] left-padded segment cotangents -> [B, n], as interp._cubic_blocked_vjp_bwd folds them."""
    k, c = D2.shape[-2], BLK + 3
    dseg = np.asarray(D2[..., :c] + D2[..., c:])
    npad = k * BLK + 3
    got = np.zeros((B, npad))
    got[:, : k * BLK] = dseg[..., :BLK].reshape(B, -1)
    for cix in range(3):
        nfold = (npad - BLK - cix - 1) // BLK + 1
        got[:, BLK + cix :: BLK] += dseg[..., BLK + cix][:, :nfold]
    return got[:, 1 : 1 + n]


@pytest.fixture(scope="module")
def cases():
    """Inputs and the JAX cotangents (f64 XLA vjp, f32 Pallas interpret) of both lookups."""
    rng = np.random.default_rng(0)
    out = {}
    for kind, n, lo, hi, beyond, blocked in (
        ("lin", 2043, -8.2, 8.2, 0.8, interp1d_linear_blocked),
        ("cubic", 320, -7.0, 7.0, 0.1, interp1d_cubic_blocked),
    ):
        x = np.linspace(lo, hi, n)
        x0, dx = float(x[0]), float(x[1] - x[0])
        t = rng.standard_normal((B, n))
        q = _queries(rng, x0, dx, n, beyond)
        g = rng.standard_normal((B, Q))
        fn = jax.vmap(lambda a, b: blocked(a, jnp.asarray(x), b))
        _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(t))
        g_q, g_t = (np.asarray(v) for v in vjp(jnp.asarray(g)))
        f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        k = -(-(n - 1) // BLK)
        if kind == "lin":
            meta = np.array([x0, dx, n])
            pallas = _fold_lin(lin_interp_pallas2_bwd(f32(q), f32(g), f32(meta), k, interpret=True), n)
        else:
            meta = np.tile([x0, dx, n], (B, 1))
            pallas = _fold_cubic(cubic_interp_pallas2_bwd(f32(q), f32(g), f32(meta), k, interpret=True), n)
        out[kind] = dict(x0=x0, dx=dx, n=n, t=t, q=q, g=g, meta=meta, g_q=g_q, g_t=g_t, pallas=pallas,
                         beyond=(q < x0) | (q > x[-1]))
    return out


def _plain_bwd(kind, c, dtype):
    tt = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    if kind == "lin":
        return lin_lookup.plain_bwd(tt(c["q"]), tt(c["g"]), c["x0"], c["dx"], c["n"])
    return cubic_lookup.plain_bwd(tt(c["q"]), tt(c["g"]), tt(c["meta"]), c["n"])


@pytest.mark.parametrize("kind", ["lin", "cubic"])
def test_plain_bwd_matches_jax_vjp_f64(cases, kind):
    c = cases[kind]
    got = _plain_bwd(kind, c, torch.float64).numpy()
    assert got.shape == (B, c["n"])
    np.testing.assert_allclose(got, c["g_t"], rtol=0, atol=F64_TOL * np.abs(c["g_t"]).max())


@pytest.mark.parametrize("kind", ["lin", "cubic"])
def test_function_cotangents_match_jax_vjp_f64(cases, kind):
    c = cases[kind]
    q = torch.tensor(c["q"], requires_grad=True)
    t = torch.tensor(c["t"], requires_grad=True)
    if kind == "lin":
        val = lin_lookup.LinLookup.apply(q, t, c["x0"], c["dx"])
    else:
        val = cubic_lookup.CubicLookup.apply(q, t, torch.tensor(c["meta"]))
    g_q, g_t = torch.autograd.grad(val, (q, t), torch.tensor(c["g"]))
    np.testing.assert_allclose(g_t.numpy(), c["g_t"], rtol=0, atol=F64_TOL * np.abs(c["g_t"]).max())
    np.testing.assert_allclose(g_q.numpy(), c["g_q"], rtol=0, atol=F64_TOL * np.abs(c["g_q"]).max())
    assert c["beyond"].sum() >= 2 * B
    if kind == "lin":  # the value is clamped beyond the ends: no query gradient there
        assert np.all(g_q.numpy()[c["beyond"]] == 0.0) and np.all(c["g_q"][c["beyond"]] == 0.0)
    else:  # the edge cells extrapolate their polynomial: nothing is masked
        assert np.all(g_q.numpy()[c["beyond"]] != 0.0)


@pytest.mark.parametrize("kind", ["lin", "cubic"])
def test_plain_bwd_matches_pallas_f32(cases, kind):
    c = cases[kind]
    got = _plain_bwd(kind, c, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), c["pallas"], rtol=0, atol=PALLAS_TOL * np.abs(c["pallas"]).max())


def test_cubic_outside_taps_are_never_deposited(cases):
    """Queries in the edge cells only: every deposit stays inside the table and sums to g times 1."""
    c = cases["cubic"]
    q = torch.tensor(c["q"][:, :64])
    g = torch.tensor(c["g"][:, :64])
    got = cubic_lookup.plain_bwd(q, g, torch.tensor(c["meta"]), c["n"])
    assert torch.all(got[:, 3:-3] == 0.0)
    # the four stencil weights of a cubic Hermite with FD slopes sum to one
    torch.testing.assert_close(got.sum(-1), g.sum(-1), rtol=0, atol=1e-12 * float(g.abs().sum()))


def test_lookup_functions_pass_gradcheck():
    rng = np.random.default_rng(1)
    n, Qs = 12, 9
    t = torch.tensor(rng.standard_normal((2, n)), requires_grad=True)
    q = torch.tensor(rng.uniform(0.3, n - 1.3, (2, Qs)) + 0.01, requires_grad=True)  # off the cell edges
    meta = torch.tensor(np.tile([0.0, 1.0, n], (2, 1)))
    assert torch.autograd.gradcheck(lambda q_, t_: lin_lookup.LinLookup.apply(q_, t_, 0.0, 1.0), (q, t))
    assert torch.autograd.gradcheck(lambda q_, t_: cubic_lookup.CubicLookup.apply(q_, t_, meta), (q, t))


def test_bwd_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((2, 8), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        lin_lookup.lin_lookup_bwd(q, q, 0.0, 1.0, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cubic_lookup.cubic_lookup_bwd(q, q, torch.zeros((2, 3)), 16)


@pytest.mark.cuda
def test_lookup_bwd_kernels_match_plain_twins_on_card(cases):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    c = cases["lin"]
    want = lin_lookup.plain_bwd(dev(c["q"]), dev(c["g"]), c["x0"], c["dx"], c["n"])
    got = lin_lookup.lin_lookup_bwd(dev(c["q"]), dev(c["g"]), c["x0"], c["dx"], c["n"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    c = cases["cubic"]
    want = cubic_lookup.plain_bwd(dev(c["q"]), dev(c["g"]), dev(c["meta"]), c["n"])
    got = cubic_lookup.cubic_lookup_bwd(dev(c["q"]), dev(c["g"]), dev(c["meta"]), c["n"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
