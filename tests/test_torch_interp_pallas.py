"""K10's plain twin and ``interp1d_linear_pallas`` against the JAX package.

* Values and slopes of ``ops.lin_lookup.plain_meta`` on zero-padded tables
  [B, 2048] (n = 2043, the chi_R table's length) against the Pallas kernel
  ``lin_interp_pallas`` in interpret mode, with queries below, on and above
  both grid ends and on inner nodes: float64 on both sides, to 1e-12 of the
  table's max (the kernel's one-hot contraction adds zeros exactly).
* ``interp1d_linear_pallas`` (value and gradients in xq and f, one table [n]
  and per-row tables [B, n]) against ``jax.vjp`` of ``interp1d_linear_blocked``,
  the semantics the JAX wrapper keeps: to 1e-12 of each output's max.
* The padded lookup and its table cotangent against K1/K2's plain forms on the
  unpadded table, exactly.
* On a card: K10 and its backward against their float32 twins and K10 against K1.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics.interp import interp1d_linear_blocked
from tsadar_tpu.ops.interp_kernel import TILE, lin_interp_pallas
from tsadar_tpu_torch.core.physics.interp import interp1d_linear_pallas
from tsadar_tpu_torch.ops import lin_lookup

N, NPAD = 2043, 2048


def _case(b, q, seed=0, n=N):
    """(grid [n], tables [b, n], queries [b, q]) with queries beyond, on and between the grid's nodes."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-8.2, 8.2, n)
    t = rng.standard_normal((b, n))
    xq = rng.uniform(-9.0, 9.0, (b, q))
    edge = [x[0] - 1.0, x[0], x[0] + 1e-9, x[1], x[-2], x[-1] - 1e-9, x[-1], x[-1] + 1.0, x[n // 2], x[n // 3]]
    xq[:, : len(edge)] = edge
    return x, t, xq


def _meta(x):
    return torch.tensor([x[0], x[1] - x[0], len(x)], dtype=torch.float64)


def _padded(t, npad=NPAD):
    return np.concatenate([t, np.zeros((t.shape[0], npad - t.shape[1]))], axis=1)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_twin_matches_pallas_interpret():
    x, t, xq = _case(3, 2 * TILE)
    meta = jnp.stack([x[0], x[1] - x[0], float(N)])
    val, slope = lin_interp_pallas(jnp.asarray(xq), jnp.asarray(_padded(t)), meta, interpret=True)
    got = lin_lookup.plain_meta(torch.tensor(xq), torch.tensor(_padded(t)), _meta(x))
    scale = np.abs(t).max()
    assert float(np.abs(got[0].numpy() - np.asarray(val)).max()) <= 1e-12 * scale
    assert float(np.abs(got[1].numpy() - np.asarray(slope)).max()) <= 1e-12 * scale


def test_padded_forms_equal_the_unpadded_lookup():
    x, t, xq = _case(2, 3000, seed=1)
    q, meta = torch.tensor(xq), _meta(x)
    x0, dx = meta[0], meta[1]
    for got, want in zip(lin_lookup.plain_meta(q, torch.tensor(_padded(t)), meta), lin_lookup.plain(q, torch.tensor(t), x0, dx)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    g = torch.tensor(np.random.default_rng(2).standard_normal(xq.shape))
    got = lin_lookup.plain_meta_bwd(q, g, meta, NPAD)
    assert got.shape == (2, NPAD) and not got[:, N:].any()
    torch.testing.assert_close(got[:, :N], lin_lookup.plain_bwd(q, g, x0, dx, N), rtol=0, atol=0)


@pytest.mark.parametrize("batched", [False, True], ids=["one_table", "per_row_tables"])
def test_values_and_gradients_match_jax_blocked(batched):
    b, n = 3, 257
    x, t, xq = _case(b, 500, seed=3, n=n)
    g = np.random.default_rng(4).standard_normal(xq.shape)
    if not batched:
        t, xq, g = t[0], xq[0].reshape(20, 25), g[0].reshape(20, 25)
        fn = lambda q, f: interp1d_linear_blocked(q, jnp.asarray(x), f)  # noqa: E731
    else:
        fn = jax.vmap(lambda q, f: interp1d_linear_blocked(q, jnp.asarray(x), f))
    want, vjp = jax.vjp(fn, jnp.asarray(xq), jnp.asarray(t))
    want_q, want_t = vjp(jnp.asarray(g))

    q, f = torch.tensor(xq, requires_grad=True), torch.tensor(t, requires_grad=True)
    got = interp1d_linear_pallas(q, torch.tensor(x), f)
    assert got.shape == q.shape
    got_q, got_t = torch.autograd.grad(got, (q, f), torch.tensor(g))
    assert _rel(got.detach().numpy(), want) <= 1e-12
    assert _rel(got_q.numpy(), want_q) <= 1e-12
    assert _rel(got_t.numpy(), want_t) <= 1e-12
    # the query cotangent is zero beyond the grid's ends and on its first node
    edge_q = got_q.numpy().reshape(-1)[:10] if not batched else got_q.numpy()[:, :10]
    assert not np.any(edge_q[..., [0, 1, 7]])


@pytest.mark.cuda
def test_kernels_match_twins_and_k1_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x, t, xq = _case(128, 51_200, seed=5)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    q, tpad, meta = dev(xq), dev(_padded(t)), dev(_meta(x).numpy())
    scale = float(np.abs(t).max())
    got = lin_lookup.lin_lookup_meta_fwd(q, tpad, meta)
    for a, b in zip(got, lin_lookup.plain_meta(q, tpad, meta)):
        assert float((a - b).abs().max()) <= 1e-5 * scale
    for a, b in zip(got, lin_lookup.lin_lookup_fwd(q, tpad[:, :N].contiguous(), float(meta[0]), float(meta[1]))):
        assert float((a - b).abs().max()) <= 1e-5 * scale
    g = dev(np.random.default_rng(6).standard_normal(xq.shape))
    got, want = lin_lookup.lin_lookup_meta_bwd(q, g, meta, NPAD), lin_lookup.plain_meta_bwd(q, g, meta, NPAD)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
