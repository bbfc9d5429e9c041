"""K9's plain twin, its coefficient vectors and its transposed mode against the JAX package.

* The interleaved pole table of ``ops.pv_tables.plain`` (float64) against the
  Pallas kernel ``pv_tables_pallas`` in interpret mode (as
  ``tests/test_ops/test_pv_kernel.py`` runs it, n = 256) and against the
  two-stage Toeplitz forms ``pv_integral_uniform(_nodes)``, to 1e-10 relative;
  the port's own float64 oracles against JAX's to 1e-12.
* The dense matrices built from the kernel's coefficient vectors by the
  kernel's index rule equal ``pv_combined_kernel_np`` bit for bit, at the main
  path's N = 1024 and at a small N: the kernel's indexing is tested here even
  though the kernel runs only on the card.
* The transposed mode (``plain_bwd`` and ``PvTables``'s backward) against
  ``jax.vjp`` of ``ratint.pv_tables_matmul``, to 1e-12 of the largest entry.
* A float64 model of the kernel's loop structure (``pv_tables.cu``): the tiles of
  outputs x lineouts, each warp's mma tiles with their B fragments read from the
  Toeplitz coefficient window, the window and operands staged by the kernel's
  index rule, the special rows 0, m, m + 1, the segments of the contraction
  shared by several blocks and the ordered sum of their shares; against ``ratint.pv_tables_matmul`` in both modes, to
  1e-12 of max, at pole counts and batches on and off the tile.  This is the only
  check of the kernel's index math that runs without a card.
* On a card: the kernel, both modes, against the float64 twin, at B = 128 and
  at a B that leaves the block of 32 lineouts partly empty.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics import ratint as jax_ratint
from tsadar_tpu.ops.pv_kernel import pv_tables_pallas
from tsadar_tpu_torch.core.physics import ratint
from tsadar_tpu_torch.ops import pv_tables

CPU = torch.device("cpu")


def _integrands(b, n, seed=0):
    rng = np.random.default_rng(seed)
    v = np.linspace(-4.0, 4.0, n)
    return np.exp(-(v**2) / 2)[None, :] * rng.uniform(0.5, 1.5, (b, 1)) + 0.01 * rng.standard_normal((b, n))


def _twin(f):
    coef = ratint.pv_coefficients(f.shape[-1] - 2, torch.float64, CPU)
    return pv_tables.plain(torch.tensor(f), coef).numpy()


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


OUT, ROWS, CHUNK, SPLIT = pv_tables.TILE_OUT, pv_tables.TILE_ROWS, pv_tables.CHUNK, pv_tables.SPLIT


def _window(c, idx0, sign, m):
    """``stage_window`` for every tile at once: cw[tile, u] = c[idx0[tile] + sign u] inside [0, 2m - 1), else 0."""
    i = np.asarray(idx0)[:, None] + sign * np.arange(CHUNK + OUT - 1)[None, :]
    return np.where((i >= 0) & (i < 2 * m - 1), c[np.clip(i, 0, 2 * m - 2)], 0.0)


def _warp_steps(acc, cw, xs):
    """One staged segment through every warp's mma tiles: acc [tiles, OUT, rows] += K xs.  Per step of 8
    contraction indices from kl, warp w's tile nt covers outputs pl .. pl + 7, pl = 32 (w % 4) + 8 nt; its B
    fragment is read from the window (lane (gid, tig): K at (kl + k, pl + n) = cw[kl - pl + OUT - 1 + k - n]
    for k = tig, tig + 4 and n = gid) and its A fragment is the staged operand at (kl + k, lineout)."""
    k = np.arange(8)
    for kl in range(0, CHUNK, 8):
        for w in range(OUT // 32):
            for nt in range(4):
                pl = 32 * w + 8 * nt
                b = cw[:, kl - pl + OUT - 1 + k[:, None] - k[None, :]]  # [tiles, k, n]
                acc[:, pl : pl + 8, :] += np.einsum("tkn,kr->tnr", b, xs[kl : kl + 8])


def _ordered_sum(parts):
    total = np.zeros_like(parts[0])
    for part in parts:  # rank order
        total = total + part
    return total


def _model_fwd(f, coef):
    """pv_tables_fwd_kernel in float64: f [B, n], coef [2, 4m] -> [B, 2m - 1]."""
    B, n = f.shape
    m = n - 2
    tiles, rows = -(-m // OUT), -(-B // ROWS) * ROWS
    o0 = np.arange(tiles) * OUT
    fp = np.zeros((rows, n))
    fp[:B] = f
    parts = np.zeros((SPLIT, 2, tiles, OUT, rows))
    p = o0[:, None] + np.arange(OUT)
    for rank in range(SPLIT):
        for k0 in range(rank * CHUNK, n, SPLIT * CHUNK):
            j = k0 + np.arange(CHUNK)
            xs = np.where(((j >= 1) & (j < m))[:, None], fp[:, np.clip(j, 0, n - 1)].T, 0.0)
            for t in range(2):
                _warp_steps(parts[rank, t], _window(coef[t], k0 - o0 - (OUT - 1) + m - 1, 1, m), xs)
        for t in range(2):
            for node, off, here in ((0, 2 * m, rank == 0), (m, 3 * m, (m // CHUNK) % SPLIT == rank)):
                if here:
                    k = np.where(p < m, coef[t][np.clip(off + p, 0, 4 * m - 1)], 0.0)
                    parts[rank, t] += k[:, :, None] * fp[None, None, :, node]
    total = _ordered_sum(parts)  # [2, tiles, OUT, rows]
    out = np.zeros((rows, 2 * tiles * OUT))
    out[:, 0::2], out[:, 1::2] = total[0].reshape(-1, rows).T, total[1].reshape(-1, rows).T
    return out[:B, : 2 * m - 1]


def _model_bwd(g, coef):
    """pv_tables_bwd_kernel in float64: g [B, 2m - 1], coef [2, 4m] -> [B, m + 2]."""
    B, width = g.shape
    m = (width + 1) // 2
    n = m + 2
    tiles, rows = -(-n // OUT), -(-B // ROWS) * ROWS
    o0 = np.arange(tiles) * OUT
    gp = np.zeros((rows, width))
    gp[:B] = g
    parts = np.zeros((SPLIT, tiles, OUT, rows))
    for rank in range(SPLIT):
        special = np.zeros((2, rows))  # this block's share of nodes 0 and m
        for k0 in range(rank * CHUNK, m, SPLIT * CHUNK):
            k = 2 * k0 + np.arange(2 * CHUNK)
            val = np.where(k < width, gp[:, np.clip(k, 0, width - 1)], 0.0)
            xs = (val[:, 0::2].T, val[:, 1::2].T)  # g_mid, g_node [CHUNK, rows]
            pole = k0 + np.arange(CHUNK)
            for t in range(2):
                _warp_steps(parts[rank], _window(coef[t], o0 - k0 + OUT + m - 2, -1, m), xs[t])
                for sel, off in ((0, 2 * m), (1, 3 * m)):
                    kr = np.where(pole < m, coef[t][np.clip(off + pole, 0, 4 * m - 1)], 0.0)
                    special[sel] += (kr[:, None] * xs[t]).sum(0)
        for sel, node in ((0, 0), (1, m)):
            parts[rank, node // OUT, node % OUT] = special[sel]
        parts[rank, (m + 1) // OUT, (m + 1) % OUT] = 0.0
    return _ordered_sum(parts).reshape(-1, rows).T[:B, :n]


@pytest.mark.parametrize("b", [1, 5, 128])
@pytest.mark.parametrize("n", [1024, 1300, 300, 9])
@pytest.mark.parametrize("mode", ["fwd", "bwd"])
def test_kernel_index_model_matches_matmul(mode, n, b):
    m = n - 2
    coef = ratint.pv_coefficients(m, torch.float64, CPU)
    kmid, knode = (k.numpy() for k in ratint.pv_dense(m, torch.float64, CPU))
    if mode == "fwd":
        f = _integrands(b, n, seed=6)
        got = _model_fwd(f, coef.numpy())
        mid, node = ratint.pv_tables_matmul(f, kmid, knode)
        want = np.zeros((b, 2 * m - 1))
        want[:, 0::2], want[:, 1::2] = mid, node
    else:
        g = np.random.default_rng(7).standard_normal((b, 2 * m - 1))
        got = _model_bwd(g, coef.numpy())
        want = g[:, 0::2] @ kmid.T + g[:, 1::2] @ knode[:, :-1].T
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("delta", [0.0, 0.5], ids=["midpoint", "node"])
@pytest.mark.parametrize("n", [1024, 9])
def test_coefficient_matrices_equal_jax_exactly(n, delta):
    want = jax_ratint.pv_combined_kernel_np(n - 2, delta)
    vec = ratint.pv_coefficient_vector(n - 2, delta)
    np.testing.assert_array_equal(ratint.dense_from_coefficients(vec), want)
    np.testing.assert_array_equal(ratint.dense_from_coefficients(torch.tensor(vec)).numpy(), want)
    coef = ratint.pv_coefficients(n - 2, torch.float64, CPU)
    np.testing.assert_array_equal(ratint.dense_from_coefficients(coef[int(delta == 0.5)]).numpy(), want)
    np.testing.assert_array_equal(ratint.pv_dense(n - 2, torch.float64, CPU)[int(delta == 0.5)].numpy(), want)


def test_twin_matches_pallas_interpret():
    n, b = 256, 4
    f = _integrands(b, n)
    mid, node = pv_tables_pallas(jnp.asarray(f), jax_ratint.pv_toeplitz_kernel(n - 2), jax_ratint.pv_node_kernel(n - 2),
                                 interpret=True)
    table = _twin(f)
    assert _rel(table[:, 0::2], mid) <= 1e-10
    assert _rel(table[:, 1::2], np.asarray(node)[:, : n - 3]) <= 1e-10


@pytest.mark.parametrize("n", [256, 1024])
def test_twin_and_oracles_match_the_two_stage_forms(n):
    f = _integrands(3, n, seed=1)
    z = np.linspace(-8.2, 8.2, n)
    table = _twin(f)
    want_mid = np.stack([np.asarray(jax_ratint.pv_integral_uniform(jnp.asarray(r), jnp.asarray(z))[1]) for r in f])
    want_node = np.stack([np.asarray(jax_ratint.pv_integral_uniform_nodes(jnp.asarray(r), jnp.asarray(z))[1]) for r in f])
    assert _rel(table[:, 0::2], want_mid) <= 1e-10
    assert _rel(table[:, 1::2], want_node) <= 1e-10
    poles, mid = ratint.pv_integral_uniform(torch.tensor(f), torch.tensor(z))
    np.testing.assert_allclose(poles.numpy(), 0.5 * (z[1:-1] + z[:-2]), rtol=0, atol=0)
    assert _rel(mid.numpy(), want_mid) <= 1e-12
    poles, node = ratint.pv_integral_uniform_nodes(torch.tensor(f), torch.tensor(z))
    np.testing.assert_array_equal(poles.numpy(), z[1 : n - 2])
    assert _rel(node.numpy(), want_node) <= 1e-12
    np.testing.assert_array_equal(ratint.pv_toeplitz_kernel(n - 2), np.asarray(jax_ratint.pv_toeplitz_kernel(n - 2)))
    np.testing.assert_array_equal(ratint.pv_node_kernel(n - 2), np.asarray(jax_ratint.pv_node_kernel(n - 2)))


@pytest.mark.parametrize("n", [1024, 9])
def test_transposed_mode_matches_jax_vjp(n):
    b, m = 3, n - 2
    f = _integrands(b, n, seed=2)
    g = np.random.default_rng(3).standard_normal((b, 2 * m - 1))
    kmid, knode = jax_ratint.pv_combined_kernels(m)
    _, vjp = jax.vjp(lambda x: jax_ratint.pv_tables_matmul(x, kmid, knode), jnp.asarray(f))
    (want,) = vjp((jnp.asarray(g[:, 0::2]), jnp.asarray(g[:, 1::2])))
    coef = ratint.pv_coefficients(m, torch.float64, CPU)
    assert _rel(pv_tables.plain_bwd(torch.tensor(g), coef).numpy(), want) <= 1e-12

    ft = torch.tensor(f, requires_grad=True)
    table = ratint.pv_tables(ft, coef)
    assert _rel(table.detach().numpy(), _twin(f)) == 0.0
    (got,) = torch.autograd.grad(table, ft, torch.tensor(g))
    assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("b", [128, 5], ids=["whole_blocks", "partial_block"])
def test_kernel_matches_twin_on_card(b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    n = 1024
    f = torch.tensor(_integrands(b, n, seed=4), dtype=torch.float32, device=dev)
    g = torch.tensor(np.random.default_rng(5).standard_normal((b, 2 * n - 5)), dtype=torch.float32, device=dev)
    coef = ratint.pv_coefficients(n - 2, torch.float32, dev)
    coef64 = ratint.pv_coefficients(n - 2, torch.float64, dev)
    table, want = pv_tables.pv_tables_fwd(f, coef), pv_tables.plain(f.double(), coef64)
    assert float((table.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    gf, want = pv_tables.pv_tables_bwd(g, coef), pv_tables.plain_bwd(g.double(), coef64)
    assert float((gf.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
