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
* On a card: the kernel, both modes, against the float64 twin, at B = 128 and
  at a B that leaves the last block of 4 lineouts partly empty.
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
