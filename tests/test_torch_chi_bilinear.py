"""The fused bilinear lookup of the stacked 2V chi tables (K7) and its cotangent (K8).

The plain twins of ``tsadar_tpu_torch.ops.chi_bilinear`` against the same
function three ways in the JAX package, on the CPU:

* JAX's ``FormFactor._interp_beta_v`` (four scalar gathers, what the JAX package
  runs on the CPU) in float64, to rounding;
* ``periodic_linear_rowmix`` + ``select_columns_linear`` and their autodiff in
  float64, to rounding (the bf16 split there is the identity in float64):
  values, the three d/dxq, dT and dbeta;
* the Pallas kernels ``chi_bilinear_pallas`` / ``chi_bilinear_pallas_bwd`` in
  interpret mode, float32: to 5e-5 of each segment's largest entry, which is
  what their hi/lo bf16 split of tables and weights keeps (2^-16).

Queries wrap both ways in beta and run past both ends of the velocity grid; a
separate edge set holds beta = -1e-8, 2 pi - 1e-7, 0, +-pi and x below the
grid, above it and exactly on nodes.  The kernels themselves run only on a
CUDA device (``cuda`` marker).

A float64 numpy model of the cotangent kernel's deposit rule (32 consecutive
queries a warp; its 12 deposits keyed by (row 0, cell), runs of neighbouring
lanes with one key summed by ``csrc/warp_deposit.cuh``'s segmented scan and
added once, an aligned pair of columns as one vector atomic, exact zeros not
added), with the block size read from
``csrc/chi_bilinear.cu``, gives ``plain_bwd``'s dT on uniform, wrapping and
angle-interleaved crowded queries (the deck's [L, A] layout, angles innermost).
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics import interp as jinterp
from tsadar_tpu.core.physics.form_factor import FormFactor as JaxFormFactor
from tsadar_tpu.ops.bilinear_kernel import QT, chi_bilinear_pallas, chi_bilinear_pallas_bwd, tables_for_bilinear
from tsadar_tpu_torch.core.physics import interp as pinterp
from tsadar_tpu_torch.ops import chi_bilinear

from .test_torch_interp_bwd import _cuda_constants, _model_warp_runs

R, NVX = 128, 32
C = 3 * NVX - 2
V0X, DVX = -6.0 + 6.0 / NVX, 12.0 / NVX
# a pole grid with its own origin AND spacing: a swap of the two grids must not pass
V0P, DVP = V0X + 0.37, 1.7 * DVX
SEGS = [(0, NVX, V0X, DVX), (NVX, 2 * NVX, V0X, DVX), (2 * NVX, C, V0P, DVP)]


def _case(seed, Q, dtype=np.float64):
    rng = np.random.default_rng(seed)
    T = (rng.standard_normal((R, C)) * 2).astype(dtype)
    bq = rng.uniform(-7, 13, Q).astype(dtype)  # wraps both ways
    xq = rng.uniform(-7.5, 7.5, Q).astype(dtype)  # runs past both ends
    gs = rng.standard_normal((3, Q)).astype(dtype)
    return T, bq, xq, gs


def _edge_queries():
    """(beta, x) pairs: every edge angle with every edge position."""
    betas = [-1e-8, 2 * math.pi - 1e-7, 0.0, math.pi, -math.pi, 2 * math.pi, -2 * math.pi - 1e-9]
    xs = [V0X - 1.0, V0X, V0X + DVX * (NVX - 1), V0X + DVX * (NVX - 1) + 1.0, V0X + 3 * DVX, V0P, V0P + DVP * (NVX - 3),
          V0P + DVP * 5, 0.123]
    b, x = np.meshgrid(betas, xs, indexing="ij")
    return b.ravel(), x.ravel()


def _meta(dtype):
    return torch.tensor([V0X, DVX, V0P, DVP], dtype=dtype)


def _jax_composition(T, b, x):
    S = jinterp.periodic_linear_rowmix(T, b)
    return [jinterp.select_columns_linear(S[:, c0:c1], v0, dv, x) for c0, c1, v0, dv in SEGS]


def _twin(T, bq, xq, dtype=torch.float64):
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return chi_bilinear.plain_fwd(t(bq), t(xq), t(T), _meta(dtype))


@pytest.mark.parametrize("queries", ["random", "edges"])
def test_twin_values_match_jax_interp_beta_v(queries):
    T, bq, xq, _ = _case(0, 700)
    if queries == "edges":
        bq, xq = _edge_queries()
    out = _twin(T, bq, xq)
    for s, (c0, c1, v0, dv) in enumerate(SEGS):
        want = JaxFormFactor._interp_beta_v(jnp.asarray(T[:, c0:c1]), v0, dv, jnp.asarray(bq), jnp.asarray(xq))
        np.testing.assert_allclose(out[s].numpy(), np.asarray(want), rtol=0, atol=1e-13 * np.abs(T).max())


def test_rowmix_and_column_select_match_jax():
    T, bq, xq, _ = _case(1, 300)
    S = pinterp.periodic_linear_rowmix(torch.tensor(T), torch.tensor(bq))
    want = jinterp.periodic_linear_rowmix(jnp.asarray(T), jnp.asarray(bq))
    np.testing.assert_allclose(S.numpy(), np.asarray(want), rtol=0, atol=1e-13 * np.abs(T).max())
    for c0, c1, v0, dv in SEGS:
        got = pinterp.select_columns_linear(S[:, c0:c1], v0, dv, torch.tensor(xq))
        ref = jinterp.select_columns_linear(want[:, c0:c1], v0, dv, jnp.asarray(xq))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-13 * np.abs(T).max())


def test_twin_and_its_cotangents_match_jax_composition_float64():
    T, bq, xq, gs = _case(2, 900)
    out = _twin(T, bq, xq)
    refs = _jax_composition(jnp.asarray(T), jnp.asarray(bq), jnp.asarray(xq))
    scale = np.abs(T).max()
    for s in range(3):
        np.testing.assert_allclose(out[s].numpy(), np.asarray(refs[s]), rtol=0, atol=1e-13 * scale)

    def loss(T_, b_, x_):
        return sum(jnp.sum(o * g) for o, g in zip(_jax_composition(T_, b_, x_), gs))

    dT_ref, db_ref, dx_ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(T), jnp.asarray(bq), jnp.asarray(xq))
    t = torch.tensor
    dT, db = chi_bilinear.plain_bwd(t(bq), t(xq), t(T), _meta(torch.float64), t(gs))
    dx = torch.sum(t(gs) * out[3:], dim=0)
    for name, got, ref in (("dT", dT, dT_ref), ("dbeta", db, db_ref), ("dxq", dx, dx_ref)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max(), err_msg=name)


def test_derivative_outputs_vanish_where_the_position_is_clamped():
    T = _case(3, 1)[0]
    bq, xq = _edge_queries()
    out = _twin(T, bq, xq)
    t = torch.tensor
    for s, (c0, c1, v0, dv) in enumerate(SEGS):
        raw = (xq - v0) / dv
        clamped = (raw <= 0.0) | (raw >= (c1 - c0) - 1.0)
        assert clamped.any() and (~clamped).any()
        assert torch.all(out[3 + s][t(clamped)] == 0.0)
        # the value there is the end column's row mix
        end = np.where(raw <= 0.0, c0, c1 - 1)
        ib0, ib1, wb = pinterp.rowmix_indices(R, t(bq))
        want = (1 - wb) * t(T)[ib0, t(end)] + wb * t(T)[ib1, t(end)]
        np.testing.assert_allclose(out[s][t(clamped)].numpy(), want[t(clamped)].numpy(), rtol=0, atol=1e-14 * np.abs(T).max())
    # beta one ulp below a whole turn rounds up to row R in float32: row 0, weight 0
    ib0, ib1, wb = pinterp.rowmix_indices(R, torch.tensor([-1e-8], dtype=torch.float32))
    assert (int(ib0), int(ib1), float(wb)) == (0, 1, 0.0)
    ib0, ib1, wb = pinterp.rowmix_indices(R, torch.tensor([-math.pi, math.pi], dtype=torch.float64))
    assert ib0.tolist() == [R // 2, R // 2] and torch.all(wb < 1e-9)


@pytest.mark.parametrize("queries", ["random", "edges"])
def test_twin_matches_pallas_kernels_interpret_float32(queries):
    """Forward and backward against the TPU kernels themselves, as the JAX tests run them on the CPU."""
    Q = 2 * QT
    T, bq, xq, gs = _case(4, Q, np.float32)
    if queries == "edges":
        eb, ex = _edge_queries()
        bq[: eb.size], xq[: ex.size] = eb, ex
    tsplit = tables_for_bilinear(jnp.asarray(T)[None])
    meta = jnp.asarray([[V0X, DVX, V0P, DVP]], jnp.float32)
    want = chi_bilinear_pallas(jnp.asarray(bq)[None], jnp.asarray(xq)[None], tsplit, meta, NVX, interpret=True)
    out = _twin(T, bq, xq, torch.float32)
    # at an exact cell edge a float32 position can fall into the neighbouring cell of the kernel's: the
    # value is continuous there, the derivative is not, so derivatives are compared where float32 and
    # float64 agree on the cell (all but a handful of queries)
    seg_max = [float(np.abs(T[:, c0:c1]).max()) for c0, c1, _, _ in SEGS]
    t32, t64 = torch.tensor(xq), torch.tensor(xq, dtype=torch.float64)
    rows_same = pinterp.rowmix_indices(R, torch.tensor(bq))[0] == pinterp.rowmix_indices(R, torch.tensor(bq).double())[0]
    for s, (c0, c1, v0, dv) in enumerate(SEGS):
        np.testing.assert_allclose(out[s].numpy(), np.asarray(want[s][0]), rtol=0, atol=5e-5 * seg_max[s])
        cells = [pinterp.col_cell(x, torch.tensor(v0, dtype=x.dtype), torch.tensor(dv, dtype=x.dtype), c1 - c0) for x in (t32, t64)]
        same = (rows_same & (cells[0][0] == cells[1][0]) & (cells[0][2].double() == cells[1][2])).numpy()
        assert same.mean() > 0.95  # the edge set sits on cell edges on purpose
        miss = np.abs(out[3 + s].numpy() - np.asarray(want[3 + s][0]))
        assert miss[same].max() <= 5e-5 * seg_max[s] / dv, f"derivative {s}"
    g = [jnp.asarray(gi)[None] for gi in gs]
    dt_ref, db_ref = chi_bilinear_pallas_bwd(jnp.asarray(bq)[None], jnp.asarray(xq)[None], tsplit, *g, meta, NVX, interpret=True)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    dT, db = chi_bilinear.plain_bwd(t(bq), t(xq), t(T), _meta(torch.float32), t(gs))
    dt_ref, db_ref = np.asarray(dt_ref[0][:, :C]), np.asarray(db_ref[0])
    np.testing.assert_allclose(dT.numpy(), dt_ref, rtol=0, atol=5e-5 * np.abs(dt_ref).max())
    np.testing.assert_allclose(db.numpy(), db_ref, rtol=0, atol=5e-5 * np.abs(db_ref).max())


def test_lookup_function_differentiates_like_jax_on_2d_queries():
    """``interp.chi_bilinear_lookup`` (the dispatch) on [7, 100] queries: values and the three
    gradients against autodiff of the JAX composition; the grids get no gradient."""
    T, bq, xq, gs = _case(5, 700)
    shape = (7, 100)
    t = lambda a: torch.tensor(a, requires_grad=True)  # noqa: E731
    Tt, bt, xt = t(T), t(bq.reshape(shape)), t(xq.reshape(shape))
    v0x = torch.tensor(V0X, dtype=torch.float64, requires_grad=True)
    outs = pinterp.chi_bilinear_lookup(Tt, bt, xt, v0x, DVX, V0P, DVP)
    assert all(o.shape == shape for o in outs)
    total = sum(torch.sum(o * torch.tensor(g.reshape(shape))) for o, g in zip(outs, gs))
    total.backward()
    assert v0x.grad is None

    def loss(T_, b_, x_):
        return sum(jnp.sum(o * g) for o, g in zip(_jax_composition(T_, b_, x_), gs))

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(jnp.asarray(T), jnp.asarray(bq), jnp.asarray(xq))
    np.testing.assert_allclose(float(total), float(val), rtol=1e-12)
    for name, got, ref in zip(("dT", "dbeta", "dxq"), (Tt.grad, bt.grad.reshape(-1), xt.grad.reshape(-1)), grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max(), err_msg=name)


def test_gradcheck_of_the_autograd_function():
    rng = np.random.default_rng(6)
    nvx, rows = 6, 8
    T = torch.tensor(rng.standard_normal((rows, 3 * nvx - 2)), requires_grad=True)
    meta = torch.tensor([-2.5, 1.0, -2.0, 1.0], dtype=torch.float64)
    # queries inside cells, away from their edges, where the function is smooth
    bq = torch.tensor((rng.integers(0, rows, 12) + rng.uniform(0.2, 0.8, 12)) * 2 * math.pi / rows - math.pi, requires_grad=True)
    xq = torch.tensor(-2.0 + rng.integers(0, nvx - 3, 12) + rng.uniform(0.2, 0.4, 12), requires_grad=True)
    assert torch.autograd.gradcheck(lambda T_, b_, x_: chi_bilinear.ChiBilinear.apply(T_, b_, x_, meta), (T, bq, xq))


def test_raw_wrappers_refuse_cpu_tensors():
    T, bq, xq, gs = _case(7, 16, np.float32)
    t = torch.tensor
    with pytest.raises(ValueError, match="CUDA"):
        chi_bilinear.chi_bilinear_fwd(t(bq), t(xq), t(T), _meta(torch.float32))
    with pytest.raises(ValueError, match="CUDA"):
        chi_bilinear.chi_bilinear_bwd(t(bq), t(xq), t(T), _meta(torch.float32), t(gs))


def _crowded(seed, n_lam=60, n_ang=241):
    """(T, bq, xq, gs) with the deck's layout: [n_lam, n_ang] queries, the angles innermost, beta rising slowly
    with the angle and |xi_e| ramping over the wavelengths past both ends of the grids, so that neighbouring
    lanes share a (row, cell) and the clamped ends crowd."""
    T, _, _, gs = _case(seed, n_lam * n_ang)
    a, lam = np.arange(n_ang) / n_ang, np.linspace(-1.5, 1.5, n_lam)
    bq = (0.6 + 0.5 * a[None, :] + 0.002 * np.arange(n_lam)[:, None]).ravel()
    xq = (lam[:, None] * (V0X + DVX * (NVX - 1)) * (1.0 + 0.05 * a[None, :])).ravel()
    return T, bq, xq, gs


def _model_k8(bq, xq, T, gs):
    """dT [R, C] as ``chi_bilinear_bwd_kernel`` deposits it, in float64, and the atomics it makes."""
    threads = _cuda_constants("chi_bilinear")["kThreads"]
    assert threads % 32 == 0
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    ib0, ib1, wb = (x.numpy() for x in pinterp.rowmix_indices(R, t(bq)))
    cx = [x.numpy() for x in pinterp.col_cell(t(xq), t(V0X), t(DVX), NVX)]
    cp = [x.numpy() for x in pinterp.col_cell(t(xq), t(V0P), t(DVP), NVX - 2)]
    w0 = 1.0 - wb
    f0, f1, d0, d1 = gs[0] * (1.0 - cx[1]), gs[0] * cx[1], gs[1] * (1.0 - cx[1]), gs[1] * cx[1]
    p0, p1 = gs[2] * (1.0 - cp[1]), gs[2] * cp[1]
    o0, o1 = ib0 * C, ib1 * C
    groups = [  # (key, values [Q, T], targets [Q, T]) of the two warp_runs calls
        (o0 + cx[0], np.stack([w0 * f0, w0 * f1, w0 * d0, w0 * d1, wb * f0, wb * f1, wb * d0, wb * d1], 1),
         np.stack([o + cx[0] + k for o in (o0, o1) for k in (0, 1, NVX, NVX + 1)], 1)),
        (o0 + 2 * NVX + cp[0], np.stack([w0 * p0, w0 * p1, wb * p0, wb * p1], 1),
         np.stack([o + 2 * NVX + cp[0] + k for o in (o0, o1) for k in (0, 1)], 1)),
    ]
    Q = bq.size
    dT, made = np.zeros(R * C), 0
    for first in range(0, Q, threads):  # one block; lanes past the end pass key -1 and zeros
        for w in range(first, first + threads, 32):
            j = w + np.arange(32)
            valid = j < Q
            jj = np.minimum(j, Q - 1)
            for key, vals, targets in groups:
                adds, v = _model_warp_runs(np.where(valid, key[jj], -1), np.where(valid[:, None], vals[jj], 0.0))
                m = adds[:, None] & (v != 0.0)
                np.add.at(dT, targets[jj][m], v[m])
                # the columns of a deposit, (0, 1), (2, 3), ..., go as one vector atomic where both are non-zero
                # and the first is even (8-byte aligned: dT's allocation is)
                both = m[:, 0::2] & m[:, 1::2] & (targets[jj][:, 0::2] % 2 == 0)
                made += int(m.sum()) - int(both.sum())
    return dT.reshape(R, C), made


@pytest.mark.parametrize("queries", ["uniform", "wrapping", "crowded"])
def test_k8_deposit_model_matches_twin(queries):
    """The cotangent kernel's deposit rule gives the twin's dT in float64; crowded warps add once a run."""
    if queries == "crowded":
        T, bq, xq, gs = _crowded(9)
    else:
        T, bq, xq, gs = _case(9, 5000)
        if queries == "uniform":  # inside both grids and one turn
            rng = np.random.default_rng(10)
            bq, xq = rng.uniform(0.0, 2 * math.pi, bq.size), rng.uniform(V0X, V0X + DVX * (NVX - 1), xq.size)
    gs[:, ::7] = 0.0  # some zero cotangents
    want = chi_bilinear.plain_bwd(*(torch.tensor(a) for a in (bq, xq, T)), _meta(torch.float64), torch.tensor(gs))[0]
    got, made = _model_k8(bq, xq, T, gs)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12 * float(want.abs().max()))
    if queries == "crowded":
        assert made < 0.25 * 12 * bq.size
    else:  # the even pairs go as one atomic; exact zeros (zero cotangents, clamped queries' end weights) not at all
        assert made < 10 * bq.size


@pytest.mark.cuda
@pytest.mark.parametrize("queries", ["seeded", "crowded"])
def test_kernels_match_plain_twins_on_card(queries):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    if queries == "crowded":
        T, bq, xq, gs = (a.astype(np.float32) for a in _crowded(8))
    else:
        T, bq, xq, gs = _case(8, 50_000, np.float32)
        eb, ex = _edge_queries()
        bq[: eb.size], xq[: ex.size] = eb, ex
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    args = (t(bq), t(xq), t(T), _meta(torch.float32).to(dev))
    got, want = chi_bilinear.chi_bilinear_fwd(*args), chi_bilinear.plain_fwd(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(np.abs(T).max()) / DVX)
    (dT, db), (dT_w, db_w) = chi_bilinear.chi_bilinear_bwd(*args, t(gs)), chi_bilinear.plain_bwd(*args, t(gs))
    torch.testing.assert_close(dT, dT_w, rtol=0, atol=1e-5 * float(dT_w.abs().max()))
    torch.testing.assert_close(db, db_w, rtol=0, atol=1e-5 * float(db_w.abs().max()))
