"""The port's lookup cotangents against the JAX package's.

For the linear (chi_R table, n = 2043) and the cubic (log-EDF, n = 320) lookup,
on seeded tables and cotangents, with queries that cover both edge cells and lie
beyond both ends, and with crowded queries laid out as the form factor's xi_e
(angle-interleaved monotone ramps, a third of each row beyond each end, the
cubic's g zeroed there as the forward's overwrite does):

* float64: ``plain_bwd`` (the table cotangent) and both cotangents of the
  ``LinLookup``/``CubicLookup`` Functions against ``jax.vjp`` of
  ``interp1d_linear_blocked``/``interp1d_cubic_blocked`` on the CPU, to 1e-12
  of each cotangent's max (same sums in another order); the linear query
  cotangent is exactly zero beyond the ends (the ``inside`` mask), the cubic
  one is not masked;
* float32: ``plain_bwd`` against the Pallas kernels ``lin_interp_pallas2_bwd``
  and ``cubic_interp_pallas2_bwd`` in interpret mode, folded as the JAX tests
  fold them, to 1e-4 of max (those kernels carry a hi/lo-bf16 split of g);
* a float64 numpy model of the kernels' deposit rule (``csrc/warp_deposit.cuh``,
  also used by the chi tables' cotangent, ``tests/test_torch_chi_bilinear.py``:
  32 consecutive queries a warp, runs of neighbouring lanes in one cell summed
  by a segmented scan and added once by the run's last lane, exact zeros and
  taps outside the table not added; slabs of kSlab queries a block, one
  accumulator a block or, where the source sets kCopies, one a warp, summed in
  order; each block's non-zero entries added to the output), with the
  constants read from the CUDA sources, against ``scatter_add_``'s table;
* the kernel wrappers refuse CPU tensors; kernel against twin runs on the card.
"""

import re
from pathlib import Path

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
ANGLES = 10  # the form factor's queries are [wavelength, angle], the angles innermost
KINDS = ["lin", "lin_crowded", "cubic", "cubic_crowded"]
CSRC = Path(__file__).resolve().parents[1] / "tsadar_tpu_torch" / "csrc"


def _queries(rng, x0, dx, n, beyond):
    q = rng.uniform(x0 - beyond, x0 + (n - 1) * dx + beyond, (B, Q))
    q[:, :32] = x0 + dx * rng.uniform(0.0, 1.0, (B, 32))  # first cell
    q[:, 32:64] = x0 + dx * (n - 2 + rng.uniform(0.0, 1.0, (B, 32)))  # last cell
    q[:, 64:66] = [x0 - 2 * beyond, x0 + (n - 1) * dx + 2 * beyond]
    return q


def _crowded_queries(rng, x0, xend, rows, count):
    """[rows, count] queries laid out [L, ANGLES] as xi_e: per angle a monotone ramp over three times the
    grid's span around its centre (a third of each row below the grid, a third above), slope and offset
    drawn per (row, angle)."""
    L = -(-count // ANGLES)
    span = xend - x0
    ramp = np.linspace(-1.5, 1.5, L)[None, :, None]
    q = 0.5 * (x0 + xend) + span * (ramp * rng.uniform(0.9, 1.1, (rows, 1, ANGLES)) + rng.uniform(-0.05, 0.05, (rows, 1, ANGLES)))
    return q.reshape(rows, -1)[:, :count]


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
        ("lin_crowded", 2043, -8.2, 8.2, None, interp1d_linear_blocked),
        ("cubic_crowded", 320, -7.0, 7.0, None, interp1d_cubic_blocked),
    ):
        x = np.linspace(lo, hi, n)
        x0, dx = float(x[0]), float(x[1] - x[0])
        t = rng.standard_normal((B, n))
        q = _queries(rng, x0, dx, n, beyond) if beyond else _crowded_queries(rng, x0, x[-1], B, Q)
        g = rng.standard_normal((B, Q))
        outside = (q < x0) | (q > x[-1])
        if kind == "cubic_crowded":  # the forward overwrites the log-EDF beyond its grid: no cotangent there
            g[outside] = 0.0
        fn = jax.vmap(lambda a, b: blocked(a, jnp.asarray(x), b))
        _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(t))
        g_q, g_t = (np.asarray(v) for v in vjp(jnp.asarray(g)))
        f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        k = -(-(n - 1) // BLK)
        if kind.startswith("lin"):
            meta = np.array([x0, dx, n])
            pallas = _fold_lin(lin_interp_pallas2_bwd(f32(q), f32(g), f32(meta), k, interpret=True), n)
        else:
            meta = np.tile([x0, dx, n], (B, 1))
            pallas = _fold_cubic(cubic_interp_pallas2_bwd(f32(q), f32(g), f32(meta), k, interpret=True), n)
        out[kind] = dict(x0=x0, dx=dx, n=n, t=t, q=q, g=g, meta=meta, g_q=g_q, g_t=g_t, pallas=pallas, beyond=outside)
    return out


def _plain_bwd(kind, c, dtype):
    tt = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    if kind.startswith("lin"):
        return lin_lookup.plain_bwd(tt(c["q"]), tt(c["g"]), c["x0"], c["dx"], c["n"])
    return cubic_lookup.plain_bwd(tt(c["q"]), tt(c["g"]), tt(c["meta"]), c["n"])


@pytest.mark.parametrize("kind", KINDS)
def test_plain_bwd_matches_jax_vjp_f64(cases, kind):
    c = cases[kind]
    got = _plain_bwd(kind, c, torch.float64).numpy()
    assert got.shape == (B, c["n"])
    np.testing.assert_allclose(got, c["g_t"], rtol=0, atol=F64_TOL * np.abs(c["g_t"]).max())


@pytest.mark.parametrize("kind", KINDS)
def test_function_cotangents_match_jax_vjp_f64(cases, kind):
    c = cases[kind]
    q = torch.tensor(c["q"], requires_grad=True)
    t = torch.tensor(c["t"], requires_grad=True)
    if kind.startswith("lin"):
        val = lin_lookup.LinLookup.apply(q, t, c["x0"], c["dx"])
    else:
        val = cubic_lookup.CubicLookup.apply(q, t, torch.tensor(c["meta"]))
    g_q, g_t = torch.autograd.grad(val, (q, t), torch.tensor(c["g"]))
    np.testing.assert_allclose(g_t.numpy(), c["g_t"], rtol=0, atol=F64_TOL * np.abs(c["g_t"]).max())
    np.testing.assert_allclose(g_q.numpy(), c["g_q"], rtol=0, atol=F64_TOL * np.abs(c["g_q"]).max())
    assert c["beyond"].sum() >= 2 * B
    if kind.startswith("lin"):  # the value is clamped beyond the ends: no query gradient there
        assert np.all(g_q.numpy()[c["beyond"]] == 0.0) and np.all(c["g_q"][c["beyond"]] == 0.0)
    elif kind == "cubic":  # the edge cells extrapolate their polynomial: nothing is masked
        assert np.all(g_q.numpy()[c["beyond"]] != 0.0)
    else:  # crowded: g is zero beyond the grid, and so is the query cotangent
        assert np.all(g_q.numpy()[c["beyond"]] == 0.0)


@pytest.mark.parametrize("kind", KINDS)
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
@pytest.mark.parametrize("kind", KINDS)
def test_lookup_bwd_kernels_match_plain_twins_on_card(cases, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    c = cases[kind]
    if kind.startswith("lin"):
        want = lin_lookup.plain_bwd(dev(c["q"]), dev(c["g"]), c["x0"], c["dx"], c["n"])
        got = lin_lookup.lin_lookup_bwd(dev(c["q"]), dev(c["g"]), c["x0"], c["dx"], c["n"])
    else:
        want = cubic_lookup.plain_bwd(dev(c["q"]), dev(c["g"]), dev(c["meta"]), c["n"])
        got = cubic_lookup.cubic_lookup_bwd(dev(c["q"]), dev(c["g"]), dev(c["meta"]), c["n"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def _cuda_constants(name):
    """The ``constexpr int`` constants of ``csrc/<name>.cu``, each evaluated from those before it."""
    consts = {}
    for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", (CSRC / f"{name}.cu").read_text()):
        # integer expressions of the repo's own source; C++'s / on ints is Python's //
        consts[key] = eval(expr.replace("/", "//"), {}, dict(consts))  # noqa: S307
    return consts


def _model_warp_runs(key, v):
    """``warp_runs<T>`` on one warp in float64: keys [32], values [32, T]; returns (the lanes that add, the
    values summed over each run into its last lane)."""
    if not (v != 0.0).any():
        return np.zeros(32, bool), v
    lane = np.arange(32)
    heads = (lane == 0) | (key != np.concatenate([key[:1], key[:-1]]))
    if heads.all():
        return np.ones(32, bool), v
    start = np.maximum.accumulate(np.where(heads, lane, 0))
    for d in (1, 2, 4, 8, 16):  # every lane reads its neighbour's value before any lane adds
        up = np.concatenate([v[:d], v[:-d]])
        v = np.where((lane - d >= start)[:, None], v + up, v)
    return np.append(heads[1:], True), v


def _model_warp_deposit(acc, key, v, first):
    """``warp_deposit<T, first>`` on one warp in float64: keys [32], tap values [32, T]; returns the atomics made."""
    adds, v = _model_warp_runs(key, v)
    made = 0
    for t in range(v.shape[1]):
        i = key + first + t
        m = adds & (v[:, t] != 0.0) & (i >= 0) & (i < acc.shape[0])
        np.add.at(acc, i[m], v[m, t])
        made += int(m.sum())
    return made


def _model_bwd(keys, vals, width, first, consts):
    """The table cotangent [rows, width] as the kernels build it, and the number of shared atomics."""
    threads, unroll, slab = consts["kThreads"], consts["kUnroll"], consts["kSlab"]
    copies = consts.get("kCopies", 1)  # one accumulator per warp, or one per block
    rows, count = keys.shape
    out, made = np.zeros((rows, width)), 0
    for b in range(rows):
        for slab0 in range(0, count, slab):  # one block
            acc = np.zeros((copies, width))
            end = min(count, slab0 + slab)
            for c in range(slab0, end, threads * unroll):
                for u in range(unroll):
                    for warp in range(threads // 32):
                        j = c + u * threads + warp * 32 + np.arange(32)
                        valid = j < end
                        jj = np.minimum(j, count - 1)
                        made += _model_warp_deposit(acc[warp % copies], np.where(valid, keys[b, jj], -1),
                                                    np.where(valid[:, None], vals[b, jj], 0.0), first)
            total = acc[0].copy()
            for k in range(1, copies):  # the block sums its copies in order
                total += acc[k]
            out[b] += np.where(total != 0.0, total, 0.0)
    return out, made


@pytest.mark.parametrize("kind", ["lin", "cubic"])
@pytest.mark.parametrize("queries", ["uniform", "crowded", "beyond"])
def test_deposit_model_matches_scatter_add(kind, queries):
    """The kernels' deposit rule gives scatter_add_'s table in float64; crowded warps add once a run."""
    consts = _cuda_constants(f"{kind}_lookup")
    assert consts["kThreads"] % 32 == 0 and consts["kSlab"] % (consts["kThreads"] * consts["kUnroll"]) == 0
    assert consts.get("kCopies", 1) in (1, consts["kThreads"] // 32)
    rng = np.random.default_rng(7)
    rows, count = 2, consts["kSlab"] + 1000  # two blocks a row, the second cut short mid-warp
    n, x0, dx = (2043, -8.2, 16.4 / 2042) if kind == "lin" else (320, -5.98125, 0.0375)
    xend = x0 + dx * (n - 1)
    if queries == "uniform":
        q = rng.uniform(x0 - 0.1, xend + 0.1, (rows, count))
    elif queries == "crowded":
        q = _crowded_queries(rng, x0, xend, rows, count)
    else:  # every query beyond the low end: every warp's 32 lanes in one cell
        q = rng.uniform(x0 - 3.0, x0 - 0.1, (rows, count))
    g = rng.standard_normal((rows, count))
    if kind == "cubic":
        g[(q < x0) | (q > xend)] = 0.0  # as the forward's overwrite leaves it
    qt, gt = torch.tensor(q), torch.tensor(g)
    if kind == "lin":
        _, i0, w = lin_lookup._cell(qt, x0, dx, n)
        vals, first = torch.stack([gt * (1.0 - w), gt * w], -1), 0
        want = lin_lookup.plain_bwd(qt, gt, x0, dx, n)
    else:
        meta = torch.tensor(np.tile([x0, dx, n], (rows, 1)))
        i0, t, is_first, is_last = cubic_lookup._cell(qt, meta)
        vals, first = torch.stack([gt * c for c in cubic_lookup._cubic_weights(t, is_first, is_last)], -1), -1
        want = cubic_lookup.plain_bwd(qt, gt, meta, n)
    got, made = _model_bwd(i0.numpy(), vals.numpy(), n, first, consts)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=F64_TOL * float(want.abs().max()))
    warps = rows * sum(-(-min(consts["kSlab"], count - s) // 32) for s in range(0, count, consts["kSlab"]))
    if queries == "beyond":  # one atomic a warp (the linear lookup's w = 0 tap is an exact zero); none for g = 0
        assert made == (warps if kind == "lin" else 0)
    elif queries == "crowded":  # the runs beyond the ends collapse
        assert made < 0.6 * vals.shape[-1] * rows * count
