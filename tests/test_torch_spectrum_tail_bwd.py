"""The port's spectrum-tail cotangents against the JAX package's.

Inputs are the JAX ``FormFactor._lookups_1v`` outputs of two lineouts with two
gradient points, non-zero drift (ud) and flow (Va), three angles and one or two
ion species, stacked for the port.  The cotangent of the reduced spectrum is a
seeded g [B, L].

* float64: ``SpectrumTail``'s cotangents (the Function on CPU tensors, i.e.
  ``plain_bwd`` = autograd of the plain tail with the analytic Dawson
  derivative) against ``jax.vjp`` of ``form_factor._reduced_tail_cvjp``, the
  hand-derived ``_rt_bwd``: 1e-9 of each cotangent's max, with a floor at the
  largest cotangent of all as in the JAX tests; Ti's gradient is a ~1e8-fold
  cancellation of vTi terms (``tests/test_physics/test_spectrum_kernel.py``),
  which autograd and the hand-derived chain round differently: 1e-6 there;
* float32: ``plain_bwd`` against the Pallas kernel ``spectrum_tail_pallas_bwd``
  in interpret mode, unpacked from its (g_lf, g_chi, g_rsc, g_misc) layout:
  1e-2 of the global gradient scale per output (float32 through the narrow
  resonances; the kernel's own Dawson summation).  The sums behind lam, Va and
  ud telescope over the wavelengths and Ti's is a ~1e8-fold cancellation:
  float32 loses digits to all of them (Ti altogether), in the Pallas kernel as
  in the twin, so there the twin may miss JAX's float64 value by at most twice
  the Pallas kernel's own miss of it.

A, the weights, the angles and the frequency axis get no gradient.

The card path's own logic is rehearsed here too: the wrapper's dispatch to the
C entry point on CPU tensors, and a numpy model of the CUDA kernel's slab,
angle-chunk and write-out index rule.
"""

import collections
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics.form_factor import FormFactor, _reduced_tail_cvjp
from tsadar_tpu.ops.spectrum_kernel import spectrum_tail_pallas_bwd
from tsadar_tpu_torch.ops import spectrum_tail
from tsadar_tpu_torch.utils import trace

ANGLES = (55.0, 60.0, 65.0)
WEIGHTS = np.array([0.5, 0.3, 0.2])
NAMES = spectrum_tail.GRAD_NAMES
F64_TOL = 1e-9
F64_TOL_TI = 1e-6
F32_TOL = 1e-2


def _lineout(Te, ne, ud, Va, two_species, nv=64):
    dv = 12.0 / nv
    vx = jnp.linspace(-6.0 + dv / 2, 6.0 - dv / 2, nv)
    fe = jnp.exp(-(vx**2) / 2)
    fe = fe / jnp.sum(fe) / dv
    p = {
        "electron": {"Te": jnp.asarray(Te), "ne": jnp.asarray(ne), "fe": fe, "v": vx},
        "general": {"lam": jnp.asarray(526.5), "ne_gradient": jnp.asarray(1.5), "Te_gradient": jnp.asarray(2.0),
                    "ud": jnp.asarray(ud), "Va": jnp.asarray(Va)},
        "ion-1": {"A": jnp.asarray(40.0), "Z": jnp.asarray(8.0), "Ti": jnp.asarray(0.2),
                  "fract": jnp.asarray(0.7 if two_species else 1.0)},
    }
    if two_species:
        p["ion-2"] = {"A": jnp.asarray(1.0), "Z": jnp.asarray(1.0), "Ti": jnp.asarray(0.15), "fract": jnp.asarray(0.3)}
    return p


def _pallas_bwd(stacked, sarad, omgs, g):
    """spectrum_tail_pallas_bwd on its own packing, unpacked to the port's order of cotangents."""
    lf, chi, ne, Te, lam, Va, ud, A, Z, Ti, fract = stacked
    B, G, L, NA = lf.shape
    S = A.shape[-1]
    rows = lambda a: np.transpose(a, (0, 1, 3, 2)).reshape(B, G * NA, L)  # noqa: E731
    wrow = np.broadcast_to(WEIGHTS.reshape(1, 1, -1), (B, G, NA)) / G
    cols = [np.broadcast_to(ne[..., None], (B, G, NA)), np.broadcast_to(Te[..., None], (B, G, NA)),
            np.broadcast_to(np.cos(sarad), (B, G, NA)), wrow] + [np.zeros((B, G, NA))] * 4
    rsc = np.stack(cols, -1).reshape(B, G * NA, 8)
    scal = np.concatenate([np.stack([lam, Va, ud], -1), np.zeros((B, 5))], -1)
    spp = np.stack([Z, Ti, fract, A], 1)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    g_lf, g_chi, g_rsc, g_misc = (np.asarray(o) for o in spectrum_tail_pallas_bwd(
        f32(rows(lf)), f32(rows(chi)), f32(rsc), f32(scal), f32(spp), f32(np.broadcast_to(omgs, (B, L))), f32(g),
        interpret=True))
    unrows = lambda a: np.transpose(a.reshape(B, G, NA, L), (0, 1, 3, 2))  # noqa: E731
    per_g = g_rsc.reshape(B, G, NA, 8).sum(2)  # ne and Te ride every (g, a) row: their cotangents sum over the angles
    species = [g_misc[:, 8 + k : 8 + k + 3 * S : 3] for k in range(3)]  # Z, Ti, fract per species
    return (unrows(g_lf), unrows(g_chi), per_g[..., 0], per_g[..., 1], g_misc[:, 0], g_misc[:, 1], g_misc[:, 2], *species)


@pytest.fixture(scope="module", params=[False, True], ids=["one-species", "two-species"])
def case(request):
    """Stacked tail inputs, a seeded g, and JAX's cotangents (f64 ``_rt_bwd``, f32 Pallas interpret)."""
    two = request.param
    ff = FormFactor([450, 650], npts=256, lam_shift=0.0, scattering_angles={"sa": np.array(ANGLES)}, num_grad_points=2)
    per = [ff._lookups_1v(_lineout(*p, two)) for p in ((0.5, 0.2, 0.5, -0.3), (0.8, 0.3, -0.4, 0.6))]
    stacked = [np.stack([np.asarray(x).reshape(-1) if np.ndim(x) == 4 else np.asarray(x) for x in col])
               for col in zip(*per)]
    sarad = np.asarray(ff.scattering_angles["sa"]) * np.pi / 180.0
    omgs = np.asarray(ff.omgs).reshape(-1)
    g = np.random.default_rng(0).standard_normal((2, omgs.size))
    want = []
    for b, inp in enumerate(per):
        _, vjp = jax.vjp(lambda *a: _reduced_tail_cvjp(*a, jnp.asarray(WEIGHTS), jnp.asarray(sarad).reshape(1, 1, -1),
                                                        ff.omgs), *inp)
        cots = vjp(jnp.asarray(g[b]))
        want.append([np.asarray(c).reshape(-1) if np.ndim(c) == 4 else np.asarray(c) for c in cots])
    want = [np.stack(col) for col in zip(*want)]
    want = want[:7] + want[8:]  # drop A's (zero) cotangent: the port's order is GRAD_NAMES
    return stacked, sarad, omgs, g, want, _pallas_bwd(stacked, sarad, omgs, g)


def _port_args(stacked, sarad, omgs, dtype, requires_grad):
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    args = [t(a) for a in stacked] + [t(WEIGHTS), t(sarad), t(omgs)]
    if requires_grad:
        for a in args:
            a.requires_grad_(True)
    return args


def _check(got, want, tol, tol_ti=None, names=NAMES):
    gmax = max(np.abs(w).max() for w in want)
    for name, g, w in zip(names, got, want):
        g = np.asarray(g)
        assert g.shape == w.shape, name
        t = tol_ti if name == "Ti" and tol_ti else tol
        np.testing.assert_allclose(g, w, rtol=t, atol=t * max(np.abs(w).max(), gmax), err_msg=f"grad[{name}]")


def test_function_cotangents_match_jax_f64(case):
    stacked, sarad, omgs, g, want, _ = case
    args = _port_args(stacked, sarad, omgs, torch.float64, requires_grad=True)
    out = spectrum_tail.SpectrumTail.apply(*args)
    out.backward(torch.tensor(g))
    grads = [a.grad for a in args]
    assert grads[7] is None and all(gr is None for gr in grads[11:])  # A, weights, sarad, omgs
    _check([gr.numpy() for gr in grads[:7] + grads[8:11]], want, F64_TOL, F64_TOL_TI)


def test_function_forward_is_the_plain_tail(case):
    stacked, sarad, omgs, *_ = case
    args = _port_args(stacked, sarad, omgs, torch.float64, requires_grad=False)
    torch.testing.assert_close(spectrum_tail.SpectrumTail.apply(*args), spectrum_tail.plain(*args), rtol=0, atol=0)


def test_plain_bwd_matches_pallas_f32(case):
    stacked, sarad, omgs, g, want, pallas = case
    args = _port_args(stacked, sarad, omgs, torch.float32, requires_grad=False)
    got = spectrum_tail.plain_bwd(torch.tensor(g, dtype=torch.float32), *args)
    assert all(x.dtype == torch.float32 and torch.isfinite(x).all() for x in got)
    cancelling = [NAMES.index(n) for n in ("lam", "Va", "ud", "Ti")]
    floor = 1e-9 * max(np.abs(w).max() for w in want)  # ud's sum is an exact zero here: both return rounding noise
    for i in cancelling:
        assert np.abs(got[i].numpy() - want[i]).max() <= 2.0 * np.abs(pallas[i] - want[i]).max() + floor, NAMES[i]
    keep = [i for i in range(len(NAMES)) if i not in cancelling]
    _check([got[i].numpy() for i in keep], [pallas[i] for i in keep], F32_TOL, names=[NAMES[i] for i in keep])


def test_only_needed_cotangents_are_returned(case):
    stacked, sarad, omgs, g, want, _ = case
    args = _port_args(stacked, sarad, omgs, torch.float64, requires_grad=False)
    args[3].requires_grad_(True)  # Te alone
    spectrum_tail.SpectrumTail.apply(*args).backward(torch.tensor(g))
    assert all(a.grad is None for i, a in enumerate(args) if i != 3)
    np.testing.assert_allclose(args[3].grad.numpy(), want[3], rtol=F64_TOL, atol=F64_TOL * np.abs(want[3]).max())


def test_bwd_kernel_wrapper_refuses_cpu_tensors(case):
    stacked, sarad, omgs, g, *_ = case
    args = _port_args(stacked, sarad, omgs, torch.float32, requires_grad=False)
    with pytest.raises(ValueError, match="CUDA"):
        spectrum_tail.spectrum_tail_bwd(torch.tensor(g, dtype=torch.float32), *args)


@pytest.mark.cuda
def test_tail_bwd_kernel_matches_plain_twin_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    stacked, sarad, omgs, g, *_ = case
    args = [a.cuda() for a in _port_args(stacked, sarad, omgs, torch.float32, requires_grad=False)]
    gt = torch.tensor(g, dtype=torch.float32, device="cuda")
    got = spectrum_tail.spectrum_tail_bwd(gt, *args)
    ref = spectrum_tail.plain_bwd(gt.double(), *(a.double() for a in args))
    scales = {name: float(r.abs().max()) for name, r in zip(NAMES, ref)}
    # as chip_smoke.py holds it: 1e-3 of each output's own magnitude; the exact zeros (ud, a single
    # species' fract) by a neighbour's, and Ti with the float64 twin's own rounding noise on top
    floors = {"ud": 1e-3 * scales["Va"], "Ti": 1e-6 * scales["Te"], "fract": 1e-3 * scales["Z"]}
    for name, k, r in zip(NAMES, got, ref):
        assert float((k.double() - r).abs().max()) <= 1e-3 * scales[name] + floors.get(name, 0.0), name


class _CFunction(collections.namedtuple("_CFunction", "lib name argtypes")):
    """What ``build.c_function`` is asked for, in place of the C entry point: ``build.launch`` reads its name."""

    @property
    def __name__(self):
        return self.name


def _card_checks_on_cpu(t, name, ndim):
    """``build.check_input`` without its device test: the wrapper's shape, type and layout checks."""
    if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: {t.dtype}, {tuple(t.shape)}")


@pytest.mark.parametrize("S", range(1, spectrum_tail.MAX_SPECIES + 1))
def test_bwd_wrapper_dispatch_rehearsed_on_cpu(S, monkeypatch):
    """The card path of ``spectrum_tail_bwd`` up to its C call, on CPU tensors: the C entry point (which
    dispatches S to the kernel's instantiation) gets the operands (the log-EDF shift lfc last of them, zeros
    [B] when not given), g, the ten outputs and the float64 sums in ``_BWD_ARGTYPES``'s order, then (B, G, L,
    NA, S); the outputs have ``GRAD_NAMES``' shapes."""
    from tsadar_tpu_torch.ops import build

    B, G, L, NA = 2, 2, 7, 3
    rng = np.random.default_rng(S)
    t = lambda *shape: torch.tensor(rng.uniform(0.5, 1.5, shape), dtype=torch.float32)  # noqa: E731
    args = (t(B, G, L, NA), t(B, G, L, NA), t(B, G), t(B, G), t(B), t(B), t(B), t(B, S), t(B, S), t(B, S), t(B, S),
            t(NA), t(NA), t(L))
    g = t(B, L)
    calls = []
    monkeypatch.setattr(build, "check_input", _card_checks_on_cpu)
    monkeypatch.setattr(build, "c_function", lambda lib, fn, argtypes: _CFunction(lib, fn, argtypes))
    monkeypatch.setattr(build, "_on_stream", lambda fn, a, device: calls.append((fn, a, device)) or 0)
    before = trace.counters().get("ops.launches[spectrum_tail_bwd]", 0)
    outs = spectrum_tail.spectrum_tail_bwd(g, *args)
    assert trace.counters()["ops.launches[spectrum_tail_bwd]"] == before + 1
    ((lib, name, argtypes), a, device), = calls
    assert (lib, name, argtypes) == ("spectrum_tail_bwd", "spectrum_tail_bwd", spectrum_tail._BWD_ARGTYPES)
    assert len(a) + 1 == len(argtypes) and a[-5:] == (B, G, L, NA, S) and device == args[0].device
    assert a[:2] == (args[0].data_ptr(), args[1].data_ptr()) and a[16] == g.data_ptr()
    assert a[17:27] == tuple(o.data_ptr() for o in outs)
    shapes = [(B, G, L, NA)] * 2 + [(B, G)] * 2 + [(B,)] * 3 + [(B, S)] * 3
    assert [tuple(o.shape) for o in outs] == shapes


@pytest.mark.parametrize("S", [0, spectrum_tail.MAX_SPECIES + 1])
def test_bwd_wrapper_refuses_species_counts_without_a_kernel(S, monkeypatch):
    from tsadar_tpu_torch.ops import build

    B, G, L, NA = 2, 1, 5, 3
    z = lambda *shape: torch.ones(shape, dtype=torch.float32)  # noqa: E731
    monkeypatch.setattr(build, "check_input", _card_checks_on_cpu)
    monkeypatch.setattr(build, "launch", lambda *a, **k: pytest.fail("launched"))
    with pytest.raises(ValueError, match="ion species"):
        spectrum_tail.spectrum_tail_bwd(z(B, L), z(B, G, L, NA), z(B, G, L, NA), z(B, G), z(B, G), z(B), z(B), z(B),
                                        z(B, S), z(B, S), z(B, S), z(B, S), z(NA), z(NA), z(L))


_K6_SOURCE = Path(spectrum_tail.__file__).resolve().parent.parent / "csrc" / "spectrum_tail_bwd.cu"


def _k6_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _K6_SOURCE.read_text()).group(1))


def _slab_walk(tid, nc, threads):
    """The kernel's ``SlabWalk``: (e, row, column) of e = tid, tid + threads, ... stepped without a division."""
    row, col, drow, dcol = tid // nc, tid % nc, threads // nc, threads % nc
    e = tid
    while True:
        yield e, row, col
        e, row, col = e + threads, row + drow, col + dcol
        if col >= nc:
            row, col = row + 1, col - nc


def _k6_neighbour_model(fe, t, g_fe):
    """g_lf of ``spectrum_tail_bwd.cu`` from its per-point f_e, t and g_fe [L, NA], through the kernel's
    own index rule: blocks of kOwned wavelengths whose thread 0 is the left halo, the angles in chunks of
    at most kMaxChunk, each chunk's slab staged [kSlab][nc] by the walk, the owners' slots [kThreads][nc],
    and the coalesced write-out of g_lf = (g_fe + (t[l-1] - t[l])) f_e.  Counts the writes of each entry."""
    threads, max_chunk = _k6_constant("kThreads"), _k6_constant("kMaxChunk")
    owned_max, slab = threads - 1, threads + 1  # kOwned, kSlab
    L, NA = fe.shape
    chunks = -(-NA // max_chunk) if NA > max_chunk else 1
    NC = -(-NA // chunks)
    out, writes = np.zeros(L * NA), np.zeros(L * NA, dtype=int)
    for first in range(0, L, owned_max):
        owned = min(owned_max, L - first)
        for a0 in range(0, NA, NC):
            nc = min(NC, NA - a0)
            fe_s, k_s, t_s = np.full(slab * nc, np.nan), np.full(slab * nc, np.nan), np.full(threads * nc, np.nan)
            for tid in range(threads):  # staging: fe from [L, NA] at the walk's (row, column), 0 off the ends
                for e, row, col in _slab_walk(tid, nc, threads):
                    if e >= slab * nc:
                        break
                    li = first - 1 + row
                    fe_s[e] = fe[li, a0 + col] if 0 <= li < L else 0.0
            for tid in range(threads):  # the angle loop's slots: t of every thread in range, g_fe of the owners
                l_raw = first + tid - 1
                in_range = 0 <= l_raw < L
                l = min(max(l_raw, 0), L - 1)
                for a in range(nc):
                    t_s[tid * nc + a] = t[l, a0 + a] if in_range else 0.0
                    if in_range and tid > 0:
                        k_s[tid * nc + a] = g_fe[l, a0 + a]
            for tid in range(threads):  # write-out
                for e, row, col in _slab_walk(tid, nc, threads):
                    if e >= owned * nc:
                        break
                    p, d = e + nc, (first + row) * NA + a0 + col
                    out[d] = (k_s[p] + (t_s[e] - t_s[p])) * fe_s[p]
                    writes[d] += 1
    return out.reshape(L, NA), writes.reshape(L, NA)


@pytest.mark.parametrize("L, NA", [(1, 1), (50, 10), (127, 12), (128, 13), (255, 25), (300, 70)])
def test_k6_chunked_slab_index_model(L, NA):
    """The kernel's slab, chunk and write-out index rule (modelled in numpy from its constants) gives every
    g_lf entry once, equal to (g_fe + (t[l-1] - t[l])) f_e with t[-1] = 0, for any angle count."""
    rng = np.random.default_rng(L * 100 + NA)
    fe, t, g_fe = (rng.standard_normal((L, NA)) for _ in range(3))
    got, writes = _k6_neighbour_model(fe, t, g_fe)
    t_prev = np.vstack([np.zeros((1, NA)), t[:-1]])
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_allclose(got, (g_fe + (t_prev - t)) * fe, rtol=0, atol=1e-15)
