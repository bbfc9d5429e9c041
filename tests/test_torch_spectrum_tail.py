"""The port's spectrum tail against the JAX package's.

Inputs are the JAX ``FormFactor._lookups_1v`` outputs of two lineouts with two
gradient points, two ion species and non-zero drift (ud) and flow (Va), at
three angles, fed to both sides:

* float64: ``_reduced_tail`` against ``form_factor._reduced_tail`` to 1e-12 of
  peak (same expressions; the frameworks' exp and sums round differently);
* float32: against the Pallas kernel ``spectrum_tail_pallas`` in interpret
  mode to 1e-4 of peak (float32 rounding, amplified near the resonances, and
  the kernel's own Dawson summation).

Weights are a per-angle vector and a scalar (the production ``weights[0]``).
Both comparisons also run on the case cut to 50 and 255 wavelengths (the CUDA
kernel's block edges) and on the two lineouts at 70 angles (staged by the kernel
in several chunks).  A numpy model of the kernel's slab and halo index rule,
with its constants read from ``csrc/spectrum_tail.cu``, shows that every
wavelength reads its own point and its right neighbour's from the staged slab.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.physics.form_factor import FormFactor, _reduced_tail
from tsadar_tpu.ops.spectrum_kernel import spectrum_tail_pallas
from tsadar_tpu_torch.core.physics.constants import C
from tsadar_tpu_torch.core.physics.form_factor import _reduced_tail as port_tail
from tsadar_tpu_torch.ops import spectrum_tail

from .test_torch_spectrum_tail_bwd import _slab_walk

ANGLES = (55.0, 60.0, 65.0)
LAM = 526.5  # probe wavelength of every lineout, nm
IAW_HALF_WIDTH_NM = 12.0  # the ion-acoustic band: the whole-shot deck's iawfilter notch is 24 nm wide
EPW_TOL = 1e-3  # of the EPW peak, the kernel against the float64 twin outside the IAW band (as in chip_smoke.py)
WEIGHTS = {"vector": np.array([0.5, 0.3, 0.2]), "scalar": np.array(0.00702671050853565)}
RAGGED_L = (50, 255)  # wavelengths cut from the case: fewer than a block of the kernel's, one short of two
MANY_ANGLES = 70  # angles of a case that the kernel stages in several chunks
# the case with either weights, cut to RAGGED_L wavelengths, or at MANY_ANGLES angles (vector weights)
VARIANTS = sorted(WEIGHTS) + [f"L{n}" for n in RAGGED_L] + [f"A{MANY_ANGLES}"]


def _lineout(Te, ne, ud, Va, nv=512):
    dv = 12.0 / nv
    vx = jnp.linspace(-6.0 + dv / 2, 6.0 - dv / 2, nv)
    fe = jnp.exp(-(vx**2) / 2)
    fe = fe / jnp.sum(fe) / dv
    return {
        "electron": {"Te": jnp.asarray(Te), "ne": jnp.asarray(ne), "fe": fe, "v": vx},
        "general": {"lam": jnp.asarray(LAM), "ne_gradient": jnp.asarray(1.5), "Te_gradient": jnp.asarray(2.0),
                    "ud": jnp.asarray(ud), "Va": jnp.asarray(Va)},
        "ion-1": {"A": jnp.asarray(40.0), "Z": jnp.asarray(8.0), "Ti": jnp.asarray(0.2), "fract": jnp.asarray(0.7)},
        "ion-2": {"A": jnp.asarray(1.0), "Z": jnp.asarray(1.0), "Ti": jnp.asarray(0.15), "fract": jnp.asarray(0.3)},
    }


def _case(angles):
    """Per-lineout JAX tail inputs, and the same stacked for the port."""
    ff = FormFactor([450, 650], npts=256, lam_shift=0.0, scattering_angles={"sa": np.array(angles)}, num_grad_points=2)
    per = [ff._lookups_1v(_lineout(*p)) for p in ((0.5, 0.2, 0.5, -0.3), (0.8, 0.3, -0.4, 0.6))]
    # lf, chi [G, L, A] and ne, Te [G] as they are; species [1, 1, 1, S] -> [S]
    stacked = [np.stack([np.asarray(x).reshape(-1) if np.ndim(x) == 4 else np.asarray(x) for x in col])
               for col in zip(*per)]
    sarad = np.asarray(ff.scattering_angles["sa"]) * np.pi / 180.0
    return ff, per, stacked, sarad, np.asarray(ff.omgs).reshape(-1)


@pytest.fixture(scope="module")
def case():
    return _case(ANGLES)


@pytest.fixture(scope="module")
def many_angles():
    return _case(np.linspace(55.0, 65.0, MANY_ANGLES))


def _variant(case, many_angles, variant):
    """(JAX per-lineout inputs, the port's stacked inputs, sarad, JAX omgs [1, L, 1], weights) of a variant."""
    ff, per, stacked, sarad, _ = many_angles if variant.startswith("A") else case
    if variant in WEIGHTS:
        return per, stacked, sarad, ff.omgs, WEIGHTS[variant]
    if variant.startswith("A"):
        return per, stacked, sarad, ff.omgs, np.resize(WEIGHTS["vector"], sarad.size)
    cut = slice(0, int(variant[1:]))  # from 450 nm on: the EPW side, and for 255 through the ion-acoustic band
    per = [(inp[0][:, cut], inp[1][:, cut], *inp[2:]) for inp in per]
    stacked = [stacked[0][:, :, cut], stacked[1][:, :, cut], *stacked[2:]]
    return per, stacked, sarad, ff.omgs[:, cut], WEIGHTS["vector"]


def _port(stacked, w, sarad, omgs, dtype):
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    return port_tail(*[t(a) for a in stacked], t(w), t(sarad), t(omgs)).numpy()


@pytest.mark.parametrize("variant", VARIANTS)
def test_tail_matches_jax_f64(case, many_angles, variant):
    per, stacked, sarad, omgs, w = _variant(case, many_angles, variant)
    want = np.stack([np.asarray(_reduced_tail(*inp, jnp.asarray(w), jnp.asarray(sarad).reshape(1, 1, -1), omgs))
                     for inp in per])
    got = _port(stacked, w, sarad, np.asarray(omgs).reshape(-1), torch.float64)
    assert got.shape == (2, np.size(omgs))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def _pallas(stacked, w, sarad, omgs):
    """spectrum_tail_pallas's packing: rows (g, a) G-major, wavelengths on lanes."""
    lf, chi, ne, Te, lam, Va, ud, A, Z, Ti, fract = stacked
    B, G, L, NA = lf.shape
    rows = lambda a: np.transpose(a, (0, 1, 3, 2)).reshape(B, G * NA, L)  # noqa: E731
    wrow = np.broadcast_to(np.reshape(w, (1, 1, -1)), (B, G, NA)) / G
    cols = [np.broadcast_to(ne[..., None], (B, G, NA)), np.broadcast_to(Te[..., None], (B, G, NA)),
            np.broadcast_to(np.cos(sarad), (B, G, NA)), wrow] + [np.zeros((B, G, NA))] * 4
    rsc = np.stack(cols, -1).reshape(B, G * NA, 8)
    scal = np.concatenate([np.stack([lam, Va, ud], -1), np.zeros((B, 5))], -1)
    spp = np.stack([Z, Ti, fract, A], 1)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    out = spectrum_tail_pallas(f32(rows(lf)), f32(rows(chi)), f32(rsc), f32(scal), f32(spp),
                               f32(np.broadcast_to(omgs, (B, L))), interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("variant", VARIANTS)
def test_tail_matches_pallas_f32(case, many_angles, variant):
    _, stacked, sarad, omgs, w = _variant(case, many_angles, variant)
    omgs = np.asarray(omgs).reshape(-1)
    want = _pallas(stacked, w, sarad, omgs)
    got = _port(stacked, w, sarad, omgs, torch.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_tail_kernel_refuses_cpu_tensors(case):
    _, _, stacked, sarad, omgs = case
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        spectrum_tail.spectrum_tail_fwd(*[t(a) for a in stacked], t(0.1), t(sarad), t(omgs))


def _misses(got, args):
    """got's miss of the float64 twin on the same inputs: the worst over lineouts
    outside the ion-acoustic band (of each lineout's peak there) and the largest
    inside it (absolute), the band being IAW_HALF_WIDTH_NM about the probe."""
    ref = spectrum_tail.plain(*(a.double() for a in args))
    lam = 2.0 * np.pi * C / args[-1].double() * 1e7
    iaw = (lam - LAM).abs() < IAW_HALF_WIDTH_NM
    miss = (got.double() - ref).abs()
    epw = float((miss[:, ~iaw].amax(1) / ref[:, ~iaw].abs().amax(1)).max())
    return epw, float(miss[:, iaw].max()), float(ref.abs().max())


def _f32_args(case, weights, device):
    _, _, stacked, sarad, omgs = case
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    return [t(a) for a in stacked] + [t(WEIGHTS[weights]), t(sarad), t(omgs)]


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_tail_f32_twin_within_kernel_tolerance(case, weights):
    """The float32 twin itself meets the bound the kernel is held to outside the IAW band."""
    args = _f32_args(case, weights, "cpu")
    epw, _, _ = _misses(spectrum_tail.plain(*args), args)
    assert epw <= EPW_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_tail_kernel_matches_plain_twin_on_card(case, weights):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    # as chip_smoke.py holds it: a fixed bound of the EPW peak outside the IAW
    # band; inside it no further from the float64 twin than twice the float32 twin
    args = _f32_args(case, weights, "cuda")
    epw, iaw, peak = _misses(spectrum_tail.spectrum_tail_fwd(*args), args)
    _, iaw_plain, _ = _misses(spectrum_tail.plain(*args), args)
    assert epw <= EPW_TOL
    assert iaw <= 2.0 * iaw_plain + 1e-6 * peak


_K5_SOURCE = Path(spectrum_tail.__file__).resolve().parent.parent / "csrc" / "spectrum_tail.cu"


def _k5_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _K5_SOURCE.read_text()).group(1))


def _k5_slab_model(lf, chi):
    """What each thread of ``spectrum_tail.cu`` reads, through the kernel's own index rule: blocks of
    kThreads wavelengths, one a thread, a thread past the end computing the last one; the angles in chunks
    of at most kMaxChunk; each chunk's slab of lf staged [kThreads + 1][nc] (one right halo) and of chi
    [kThreads][nc] by the walk, 0 off the end.  Returns its own lf, its right neighbour's lf (NaN where it
    reads none) and its chi per (wavelength, angle), and the writes of each output."""
    threads, max_chunk = _k5_constant("kThreads"), _k5_constant("kMaxChunk")
    slab = threads + 1  # kSlab
    L, NA = lf.shape
    chunks = -(-NA // max_chunk) if NA > max_chunk else 1
    NC = -(-NA // chunks)
    own, right, chi_read = (np.full((L, NA), np.nan) for _ in range(3))
    writes = np.zeros(L, dtype=int)
    for first in range(0, L, threads):
        for a0 in range(0, NA, NC):
            nc = min(NC, NA - a0)
            lf_s, chi_s = np.full(slab * nc, np.nan), np.full(threads * nc, np.nan)
            for tid in range(threads):  # staging
                for e, row, col in _slab_walk(tid, nc, threads):
                    if e >= slab * nc:
                        break
                    li = first + row
                    lf_s[e] = lf[li, a0 + col] if li < L else 0.0
                    if e < threads * nc:
                        chi_s[e] = chi[li, a0 + col] if li < L else 0.0
            for tid in range(threads):  # the angle loop
                l = min(first + tid, L - 1)
                ic = l - first
                for a in range(nc):
                    e = ic * nc + a
                    if first + tid < L:  # a thread past the end discards what it computes
                        own[l, a0 + a], chi_read[l, a0 + a] = lf_s[e], chi_s[e]
                        if l + 1 < L:
                            right[l, a0 + a] = lf_s[e + nc]
        for tid in range(threads):
            if first + tid < L:
                writes[first + tid] += 1
    return own, right, chi_read, writes


@pytest.mark.parametrize("L, NA", [(1, 1), (1, 10), (50, 10), (128, 12), (129, 13), (255, 25), (300, 70)])
def test_k5_slab_and_halo_index_model(L, NA):
    """Every wavelength reads its own lf and chi and its right neighbour's lf from the staged slab, for any
    angle count and at every block edge; the last wavelength reads no neighbour; each output is written once."""
    rng = np.random.default_rng(L * 100 + NA)
    lf, chi = rng.standard_normal((L, NA)), rng.standard_normal((L, NA))
    own, right, chi_read, writes = _k5_slab_model(lf, chi)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(own, lf)
    np.testing.assert_array_equal(chi_read, chi)
    np.testing.assert_array_equal(right[:-1], lf[1:])
    assert np.isnan(right[-1]).all()

