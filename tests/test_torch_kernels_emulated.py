"""The port's hand-written CUDA kernels, run on the CPU, against their plain twins.

``tests/cuda_emu/`` emulates the CUDA surface the kernels use: one std::thread
per CUDA thread, barriers for ``__syncthreads`` and the warp collectives
(shuffles, ballots), atomics through ``std::atomic_ref``, the host's maths.
Each ``tsadar_tpu_torch/csrc/*.cu`` is compiled by g++ with its launches and
shared-memory declarations rewritten for the emulation, and the kernel
wrappers of ``tsadar_tpu_torch.ops`` run unchanged on CPU tensors with only
their device test and their launcher swapped for the emulated library.  The
checks are ``chip_smoke.py``'s own, at its limits, on small shapes: the
spectrum tail (K5, K6) on two species, many angles and ragged wavelength
counts; the chi tables (K7, K8) on uniform, edge and crowded queries; the
lookups (K1-K4) on uniform and crowded ones.  This holds the kernels' index
rules, block edges, warp scans and arithmetic; it says nothing of their speed,
and the card's maths rounds otherwise in the last bits.  The tensor-core
kernel (``csrc/pv_tables.cu``, ``mma.sync``) is not emulated.  Without g++ the
tests skip.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tsadar_tpu_torch.ops import build, chi_bilinear, cubic_lookup, lin_lookup

EMU = Path(__file__).resolve().parent / "cuda_emu"
KERNELS = ("spectrum_tail", "spectrum_tail_bwd", "chi_bilinear", "lin_lookup", "cubic_lookup")
IAW_BAND = (516.0, 540.0)  # the whole-shot deck's iawfilter notch [nm]


def _for_the_cpu(src):
    """A kernel source rewritten for the emulation: launches as calls, shared arrays as the block's buffers."""
    src = re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\(", r"emu::launch(\2, \1, ", src, flags=re.S)
    src = re.sub(r"extern __shared__ float (\w+)\[\];",
                 r"float* \1 = reinterpret_cast<float*>(emu::block->dynamic_smem.data());", src)
    return re.sub(r"__shared__ (\w+) (\w+)\[\w+\];", r"\1* \2 = reinterpret_cast<\1*>(emu::block->static_smem.data());", src)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The kernels compiled for the emulation, one g++ each, all at once: {name: CDLL}."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emu")
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    shutil.copy(EMU / "async_copy.cuh", out / "async_copy.cuh")  # the emulation's synchronous copies
    jobs = {}
    for name in KERNELS:
        (out / f"{name}.cpp").write_text(_for_the_cpu((build.CSRC / f"{name}.cu").read_text()))
        cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", str(EMU), "-o", str(out / f"{name}.so"),
               str(out / f"{name}.cpp")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}:\n{log[-4000:]}"
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in KERNELS}


@pytest.fixture
def emulated(libs, monkeypatch):
    """The kernel wrappers launching the emulated kernels on CPU tensors; returns the atomics counter."""

    def check_input(t, name, ndim):  # build.check_input without its device test
        if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype}, {tuple(t.shape)}, contiguous {t.is_contiguous()}")

    def c_function(lib_name, fn_name, argtypes):
        fn = getattr(libs[lib_name], fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def launch(fn, *args, device):
        err = fn(*args, None)
        if err:
            raise RuntimeError(f"{fn.__name__} failed with error {err}")

    monkeypatch.setattr(build, "check_input", check_input)
    monkeypatch.setattr(build, "c_function", c_function)
    monkeypatch.setattr(build, "launch", launch)
    taken = libs["chi_bilinear"].emu_atomics_taken
    taken.restype = ctypes.c_longlong
    taken()
    return taken


def _one_species(args):
    """The tail's arguments with the second species dropped (the first then takes the whole fraction)."""
    args = list(args)
    for i in (7, 8, 9):
        args[i] = args[i][:, :1].contiguous()
    args[10] = torch.ones_like(args[9])
    return tuple(args)


def _tail_case(label):
    """(g, the tail's fourteen arguments) of ``chip_smoke.two_species_tail_case`` at the label's angles and
    wavelengths: two species, two gradient points, flow and drift, some wavelengths in the ion-acoustic band."""
    angles, wavelengths = {"two_species": (3, 96), "one_species_A10_L255": (10, 255), "A70_L300": (70, 300),
                           "A13_L2": (13, 2), "A3_L1": (3, 1)}[label]
    g, args = cs.two_species_tail_case(np.random.default_rng(angles * 1000 + wavelengths), "cpu", angles, wavelengths)
    return g, (_one_species(args) if label.startswith("one_species") else args)


TAIL_CASES = ["two_species", "one_species_A10_L255", "A70_L300", "A13_L2", "A3_L1"]


@pytest.mark.parametrize("label", TAIL_CASES)
def test_k5_emulated_matches_f64_twin(emulated, label):
    """K5 (csrc/spectrum_tail.cu) against its float64 twin, split at the iawfilter band as chip_smoke.py holds it."""
    report = {}
    ok, _ = cs.tail_fwd_misses(label, _tail_case(label)[1], IAW_BAND, report)
    assert ok, report


# (Not A13_L2: at 450 and 650 nm alone, far from the ion-acoustic band, the float64 twin's own g_Ti of the
# heavy species is rounding noise of ~1e-6 of g_Te, above chip_smoke.py's floor for it.)
@pytest.mark.parametrize("label", ["two_species", "one_species_A10_L255", "A70_L300"])
def test_k6_emulated_matches_f64_twin(emulated, label):
    """K6 (csrc/spectrum_tail_bwd.cu), every cotangent against its float64 twin at chip_smoke.py's limits."""
    report = {}
    ok, _ = cs.tail_bwd_misses(label, *_tail_case(label), report)
    assert ok, {k: v for k, v in report.items() if not v["ok"]}


def _chi_queries(kind, rng, meta, nvx):
    """(bq, xq) of a kind: uniform over one turn and both grids; chip_smoke.py's edge set; or the ARTS deck's
    layout, [L, A] with the angles innermost, beta rising slowly with the angle and x ramping past both ends."""
    v0x, dvx, v0p, dvp = (float(m) for m in meta)
    if kind == "edges":
        return cs.chi_edge_queries(v0x, dvx, v0p, dvp, nvx)
    if kind == "uniform":
        return rng.uniform(-7.0, 13.0, 3000), rng.uniform(v0x - 1.5, -v0x + 1.5, 3000)
    a, lam = np.arange(241) / 241, np.linspace(-1.5, 1.5, 12)
    bq = 0.6 + 0.5 * a[None, :] + 0.002 * np.arange(lam.size)[:, None]
    return bq.ravel(), (lam[:, None] * -v0x * (1.0 + 0.05 * a[None, :])).ravel()


@pytest.mark.parametrize("kind", ["uniform", "edges", "crowded"])
def test_k7_k8_emulated_match_twins(emulated, kind):
    """K7 and K8 (csrc/chi_bilinear.cu) against their float32 and float64 twins (``chip_smoke.chi_case``, at
    CHI_TOL and CHI_BWD_TOL); on crowded queries K8 makes far fewer atomics than its 12 deposits a query."""
    rng = np.random.default_rng(11)
    R, nvx = 32, 16
    v0x = -6.0 + 6.0 / nvx
    meta = torch.tensor([v0x, 12.0 / nvx, v0x + 0.37, 1.7 * 12.0 / nvx], dtype=torch.float32)
    bq, xq = _chi_queries(kind, rng, meta, nvx)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    T, g = t(cs.smooth_tables(rng, R, nvx)), t(rng.standard_normal((3, bq.size)))
    report, ok, _, _ = cs.chi_case(kind, t(bq), t(xq), T, meta, g)
    assert ok, report
    emulated()
    chi_bilinear.chi_bilinear_bwd(t(bq), t(xq), T, meta, g)
    made = emulated()
    assert made < (0.25 if kind == "crowded" else 1.0) * 12 * bq.size


@pytest.mark.parametrize("kind", ["lin", "cubic"])
@pytest.mark.parametrize("queries", ["uniform", "crowded"])
def test_lookups_emulated_match_twins(emulated, kind, queries):
    """K1-K4 (csrc/lin_lookup.cu, csrc/cubic_lookup.cu) against their float32 twins: values at LOOKUP_TOL of
    max |table|, table cotangents at LOOKUP_BWD_TOL of max |cotangent|, on two rows of uniform or crowded
    (``chip_smoke.crowded_queries``) queries, the second block of each row cut short."""
    rng = np.random.default_rng(12)
    B, Q = 2, 9000
    if kind == "lin":
        n, x0, dx = 2043, -8.2, 16.4 / 2042
        grid = (x0, dx)
    else:
        n = 320
        dx = 12.0 / n
        x0 = -6.0 + dx / 2
        grid = torch.tensor(np.tile([x0, dx, n], (B, 1)), dtype=torch.float32)
    xend = x0 + dx * (n - 1)
    q = rng.uniform(x0 - 2 * dx, xend + 2 * dx, (B, Q)) if queries == "uniform" else cs.crowded_queries(rng, x0, xend, B, Q)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    q, table, g = t(q), t(rng.standard_normal((B, n))), t(rng.standard_normal((B, Q)))
    if kind == "lin":
        got, want = lin_lookup.lin_lookup_fwd(q, table, *grid), lin_lookup.plain(q, table, *grid)
        d_got, d_want = lin_lookup.lin_lookup_bwd(q, g, *grid, n), lin_lookup.plain_bwd(q, g, *grid, n)
    else:
        g = torch.where((q < x0) | (q > xend), 0.0, g).contiguous()  # as the forward's overwrite leaves it
        got, want = cubic_lookup.cubic_lookup_fwd(q, table, grid), cubic_lookup.plain(q, table, grid)
        d_got, d_want = cubic_lookup.cubic_lookup_bwd(q, g, grid, n), cubic_lookup.plain_bwd(q, g, grid, n)
    assert cs.max_err(got, want) <= cs.LOOKUP_TOL * float(table.abs().max())
    assert float((d_got - d_want).abs().max()) <= cs.LOOKUP_BWD_TOL * float(d_want.abs().max())


def test_emulation_rewrites_every_launch():
    """Every kernel source's launches and shared arrays take the emulation's forms (none left for g++ to reject)."""
    for name in KERNELS:
        src = _for_the_cpu((build.CSRC / f"{name}.cu").read_text())
        assert "<<<" not in src and "__shared__" not in src, name
        assert src.count("emu::launch(") >= 1, name
