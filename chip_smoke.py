#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

From the repository root, on a machine with one CUDA GPU and nvcc.  It

1. reads the card's name and power limit;
2. builds every kernel of the port from ``tsadar_tpu_torch/csrc`` (timed as set-up);
3. holds each kernel against its plain PyTorch twin on the card, at the shapes
   of the whole-shot forward, and times kernel, twin and (where one exists) a
   single PyTorch library call computing the same function;
4. drives the whole-shot 1V forward -- the ``tests/configs/time_test_*`` deck,
   128 lineouts with seeded random Te, ne, m and lam, float32 -- through
   ``ThomsonScatteringDiagnostic``, checks that every kernel launched in that
   run, compares 4 lineouts with the plain path on the CPU in float64, and
   times the forward.

It prints one JSON line per phase and check, then the kernel table, then the
card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit code is
0 only when everything passed; without a CUDA device it prints no result and
exits 2.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import yaml

ROOT = Path(__file__).resolve().parent
SEED = 0
N_LINEOUTS = 128  # the whole-shot batch
N_CHECK = 4  # lineouts compared with the CPU float64 path
FWD_TOL = 5e-3  # of peak: float32 on the card vs float64 on the CPU (the JAX bench's gate)
# lookup kernels vs their float32 plain twins on the same card and inputs, of
# max |table|: the two differ only by fused multiply-adds
LOOKUP_TOL = 1e-5
# the tail kernel is held to its twin run in float64 on the same inputs.  Outside
# the ion-acoustic band that the deck's iawfilter notch cuts, at most
# TAIL_EPW_TOL of each lineout's own peak there (the float32 twin stays within a
# few 1e-4).  Inside that band the resonance is so narrow that float32 alone
# moves the spike by percents of its peak: there the kernel may miss by at most
# TAIL_IAW_RATIO times the float32 twin's own miss, plus TAIL_IAW_FLOOR of peak.
TAIL_EPW_TOL = 1e-3
TAIL_IAW_RATIO = 2.0
TAIL_IAW_FLOOR = 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SLEEP_CYCLES = 400_000_000  # ~0.2 s: lets the host queue every timed launch before the first runs


def emit(obj):
    print(json.dumps(obj), flush=True)


def device_times_ms(fn, reps=20, warmup=3):
    """Median device time of one ``fn()`` call, from CUDA events around each call.

    The stream first sleeps so that the host has queued every call before the
    first one runs: the events then bracket device work, not host overhead.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes, nops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def load_deck():
    from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges

    decks = [yaml.safe_load((ROOT / "tests" / "configs" / f"time_test_{n}.yaml").read_text()) for n in ("defaults", "inputs")]
    return set_forward_ranges(merge_configs(*decks))


def draw_lineouts(n):
    """Per-lineout physical Te [keV], ne [1e20 cm^-3], DLM m and probe lam [nm], inside the deck's bounds.

    The band surrounds shot 101675's fitted values (Te ~0.6, ne ~0.22).  At
    lower Te, higher ne or flatter EDFs (m > 4) the EPW resonance turns so
    narrow that float32 misses the float64 spectrum by up to tens of percent of
    peak at npts = 5120, the JAX package's float32 path as much as the port's
    (``tests/test_torch_float32.py``), and no float32 run can meet the 5e-3
    check there.
    """
    rng = np.random.default_rng(SEED)
    return {
        "Te": rng.uniform(0.5, 1.0, n),
        "ne": rng.uniform(0.1, 0.25, n),
        "m": rng.uniform(2.0, 3.5, n),
        "lam": rng.uniform(523.5, 527.5, n),
    }


def make_params(cfg, draws, n, device, dtype):
    """``ThomsonParams`` of the first ``n`` drawn lineouts."""
    import torch

    from tsadar_tpu_torch import ThomsonParams
    from tsadar_tpu_torch.core.params.distributions import inv_act

    params = ThomsonParams.create(cfg["parameters"], n, activate=True, device=device, dtype=dtype)

    def put(group, name, vals):
        x = inv_act((vals[:n] - group.shifts[name]) / group.scales[name], group.activated[name])
        group.normed[name].data.copy_(torch.as_tensor(x))

    put(params.electron.params, "Te", draws["Te"])
    put(params.electron.params, "ne", draws["ne"])
    put(params.general.params, "lam", draws["lam"])
    dist = params.electron.distribution_functions
    dist.normed_m.data.copy_(torch.as_tensor(inv_act((draws["m"][:n] - dist.m_shift) / dist.m_scale, dist.activated)))
    return params


def make_batch(n):
    return {"e_amps": np.ones((n, 1)), "i_amps": np.ones((n, 1)), "noise_e": np.zeros((n, 1)), "noise_i": np.zeros((n, 1))}


def check_kernel(name, got, want, scale):
    err = max_err(got, want)
    tol = LOOKUP_TOL * scale
    emit({"phase": "kernel_check", "kernel": name, "max_abs_err": err, "scale": scale, "tol": tol, "ok": err <= tol})
    if not err <= tol:
        raise RuntimeError(f"{name}: kernel disagrees with its plain twin, max |err| {err:.3e} > {tol:.3e}")
    return err


def check_lookups(rng):
    """K1 and K3 at the whole-shot shapes, on seeded tables and queries that
    include both edge cells and queries beyond both ends."""
    import torch
    import torch.nn.functional as F

    from tsadar_tpu_torch.ops import cubic_lookup, lin_lookup

    dev = torch.device("cuda")
    B, Q = N_LINEOUTS, 5120 * 10
    rows = {}

    # K1: the 2043-entry chi_R pole table on its xi grid
    n, x0, dx = 2043, -8.2, 16.4 / 2042
    table = rng.standard_normal((B, n))
    q = rng.uniform(x0 - 1.0, x0 + (n - 1) * dx + 1.0, (B, Q))
    q[:, :64] = x0 + dx * rng.uniform(0.0, 1.0, (B, 64))  # first cell
    q[:, 64:128] = x0 + dx * (n - 2 + rng.uniform(0.0, 1.0, (B, 64)))  # last cell
    qt = torch.tensor(q, dtype=torch.float32, device=dev)
    tt = torch.tensor(table, dtype=torch.float32, device=dev)
    kern = lambda: lin_lookup.lin_lookup_fwd(qt, tt, x0, dx)  # noqa: E731
    plain = lambda: lin_lookup.plain(qt, tt, x0, dx)  # noqa: E731
    err = check_kernel("lin_lookup_fwd", kern(), plain(), float(tt.abs().max()))
    # yardstick: grid_sample's border-clamped linear interpolation gives the value (not the slope)
    grid = torch.zeros((B, 1, Q, 2), dtype=torch.float32, device=dev)
    grid[..., 0] = ((qt - x0) / (dx * (n - 1)) * 2.0 - 1.0)[:, None, :]
    img = tt[:, None, None, :]
    lib = lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True)  # noqa: E731
    b_ms, b_by = bound_ms(4 * B * Q + 4 * B * n + 8 * B * Q, 10 * B * Q)
    rows["lin_lookup_fwd"] = dict(
        max_abs_err=err, ms=device_times_ms(kern), plain_ms=device_times_ms(plain), bound_ms=b_ms, bound_by=b_by,
        library_ms=device_times_ms(lib),
    )

    # K3: the 320-point log-EDF table on the DLM velocity grid, per-row meta
    n = 320
    dv = 12.0 / n
    x0 = -6.0 + dv / 2
    vx = x0 + dv * np.arange(n)
    table = -(vx**2) / 2 + 0.1 * rng.standard_normal((B, n))
    q = rng.uniform(x0 - 1.5 * dv, vx[-1] + 1.5 * dv, (B, Q))
    q[:, :64] = x0 + dv * rng.uniform(0.0, 1.0, (B, 64))
    q[:, 64:128] = x0 + dv * (n - 2 + rng.uniform(0.0, 1.0, (B, 64)))
    qt = torch.tensor(q, dtype=torch.float32, device=dev)
    tt = torch.tensor(table, dtype=torch.float32, device=dev)
    meta = torch.tensor(np.tile([x0, dv, n], (B, 1)), dtype=torch.float32, device=dev)
    kern = lambda: cubic_lookup.cubic_lookup_fwd(qt, tt, meta)  # noqa: E731
    plain = lambda: cubic_lookup.plain(qt, tt, meta)  # noqa: E731
    err = check_kernel("cubic_lookup_fwd", kern(), plain(), float(tt.abs().max()))
    b_ms, b_by = bound_ms(4 * B * Q + 4 * B * n + 12 * B + 8 * B * Q, 50 * B * Q)
    rows["cubic_lookup_fwd"] = dict(
        max_abs_err=err, ms=device_times_ms(kern), plain_ms=device_times_ms(plain), bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
    )
    return rows


def check_tail(diag, params):
    """K5 on the forward's own lookup outputs [128, 1, 5120, 10]."""
    import torch

    from tsadar_tpu_torch.core.physics.constants import C
    from tsadar_tpu_torch.ops import spectrum_tail

    ff = diag.model.electron_form_factor
    inputs = ff._lookups_1v(params())
    args = (*inputs, diag.model.weight, ff.sarad, ff.omgs)
    kern = lambda: spectrum_tail.spectrum_tail_fwd(*args)  # noqa: E731
    plain = lambda: spectrum_tail.plain(*args)  # noqa: E731
    got, want = kern(), plain()
    ref = spectrum_tail.plain(*(a.double() for a in args))
    peak = float(ref.abs().max())
    err = float((got - want).abs().max())
    blue, red, _ = diag.model._filter_band()
    lam = 2.0 * math.pi * C / ff.omgs.double() * 1e7
    iaw = (lam > blue) & (lam < red)
    epw_peak = ref[:, ~iaw].abs().amax(1)
    miss_epw = lambda x: float(((x.double() - ref)[:, ~iaw].abs().amax(1) / epw_peak).max())  # noqa: E731
    miss_iaw = lambda x: float((x.double() - ref)[:, iaw].abs().max())  # noqa: E731
    epw_kernel, epw_plain = miss_epw(got), miss_epw(want)
    iaw_kernel, iaw_plain = miss_iaw(got), miss_iaw(want)
    iaw_tol = TAIL_IAW_RATIO * iaw_plain + TAIL_IAW_FLOOR * peak
    ok = epw_kernel <= TAIL_EPW_TOL and iaw_kernel <= iaw_tol
    emit({"phase": "kernel_check", "kernel": "spectrum_tail_fwd", "max_abs_err": err, "peak": peak,
          "iaw_band_nm": [blue, red], "epw_row_peak_range": [float(epw_peak.min()), float(epw_peak.max())],
          "epw_kernel_vs_f64_of_row_peak": epw_kernel, "epw_plain_f32_vs_f64_of_row_peak": epw_plain,
          "epw_tol": TAIL_EPW_TOL, "iaw_kernel_vs_f64": iaw_kernel, "iaw_plain_f32_vs_f64": iaw_plain,
          "iaw_tol": iaw_tol, "ok": ok})
    if not ok:
        raise RuntimeError(
            f"spectrum_tail_fwd: kernel misses the float64 twin by {epw_kernel:.3e} of the EPW peak "
            f"(tol {TAIL_EPW_TOL}) and by {iaw_kernel:.3e} in the IAW band (tol {iaw_tol:.3e})"
        )
    B, G, L, NA = inputs[0].shape
    S = inputs[7].shape[-1]
    # per (lineout, gradient, wavelength, angle) point, counted from the kernel
    # source with each transcendental as one operation: ~100 for kinematics,
    # the Landau term and the assembly, ~130 per ion species (Z' included)
    nops = B * G * L * NA * (100 + 130 * S)
    nbytes = 8 * B * G * L * NA + 4 * B * L + 4 * (2 * B * G + 3 * B + 4 * B * S + 2 * NA + L)
    b_ms, b_by = bound_ms(nbytes, nops)
    return dict(
        max_abs_err=err, ms=device_times_ms(kern), plain_ms=device_times_ms(plain), bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
    )


def profile_forward(forward, forward_ms, reps=3, top=10):
    """Device time per forward (torch.profiler): the sum over device kernels, the
    device's busy share, the top kernels, and the top PyTorch ops by the device
    time of the kernels they launched (the port's own kernels have no op)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            forward()
        torch.cuda.synchronize()

    def ranked(on_device):
        rows = [(e.key, e.self_device_time_total / reps / 1e3, e.count / reps) for e in prof.key_averages()
                if (e.device_type == DeviceType.CUDA) == on_device and e.self_device_time_total > 0]
        return sorted(rows, key=lambda r: -r[1])

    kernels, ops = ranked(True), ranked(False)
    device_ms = sum(r[1] for r in kernels)
    as_json = lambda rows: [{"name": k[:100], "ms": t, "calls": c} for k, t, c in rows[:top]]  # noqa: E731
    return {"phase": "profile", "device_ms_per_forward": device_ms, "forward_ms": forward_ms,
            "device_busy_share": device_ms / forward_ms, "kernel_launches_per_forward": sum(r[2] for r in kernels),
            "top_kernels": as_json(kernels), "top_ops": as_json(ops)}


KERNELS = {
    "lin_lookup_fwd": ("tsadar_tpu_torch/csrc/lin_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:84"),
    "cubic_lookup_fwd": ("tsadar_tpu_torch/csrc/cubic_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:314"),
    "spectrum_tail_fwd": ("tsadar_tpu_torch/csrc/spectrum_tail.cu", "tsadar_tpu/ops/spectrum_kernel.py:380"),
}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 2
    if not (ROOT / "tsadar_tpu_torch").is_dir():
        print(f"chip_smoke: no tsadar_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from tsadar_tpu_torch import ThomsonScatteringDiagnostic, get_scattering_angles
    from tsadar_tpu_torch.ops import build, cubic_lookup, lin_lookup, spectrum_tail

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build (set-up)
    t0 = time.perf_counter()
    logs = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": list(build.SOURCES),
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln] for k, v in logs.items()}})

    cfg = load_deck()
    sas = get_scattering_angles(cfg)
    draws = draw_lineouts(N_LINEOUTS)
    diag = ThomsonScatteringDiagnostic(cfg, sas)
    params = make_params(cfg, draws, N_LINEOUTS, None, None)
    batch = make_batch(N_LINEOUTS)
    wrappers = {
        "lin_lookup_fwd": lin_lookup.lin_lookup_fwd,
        "cubic_lookup_fwd": cubic_lookup.cubic_lookup_fwd,
        "spectrum_tail_fwd": spectrum_tail.spectrum_tail_fwd,
    }

    with torch.no_grad():
        # 3. every kernel against its plain twin, at the main path's shapes
        rows = check_lookups(np.random.default_rng(SEED))
        rows["spectrum_tail_fwd"] = check_tail(diag, params)

        # 4. the main path: the whole-shot forward through the kernels
        for fn in wrappers.values():
            fn.launches = 0
        ThryE = diag(params, batch)[0]
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        emit({"phase": "forward_launches", "launches": launches})
        if not all(launches.values()):
            raise RuntimeError(f"the forward did not launch every kernel: {launches}")
        if ThryE.shape != (N_LINEOUTS, 1024) or not bool(torch.isfinite(ThryE).all()):
            raise RuntimeError(f"forward output: shape {tuple(ThryE.shape)}, finite {bool(torch.isfinite(ThryE).all())}")

        diag_cpu = ThomsonScatteringDiagnostic(cfg, sas, device="cpu")
        ref = diag_cpu(make_params(cfg, draws, N_CHECK, "cpu", None), make_batch(N_CHECK))[0]
        err = float((ThryE[:N_CHECK].double().cpu() - ref).abs().max() / ref.abs().max())
        emit({"phase": "forward_check", "lineouts": N_CHECK, "max_err_of_peak": err, "tol": FWD_TOL, "ok": err <= FWD_TOL})
        if not err <= FWD_TOL:
            raise RuntimeError(f"forward disagrees with the CPU float64 path: {err:.3e} of peak > {FWD_TOL}")

        times = []
        for i in range(12):
            t0 = time.perf_counter()
            diag(params, batch)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        emit({"phase": "forward", "lineouts": N_LINEOUTS, "npts": cfg["other"]["npts"], "angles": len(sas["sa"]),
              "ms": ms, "spectra_per_s": N_LINEOUTS / ms * 1e3, "times_ms": times, "gpu": smi})
        emit(profile_forward(lambda: diag(params, batch), ms))

    emit({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1], "launches": launches[k], **rows[k]}
        for k in wrappers
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
