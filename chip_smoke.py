#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

From the repository root, on a machine with one CUDA GPU and nvcc.  It

1. reads the card's name and power limit;
2. builds every kernel of the port from ``tsadar_tpu_torch/csrc`` (timed as set-up);
3. holds each kernel against its plain PyTorch twin on the card, at the shapes
   of the whole-shot forward, and times kernel, twin and (where one exists) a
   single PyTorch library call computing the same function; the lookups' table
   cotangents (K2, K4) also on crowded seeded queries laid out as xi_e; the
   tail (K5, K6) also on a two-species case, on that case at 70 angles and on
   the main operands cut to 1, 50 and 255 wavelengths;
4. drives the whole-shot fit from shot 101675's real data, as
   ``bench_whole_shot.py`` does: ``prepare_data`` on the shot (128 lineouts,
   pixels 300:812:4; host seconds and shapes), the 128-lineout forward at the
   deck's start values (K1, K3, K5 and the pole tables K9 once each), K9 in
   both modes and K10 with its backward against their twins on that forward's
   own operands and on seeded ones, K5 and K6 against their twins and timed on
   that forward's operands, K2 and K4 against their twins and timed on its
   xi_e, K10's path (``interp1d_linear_pallas`` on
   the real chi_R table and queries, forward and backward, against K1/K2),
   loss and gradient of 4 real lineouts against the CPU float64 plain path,
   and FIT_STEPS adam steps at lr 2e-2 (K1-K6 and both K9 modes once per
   step) under ``bench_whole_shot.py``'s quality gate: Te, ne and m at the
   lineouts of pixels 500-510 within 10 %, 5 % and 15 % of the validated
   0.641, 0.228 and 3.20, final and median lineout loss under 1e-3, the fit
   under 60 s; ms per step and a profile of the step;
5. drives the whole-shot 1V forward -- the ``tests/configs/time_test_*`` deck,
   128 lineouts with seeded random Te, ne, m and lam, float32 -- through
   ``ThomsonScatteringDiagnostic``, checks that every forward kernel launched
   in that run, compares 4 lineouts with the plain path on the CPU in float64,
   and times the forward;
6. compares loss and gradient of 4 lineouts on the card (float32, kernels)
   with the CPU float64 plain path, per active parameter;
7. fits the 128 lineouts: the data are the port's own forward at the seeded
   truth, the parameters start at the deck's values, and ``_1d_adam_loop_``
   takes FIT_STEPS adam steps at lr 2e-2.  Every one of the six kernels must
   launch at least once per step, every loss must be finite, the best loss
   must fall to a tenth of the first, and the medians of the recovered Te, ne
   and m must lie within 10 %, 5 % and 15 % of the truth.  It reports ms per
   step and a profile of a few steps;
8. drives the ARTS 2V path at its full width (the ``tests/configs/arts2*`` deck:
   1024 wavelengths x 241 fine angles, a 128 x 128 arbitrary 2D EDF, 256-row
   angle tables, one image): holds the fused chi-table lookup and its cotangent
   (K7, K8) against their plain twins on seeded queries, on an edge set and on
   the deck's own queries (K8 timed on both query sets beside one
   ``scatter_add_`` of all its 12 deposits a query); runs the forward through
   ``ThomsonScatteringDiagnostic`` (K7 exactly once) and compares it with the
   CPU float64 plain path; compares loss and gradient with respect to the EDF
   (K7 and K8 once each) with that path; fits the image with ``angular_optax``
   (adam, ARTS_FIT_STEPS steps; K7 and K8 once per step, every loss finite, the
   last under a quarter of the first); and runs the deck's own
   spherical-harmonic EDF and the ARTS 1V deck forward once each against the
   CPU float64 path.

It prints one JSON line per phase and check, then the kernel table, then the
card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit code is
0 only when everything passed; without a CUDA device it prints no result and
exits 2.
"""

import copy
import json
import math
import re
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
# table cotangents of the lookups vs their float32 plain twins (scatter_add_),
# of max |cotangent|: both sum float32 terms per entry in an order of their own,
# ~50 (K2) or ~640 (K4) on uniform queries, and up to ~1.0e4 (K2) and ~1.4e4
# (K4) at the end entries of the real-data queries and ~1.8e4 on the crowded
# seeded ones (each case reports its count: max_deposits)
LOOKUP_BWD_TOL = 1e-5
# K10's table cotangent against its twin in float64: any float32 form resolves the weight w = pos - i0
# only to half an ulp of pos (~6e-5 at n = 2043), and each entry sums ~25 such deposits, so it is held
# to LOOKUP_BWD_F64_TOL of its max there (the float32 twin's own miss is reported beside it)
LOOKUP_BWD_F64_TOL = 1e-4
# the tail's cotangents are held to the twin (autograd of the plain tail) run
# in float64 on the same inputs, each output on its own: at most TAIL_BWD_TOL
# of that output's largest magnitude (measured <= 5e-4).  Two outputs have no
# magnitude of their own to go by.  g_ud is an exact zero (ud shifts every
# xi_e alike and the tail sees only their differences): it is held to
# TAIL_BWD_TOL of g_Va's magnitude, the other velocity.  Away from the
# ion-acoustic band the spectrum depends on Ti ~1e-10 times as much as on Te,
# and the float64 twin's own g_Ti is rounding noise there (~1e-8 of g_Te: its
# terms grow as xi_i^2 while their sum falls as xi_i^-4): g_Ti may miss by
# TAIL_BWD_TI_FLOOR of g_Te's magnitude on top of TAIL_BWD_TOL of its own.
# A single species' g_fract is an exact zero as well (the Zbar coupling cancels
# it): it gets TAIL_BWD_TOL of g_Z's magnitude.
TAIL_BWD_TOL = 1e-3
TAIL_BWD_TI_FLOOR = 1e-6
# loss and gradient, float32 kernels on the card vs the float64 plain path on
# the CPU: the loss relative, each active parameter's gradient as a share of
# that parameter's largest |gradient| over the lineouts (measured <= 4.4e-3
# for Te, ne, m, amp1, amp2 and 8.5e-3 for lam)
LOSS_TOL = 5e-3
GRAD_TOL = 2e-2
FIT_STEPS = 200
FIT_LR = 2e-2
FIT_LOSS_DROP = 0.1  # final best loss <= this share of the first
FIT_TOL = {"Te": 0.10, "ne": 0.05, "m": 0.15}  # median relative error of the recovered parameter
# the fused chi-table lookup (K7) against its float32 twin (same arithmetic but for fused multiply-adds,
# every query) and against its twin in float64 on the same float32 inputs: values at most CHI_TOL of
# the segment's largest |entry|; the derivative outputs at most CHI_TOL of that over the cell width,
# against float64 only where float32 and float64 put the query into the same cell (the derivative
# jumps from cell to cell; the queries that differ are counted and reported)
CHI_TOL = 1e-5
# its cotangent (K8): dT and dbeta at most CHI_BWD_TOL of their own largest |entry|, against both
# twins.  dT sums float32 deposits by atomics in an order that changes from run to run (runs of a
# warp's lanes summed first): Q / (R nvx) ~ 7.5 a cell on average, and at the busiest entry 331 on
# the seeded queries (those past a grid's end clamp onto its end column) and 5 791 on the deck's
# own (chi_bilinear_bwd_deposits reports both as max_deposits); measured 4e-7 / 8e-7 of max against
# the float32 twin and 1.7e-5 / 1.4e-5 against float64 (the first design, one atomic a deposit, 1.7e-5
# on the seeded set too)
CHI_BWD_TOL = 1e-4
ARTS_NEGATIVE_TOL = 1e-4  # the ARTS image may dip below zero by this share of its peak (NUDFT ringing in the far tail)
# the ARTS 1V deck's resonance is so narrow that float32 misses the float64 image at its peak pixel,
# in the plain forms on the CPU as on the card: there the card is held directly to the CPU float32
# plain forward, of peak (measured 2.0e-4; kernels against plain forms on the card itself 4.4e-5)
ARTS_1V_F32_TOL = 1e-3
ARTS_FIT_STEPS = 120
ARTS_FIT_LR = 5e-4
ARTS_FIT_DROP = 0.25  # last loss under this share of the first (the JAX ARTS bench's gate)
# the pole tables (K9, both modes) against their twin in float64 on the same float32 operands, of the
# table's (cotangent's) largest |entry|: the precombined form's float32 error is ~2e-7 (one f32 product
# per coefficient, sums over 1024 nodes); against the float32 twin (two cuBLAS products) the same limit
PV_TOL = 1e-5
PV_PARTIAL_B = 5  # a K9 check on a batch that is not a multiple of the kernel's 32 lineouts per block
PV_RAGGED = (37, 1300)  # (B, N): neither the batch nor the 1298 poles a multiple of the kernel's 32 x 128 tile
# the real-data fit (bench_whole_shot.py): 128 lineouts of shot 101675, pixels 300:812:4, 200 adam
# steps at lr 2e-2, and bench_whole_shot.py's own quality gate at the lineouts of pixels 500-510
# (tests/test_inverse/test_1d_data.py's validated values and tolerances), with its loss ceilings
REAL_PIXELS = (300, 812, 4)
REAL_TRUTH = {"Te": (0.641, 0.10), "ne": (0.228, 0.05), "m": (3.20, 0.15)}  # (validated value, relative tolerance)
REAL_WINDOW = (500, 510)
REAL_LOSS_CEILING = 1e-3  # final loss and median lineout loss
REAL_FIT_SECONDS = 60.0
REAL_CHECK_PIXELS = (500, 504, 508, 512)  # the 4 real lineouts of the loss/gradient check
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
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


def bound_ms(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sass_instructions(name):
    """Static SASS instructions per kernel of the built library ``name``, from ``cuobjdump -sass`` beside
    nvcc (the listing is kept beside the library, ``.sass``); None where there is no cuobjdump."""
    from tsadar_tpu_torch.ops import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    so = build.library_path(name)[1]
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    so.with_suffix(".sass").write_text(sass)
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn] += 1
    return counts


def ptxas_usage(log, function):
    """Registers, stack and spills of the first kernel in an nvcc ``-Xptxas -v`` log whose mangled name
    contains ``function``; None if there is none."""
    fn, usage = None, {}
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            fn = head.group(1) if function in head.group(1) else None
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if fn and frame:
            usage.update(stack_bytes=int(frame.group(1)), spill_store_bytes=int(frame.group(2)), spill_load_bytes=int(frame.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if fn and regs:
            return {"function": fn, "registers": int(regs.group(1)), **usage}
    return None


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


def check_kernel(name, got, want, scale, rel_tol=LOOKUP_TOL):
    err = max_err(got, want)
    tol = rel_tol * scale
    emit({"phase": "kernel_check", "kernel": name, "max_abs_err": err, "scale": scale, "tol": tol, "ok": err <= tol})
    if not err <= tol:
        raise RuntimeError(f"{name}: kernel disagrees with its plain twin, max |err| {err:.3e} > {tol:.3e}")
    return err


def crowded_queries(rng, x0, xend, B, Q, angles=10):
    """[B, Q] queries laid out [L, angles] as the form factor's xi_e: per angle a monotone ramp over three
    times the grid's span around its centre (a third of each row below the grid, a third above), slope and
    offset drawn per (row, angle), so that neighbouring queries share cells and the clamped ones crowd the
    two end cells."""
    L = -(-Q // angles)
    span = xend - x0
    ramp = np.linspace(-1.5, 1.5, L)[None, :, None]
    q = 0.5 * (x0 + xend) + span * (ramp * rng.uniform(0.9, 1.1, (B, 1, angles)) + rng.uniform(-0.05, 0.05, (B, 1, angles)))
    return q.reshape(B, -1)[:, :Q]


def lookup_deposits(kind, q, g, grid, n):
    """Every deposit of K2 (kind "lin", grid (x0, dx)) or K4 ("cubic", grid = meta [B, 3]) as one index and one
    value tensor [B, taps x Q], and the most deposits any entry takes.  K4's taps outside the table (weight
    exactly 0) go onto the nearest entry and are not counted."""
    import torch

    from tsadar_tpu_torch.core.physics.interp import _cubic_weights, cubic_cell, lin_cell

    if kind == "lin":
        _, i0, w = lin_cell(q, *grid, n)
        taps, vals = [i0, i0 + 1], [g * (1.0 - w), g * w]
    else:
        i0, t, first, last = cubic_cell(q, grid)
        taps, vals = [i0 + k - 1 for k in range(4)], [g * c for c in _cubic_weights(t, first, last)]
    idx = torch.cat([tap.clamp(0, n - 1) for tap in taps], 1)
    inside = torch.cat([((tap >= 0) & (tap < n)).float() for tap in taps], 1)
    counts = torch.zeros((q.shape[0], n), dtype=torch.float32, device=q.device).scatter_add_(-1, idx, inside)
    return idx, torch.cat(vals, 1), int(counts.max())


def lookup_bwd_case(kind, q, g, grid, n):
    """K2 or K4 (``lookup_deposits``' kinds) on (q, g): the kernel against its float32 twin, held to
    LOOKUP_BWD_TOL of max |cotangent| (its and the twin's miss of the float64 twin reported beside); the
    kernel's time and that of one scatter_add_ of all its deposits (indices and values built untimed), the
    most deposits an entry takes.  Returns (report, ok)."""
    import torch

    from tsadar_tpu_torch.ops import cubic_lookup, lin_lookup

    if kind == "lin":
        grid = tuple(float(np.float32(v)) for v in grid)  # the grid the kernel sees, for the float64 twin too
        kern = lambda: lin_lookup.lin_lookup_bwd(q, g, *grid, n)  # noqa: E731
        want, f64 = lin_lookup.plain_bwd(q, g, *grid, n), lin_lookup.plain_bwd(q.double(), g.double(), *grid, n)
    else:
        kern = lambda: cubic_lookup.cubic_lookup_bwd(q, g, grid, n)  # noqa: E731
        want, f64 = cubic_lookup.plain_bwd(q, g, grid, n), cubic_lookup.plain_bwd(q.double(), g.double(), grid.double(), n)
    got = kern()
    scale, f64_scale = float(want.abs().max()), float(f64.abs().max())
    idx, vals, most = lookup_deposits(kind, q, g, grid, n)
    lib = lambda: torch.zeros((q.shape[0], n), dtype=torch.float32, device=q.device).scatter_add_(-1, idx, vals)  # noqa: E731
    err = float((got - want).abs().max())
    report = {"max_abs_err": err, "scale": scale, "vs_f32_twin_of_max": err / scale,
              "vs_f64_twin_of_max": float((got.double() - f64).abs().max()) / f64_scale,
              "f32_twin_vs_f64_twin_of_max": float((want.double() - f64).abs().max()) / f64_scale,
              "library_vs_f32_twin_of_max": float((lib() - want).abs().max()) / scale,
              "max_deposits": most, "zero_g_share": float((g == 0).double().mean()),
              "ms": device_times_ms(kern), "library_ms": device_times_ms(lib)}
    return report, bool(torch.isfinite(got).all()) and err <= LOOKUP_BWD_TOL * scale


def check_lookup_bwd(name, kind, seeded, crowded, grid, n, plain, bound):
    """K2 or K4 on seeded and on crowded (q, g) pairs (``lookup_bwd_case``); fails on a disagreement.
    Returns the kernel's row: the seeded case's error and times (``plain`` the twin on it), the crowded ones."""
    cases = {label: lookup_bwd_case(kind, q, g, grid, n) for label, (q, g) in (("seeded", seeded), ("crowded", crowded))}
    ok = all(case_ok for _, case_ok in cases.values())
    report = {label: case for label, (case, _) in cases.items()}
    emit({"phase": "kernel_check", "kernel": name, "tol": LOOKUP_BWD_TOL, "cases": report, "ok": ok})
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain twin: {report}")
    one, many = report["seeded"], report["crowded"]
    return dict(max_abs_err=one["max_abs_err"], ms=one["ms"], plain_ms=device_times_ms(plain), bound_ms=bound[0],
                bound_by=bound[1], library_ms=one["library_ms"], crowded_ms=many["ms"], crowded_library_ms=many["library_ms"],
                crowded_max_deposits=many["max_deposits"])


def check_lookups(rng):
    """K1-K4 at the whole-shot shapes, on seeded tables, queries that include
    both edge cells and queries beyond both ends, and a seeded cotangent; K2 and
    K4 also on crowded seeded queries (``crowded_queries``, K4's g zeroed beyond
    its grid as the forward's overwrite leaves it)."""
    import torch
    import torch.nn.functional as F

    from tsadar_tpu_torch.ops import cubic_lookup, lin_lookup

    dev = torch.device("cuda")
    B, Q = N_LINEOUTS, 5120 * 10
    rows = {}
    crowd_rng = np.random.default_rng(SEED + 2)  # its own draws: every other seeded operand stays as it was

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
    # K2: the table cotangent of K1; yardstick: one scatter_add_ of both deposits of every query
    gt = torch.tensor(rng.standard_normal((B, Q)), dtype=torch.float32, device=dev)
    qc = torch.tensor(crowded_queries(crowd_rng, x0, x0 + (n - 1) * dx, B, Q), dtype=torch.float32, device=dev)
    rows["lin_lookup_bwd"] = check_lookup_bwd(
        "lin_lookup_bwd", "lin", (qt, gt), (qc, gt), (x0, dx), n, lambda: lin_lookup.plain_bwd(qt, gt, x0, dx, n),
        bound_ms(8 * B * Q + 4 * B * n, 8 * B * Q))

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
    # K4: the table cotangent of K3; yardstick: one scatter_add_ of all four taps of every query
    gt = torch.tensor(rng.standard_normal((B, Q)), dtype=torch.float32, device=dev)
    qc = torch.tensor(crowded_queries(crowd_rng, x0, vx[-1], B, Q), dtype=torch.float32, device=dev)
    gc = torch.where((qc < x0) | (qc > vx[-1]), 0.0, gt).contiguous()
    rows["cubic_lookup_bwd"] = check_lookup_bwd(
        "cubic_lookup_bwd", "cubic", (qt, gt), (qc, gc), meta, n, lambda: cubic_lookup.plain_bwd(qt, gt, meta, n),
        bound_ms(8 * B * Q + 12 * B + 4 * B * n, 40 * B * Q))
    return rows


def check_lookups_real(q, poles, table_n, meta, nv):
    """K2 and K4 on the real-data forward's own queries xi_e [B, 51 200]: K2 on the chi_R pole grid, K4 on
    the log-EDF grid (``meta``, nv entries) with g zeroed where the forward overwrites the lookup (beyond
    the velocity grid); g seeded by a generator of its own.  Returns {kernel: {real_data_ms, ...}}."""
    import torch

    g = torch.tensor(np.random.default_rng(SEED + 3).standard_normal(q.shape), dtype=torch.float32, device=q.device)
    vx0, vdx = float(meta[0, 0]), float(meta[0, 1])
    g4 = torch.where((q < vx0) | (q > vx0 + vdx * (nv - 1)), 0.0, g).contiguous()
    lin, ok_lin = lookup_bwd_case("lin", q, g, (float(poles[0]), float(poles[1] - poles[0])), table_n)
    cubic, ok_cubic = lookup_bwd_case("cubic", q, g4, meta, nv)
    emit({"phase": "kernel_check", "kernel": "lin_lookup_bwd+cubic_lookup_bwd", "case": "real_data_xie", "queries": list(q.shape),
          "tol": LOOKUP_BWD_TOL, "cases": {"lin_lookup_bwd": lin, "cubic_lookup_bwd": cubic}, "ok": ok_lin and ok_cubic})
    if not (ok_lin and ok_cubic):
        raise RuntimeError(f"K2/K4 on the real-data queries disagree with their plain twins: {lin}, {cubic}")
    return {k: {"real_data_ms": r["ms"], "real_data_library_ms": r["library_ms"], "real_data_max_deposits": r["max_deposits"],
                "real_data_max_abs_err": r["max_abs_err"]} for k, r in (("lin_lookup_bwd", lin), ("cubic_lookup_bwd", cubic))}


def tail_fwd_misses(label, args, band, report):
    """K5 against its twin in float64 on ``args``, split at the iawfilter ``band`` (blue, red) [nm]: outside
    it at most TAIL_EPW_TOL of each lineout's own peak there, inside it at most TAIL_IAW_RATIO times the
    float32 twin's own miss plus TAIL_IAW_FLOOR of the peak.  Fills ``report[label]`` and returns (ok,
    max |kernel - float32 twin|)."""
    import torch

    from tsadar_tpu_torch.core.physics.constants import C
    from tsadar_tpu_torch.ops import spectrum_tail

    got, want = spectrum_tail.spectrum_tail_fwd(*args), spectrum_tail.plain(*args)
    ref = spectrum_tail.plain(*(a.double() for a in args))
    peak = float(ref.abs().max())
    lam = 2.0 * math.pi * C / args[13].double() * 1e7
    iaw = (lam > band[0]) & (lam < band[1])
    epw_peak = ref[:, ~iaw].abs().amax(1) if bool((~iaw).any()) else ref.new_ones(1)
    miss_epw = lambda x: float(((x.double() - ref)[:, ~iaw].abs().amax(1) / epw_peak).max()) if bool((~iaw).any()) else 0.0  # noqa: E731
    miss_iaw = lambda x: float((x.double() - ref)[:, iaw].abs().max()) if bool(iaw.any()) else 0.0  # noqa: E731
    epw_kernel, iaw_kernel, iaw_plain = miss_epw(got), miss_iaw(got), miss_iaw(want)
    iaw_tol = TAIL_IAW_RATIO * iaw_plain + TAIL_IAW_FLOOR * peak
    entry = {"operands": list(args[0].shape), "species": args[7].shape[-1], "peak": peak,
             "wavelengths_in_iaw_band": int(iaw.sum()), "epw_row_peak_range": [float(epw_peak.min()), float(epw_peak.max())],
             "epw_kernel_vs_f64_of_row_peak": epw_kernel, "epw_plain_f32_vs_f64_of_row_peak": miss_epw(want),
             "epw_tol": TAIL_EPW_TOL, "iaw_kernel_vs_f64": iaw_kernel, "iaw_plain_f32_vs_f64": iaw_plain, "iaw_tol": iaw_tol}
    entry["ok"] = bool(torch.isfinite(got).all()) and epw_kernel <= TAIL_EPW_TOL and iaw_kernel <= iaw_tol
    report[label] = entry
    return entry["ok"], float((got - want).abs().max())


def ragged_tail_cuts(args, noise=None):
    """(label, tail arguments[, cotangent]) of 2 lineouts of the tail's ``args`` cut to each of TAIL_BWD_RAGGED_L
    wavelengths around TAIL_BWD_RAGGED_NM (the kernels' block edges); with ``noise`` [B, L] its cut too."""
    from tsadar_tpu_torch.core.physics.constants import C

    lam = 2.0 * math.pi * C / args[13].double() * 1e7
    l_mid = int((lam - TAIL_BWD_RAGGED_NM).abs().argmin())
    for width in TAIL_BWD_RAGGED_L:
        cut = slice(l_mid - width // 2, l_mid - width // 2 + width)
        rows = (args[0][:2, :, cut].contiguous(), args[1][:2, :, cut].contiguous(), *(a[:2] for a in args[2:11]),
                *args[11:13], args[13][cut].contiguous())
        yield (f"L{width}", rows) if noise is None else (f"L{width}", rows, noise[:2, cut].contiguous())


def check_tail(diag, params):
    """K5 against its twin in float64 (``tail_fwd_misses``) on the forward's own lookup outputs [128, 1,
    5120, 10]; on a small case with two gradient points, two species, flow and drift
    (``two_species_tail_case``), on that case at TAIL_BWD_MANY_ANGLES (angles in several chunks); and on 2
    lineouts of the main operands cut to TAIL_BWD_RAGGED_L wavelengths (the block edges).  The small cases
    draw from generators of their own.  Same limits for all."""
    from tsadar_tpu_torch.ops import spectrum_tail

    ff = diag.model.electron_form_factor
    inputs = ff._lookups_1v(params())
    args = (*inputs, diag.model.weight, ff.sarad, ff.omgs)
    band = diag.model._filter_band()[:2]
    report = {}
    ok, err = tail_fwd_misses("main", args, band, report)  # max_abs_err is the main path's
    dev = ff.omgs.device
    ok = tail_fwd_misses("two_species", two_species_tail_case(np.random.default_rng(SEED + 4), dev)[1], band, report)[0] and ok
    n_angles, n_wavelengths = TAIL_BWD_MANY_ANGLES
    many = two_species_tail_case(np.random.default_rng(SEED + 1), dev, n_angles, n_wavelengths)[1]
    ok = tail_fwd_misses(f"A{n_angles}", many, band, report)[0] and ok
    for label, rows in ragged_tail_cuts(args):
        ok = tail_fwd_misses(label, rows, band, report)[0] and ok
    emit({"phase": "kernel_check", "kernel": "spectrum_tail_fwd", "max_abs_err": err, "iaw_band_nm": list(band), "cases": report,
          "ok": ok})
    if not ok:
        bad = {n: r for n, r in report.items() if not r["ok"]}
        raise RuntimeError(f"spectrum_tail_fwd: kernel misses its float64 twin: {bad}")
    B, G, L, NA = inputs[0].shape
    S = inputs[7].shape[-1]
    kern = lambda: spectrum_tail.spectrum_tail_fwd(*args)  # noqa: E731
    plain = lambda: spectrum_tail.plain(*args)  # noqa: E731
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


def tail_bwd_misses(label, g, args, report):
    """K6 against its twin in float64 on (g, args), per output (the float32 twin's own
    miss beside it); fills ``report`` and returns (all ok, max |kernel - float64 twin|)."""
    import torch

    from tsadar_tpu_torch.ops import spectrum_tail

    names = spectrum_tail.GRAD_NAMES
    got, want = spectrum_tail.spectrum_tail_bwd(g, *args), spectrum_tail.plain_bwd(g, *args)
    ref = spectrum_tail.plain_bwd(g.double(), *(a.double() for a in args))
    scales = {name: float(r.abs().max()) for name, r in zip(names, ref)}
    floors = {"ud": TAIL_BWD_TOL * scales["Va"], "Ti": TAIL_BWD_TI_FLOOR * scales["Te"], "fract": TAIL_BWD_TOL * scales["Z"]}
    ok, worst = True, 0.0
    for name, k, w, r in zip(names, got, want, ref):
        tol = TAIL_BWD_TOL * scales[name] + floors.get(name, 0.0)
        miss_k, miss_w = float((k.double() - r).abs().max()), float((w.double() - r).abs().max())
        entry = {"scale": scales[name], "kernel_vs_f64": miss_k, "plain_f32_vs_f64": miss_w, "tol": tol,
                 "ok": bool(torch.isfinite(k).all()) and miss_k <= tol}
        report[f"{label}:{name}"] = entry
        ok = ok and entry["ok"]
        worst = max(worst, miss_k)
    return ok, worst


def two_species_tail_case(rng, device, n_angles=3, L=96):
    """(g, the tail's fourteen arguments) of a small synthetic case for the branches of K6
    that the one-species main path does not run: two gradient points, two ion species
    (the Zbar coupling), flow and drift, ``n_angles`` angles over 55-65 degrees with a weight
    each, ``L`` wavelengths over 450-650 nm, some of them inside the ion-acoustic feature."""
    import torch

    from tsadar_tpu_torch.core.physics.constants import C
    from tsadar_tpu_torch.core.physics.form_factor import _kinematics_fields

    B = 3
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    ne = t(1e20 * rng.uniform(0.15, 0.3, (B, 2)))
    Te = t(rng.uniform(0.4, 0.9, (B, 2)))
    lam, Va, ud = t(rng.uniform(525.0, 528.0, B)), t(1e6 * rng.uniform(-0.5, 0.5, B)), t(1e6 * rng.uniform(-0.5, 0.5, B))
    A, Z = t(np.tile([40.0, 1.0], (B, 1))), t(np.tile([8.0, 1.0], (B, 1)))
    Ti, fract = t(rng.uniform(0.1, 0.3, (B, 2))), t(np.tile([0.7, 0.3], (B, 1)))
    sarad = t(np.deg2rad(np.linspace(55.0, 65.0, n_angles)))
    omgs = t(2.0e7 * np.pi * C / np.linspace(450.0, 650.0, L))
    xie = _kinematics_fields(sarad, omgs, ne, Te, lam, Va, ud)[-1]
    lf = (-0.5 * xie**2 - 0.92).contiguous()  # a Maxwellian's log f_e at the phase velocities
    chi = (1.0 / (1.0 + xie**2) - 0.5).contiguous()  # smooth and O(1), like chi_R
    g = t(rng.standard_normal((B, L)))
    return g, (lf, chi, ne, Te, lam, Va, ud, A, Z, Ti, fract, t(np.resize([0.5, 0.3, 0.2], n_angles)), sarad, omgs)


# wavelength counts at the tail kernels' block edges (K6 owns 127 wavelengths a block, its thread 0 being
# the left halo; K5 owns 128 and stages one right of them): one wavelength, fewer than a block, and one
# past a multiple of K6's owned width (one short of two of K5's blocks); cut from the main path's operands
# (2 lineouts) around TAIL_BWD_RAGGED_NM, inside the deck's EPW fit window
TAIL_BWD_RAGGED_L = (1, 50, 2 * 127 + 1)
TAIL_BWD_RAGGED_NM = 480.0
# (angles, wavelengths) of a K5 and K6 case whose angles the kernels stage in several chunks of at most
# 12, the last one narrower, over three blocks of wavelengths; drawn from its own generator
TAIL_BWD_MANY_ANGLES = (70, 300)


def check_tail_bwd(diag, params, rng):
    """K6 on the forward's own lookup outputs and a seeded cotangent g [128, 5120] that
    is zero inside the iawfilter band, as the loss's fit windows make it; on a small
    case with two gradient points and two species, and on that case at TAIL_BWD_MANY_ANGLES;
    and on 2 lineouts of the main operands cut to TAIL_BWD_RAGGED_L wavelengths (the block
    edges).  Same limits for all."""
    import torch

    from tsadar_tpu_torch.core.physics.constants import C
    from tsadar_tpu_torch.ops import spectrum_tail

    ff = diag.model.electron_form_factor
    inputs = ff._lookups_1v(params())
    args = (*inputs, diag.model.weight, ff.sarad, ff.omgs)
    B, G, L, NA = inputs[0].shape
    S = inputs[7].shape[-1]
    blue, red, _ = diag.model._filter_band()
    lam = 2.0 * math.pi * C / ff.omgs.double() * 1e7
    noise = torch.tensor(rng.standard_normal((B, L)), dtype=torch.float32, device=ff.omgs.device)
    noise = torch.where((lam > blue) & (lam < red), 0.0, noise)
    report = {}
    ok, worst = tail_bwd_misses("main", noise, args, report)  # max_abs_err is the main path's
    ok = tail_bwd_misses("two_species", *two_species_tail_case(rng, ff.omgs.device), report)[0] and ok
    n_angles, n_wavelengths = TAIL_BWD_MANY_ANGLES
    many = two_species_tail_case(np.random.default_rng(SEED + 1), ff.omgs.device, n_angles, n_wavelengths)
    ok = tail_bwd_misses(f"A{n_angles}", *many, report)[0] and ok
    for label, rows, g_cut in ragged_tail_cuts(args, noise):
        ok = tail_bwd_misses(label, g_cut, rows, report)[0] and ok
    emit({"phase": "kernel_check", "kernel": "spectrum_tail_bwd", "max_abs_err": worst, "per_output": report, "ok": ok})
    if not ok:
        bad = {n: r for n, r in report.items() if not r["ok"]}
        raise RuntimeError(f"spectrum_tail_bwd: cotangents miss the float64 twin: {bad}")
    g = noise
    kern = lambda: spectrum_tail.spectrum_tail_bwd(g, *args)  # noqa: E731
    plain = lambda: spectrum_tail.plain_bwd(g, *args)  # noqa: E731
    # the forward's operations recomputed (as counted for K5) plus about as many again for the chain rule
    nops = 2 * B * G * L * NA * (100 + 130 * S)
    nbytes = 16 * B * G * L * NA + 4 * B * L + 4 * (4 * B * G + 6 * B + 7 * B * S + 2 * NA + L)
    b_ms, b_by = bound_ms(nbytes, nops)
    return dict(
        max_abs_err=worst, ms=device_times_ms(kern), plain_ms=device_times_ms(plain, reps=5, warmup=1), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
    )


def check_tail_real(diag, params, rng):
    """K5 and K6 on the real-data forward's own operands (its lookups at the deck's start values, the
    128 lineouts of shot 101675), each against its float64 twin at the main case's limits: K5 split at
    the deck's iawfilter band (``tail_fwd_misses``), K6 per output on a seeded cotangent that is zero
    inside that band; both kernels timed there.  Returns {kernel: {"real_data_ms": ms, ...}}."""
    import torch

    from tsadar_tpu_torch.core.physics.constants import C
    from tsadar_tpu_torch.ops import spectrum_tail

    ff = diag.model.electron_form_factor
    inputs = ff._lookups_1v(params())
    args = (*inputs, diag.model.weight, ff.sarad, ff.omgs)
    B, G, L, NA = inputs[0].shape
    blue, red, _ = diag.model._filter_band()
    lam = 2.0 * math.pi * C / ff.omgs.double() * 1e7
    noise = torch.tensor(rng.standard_normal((B, L)), dtype=torch.float32, device=ff.omgs.device)
    noise = torch.where((lam > blue) & (lam < red), 0.0, noise)
    fwd_report = {}
    fwd_ok, fwd_err = tail_fwd_misses("real_data", args, (blue, red), fwd_report)
    emit({"phase": "kernel_check", "kernel": "spectrum_tail_fwd", "shapes": "real_data", "max_abs_err": fwd_err,
          "iaw_band_nm": [blue, red], "cases": fwd_report, "ok": fwd_ok})
    if not fwd_ok:
        raise RuntimeError(f"spectrum_tail_fwd on the real-data operands: kernel misses its float64 twin: {fwd_report}")
    report = {}
    ok, worst = tail_bwd_misses("real_data", noise, args, report)
    emit({"phase": "kernel_check", "kernel": "spectrum_tail_bwd", "shapes": "real_data", "operands": [B, G, L, NA],
          "max_abs_err": worst, "per_output": report, "ok": ok})
    if not ok:
        bad = {n: r for n, r in report.items() if not r["ok"]}
        raise RuntimeError(f"spectrum_tail_bwd on the real-data operands: cotangents miss the float64 twin: {bad}")
    return {"spectrum_tail_fwd": {"real_data_ms": device_times_ms(lambda: spectrum_tail.spectrum_tail_fwd(*args)),
                                  "real_data_max_abs_err": fwd_err},
            "spectrum_tail_bwd": {"real_data_ms": device_times_ms(lambda: spectrum_tail.spectrum_tail_bwd(noise, *args))}}


def profile_run(run, units, unit_ms, phase, unit, top=10):
    """Device time per unit of work (a forward, a fit step) from torch.profiler
    over ``run()``, which does ``units`` of them: the sum over device kernels,
    the device's busy share of the measured wall time ``unit_ms``, the top
    kernels, every kernel of the port, and the top PyTorch ops by the device
    time of the kernels they launched (the port's own kernels have no op)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def ranked(on_device):
        # ranges that PyTorch annotates on the device (the optimizer's step) span kernels counted on their own
        rows = [(e.key, e.self_device_time_total / units / 1e3, e.count / units) for e in prof.key_averages()
                if (e.device_type == DeviceType.CUDA) == on_device and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]
        return sorted(rows, key=lambda r: -r[1])

    kernels, ops = ranked(True), ranked(False)
    port = [r for r in kernels if any(k in r[0] for k in PORT_KERNEL_NAMES)]
    device_ms = sum(r[1] for r in kernels)
    # uploads belong to a run's set-up (a fit's data, a model's tables), not to its steady state
    upload_ms = sum(r[1] for r in kernels if r[0].startswith("Memcpy HtoD"))
    as_json = lambda rows: [{"name": k[:100], "ms": t, "calls": c} for k, t, c in rows[:top]]  # noqa: E731
    return {"phase": phase, f"device_ms_per_{unit}": device_ms, f"{unit}_ms": unit_ms,
            "device_busy_share": device_ms / unit_ms, f"kernel_launches_per_{unit}": sum(r[2] for r in kernels),
            f"host_to_device_copy_ms_per_{unit}": upload_ms,
            "top_kernels": as_json(kernels), "port_kernels": as_json(port), "top_ops": as_json(ops)}


def fit_config(cfg, n, steps):
    cfg = copy.deepcopy(cfg)
    cfg["optimizer"].update(method="adam", learning_rate=FIT_LR, num_epochs=steps, batch_size=n)
    return cfg


def fit_data(diag, cfg, draws, n):
    """The fit's batch: the port's own forward at the seeded truth (amps 1, noise 0)."""
    import torch

    with torch.no_grad():
        truth = make_params(cfg, draws, n, diag.device, diag.dtype)
        e_data = diag(truth, make_batch(n))[0]
    return make_batch(n) | {"e_data": e_data, "i_data": torch.zeros((n, 1), dtype=diag.dtype, device=diag.device)}


def grad_check(cfg, sas, draws, diag_cpu):
    """Loss and gradient of N_CHECK lineouts at the deck's start values, on the
    same data: the card (float32, kernels) against the CPU plain forms in float64."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams

    cfg = fit_config(cfg, N_CHECK, 1)
    data = {k: np.asarray(v) for k, v in fit_data(diag_cpu, cfg, draws, N_CHECK).items()}  # float64, for both
    results = {}
    for name, device, dtype in (("f64", "cpu", torch.float64), ("card", "cuda", torch.float32)):
        loss_fn = LossFunction(cfg, sas, data, device=device, dtype=dtype)
        params = ThomsonParams.create(cfg["parameters"], N_CHECK, activate=True, device=device, dtype=dtype)
        (value, _), grads = loss_fn.value_and_grad(params, data)
        results[name] = float(value), {k: g.double().cpu() for k, g in grads.items()}
    (loss_ref, g_ref), (loss, g_card) = results["f64"], results["card"]
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    report = {k: float((g_card[k] - g_ref[k]).abs().max() / g_ref[k].abs().max()) for k in g_ref}
    ok = loss_err <= LOSS_TOL and all(err <= GRAD_TOL for err in report.values())
    emit({"phase": "grad_check", "lineouts": N_CHECK, "loss": loss, "loss_f64_cpu": loss_ref, "loss_rel_err": loss_err,
          "loss_tol": LOSS_TOL, "grad_err_of_max_per_parameter": report, "grad_tol": GRAD_TOL, "ok": ok})
    if not ok:
        raise RuntimeError(f"loss or gradient on the card disagrees with the CPU float64 path: {loss_err:.3e}, {report}")


def run_fit(cfg, sas, draws, n, steps, diag):
    """Fit ``n`` lineouts from the deck's start values to the port's own spectra at
    the seeded truth, on ``diag``'s device: (the loop's record, best loss,
    relative errors of the recovered Te, ne, m and the absolute error of lam
    [nm] per lineout, (loss function, batch))."""
    from tsadar_tpu_torch import LossFunction
    from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_

    cfg = fit_config(cfg, n, steps)
    batch = fit_data(diag, cfg, draws, n)
    loss_fn = LossFunction(cfg, sas, batch, device=diag.device, dtype=diag.dtype)
    record = {}
    best_loss, best = _1d_adam_loop_(cfg, loss_fn, None, batch, record=record)
    fitted = best.get_unnormed_params()["electron"]
    errors = {k: np.abs(fitted[k].detach().cpu().numpy() / draws[k][:n] - 1.0) for k in FIT_TOL}
    errors["lam_nm"] = np.abs(best.get_unnormed_params()["general"]["lam"].detach().cpu().numpy() - draws["lam"][:n])
    return record, best_loss, errors, (loss_fn, batch)


ARTS_2V_DECK = ("arts2v_test_defaults.yaml", "arts2d_test_inputs.yaml")
ARTS_1V_DECK = ("arts1v_test_defaults.yaml", "arts1v_test_inputs.yaml")


def load_arts_deck(arbitrary=True, names=ARTS_2V_DECK):
    """(config, scattering angles) of a full-width ARTS workload: the test decks ``names`` merged,
    the geometry read as spectype "angular" (241 fine angles, the [1024, 241] weight matrix, the
    camera's angle axis), then run as "angular_full"; ``arbitrary`` swaps the 2V deck's
    spherical-harmonic EDF for the pointwise 128 x 128 one that the angular fit trains.  The
    1024 x 1024 CCD is not reduced, so a resolution unit is one pixel."""
    from tsadar_tpu_torch import get_calibrations, get_scattering_angles
    from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges

    cfg = set_forward_ranges(merge_configs(*[yaml.safe_load((ROOT / "tests" / "configs" / n).read_text()) for n in names]))
    fe = cfg["parameters"]["electron"]["fe"]
    if arbitrary:
        fe.update(type="arbitrary", dim=2, nvx=128)
        # the EDF starts from the deck's own super-Gaussian order, init_m 2.2, as in the JAX ARTS bench
        fe.setdefault("params", {}).setdefault("learn_log", True)
    sas = get_scattering_angles(cfg)
    sas["angAxis"] = get_calibrations(104000, cfg["other"]["extraoptions"]["spectype"], 0.0, cfg["other"]["CCDsize"])[0]
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    cfg["other"].update(ang_res_unit=1, lam_res_unit=1)
    return cfg, sas


def arts_batch(cfg):
    shape = tuple(cfg["other"]["CCDsize"])
    return {"e_data": np.ones(shape), "i_data": np.ones(shape), "e_amps": np.array([1.0]), "i_amps": np.array([1.0]),
            "noise_e": np.array([0.0]), "noise_i": np.array([0.0])}


def arts_models(cfg, sas, device, dtype=None):
    """(diagnostic, unbatched parameters) of the ARTS deck.  The port projects by the exact NUDFT on
    the card and by the fft2 slice on the CPU, as the JAX package does by backend; the CPU reference
    here is given the card's projection, so that the two devices compute the same function."""
    from tsadar_tpu_torch import ThomsonParams, ThomsonScatteringDiagnostic

    diag = ThomsonScatteringDiagnostic(cfg, sas, device=device, dtype=dtype)
    if diag.device.type == "cpu" and diag.model.dim == 2:
        ff = diag.model.electron_form_factor
        ff._project_all_fourier = lambda vx, DF, betas: ff._project_all_nudft(vx, DF)
    return diag, ThomsonParams.create(cfg["parameters"], 1, activate=True, device=device, dtype=dtype, batch=False)


def smooth_tables(rng, R, nvx):
    """A seeded stacked table [R, 3 nvx - 2] as smooth as the path's own: a few angular harmonics
    times Gaussians in velocity per segment, entries of order 1."""
    theta = 2.0 * np.pi * np.arange(R) / R
    segs = []
    for ns in (nvx, nvx, nvx - 2):
        v = np.linspace(-6.0, 6.0, ns)
        seg = np.zeros((R, ns))
        for k in range(4):
            seg += rng.uniform(0.3, 1.0) * np.cos(k * theta + rng.uniform(0, 2 * np.pi))[:, None] * np.exp(
                -((v - rng.uniform(-2.0, 2.0)) ** 2) / (2.0 * rng.uniform(0.7, 2.0) ** 2))[None, :]
        segs.append(seg)
    return np.concatenate(segs, axis=1)


def chi_edge_queries(v0x, dvx, v0p, dvp, nvx):
    """Every edge angle with every edge position: negative beta, beta next to a whole turn, 0, +-pi;
    x below the grid, on its first and last node, above it, on inner nodes of both grids."""
    betas = [-1e-8, 2 * math.pi - 1e-7, 0.0, math.pi, -math.pi, 2 * math.pi, -3.0, 3.0]
    xs = [v0x - 1.0, v0x, v0x + dvx * (nvx - 1), v0x + dvx * (nvx - 1) + 1.0, v0x + 3 * dvx, v0p, v0p + dvp * (nvx - 3),
          v0p + dvp * 5, 0.0, 0.123]
    b, x = np.meshgrid(betas, xs, indexing="ij")
    return b.ravel(), x.ravel()


def chi_case(label, bq, xq, T, meta, g):
    """K7 and K8 on one set of queries against their twins in float32 and in float64 on the card:
    (report, all ok, max |value error|, max |dT error| against float64)."""
    import torch

    from tsadar_tpu_torch.core.physics.interp import col_cell, rowmix_indices
    from tsadar_tpu_torch.ops import chi_bilinear as cb

    R, C = T.shape
    nvx = (C + 2) // 3
    d = lambda *ts: tuple(t.double() for t in ts)  # noqa: E731
    out, out32, out64 = cb.chi_bilinear_fwd(bq, xq, T, meta), cb.plain_fwd(bq, xq, T, meta), cb.plain_fwd(*d(bq, xq, T, meta))
    rows_same = rowmix_indices(R, bq)[0] == rowmix_indices(R, bq.double())[0]
    report, ok, worst_val = {"queries": int(bq.numel())}, bool(torch.isfinite(out).all()), 0.0
    same_all = rows_same.clone()
    for s, ((c0, ns, v0, dv), (_, _, v0d, dvd)) in enumerate(zip(cb.segments(nvx, meta), cb.segments(nvx, meta.double()))):
        seg_max = float(T[:, c0 : c0 + ns].abs().max())
        i32, _, in32 = col_cell(xq, v0, dv, ns)
        i64, _, in64 = col_cell(xq.double(), v0d, dvd, ns)
        same = rows_same & (i32 == i64) & (in32.double() == in64)
        same_all &= same
        entry = {
            "segment_max": seg_max,
            "value_vs_f32": float((out[s] - out32[s]).abs().max()) / seg_max,
            "value_vs_f64": float((out[s].double() - out64[s]).abs().max()) / seg_max,
            "der_vs_f32": float((out[3 + s] - out32[3 + s]).abs().max()) / (seg_max / float(dv)),
            "der_vs_f64_same_cell": float(((out[3 + s].double() - out64[3 + s]).abs() * same).max()) / (seg_max / float(dv)),
            "queries_in_another_cell_in_f64": int((~same).sum()),
        }
        entry["ok"] = all(entry[k] <= CHI_TOL for k in ("value_vs_f32", "value_vs_f64", "der_vs_f32", "der_vs_f64_same_cell"))
        ok = ok and entry["ok"]
        worst_val = max(worst_val, float((out[s].double() - out64[s]).abs().max()))
        report[f"segment{s}"] = entry

    (dT, db), (dT32, db32) = cb.chi_bilinear_bwd(bq, xq, T, meta, g), cb.plain_bwd(bq, xq, T, meta, g)
    dT64, db64 = cb.plain_bwd(*d(bq, xq, T, meta, g))
    dT_max, db_max = float(dT64.abs().max()), float(db64.abs().max())
    bwd = {
        "dT_max": dT_max, "dbeta_max": db_max,
        "dT_vs_f32": float((dT - dT32).abs().max()) / dT_max,
        "dT_vs_f64": float((dT.double() - dT64).abs().max()) / dT_max,
        "dbeta_vs_f32": float((db - db32).abs().max()) / db_max,
        "dbeta_vs_f64_same_cell": float(((db.double() - db64).abs() * same_all).max()) / db_max,
    }
    bwd["ok"] = bool(torch.isfinite(dT).all() and torch.isfinite(db).all()) and all(
        bwd[k] <= CHI_BWD_TOL for k in ("dT_vs_f32", "dT_vs_f64", "dbeta_vs_f32", "dbeta_vs_f64_same_cell"))
    report["bwd"] = bwd
    return {label: report}, ok and bwd["ok"], worst_val, float((dT.double() - dT64).abs().max())


def chi_deposits(bq, xq, g, T, meta):
    """Every deposit of K8 as one index [12 Q] into the flattened dT and one value tensor [12 Q] (the twin's
    products), and the most deposits any entry of dT takes."""
    import torch

    from tsadar_tpu_torch.core.physics.interp import col_cell, rowmix_indices
    from tsadar_tpu_torch.ops import chi_bilinear as cb

    R, C = T.shape
    ib0, ib1, wb = rowmix_indices(R, bq)
    idx, vals = [], []
    for gs, (c0, ns, v0, dv) in zip(g, cb.segments((C + 2) // 3, meta)):
        iv0, wv, _ = col_cell(xq, v0, dv, ns)
        for row, wr in ((ib0, 1.0 - wb), (ib1, wb)):
            idx += [row * C + c0 + iv0, row * C + c0 + iv0 + 1]
            vals += [wr * (gs * (1.0 - wv)), wr * (gs * wv)]
    idx, vals = torch.cat(idx), torch.cat(vals)
    counts = torch.zeros(R * C, dtype=torch.float32, device=bq.device).scatter_add_(0, idx, torch.ones_like(vals))
    return idx, vals, int(counts.max())


def check_chi_bilinear(rng, diag, params):
    """K7 and K8 at the ARTS deck's shapes (Q = 246 784 queries, R = 256 rows, nvx = 128): on seeded
    queries that wrap in beta and run past both ends of the grids, with the edge set in front; and on
    the deck's own tables and queries (beta, |xi_e|).  Times on both sets of queries."""
    import torch
    import torch.nn.functional as F

    from tsadar_tpu_torch.ops import chi_bilinear as cb

    dev = diag.device
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    ff = diag.model.electron_form_factor
    physical = params()
    vx, fe = physical["electron"]["v"], physical["electron"]["fe"]
    fields = ff._fields_2v(physical)
    bq_deck, xq_deck = fields["beta"].reshape(-1).contiguous(), fields["xie_mag"].reshape(-1).contiguous()
    _, f1d, df1d, pole_grid, chiR = ff._chi_tables(vx, fe)
    T_deck = torch.cat([f1d, df1d, chiR], dim=-1).contiguous()
    meta = torch.stack([vx[0], vx[1] - vx[0], pole_grid[0], pole_grid[1] - pole_grid[0]])
    R, C = T_deck.shape
    Q, nvx = bq_deck.numel(), vx.numel()
    if (Q, R, C) != (diag.cfg["other"]["npts"] * ff.sarad.numel(), ff.num_beta, 3 * nvx - 2):
        raise RuntimeError(f"the ARTS deck gives Q, R, C, nvx = {Q}, {R}, {C}, {nvx}")

    v0x, dvx, v0p, dvp = (float(m) for m in meta)
    bq, xq = rng.uniform(-7.0, 13.0, Q), rng.uniform(v0x - 1.5, -v0x + 1.5, Q)
    eb, ex = chi_edge_queries(v0x, dvx, v0p, dvp, nvx)
    bq[: eb.size], xq[: ex.size] = eb, ex
    bq, xq, T = t(bq), t(xq), t(smooth_tables(rng, R, nvx))
    g, g_deck = t(rng.standard_normal((3, Q))), t(rng.standard_normal((3, Q)))

    report, ok, worst_val, worst_dT = chi_case("seeded", bq, xq, T, meta, g)
    edge = chi_case("edge_set", bq[: eb.size].contiguous(), xq[: ex.size].contiguous(), T, meta, g[:, : eb.size].contiguous())
    deck = chi_case("deck_queries", bq_deck, xq_deck, T_deck, meta, g_deck)
    report |= edge[0] | deck[0]
    ok = ok and edge[1] and deck[1]
    emit({"phase": "kernel_check", "kernel": "chi_bilinear_fwd+bwd", "Q": Q, "R": R, "nvx": nvx, "tol": CHI_TOL,
          "bwd_tol": CHI_BWD_TOL, "cases": report, "ok": ok})
    if not ok:
        raise RuntimeError(f"chi_bilinear: a kernel disagrees with its plain twins: {report}")

    rows = {}
    fwd = lambda b, x, tab: (lambda: cb.chi_bilinear_fwd(b, x, tab, meta))  # noqa: E731
    # yardstick: grid_sample's bilinear interpolation of ONE segment's values (rows made periodic by a copy of row 0)
    img = torch.cat([T[:, :nvx], T[:1, :nvx]])[None, None]
    grid = torch.stack([(xq - v0x) / (dvx * (nvx - 1)) * 2.0 - 1.0, torch.remainder(bq, 2 * math.pi) / math.pi - 1.0], dim=-1)[None, None]
    lib = lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True)  # noqa: E731
    b_ms, b_by = bound_ms(4 * (8 * Q + R * C + 4), 60 * Q)
    rows["chi_bilinear_fwd"] = dict(
        max_abs_err=worst_val, ms=device_times_ms(fwd(bq, xq, T)), ms_deck_queries=device_times_ms(fwd(bq_deck, xq_deck, T_deck)),
        plain_ms=device_times_ms(lambda: cb.plain_fwd(bq, xq, T, meta)), bound_ms=b_ms, bound_by=b_by,
        library_ms=device_times_ms(lib), library_computes="grid_sample: one segment's values, 1 of K7's 6 outputs",
    )
    bwd = lambda b, x, tab, gg: (lambda: cb.chi_bilinear_bwd(b, x, tab, meta, gg))  # noqa: E731
    # yardstick: one scatter_add_ of all twelve deposits of every query (indices and values built untimed)
    scatter = {}
    for label, (b, x, gg, tab) in (("seeded", (bq, xq, g, T)), ("deck_queries", (bq_deck, xq_deck, g_deck, T_deck))):
        idx, vals, most = chi_deposits(b, x, gg, tab, meta)
        lib = lambda idx=idx, vals=vals: torch.zeros(R * C, dtype=torch.float32, device=dev).scatter_add_(0, idx, vals)  # noqa: E731
        dT_lib, dT_twin = lib().view(R, C), cb.plain_bwd(b, x, tab, meta, gg)[0]
        scatter[label] = {"library_ms": device_times_ms(lib), "max_deposits": most,
                          "library_vs_f32_twin_of_max": float((dT_lib - dT_twin).abs().max() / dT_twin.abs().max())}
    emit({"phase": "chi_bilinear_bwd_deposits", "cases": scatter})
    b_ms, b_by = bound_ms(4 * (6 * Q + 2 * R * C + 4), 80 * Q)
    rows["chi_bilinear_bwd"] = dict(
        max_abs_err=worst_dT, ms=device_times_ms(bwd(bq, xq, T, g)),
        ms_deck_queries=device_times_ms(bwd(bq_deck, xq_deck, T_deck, g_deck)),
        plain_ms=device_times_ms(lambda: cb.plain_bwd(bq, xq, T, meta, g)), bound_ms=b_ms, bound_by=b_by,
        library_ms=scatter["seeded"]["library_ms"], library_ms_deck_queries=scatter["deck_queries"]["library_ms"],
        max_deposits=scatter["seeded"]["max_deposits"], max_deposits_deck_queries=scatter["deck_queries"]["max_deposits"],
    )
    return rows


def arts_forward(cfg, sas, diag, params, wrappers, smi):
    """The ARTS forward on the card through the diagnostic: K7 exactly once, a finite positive image,
    above -ARTS_NEGATIVE_TOL of its peak, within FWD_TOL of peak of the CPU float64 plain path; wall time and a profile.  Returns the
    launches and the float64 image."""
    import torch

    batch = arts_batch(cfg)
    with torch.no_grad():
        read_and_zero(wrappers)
        ThryE = diag(params, batch)[0]
        torch.cuda.synchronize()
        launches = read_and_zero(wrappers)
        lineouts = cfg["data"]["lineouts"]
        shape_ok = tuple(ThryE.shape) == (lineouts["end"] - lineouts["start"], cfg["other"]["npts"])
        # positive but for the far tail: the exact NUDFT projection of the truncated EDF rings there at
        # ~1e-5 of peak, in float64 as in float32 (the CPU's fft2 projection does not)
        sane = shape_ok and bool(torch.isfinite(ThryE).all()) and float(ThryE.min()) > -ARTS_NEGATIVE_TOL * float(ThryE.max())
        diag_cpu, params_cpu = arts_models(cfg, sas, "cpu")
        t0 = time.perf_counter()
        ref = diag_cpu(params_cpu, batch)[0]
        cpu_s = time.perf_counter() - t0
        miss = (ThryE.double().cpu() - ref).abs()
        err = float(miss.max() / ref.abs().max())
        worst = np.unravel_index(int(miss.argmax()), miss.shape)
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            diag(params, batch)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        ok = launches == {k: int(k == "chi_bilinear_fwd") for k in wrappers} and sane and err <= FWD_TOL
        emit({"phase": "arts_forward", "image": list(ThryE.shape), "queries": cfg["other"]["npts"] * len(sas["sa"]),
              "launches": launches, "finite_and_positive_to_tol": sane,
              "min": float(ThryE.min()), "max": float(ThryE.max()), "min_f64_cpu": float(ref.min()), "negative_tol": ARTS_NEGATIVE_TOL, "max_err_of_peak": err, "worst_at_row_col": [int(i) for i in worst],
              "tol": FWD_TOL, "ms": ms, "times_ms": times, "cpu_f64_forward_s": cpu_s, "gpu": smi, "ok": ok})
        if not ok:
            raise RuntimeError(f"ARTS forward: launches {launches}, sane {sane}, {err:.3e} of peak against {FWD_TOL}")
        emit(profile_run(lambda: [diag(params, batch) for _ in range(3)], 3, ms, "arts_profile", "forward"))
    return launches, ref


def arts_grad_check(cfg, sas, target, wrappers):
    """The JAX ARTS bench's loss mean((T - 0.9 target)^2) and its gradient with respect to the
    128 x 128 ``fval``: the card (float32, K7 and K8 once each) against the CPU float64 plain path."""
    import torch

    from tsadar_tpu_torch.core.params import get_filter_spec

    batch, results = arts_batch(cfg), {}
    for name, device in (("f64", "cpu"), ("card", "cuda")):
        diag, params = arts_models(cfg, sas, device)
        (fval,) = get_filter_spec(cfg["parameters"], params).values()
        read_and_zero(wrappers)
        loss = torch.mean((diag(params, batch)[0] - 0.9 * target.to(diag.device, diag.dtype)) ** 2)
        (grad,) = torch.autograd.grad(loss, [fval])
        results[name] = float(loss.detach()), grad.double().cpu(), read_and_zero(wrappers)
    (loss_ref, g_ref, _), (loss, g, launches) = results["f64"], results["card"]
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    grad_err = float((g - g_ref).abs().max() / g_ref.abs().max())
    ok = (loss_err <= LOSS_TOL and grad_err <= GRAD_TOL and bool(torch.isfinite(g).all())
          and launches == {k: int(k in ARTS_KERNELS) for k in wrappers})
    emit({"phase": "arts_grad_check", "loss": loss, "loss_f64_cpu": loss_ref, "loss_rel_err": loss_err, "loss_tol": LOSS_TOL,
          "grad_shape": list(g.shape), "grad_max": float(g_ref.abs().max()), "grad_err_of_max": grad_err, "grad_tol": GRAD_TOL,
          "launches": launches, "ok": ok})
    if not ok:
        raise RuntimeError(f"ARTS loss or gradient on the card disagrees with the CPU float64 path: {loss_err:.3e}, {grad_err:.3e}, {launches}")


def arts_fit_data(cfg, target):
    """``angular_optax``'s data: the whole CCD in resolution units, its lineout window holding 0.9 x target."""
    n_ang, n_lam = cfg["other"]["CCDsize"]
    lineouts = cfg["data"]["lineouts"]
    e_data = np.zeros((n_ang, n_lam))
    e_data[lineouts["start"] : lineouts["end"]] = 0.9 * target.numpy()
    return {"e_data": e_data, "e_amps": np.ones((n_ang, 1)), "i_data": np.zeros(n_ang), "i_amps": np.zeros(n_ang),
            "noiseE": np.zeros((n_ang, n_lam)), "noiseI": np.zeros((n_ang, n_lam))}


def arts_fit(cfg, sas, target, wrappers, smi):
    """The angular fit on the card: ``angular_optax`` with adam against 0.9 x target, K7 and K8 once
    per step, every loss finite, the last under ARTS_FIT_DROP of the first; then a profile of a few steps."""
    import torch

    from tsadar_tpu_torch import ThomsonParams, angular_optax
    from tsadar_tpu_torch.inverse.loops import _angular_batch, _angular_loop_

    def fit_config(steps):
        fit_cfg = copy.deepcopy(cfg)
        fit_cfg["optimizer"].update(method="adam", learning_rate=ARTS_FIT_LR, num_epochs=steps, chunk_size=8)
        return fit_cfg

    all_data = arts_fit_data(cfg, target)
    record = {}
    read_and_zero(wrappers)
    best, last_loss, loss_fn = angular_optax(fit_config(ARTS_FIT_STEPS), all_data, sas, record=record)
    torch.cuda.synchronize()
    launches = read_and_zero(wrappers)
    losses, steps_run = record["losses"], sum(record["chunk_steps"])
    ms_per_step = 1e3 * sum(record["chunk_seconds"]) / steps_run
    fval = best.electron.distribution_functions.fval
    ok = (launches == {k: steps_run * int(k in ARTS_KERNELS) for k in wrappers} and bool(np.isfinite(losses).all())
          and bool(torch.isfinite(fval).all()) and losses[-1] < ARTS_FIT_DROP * losses[0])
    emit({"phase": "arts_fit", "steps_asked": ARTS_FIT_STEPS, "steps_run": steps_run, "epochs_counted": len(losses),
          "stopped_early": len(losses) < ARTS_FIT_STEPS, "lr": ARTS_FIT_LR, "launches": launches, "first_loss": losses[0],
          "last_loss": losses[-1], "best_loss": min(losses), "drop_tol": ARTS_FIT_DROP, "losses_finite": bool(np.isfinite(losses).all()),
          "ms_per_step": ms_per_step, "steps_per_s": 1e3 / ms_per_step, "fit_seconds": sum(record["chunk_seconds"]),
          "chunk_ms_per_step": [1e3 * s / n for s, n in zip(record["chunk_seconds"], record["chunk_steps"])],
          "losses_every_8th": losses[::8], "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"ARTS fit: launches {launches} over {steps_run} steps, losses {losses[0]:.3e} -> {losses[-1]:.3e}")
    # a few steps of the loop alone under the profiler, from the deck's start values again: the
    # loss function, its tables and the data are on the card already, as in the 1V fit's profile
    few, lineouts = 4, cfg["data"]["lineouts"]
    few_cfg = fit_config(few)
    batch = loss_fn.device_batch(_angular_batch(all_data, slice(lineouts["start"], lineouts["end"])))
    start = ThomsonParams.create(few_cfg["parameters"], 1, activate=True, device=loss_fn.ts_diag.device, dtype=loss_fn.ts_diag.dtype, batch=False)
    emit(profile_run(lambda: _angular_loop_(few_cfg, loss_fn, start, batch), few, ms_per_step, "arts_fit_profile", "step"))
    return launches, steps_run


def check_lookups_arts_1v(cfg, sas, rng):
    """K1, K3 and K9 at the ARTS 1V deck's shapes -- one row, 2048 x 241 queries, the 2043-entry pole
    table, the 256-point log-EDF and the PV integrand [1, 1024] as the forward builds them -- on the
    deck's own operands (K9's transposed mode on a seeded cotangent).  K9 is held to its float32 and
    float64 twins at PV_TOL of max |table|, one row being a partial block of its 32.  K1 and K3 are
    held to their twins in float32 (every query) and in float64 on the same float32 operands, at
    LOOKUP_TOL of max |table|.  K1's second output jumps from cell to cell: against float64 it is compared where
    both precisions put the query into the same cell, and the others are counted.  K3 extrapolates
    its edge polynomial with an unclamped t, which far from the grid (this deck's |xi_e| reaches 15
    on a grid of +-8) is rounding noise in any float32 form, and the forward overwrites every query
    beyond the grid: K3 is compared up to 1.5 cells beyond either end, as at the whole-shot shapes."""
    import torch

    from tsadar_tpu_torch.core.physics.form_factor import _batch_of_one
    from tsadar_tpu_torch.core.physics.interp import lin_cell
    from tsadar_tpu_torch.ops import cubic_lookup, lin_lookup

    diag, params = arts_models(cfg, sas, None)
    ff = diag.model.electron_form_factor
    physical = _batch_of_one(params())
    xie, log_fe, meta, table, _ = ff._lookup_inputs_1v(physical)
    q = xie.reshape(1, -1).contiguous()
    x0, dx, n = ff.pv_x0, ff.pv_dx, table.shape[1]
    ratdf = ff._pv_integrand(log_fe, physical["electron"]["v"])
    if (q.shape[1], n, log_fe.shape[1], tuple(ratdf.shape)) != (cfg["other"]["npts"] * len(sas["sa"]), 2043, 256, (1, 1024)):
        raise RuntimeError(f"the ARTS 1V deck gives Q, pole table, EDF, PV integrand = {q.shape[1]}, {n}, {log_fe.shape[1]}, {tuple(ratdf.shape)}")

    g = torch.tensor(rng.standard_normal((1, n)), dtype=torch.float32, device=ratdf.device)
    report, ok, _ = pv_case("arts_1v_ratdf", ratdf, g, ff._pv_coef)
    emit({"phase": "kernel_check", "kernel": "pv_tables_fwd+bwd", "shapes": "arts_1v", "B": 1, "N": ratdf.shape[1],
          "tol": PV_TOL, "cases": report, "ok": ok})
    if not ok:
        raise RuntimeError(f"pv_tables at the ARTS 1V shapes disagrees with its plain twins: {report}")

    got, f32, f64 = lin_lookup.lin_lookup_fwd(q, table, x0, dx), lin_lookup.plain(q, table, x0, dx), lin_lookup.plain(q.double(), table.double(), x0, dx)
    same = lin_cell(q, x0, dx, n)[1] == lin_cell(q.double(), x0, dx, n)[1]
    scale = float(table.abs().max())
    errs = {"value_vs_f32": float((got[0] - f32[0]).abs().max()), "value_vs_f64": float((got[0].double() - f64[0]).abs().max()),
            "slope_vs_f32": float((got[1] - f32[1]).abs().max()), "slope_vs_f64_same_cell": float(((got[1].double() - f64[1]).abs() * same).max())}
    ok = all(e <= LOOKUP_TOL * scale for e in errs.values())
    emit({"phase": "kernel_check", "kernel": "lin_lookup_fwd", "shapes": "arts_1v", "queries": list(q.shape), "table": list(table.shape),
          **errs, "queries_in_another_cell_in_f64": int((~same).sum()), "scale": scale, "tol": LOOKUP_TOL * scale, "ok": ok})
    if not ok:
        raise RuntimeError(f"lin_lookup_fwd at the ARTS 1V shapes disagrees with its plain twins: {errs} against {LOOKUP_TOL * scale:.3e}")

    v0, dv = float(meta[0, 0]), float(meta[0, 1])
    near = (q >= v0 - 1.5 * dv) & (q <= v0 + (log_fe.shape[1] + 0.5) * dv)
    got, f32 = cubic_lookup.cubic_lookup_fwd(q, log_fe, meta), cubic_lookup.plain(q, log_fe, meta)
    f64 = cubic_lookup.plain(q.double(), log_fe.double(), meta.double())
    scale = float(log_fe.abs().max())
    errs = {f"{name}_vs_{ref_name}": float(((g.double() - r).abs() * near).max())
            for name, g, refs in zip(("value", "dvalue_dt"), got, zip(f32, f64)) for ref_name, r in zip(("f32", "f64"), refs)}
    ok = all(e <= LOOKUP_TOL * scale for e in errs.values())
    emit({"phase": "kernel_check", "kernel": "cubic_lookup_fwd", "shapes": "arts_1v", "queries": list(q.shape), "table": list(log_fe.shape),
          **errs, "queries_compared": int(near.sum()), "queries_beyond_1.5_cells": int((~near).sum()),
          "scale": scale, "tol": LOOKUP_TOL * scale, "ok": ok})
    if not ok:
        raise RuntimeError(f"cubic_lookup_fwd at the ARTS 1V shapes disagrees with its plain twins: {errs} against {LOOKUP_TOL * scale:.3e}")


def arts_other_forward(phase, cfg, sas, kernels, wrappers, plain_f32_tol=None):
    """Another ARTS deck once, forward only, on the card against the CPU float64 plain path at
    FWD_TOL; exactly ``kernels`` must launch, once each.  ``plain_f32_tol``: the deck's resonance is
    so narrow that float32 itself misses FWD_TOL at the peak (the loss that
    ``tests/test_torch_float32.py`` shows for the whole-shot deck at such parameters); the card is
    then held to the plain forms run in float32 on the CPU, at that share of peak, and what both
    miss of the float64 image is reported."""
    import torch

    batch = arts_batch(cfg)
    with torch.no_grad():
        diag, params = arts_models(cfg, sas, None)
        read_and_zero(wrappers)
        ThryE = diag(params, batch)[0]
        torch.cuda.synchronize()
        launches = read_and_zero(wrappers)
        ref = (lambda d, p: d(p, batch)[0])(*arts_models(cfg, sas, "cpu"))
        miss = lambda x: float((x.double().cpu() - ref).abs().max() / ref.abs().max())  # noqa: E731
        err, tol, report = miss(ThryE), FWD_TOL, {}
        if plain_f32_tol is not None:
            plain32 = (lambda d, p: d(p, batch)[0])(*arts_models(cfg, sas, "cpu", torch.float32))
            over = (ThryE.double().cpu() - ref).abs() > FWD_TOL * ref.abs().max()
            report = {"compared_with": "the CPU float32 plain forward", "card_vs_f64_of_peak": err, "plain_f32_cpu_vs_f64_of_peak": miss(plain32),
                      "pixels_over_fwd_tol_of_f64": int(over.sum()), "pixels": over.numel()}
            err, tol = float((ThryE.cpu() - plain32).abs().max() / ref.abs().max()), plain_f32_tol
            if "pv_tables_fwd" in kernels:
                # the same card forward with K9's float32 twin (two cuBLAS products) in the kernel's
                # place, outside the launch count: the share of the miss that K9's rounding makes
                from tsadar_tpu_torch.ops import pv_tables

                kernel, pv_tables.pv_tables_fwd = pv_tables.pv_tables_fwd, pv_tables.plain
                try:
                    with_twin = diag(params, batch)[0]
                finally:
                    pv_tables.pv_tables_fwd = kernel
                report["card_with_pv_twin_vs_plain_f32_of_peak"] = float((with_twin.cpu() - plain32).abs().max() / ref.abs().max())
    fe =cfg["parameters"]["electron"]["fe"]
    ok = launches == {k: int(k in kernels) for k in wrappers} and bool(torch.isfinite(ThryE).all()) and err <= tol
    emit({"phase": phase, "fe": {k: v for k, v in fe.items() if k != "active"}, "npts": cfg["other"]["npts"],
          "image": list(ThryE.shape), "max_err_of_peak": err, "tol": tol, **report, "launches": launches, "ok": ok})
    if not ok:
        raise RuntimeError(f"{phase}: {err:.3e} of peak against {tol:.3e}, launches {launches}")


def load_real_deck(start, end, skip, batch_size):
    """The whole-shot deck as ``bench_whole_shot.py`` sets it up: lineouts start:end:skip of shot
    101675, one batch.  The deck asks for the raw-data visualizer, which the port does not have
    (matplotlib): it is switched off."""
    from tsadar_tpu_torch.inverse.fitter import _lineout_selection
    from tsadar_tpu_torch.utils.config import merge_configs

    decks = [yaml.safe_load((ROOT / "tests" / "configs" / f"time_test_{n}.yaml").read_text()) for n in ("defaults", "inputs")]
    cfg = merge_configs(*decks)
    cfg["data"]["launch_data_visualizer"] = False
    cfg["data"]["lineouts"].update(start=start, end=end, skip=skip)
    cfg["optimizer"]["batch_size"] = batch_size
    return _lineout_selection(cfg)


def real_batch(all_data, rows=slice(None)):
    """The loss's batch from ``prepare_data``'s output, as ``bench_whole_shot.py`` builds it."""
    return {"e_data": all_data["e_data"][rows], "e_amps": all_data["e_amps"][rows, None],
            "i_data": all_data["i_data"][rows], "i_amps": all_data["i_amps"][rows, None],
            "noise_e": all_data["noiseE"][rows], "noise_i": all_data["noiseI"][rows]}


def real_data_prepare():
    """The port's data pipeline on shot 101675 at the bench's 128 lineouts: (config, sa, all_data)."""
    from tsadar_tpu_torch.utils.process.prepare import prepare_data

    cfg = load_real_deck(*REAL_PIXELS, N_LINEOUTS)
    t0 = time.perf_counter()
    all_data, sa, axes = prepare_data(cfg, cfg["data"]["shotnum"])
    seconds = time.perf_counter() - t0
    shapes = {k: list(np.shape(v)) for k, v in all_data.items()}
    ok = (np.shape(all_data["e_data"]) == (N_LINEOUTS, 1024) and bool(np.isfinite(all_data["e_data"]).all())
          and bool((all_data["e_amps"] > 0).all()) and cfg["other"]["npts"] == 5120)
    emit({"phase": "real_data_prepare", "shot": cfg["data"]["shotnum"], "pixels": list(REAL_PIXELS),
          "lineouts": len(cfg["data"]["lineouts"]["val"]), "host_seconds": seconds, "shapes": shapes,
          "npts": cfg["other"]["npts"], "lamrangE": [float(v) for v in cfg["other"]["lamrangE"]],
          "widIRF": cfg["other"]["PhysParams"]["widIRF"], "e_amps_range": [float(all_data["e_amps"].min()), float(all_data["e_amps"].max())],
          "ok": ok})
    if not ok:
        raise RuntimeError(f"prepare_data on shot 101675: shapes {shapes}, npts {cfg['other']['npts']}")
    return cfg, sa, all_data


def real_operands(loss_fn, params):
    """The real-data forward's lookup operands: (PV integrand [B, 1024], chi_R table [B, 2043], its pole grid
    [2043], the queries xi_e [B, 51 200], the log-EDF grid meta [B, 3], the log-EDF's length nv)."""
    ff = loss_fn.ts_diag.model.electron_form_factor
    physical = params()
    xie, log_fe, meta, table, _ = ff._lookup_inputs_1v(physical)
    ratdf = ff._pv_integrand(log_fe, physical["electron"]["v"])
    return ratdf, table, ff.pv_poles, xie.reshape(xie.shape[0], -1).contiguous(), meta, log_fe.shape[1]


def pv_case(label, f, g, coef):
    """K9 in both modes on (f, g) against its twin in float32 and in float64 (float64 coefficients,
    the same f and g)."""
    import torch

    from tsadar_tpu_torch.core.physics import ratint
    from tsadar_tpu_torch.ops import pv_tables

    coef64 = ratint.pv_coefficients(coef.shape[1] // 4, torch.float64, coef.device)
    report, worst = {}, {}
    for mode, x, kern, twin in (("fwd", f, pv_tables.pv_tables_fwd, pv_tables.plain), ("bwd", g, pv_tables.pv_tables_bwd, pv_tables.plain_bwd)):
        got, f32, f64 = kern(x, coef), twin(x, coef), twin(x.double(), coef64)
        scale = float(f64.abs().max())
        entry = {"scale": scale, "vs_f32": float((got - f32).abs().max()) / scale,
                 "vs_f64": float((got.double() - f64).abs().max()) / scale, "f32_twin_vs_f64": float((f32.double() - f64).abs().max()) / scale}
        entry["ok"] = bool(torch.isfinite(got).all()) and entry["vs_f32"] <= PV_TOL and entry["vs_f64"] <= PV_TOL
        report[mode] = entry
        worst[mode] = float((got.double() - f64).abs().max())
    return {label: report}, all(r["ok"] for r in report.values()), worst


def check_pv_tables(rng, ratdf):
    """K9, both modes, at the main path's shapes (B = 128, N = 1024): seeded smooth integrands and
    cotangents, the same on their first PV_PARTIAL_B rows (the block of 32 lineouts partly empty: the
    kernels' row guards), seeded operands at PV_RAGGED (a pole count and a batch off the kernel's tile, two
    segments of the contraction for some blocks), and the real-data forward's own integrand
    ``ratdf``; times of the kernels, their twins and one torch.matmul with the concatenated dense matrices
    (the same function)."""
    import torch

    from tsadar_tpu_torch.core.physics import ratint
    from tsadar_tpu_torch.ops import pv_tables

    dev = ratdf.device
    B, n = ratdf.shape
    m = n - 2
    coef = ratint.pv_coefficients(m, torch.float32, dev)
    v = np.linspace(-8.2, 8.2, n)
    seeded = -v * np.exp(-(v[None, :] ** 2) / (2.0 * rng.uniform(0.5, 2.0, (B, 1)))) + 1e-3 * rng.standard_normal((B, n))
    f = torch.tensor(seeded, dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal((B, 2 * m - 1)), dtype=torch.float32, device=dev)
    report, ok, worst = pv_case("seeded", f, g, coef)
    rb, rn = PV_RAGGED
    vr = np.linspace(-8.2, 8.2, rn)
    fr = torch.tensor(-vr * np.exp(-(vr[None, :] ** 2) / 2.0) + 1e-3 * rng.standard_normal((rb, rn)), dtype=torch.float32, device=dev)
    gr = torch.tensor(rng.standard_normal((rb, 2 * rn - 5)), dtype=torch.float32, device=dev)
    ragged = pv_case(f"seeded_B{rb}_N{rn}", fr, gr, ratint.pv_coefficients(rn - 2, torch.float32, dev))
    for case in (pv_case(f"seeded_B{PV_PARTIAL_B}", f[:PV_PARTIAL_B], g[:PV_PARTIAL_B], coef), ragged, pv_case("real_data_ratdf", ratdf, g, coef)):
        report |= case[0]
        ok = ok and case[1]
    emit({"phase": "kernel_check", "kernel": "pv_tables_fwd+bwd", "B": B, "N": n, "tol": PV_TOL, "cases": report, "ok": ok})
    if not ok:
        raise RuntimeError(f"pv_tables: a kernel disagrees with its plain twins: {report}")

    kcat = torch.cat(ratint.pv_dense(m, torch.float32, dev), dim=1)  # [n, 2m], the twin's cached pair
    gcat = torch.cat([g[:, 0::2], g[:, 1::2], torch.zeros((B, 1), dtype=g.dtype, device=dev)], dim=1)
    nbytes = 4 * (B * n + B * (2 * m - 1) + 8 * m)
    nops = 2 * 2 * B * n * m  # two tables, a multiply and an add per term
    # the kernels run it on the tensor cores at float32 accuracy: three TF32 products a term (3xTF32)
    b_ms, b_by = bound_ms(nbytes, 3 * nops, TF32_OPS_PER_S)
    simt = {"bound_f32_simt_ms": bound_ms(nbytes, nops)[0]}  # the same terms as float32 FMAs outside them
    rows = {
        "pv_tables_fwd": dict(max_abs_err=worst["fwd"], ms=device_times_ms(lambda: pv_tables.pv_tables_fwd(ratdf, coef)),
                              plain_ms=device_times_ms(lambda: pv_tables.plain(ratdf, coef)), bound_ms=b_ms, bound_by=b_by,
                              library_ms=device_times_ms(lambda: torch.matmul(ratdf, kcat)), **simt),
        "pv_tables_bwd": dict(max_abs_err=worst["bwd"], ms=device_times_ms(lambda: pv_tables.pv_tables_bwd(g, coef)),
                              plain_ms=device_times_ms(lambda: pv_tables.plain_bwd(g, coef)), bound_ms=b_ms, bound_by=b_by,
                              library_ms=device_times_ms(lambda: torch.matmul(gcat, kcat.T)), **simt),
    }
    return rows


def check_lin_lookup_meta(rng, table, poles, q):
    """K10 and its backward at the real-data path's shapes: the chi_R table [128, 2043] zero-padded to
    2048 with the grid as a device tensor, at the real xi_e queries [128, 51 200] and at seeded queries
    that run past both ends; against their float32 and float64 twins (at LOOKUP_TOL of max |table|; the
    slope against float64 where both precisions put the query into the same cell) and against K1/K2 on
    the unpadded table."""
    import torch
    import torch.nn.functional as F

    from tsadar_tpu_torch.core.physics.interp import PAD_BLOCK, lin_cell
    from tsadar_tpu_torch.ops import lin_lookup

    dev = table.device
    B, n = table.shape
    npad = (n // PAD_BLOCK + 1) * PAD_BLOCK
    tpad = F.pad(table, (0, npad - n)).contiguous()
    meta = torch.stack([poles[0], poles[1] - poles[0], torch.full_like(poles[0], n)]).contiguous()
    x0, dx = float(meta[0]), float(meta[1])
    span = x0 + dx * (n - 1)
    q_seeded = torch.tensor(rng.uniform(x0 - 1.0, span + 1.0, q.shape), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal(q.shape), dtype=torch.float32, device=dev)
    scale = float(table.abs().max())
    report, ok, worst = {}, True, (0.0, 0.0)
    for label, qq in (("real_data_xie", q), ("seeded", q_seeded)):
        got, f32, f64 = lin_lookup.lin_lookup_meta_fwd(qq, tpad, meta), lin_lookup.plain_meta(qq, tpad, meta), lin_lookup.plain_meta(qq.double(), tpad.double(), meta.double())
        k1 = lin_lookup.lin_lookup_fwd(qq, table.contiguous(), x0, dx)
        same = lin_cell(qq, meta[0], meta[1], n)[1] == lin_cell(qq.double(), meta[0].double(), meta[1].double(), n)[1]
        d_bwd, d_f32, k2 = lin_lookup.lin_lookup_meta_bwd(qq, g, meta, npad), lin_lookup.plain_meta_bwd(qq, g, meta, npad), lin_lookup.lin_lookup_bwd(qq, g, x0, dx, n)
        # against float64 with the queries that float64 puts into another cell left out on both sides
        g_same = (g * same).contiguous()
        d_same, d_f64 = lin_lookup.lin_lookup_meta_bwd(qq, g_same, meta, npad), lin_lookup.plain_meta_bwd(qq.double(), g_same.double(), meta.double(), npad)
        d_scale = float(d_f64.abs().max())
        entry = {
            "value_vs_f32": float((got[0] - f32[0]).abs().max()) / scale, "value_vs_f64": float((got[0].double() - f64[0]).abs().max()) / scale,
            "slope_vs_f32": float((got[1] - f32[1]).abs().max()) / scale,
            "slope_vs_f64_same_cell": float(((got[1].double() - f64[1]).abs() * same).max()) / scale,
            "value_vs_k1": float((got[0] - k1[0]).abs().max()) / scale, "slope_vs_k1": float((got[1] - k1[1]).abs().max()) / scale,
            "queries_in_another_cell_in_f64": int((~same).sum()),
            "dtable_vs_f32": float((d_bwd - d_f32).abs().max()) / d_scale, "dtable_vs_f64_same_cell": float((d_same.double() - d_f64).abs().max()) / d_scale,
            "dtable_f32_twin_vs_f64_same_cell": float((lin_lookup.plain_meta_bwd(qq, g_same, meta, npad).double() - d_f64).abs().max()) / d_scale,
            "dtable_vs_k2": float((d_bwd[:, :n] - k2).abs().max()) / d_scale, "dtable_padding_zero": bool((d_bwd[:, n:] == 0).all()),
        }
        entry["ok"] = entry["dtable_padding_zero"] and all(
            entry[k] <= LOOKUP_TOL for k in ("value_vs_f32", "value_vs_f64", "slope_vs_f32", "slope_vs_f64_same_cell", "value_vs_k1", "slope_vs_k1")
        ) and entry["dtable_vs_f32"] <= LOOKUP_BWD_TOL and entry["dtable_vs_k2"] <= LOOKUP_BWD_TOL and (
            entry["dtable_vs_f64_same_cell"] <= LOOKUP_BWD_F64_TOL)
        report[label] = entry
        ok = ok and entry["ok"]
        if label == "real_data_xie":
            worst = (float((got[0].double() - f64[0]).abs().max()), float((d_same.double() - d_f64).abs().max()))
    emit({"phase": "kernel_check", "kernel": "lin_lookup_meta_fwd+bwd", "queries": list(q.shape), "table": [B, npad], "n": n,
          "tol": LOOKUP_TOL, "bwd_tol": LOOKUP_BWD_TOL, "bwd_f64_tol": LOOKUP_BWD_F64_TOL, "table_scale": scale, "cases": report, "ok": ok})
    if not ok:
        raise RuntimeError(f"lin_lookup_meta: a kernel disagrees with its twins or with K1/K2: {report}")

    Q = q.shape[1]
    grid = torch.zeros((B, 1, Q, 2), dtype=torch.float32, device=dev)
    grid[..., 0] = ((q - x0) / (dx * (n - 1)) * 2.0 - 1.0)[:, None, :]
    img = table[:, None, None, :].contiguous()
    # the backward's yardstick: one scatter_add_ of both deposits of every query (built untimed)
    idx, vals, most = lookup_deposits("lin", q, g, (meta[0], meta[1]), n)
    fwd_ms, fwd_by = bound_ms(4 * B * Q + 4 * B * npad + 12 + 8 * B * Q, 10 * B * Q)
    bwd_ms, bwd_by = bound_ms(8 * B * Q + 12 + 4 * B * npad, 8 * B * Q)
    bwd_kernel_ms = device_times_ms(lambda: lin_lookup.lin_lookup_meta_bwd(q, g, meta, npad))
    bwd_library_ms = device_times_ms(lambda: torch.zeros((B, npad), dtype=torch.float32, device=dev).scatter_add_(-1, idx, vals))
    return {
        "lin_lookup_meta_fwd": dict(
            max_abs_err=worst[0], ms=device_times_ms(lambda: lin_lookup.lin_lookup_meta_fwd(q, tpad, meta)),
            plain_ms=device_times_ms(lambda: lin_lookup.plain_meta(q, tpad, meta)), bound_ms=fwd_ms, bound_by=fwd_by,
            library_ms=device_times_ms(lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True))),
        # timed on the real-data queries, as its forward: real_data_ms repeats ms
        "lin_lookup_meta_bwd": dict(
            max_abs_err=worst[1], ms=bwd_kernel_ms,
            plain_ms=device_times_ms(lambda: lin_lookup.plain_meta_bwd(q, g, meta, npad)), bound_ms=bwd_ms, bound_by=bwd_by,
            library_ms=bwd_library_ms, real_data_ms=bwd_kernel_ms, real_data_library_ms=bwd_library_ms, real_data_max_deposits=most),
    }


def real_data_lookup_padded(table, poles, q, wrappers):
    """K10's path: ``interp1d_linear_pallas`` on the real-data chi_R table and queries, forward and
    backward through autograd (K10 and its backward once each), against the same lookup through
    ``LinLookup`` (K1, K2): values, the query cotangent and the table cotangent."""
    import torch

    from tsadar_tpu_torch.core.physics.interp import interp1d_linear_pallas, lin_lookup

    g = torch.tensor(np.random.default_rng(SEED + 1).standard_normal(q.shape), dtype=torch.float32, device=q.device)
    results = {}
    for name in ("k10", "k1"):
        qq, tt = q.detach().clone().requires_grad_(), table.detach().clone().requires_grad_()
        with torch.enable_grad():
            read_and_zero(wrappers)
            val = interp1d_linear_pallas(qq, poles, tt) if name == "k10" else lin_lookup(qq, tt, float(poles[0]), float(poles[1] - poles[0]))
            g_q, g_t = torch.autograd.grad(val, (qq, tt), g)
        torch.cuda.synchronize()
        results[name] = (val.detach(), g_q, g_t, read_and_zero(wrappers))
    (val, g_q, g_t, launches), (val1, g_q1, g_t1, _) = results["k10"], results["k1"]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    errs = {"value_vs_k1": rel(val, val1), "g_q_vs_k1": rel(g_q, g_q1), "g_table_vs_k2": rel(g_t, g_t1)}
    ok = (launches == {k: int(k in ("lin_lookup_meta_fwd", "lin_lookup_meta_bwd")) for k in wrappers}
          and errs["value_vs_k1"] <= LOOKUP_TOL and errs["g_q_vs_k1"] <= LOOKUP_TOL and errs["g_table_vs_k2"] <= LOOKUP_BWD_TOL)
    emit({"phase": "real_data_lookup_padded", "queries": list(q.shape), "table": list(table.shape), "launches": launches, **errs,
          "tol": LOOKUP_TOL, "bwd_tol": LOOKUP_BWD_TOL, "ok": ok})
    if not ok:
        raise RuntimeError(f"interp1d_linear_pallas on the real-data operands: launches {launches}, {errs}")
    return launches


def real_data_forward(cfg, sa, all_data, wrappers, smi):
    """The 128-lineout forward of the real-data fit's loss at the deck's start values: K1, K3, K5 and K9
    once each, finite spectra of the data's shape; wall time.  Returns (loss function, batch, params, launches)."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams

    batch = real_batch(all_data)
    loss_fn = LossFunction(cfg, sa, batch)
    diag = loss_fn.ts_diag
    params = ThomsonParams.create(cfg["parameters"], N_LINEOUTS, activate=True, device=diag.device, dtype=diag.dtype)
    dev_batch = loss_fn.device_batch(batch)
    with torch.no_grad():
        read_and_zero(wrappers)
        ThryE = diag(params, dev_batch)[0]
        torch.cuda.synchronize()
        launches = read_and_zero(wrappers)
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            diag(params, dev_batch)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    want = {k: int(k in FORWARD_KERNELS) for k in wrappers}
    ok = launches == want and tuple(ThryE.shape) == (N_LINEOUTS, 1024) and bool(torch.isfinite(ThryE).all())
    emit({"phase": "real_data_forward", "lineouts": N_LINEOUTS, "launches": launches, "shape": list(ThryE.shape),
          "finite": bool(torch.isfinite(ThryE).all()), "ms": ms, "spectra_per_s": N_LINEOUTS / ms * 1e3, "times_ms": times,
          "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"real-data forward: launches {launches} (want {want}), shape {tuple(ThryE.shape)}")
    return loss_fn, batch, params, launches


def real_data_grad_check(cfg, sa, all_data):
    """Loss and gradient of the real lineouts at REAL_CHECK_PIXELS at the deck's start values: the card
    (float32, kernels) against the CPU plain path in float64, at grad_check's limits."""
    from tsadar_tpu_torch import LossFunction, ThomsonParams

    pixels = list(cfg["data"]["lineouts"]["val"])
    rows = [pixels.index(p) for p in REAL_CHECK_PIXELS]
    data = real_batch(all_data, rows)
    check_cfg = copy.deepcopy(cfg)
    check_cfg["optimizer"]["batch_size"] = len(rows)
    results = {}
    for name, device in (("f64", "cpu"), ("card", "cuda")):
        loss_fn = LossFunction(check_cfg, {"sa": sa["sa"], "weights": sa["weights"][rows]}, data, device=device)
        params = ThomsonParams.create(check_cfg["parameters"], len(rows), activate=True, device=device,
                                      dtype=loss_fn.ts_diag.dtype)
        (value, _), grads = loss_fn.value_and_grad(params, data)
        results[name] = float(value), {k: g.double().cpu() for k, g in grads.items()}
    (loss_ref, g_ref), (loss, g_card) = results["f64"], results["card"]
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    report = {k: float((g_card[k] - g_ref[k]).abs().max() / g_ref[k].abs().max()) for k in g_ref}
    ok = loss_err <= LOSS_TOL and all(err <= GRAD_TOL for err in report.values())
    emit({"phase": "real_data_grad_check", "pixels": list(REAL_CHECK_PIXELS), "loss": loss, "loss_f64_cpu": loss_ref,
          "loss_rel_err": loss_err, "loss_tol": LOSS_TOL, "grad_err_of_max_per_parameter": report, "grad_tol": GRAD_TOL, "ok": ok})
    if not ok:
        raise RuntimeError(f"real-data loss or gradient on the card disagrees with the CPU float64 path: {loss_err:.3e}, {report}")


def real_data_fit(cfg, loss_fn, batch, wrappers, smi):
    """``_1d_adam_loop_`` on the 128 real lineouts: FIT_STEPS adam steps at FIT_LR in chunks of 8, K1-K6
    and both K9 modes once per step, then ``bench_whole_shot.py``'s quality gate.  Returns the launches."""
    import torch

    from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_

    fit_cfg = fit_config(cfg, N_LINEOUTS, FIT_STEPS)
    record = {}
    read_and_zero(wrappers)
    best_loss, best = _1d_adam_loop_(fit_cfg, loss_fn, None, batch, record=record)
    torch.cuda.synchronize()
    launches = read_and_zero(wrappers)
    losses = record["losses"]
    fit_seconds = sum(record["chunk_seconds"])
    with torch.no_grad():
        row_loss = loss_fn.__loss__(best, batch)[1][2].double().cpu().numpy()
    fitted = {k: v.detach().double().cpu().numpy() for k, v in best.get_unnormed_params()["electron"].items() if k in REAL_TRUTH}
    pixels = np.asarray(cfg["data"]["lineouts"]["val"])
    sel = np.where((pixels >= REAL_WINDOW[0]) & (pixels <= REAL_WINDOW[1]))[0]
    at_window = {k: [float(v) for v in fitted[k][sel]] for k in REAL_TRUTH}
    gates = {k: all(abs(v - truth) / truth <= tol for v in at_window[k]) for k, (truth, tol) in REAL_TRUTH.items()}
    gates |= {"covered": len(sel) > 0, "final_loss": losses[-1] < REAL_LOSS_CEILING,
              "lineout_median": float(np.median(row_loss)) < REAL_LOSS_CEILING, "fit_time": fit_seconds < REAL_FIT_SECONDS}
    want = {k: FIT_STEPS * int(k in REAL_FIT_KERNELS) for k in wrappers}
    ok = launches == want and bool(np.isfinite(losses).all()) and all(gates.values())
    ms_per_step = 1e3 * fit_seconds / FIT_STEPS
    emit({"phase": "real_data_fit", "lineouts": N_LINEOUTS, "steps": FIT_STEPS, "lr": FIT_LR, "launches": launches,
          "first_loss": losses[0], "final_loss": losses[-1], "best_loss": best_loss,
          "median_lineout_loss": float(np.median(row_loss)), "worst_lineout_loss": float(np.max(row_loss)),
          "at_pixels_500_510": at_window, "truth_and_tol": REAL_TRUTH, "gates": gates, "quality_ok": all(gates.values()),
          "fit_seconds": fit_seconds, "ms_per_step": ms_per_step, "lineout_steps_per_s": N_LINEOUTS * 1e3 / ms_per_step,
          "median_fitted": {k: float(np.median(v)) for k, v in fitted.items()}, "losses_every_10th": losses[::10], "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"real-data fit: launches {launches} (want {want}), gates {gates}")
    few = 4  # steps under the profiler, from the deck's start values again
    emit(profile_run(lambda: _1d_adam_loop_(fit_config(cfg, N_LINEOUTS, few), loss_fn, None, batch), few, ms_per_step,
                     "real_data_fit_profile", "step"))
    return launches


# (source, the TPU kernel it replaces, which of the repo's ten TPU kernels); K9's transposed mode and
# K10's table cotangent have no TPU kernel of their own: they stand beside the kernel they belong to
KERNELS = {
    "lin_lookup_fwd": ("tsadar_tpu_torch/csrc/lin_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:84", "K1"),
    "lin_lookup_bwd": ("tsadar_tpu_torch/csrc/lin_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:193", "K2"),
    "cubic_lookup_fwd": ("tsadar_tpu_torch/csrc/cubic_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:314", "K3"),
    "cubic_lookup_bwd": ("tsadar_tpu_torch/csrc/cubic_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:416", "K4"),
    "spectrum_tail_fwd": ("tsadar_tpu_torch/csrc/spectrum_tail.cu", "tsadar_tpu/ops/spectrum_kernel.py:380", "K5"),
    "spectrum_tail_bwd": ("tsadar_tpu_torch/csrc/spectrum_tail_bwd.cu", "tsadar_tpu/ops/spectrum_kernel.py:407", "K6"),
    "chi_bilinear_fwd": ("tsadar_tpu_torch/csrc/chi_bilinear.cu", "tsadar_tpu/ops/bilinear_kernel.py:132", "K7"),
    "chi_bilinear_bwd": ("tsadar_tpu_torch/csrc/chi_bilinear.cu", "tsadar_tpu/ops/bilinear_kernel.py:253", "K8"),
    "pv_tables_fwd": ("tsadar_tpu_torch/csrc/pv_tables.cu", "tsadar_tpu/ops/pv_kernel.py:85", "K9"),
    "pv_tables_bwd": ("tsadar_tpu_torch/csrc/pv_tables.cu", "tsadar_tpu/ops/pv_kernel.py:85", "K9, transposed mode"),
    "lin_lookup_meta_fwd": ("tsadar_tpu_torch/csrc/lin_lookup.cu", "tsadar_tpu/ops/interp_kernel.py:84", "K10"),
    "lin_lookup_meta_bwd": ("tsadar_tpu_torch/csrc/lin_lookup.cu", "tsadar_tpu/core/physics/interp.py:1227", "K10, table cotangent"),
}
# the port's device functions by name (csrc/*.cu), as the profiler lists them
PORT_KERNEL_NAMES = ("lin_lookup", "cubic_lookup", "spectrum_tail", "pv_tables", "sum_shares", "chi_bilinear")
FORWARD_KERNELS = ("lin_lookup_fwd", "cubic_lookup_fwd", "spectrum_tail_fwd", "pv_tables_fwd")
ARTS_KERNELS = ("chi_bilinear_fwd", "chi_bilinear_bwd")
PADDED_KERNELS = ("lin_lookup_meta_fwd", "lin_lookup_meta_bwd")
REAL_FIT_KERNELS = tuple(k for k in KERNELS if k not in ARTS_KERNELS + PADDED_KERNELS)  # K1-K6 and both K9 modes


def read_and_zero(wrappers):
    counts = {k: fn.launches for k, fn in wrappers.items()}
    for fn in wrappers.values():
        fn.launches = 0
    return counts


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
    from tsadar_tpu_torch.ops import build, chi_bilinear, cubic_lookup, lin_lookup, pv_tables, spectrum_tail

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
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
                    for k, v in logs.items()}})
    # registers, stack and spills of this slice's redesigned kernels, K5 at the main path's one species
    ptxas = {"spectrum_tail_fwd": ptxas_usage(logs.get("spectrum_tail", ""), "spectrum_tail_kernelILi1EE"),
             "chi_bilinear_bwd": ptxas_usage(logs.get("chi_bilinear", ""), "chi_bilinear_bwd_kernel")}
    emit({"phase": "sass", "instructions": {k: sass_instructions(k) for k in build.SOURCES}})

    cfg = load_deck()
    sas = get_scattering_angles(cfg)
    draws = draw_lineouts(N_LINEOUTS)
    diag = ThomsonScatteringDiagnostic(cfg, sas)
    params = make_params(cfg, draws, N_LINEOUTS, None, None)
    batch = make_batch(N_LINEOUTS)
    wrappers = {
        "lin_lookup_fwd": lin_lookup.lin_lookup_fwd,
        "lin_lookup_bwd": lin_lookup.lin_lookup_bwd,
        "cubic_lookup_fwd": cubic_lookup.cubic_lookup_fwd,
        "cubic_lookup_bwd": cubic_lookup.cubic_lookup_bwd,
        "spectrum_tail_fwd": spectrum_tail.spectrum_tail_fwd,
        "spectrum_tail_bwd": spectrum_tail.spectrum_tail_bwd,
        "chi_bilinear_fwd": chi_bilinear.chi_bilinear_fwd,
        "chi_bilinear_bwd": chi_bilinear.chi_bilinear_bwd,
        "pv_tables_fwd": pv_tables.pv_tables_fwd,
        "pv_tables_bwd": pv_tables.pv_tables_bwd,
        "lin_lookup_meta_fwd": lin_lookup.lin_lookup_meta_fwd,
        "lin_lookup_meta_bwd": lin_lookup.lin_lookup_meta_bwd,
    }
    arts_cfg, arts_sas = load_arts_deck()
    arts_diag, arts_params = arts_models(arts_cfg, arts_sas, None)

    with torch.no_grad():
        # 3. every kernel against its plain twin, at the main path's shapes
        rng = np.random.default_rng(SEED)
        rows = check_lookups(rng)
        rows["spectrum_tail_fwd"] = check_tail(diag, params)
        rows["spectrum_tail_bwd"] = check_tail_bwd(diag, params, rng)
        rows |= check_chi_bilinear(rng, arts_diag, arts_params)

    # 4. this slice's main path: the whole-shot fit from shot 101675's real data -- the data pipeline,
    # the 128-lineout forward (K9 among its kernels), K9 and K10 on its own operands, K10's path through
    # interp1d_linear_pallas, loss and gradient against the CPU float64 path, and the 200-step adam fit
    real_cfg, real_sa, real_all = real_data_prepare()
    real_loss_fn, real_fit_batch, real_params, real_fwd_launches = real_data_forward(real_cfg, real_sa, real_all, wrappers, smi)
    with torch.no_grad():
        ratdf, chi_table, chi_poles, xie, lfe_meta, nv = real_operands(real_loss_fn, real_params)
        rows |= check_pv_tables(rng, ratdf)
        for k, extra in (check_tail_real(real_loss_fn.ts_diag, real_params, rng)
                         | check_lookups_real(xie, chi_poles, chi_table.shape[1], lfe_meta, nv)).items():
            rows[k] |= extra
        rows |= check_lin_lookup_meta(rng, chi_table, chi_poles, xie)
    padded_launches = real_data_lookup_padded(chi_table, chi_poles, xie, wrappers)
    real_data_grad_check(real_cfg, real_sa, real_all)
    real_fit_launches = real_data_fit(real_cfg, real_loss_fn, real_fit_batch, wrappers, smi)

    with torch.no_grad():
        # 5. the first slice's path: the whole-shot forward of synthetic spectra through the kernels
        read_and_zero(wrappers)
        ThryE = diag(params, batch)[0]
        torch.cuda.synchronize()
        fwd_launches = read_and_zero(wrappers)
        emit({"phase": "forward_launches", "launches": fwd_launches})
        if not all(fwd_launches[k] for k in FORWARD_KERNELS):
            raise RuntimeError(f"the forward did not launch every forward kernel: {fwd_launches}")
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
        emit(profile_run(lambda: [diag(params, batch) for _ in range(3)], 3, ms, "profile", "forward"))

    # 6. loss and gradient on the card against the CPU float64 plain path
    grad_check(cfg, sas, draws, diag_cpu)

    # 7. the second slice's path: the adam fit of the whole lineout batch, forward and backward through the kernels
    read_and_zero(wrappers)
    record, best_loss, errors, (loss_fn, fit_batch) = run_fit(cfg, sas, draws, N_LINEOUTS, FIT_STEPS, diag)
    torch.cuda.synchronize()
    fit_launches = read_and_zero(wrappers)
    losses = record["losses"]
    # the whole fit on the host clock (every chunk ends on a synchronizing read), and the chunks on their own
    ms_per_step = 1e3 * sum(record["chunk_seconds"]) / FIT_STEPS
    chunk_ms = [1e3 * s / n for s, n in zip(record["chunk_seconds"], record["chunk_steps"])]
    medians = {k: float(np.median(v)) for k, v in errors.items()}
    fit_ok = (
        all(fit_launches[k] >= FIT_STEPS for k in REAL_FIT_KERNELS)
        and bool(np.isfinite(losses).all())
        and best_loss <= FIT_LOSS_DROP * losses[0]
        and all(medians[k] <= tol for k, tol in FIT_TOL.items())
    )
    emit({"phase": "fit", "lineouts": N_LINEOUTS, "steps": FIT_STEPS, "lr": FIT_LR, "launches": fit_launches,
          "first_loss": losses[0], "last_loss": losses[-1], "best_loss": best_loss, "losses_finite": bool(np.isfinite(losses).all()),
          "median_rel_err": {k: medians[k] for k in FIT_TOL}, "max_rel_err": {k: float(errors[k].max()) for k in FIT_TOL},
          "tol": FIT_TOL, "median_lam_abs_err_nm": medians["lam_nm"], "max_lam_abs_err_nm": float(errors["lam_nm"].max()),
          "ms_per_step": ms_per_step, "steps_per_s": 1e3 / ms_per_step, "lineout_steps_per_s": N_LINEOUTS * 1e3 / ms_per_step,
          "fit_seconds": sum(record["chunk_seconds"]), "chunk_median_ms_per_step": statistics.median(chunk_ms),
          "chunk_ms_per_step": chunk_ms, "losses_every_10th": losses[::10], "gpu": smi, "ok": fit_ok})
    if not fit_ok:
        raise RuntimeError(f"fit: launches {fit_launches}, best loss {best_loss:.3e} of first {losses[0]:.3e}, "
                           f"median errors {medians} against {FIT_TOL}")
    from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_

    few = 4  # steps under the profiler, from the deck's start values again
    emit(profile_run(lambda: _1d_adam_loop_(fit_config(cfg, N_LINEOUTS, few), loss_fn, None, fit_batch), few, ms_per_step,
                     "fit_profile", "step"))

    # 8. the third slice's path: the ARTS 2V forward, its gradient and the angular fit through K7 and K8
    arts_fwd_launches, arts_target = arts_forward(arts_cfg, arts_sas, arts_diag, arts_params, wrappers, smi)
    arts_grad_check(arts_cfg, arts_sas, arts_target, wrappers)
    arts_fit_launches, arts_steps = arts_fit(arts_cfg, arts_sas, arts_target, wrappers, smi)
    # the deck's own EDF family (spherical harmonics with the Mora-Yahi f1, nvx 128, nvr 64), and the
    # ARTS 1V deck (a DLM EDF on nvx 256 through the unreduced 1V spectrum: K1 and K3 at 2048 x 241 queries)
    arts_other_forward("arts_spherical_harmonics_forward", *load_arts_deck(arbitrary=False), ("chi_bilinear_fwd",), wrappers)
    arts_1v = load_arts_deck(arbitrary=False, names=ARTS_1V_DECK)
    with torch.no_grad():
        check_lookups_arts_1v(*arts_1v, rng)
    arts_other_forward("arts_1v_forward", *arts_1v, ("lin_lookup_fwd", "cubic_lookup_fwd", "pv_tables_fwd"), wrappers,
                       plain_f32_tol=ARTS_1V_F32_TOL)

    def launches_of(k):
        """(on its main path, in that path's fit, fit steps): the ARTS path (K7, K8), K10's drive on the
        real-data operands, the real-data path (K9), or the first slices' synthetic 1V path (K1-K6)."""
        if k in ARTS_KERNELS:
            return (arts_fwd_launches if k == "chi_bilinear_fwd" else arts_fit_launches)[k], arts_fit_launches[k], arts_steps
        if k in PADDED_KERNELS:
            return padded_launches[k], 0, 0
        if k.startswith("pv_tables"):
            return (real_fwd_launches if k in FORWARD_KERNELS else real_fit_launches)[k], real_fit_launches[k], FIT_STEPS
        return (fwd_launches if k in FORWARD_KERNELS else fit_launches)[k], fit_launches[k], FIT_STEPS

    emit({"kernels": [
        {"name": k, "tpu_kernel": KERNELS[k][2], "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
         "launches": launches_of(k)[0], "fit_launches": launches_of(k)[1],
         "launches_per_fit_step": launches_of(k)[1] / launches_of(k)[2] if launches_of(k)[2] else 0.0,
         "real_data_fit_launches": real_fit_launches[k], **rows[k], **({"ptxas": ptxas[k]} if k in ptxas else {})}
        for k in wrappers
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
