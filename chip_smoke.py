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
   step, counted on the device's trace: the steps after the first two are
   replays of its CUDA graph, which call no launcher) under
   ``bench_whole_shot.py``'s quality gate: Te, ne and m at the lineouts of pixels 500-510 within 10 %, 5 % and
   15 % of the validated 0.641, 0.228 and 3.20, final and median lineout loss
   under 1e-3, the fit under 60 s; ms per step and a profile of the step;
   GRAPH_STEPS graphed steps against the same steps run eagerly
   (``real_data_fit_graph``);
   Then the main deck as written (``tests/configs/time_test_{defaults,inputs}.yaml``:
   pixels 500 and 505, batch size 2, scipy L-BFGS-B, 1000 iterations at most)
   through ``fitter.fit`` on the card: loss and gradient at batch sizes 2 and 1
   against the CPU float64 path (``main_deck_grad_check_b2``/``_b1``), the fit
   (``main_deck_fit``: K1-K6 and both K9 modes once an evaluation, the fitted
   parameters within ``tests/test_inverse/test_1d_data.py``'s validated values
   and tolerances, its pins reported, scipy's message, ``nit`` and ``nfev``)
   and its postprocess with a refit of lineout 1 at batch size 1 after a fit
   cut to MAIN_DECK_SHORT_FIT iterations, written into (batch 0, slot 1), and
   the float64 sigma-Hessian on the CPU (``main_deck_postprocess``: every
   sigma finite and non-zero);
   Then the rest of the 1V fitter, each path with the launch counts read
   around it: ``one_d_loop`` with ``method: lbfgs`` (the device L-BFGS) on
   ``tests/test_inverse/test_1d_random.py``'s seed-7 synthetic setup, 150
   steps (``lbfgs_fit``: final loss under 1e-4, every active parameter within
   10 % of the truth, K1-K6 and both K9 modes once an evaluation); the IAW
   deck (``configs/1d``, ps lineouts 535:735:100, only the loss's IAW arm):
   loss and gradient against the CPU float64 path and K5/K6 at its ion window
   against their float64 twins (``iaw_deck_grad_check``), then ``fitter.fit``
   with refits and sigmas (``iaw_deck_fit``: ``test_1d_iaw_data.py``'s pins,
   the refit of lineout 1 in its slot, 8 finite sigmas, lineout 0's
   positive); ``fitter.fit`` on shot 111411 (``shot_111411_fit``:
   ``test_1d_data_111411.py``'s pins and guards) and on the imaging shot
   112059 with adam and the spectrum breakdown (``imaging_112059_fit``:
   ``test_imaging_data.py``'s pins, the breakdown finite); and the main deck's
   two lineouts with a pointwise ``Arbitrary1V`` EDF, forward, loss and
   gradient against the CPU float64 path (``arbitrary_1v``);
   Then the normal entry point, each path with the launch counts read around
   it: ``python -m tsadar_tpu_torch --cfg configs/1d --mode forward`` in a
   child process (``cli_forward_subprocess``: rc 0, one finite 1024-point
   spectrum a feature against the CPU float64 ``forward_pass``, K1, K3, K5
   and K9 once a feature as the child counts them, the child's wall
   seconds); ``runner.run`` of
   ``configs/1d_series`` (``cli_series``: 7 entries of two ion species, each
   spectrum against the CPU float64 ``forward_pass``, K1, K3, K5 and K9 once
   an entry and feature, the ``.nc`` files equal to the ``.npz``, ms an
   entry) and of the ARTS deck ``configs/arts-2d`` in forward mode
   (``cli_forward_arts``: the layout step and K7 once, the image against the
   CPU float64 forward); the main deck through ``cli.main`` with sigmas and
   the export (``cli_main_deck_fit``); and the whole-shot fit of shot 101675
   (128 lineouts, 200 adam steps, sigmas) through ``runner.run``
   (``cli_whole_shot_fit``: ``bench_whole_shot.py``'s gates read from the
   run's CSV and tracker, 128 x 6 finite sigmas, every stage's seconds);
   Then the ARTS fits from real data: the ARTS 1V deck as ``e2e_arts.py`` runs it
   (the ATS image of shot 94475, adam 200 epochs, sigmas) through ``runner.run``
   with checkpoints and a resumed fit (``cli_arts_1v_fit``: ``e2e_arts.py``'s
   gates, K1-K4, K9 and K9ᵀ once a step), its first batch's loss and gradient
   against the CPU float64 path (``arts_1v_real_grad_check``), the 2V deck's
   128 x 128 pointwise EDF on the same image through ``fitter.fit``
   (``arts_2v_real_fit``: rmsprop at 1e-3, 120 epochs, the Hessian skipped past its
   budget, the layout step, K7 and K8 once a step) and the multiplexed two-shot
   fit of shots 94475 and 94477 (``arts_multiplex``: loss and gradient against
   the CPU float64 path, 40 adam steps, the chi kernels twice a step);
   Then the rest of the 2V physics and of the library surface: the ARTS 2V deck at
   full width with the rotate projection (``arts_2v_rotate``: its projections
   against the NUDFT ones, the forward, loss and gradient against the CPU
   float64 rotate path, 20 adam steps; the layout step, K7 and K8), in exact
   mode (``arts_2v_exact``: the chi values at 2048 of the deck's points against
   the CPU float64 exact mode, one forward and one ``value_and_grad`` at
   246 784 points with their seconds and peak memory, the gap to the table mode,
   loss and gradient on a cut wavelength axis against the CPU float64 exact
   mode; no kernel), with the spherical-harmonic EDF at ``Nl: 2``
   (``arts_sph_harmonics_l2``), the angular breakdown of the 2V deck and of the
   ARTS 1V deck's real window (``arts_breakdown``), the optax optimizers ported
   last on the ARTS 1V real-data fit (``arts_optimizers``) and
   ``python -m tsadar_tpu_torch.run_bo`` in a child process (``run_bo``);
   Then the fit of shot 112059 whose lineouts and fit windows come from the feature detector
   (``feature_detector.estimate_lineouts_epw`` on the imaging deck, batches of 20, adam for 30 epochs) through
   ``runner.run`` (``detector_112059_fit``: the detected windows and 60 pixels equal to the JAX package's, the
   detector's host seconds, the first batch's loss and gradient against the CPU float64 path, K1-K6 and both K9
   modes once a step at B = 20, each batch's loss falling, every fitted value finite and in its bounds, 60 rows of
   ``learned_parameters.csv`` at the detected pixels, ms a step);
   every phase that runs ``runner.run`` or the command line also reports the run's ``figures`` tag
   (``figures_check``): on a machine without matplotlib ``not drawn`` naming it, and no PNG in the run; where
   matplotlib imports, ``drawn`` and every figure the JAX package draws for such a run under ``plots/``;
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
   the deck's own queries, K7 with the layout step that writes its quad table
   (``chi_bilinear_pack``, bit for bit against its twin), each timed by CUDA
   events and by the profiler's kernel records beside an empty kernel's launch
   floor (K8 timed on both query sets beside one
   ``scatter_add_`` of all its 12 deposits a query); runs the forward through
   ``ThomsonScatteringDiagnostic`` (K7 exactly once) and compares it with the
   CPU float64 plain path; compares loss and gradient with respect to the EDF
   (K7 and K8 once each) with that path; fits the image with ``angular_optax``
   (adam, ARTS_FIT_STEPS steps; K7 and K8 once per step, every loss finite, the
   last under a quarter of the first); and runs the deck's own
   spherical-harmonic EDF and the ARTS 1V deck forward once each against the
   CPU float64 path;
9. drives the multi-GPU sharding (``tsadar_tpu_torch.parallel``), each path with the launch counts read in its
   processes: the whole-shot fit of shot 101675 (128 lineouts, 200 adam steps, no sigmas) through
   ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m tsadar_tpu_torch --cfg DIR --mode fit``
   with ``optimizer.parallel: true`` and ``TSADAR_MULTIHOST=1`` (``dist_one_rank_nccl``: an NCCL group of one,
   collectives called, K1-K6 and both K9 modes 200 times, ``bench_whole_shot.py``'s gates from the run's files,
   the losses of ``real_data_fit``); then two ranks on the one card under torchrun with gloo named (NCCL refuses
   two ranks on one device; ``dist_worker``): each fits 64 of the 128 lineouts for 200 steps
   (``dist_two_ranks_whole_shot``: K1-K6 and both K9 modes 200 times on each rank at 64 rows, the first step's
   loss and gradient against this process's single-rank card run, the gates on the gathered parameters, the
   same final loss on both ranks, each rank's ms a step), then splits the ARTS 2V deck's 246 784 chi points
   (``dist_arts_2v_points``: ``shard_2v_points``, the loss and EDF gradient against the unsharded card run, the
   layout step, K7 and K8 once a step on each rank at 123 392 queries, 20 adam steps whose loss falls, the same
   EDF on both ranks at the end).  A rank that fails fails its command and the phase.

It prints one JSON line per phase and check, then the kernel table, then the
card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit code is
0 only when everything passed; without a CUDA device it prints no result and
exits 2.
"""

import contextlib
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
# K6 at the IAW deck's ion window may miss its float64 twin by TAIL_IAW_RATIO times the float32 twin's miss,
# but never by this share of the output's largest float64 entry or more: a zero cotangent misses by 1 of it,
# a sign-flipped one by 2
TAIL_IAW_BWD_CEILING = 0.25
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
GRAD_F32_RATIO = 2.0  # a gradient that float32 itself misses by more than GRAD_TOL: at most this times that miss
# ... and always by less than this share of its largest float64 entry: what an all-zero gradient misses by
GRAD_ZERO_MISS = 1.0
# ... and within this share of the CPU float32 plain path's largest entry of that path itself (on an H100: 1.8e-3
# to 4.3e-3 on the ARTS 1V deck's Te, ne, m and lam, 9.8e-5 on the main deck's m at B = 1, 1.3e-2 and 2.0e-2 on
# the IAW deck's Te and Va, float32 cancellations by ~1e5 at the ion window)
F32_TWIN_GRAD_TOL = 5e-2
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
# the main deck as written (tests/configs/time_test_{defaults,inputs}.yaml: pixels 500 and 505, batch size 2,
# scipy L-BFGS-B with num_epochs 1000) through fitter.fit, held to tests/test_inverse/test_1d_data.py's
# upstream-validated values and tolerances at its first lineout; its self-validated pins of both lineouts
# (rtol 3e-2, a CPU float64 fit's) are reported, not gated
MAIN_DECK_TRUTH = {"amp1_general": (0.733, 1e-1), "amp2_general": (0.520, 1e-1), "lam_general": (523.855, 5e-3),
                   "Te_electron": (0.641, 1e-1), "ne_electron": (0.228, 5e-2), "m_electron": (3.20, 15e-2)}
MAIN_DECK_PINS = {"amp1_general": [0.7855, 0.7621], "amp2_general": [0.5073, 0.5169], "lam_general": [524.57, 524.45],
                  "Te_electron": [0.6476, 0.6282], "ne_electron": [0.2291, 0.2295], "m_electron": [3.155, 3.079]}
MAIN_DECK_PIN_RTOL = 3e-2
MAIN_DECK_SHORT_FIT = 5  # L-BFGS-B iterations of the fit that main_deck_postprocess refits
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


def kernel_ms(fn, name, reps=20):
    """Mean device duration of the kernels whose name holds ``name`` in one ``fn()`` call, from the
    profiler's kernel records over ``reps`` calls: the kernel alone, without the launch gaps and event
    records that ``device_times_ms`` brackets as well."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages() if name in e.key) / reps / 1e3


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
    from tsadar_tpu_torch.utils.config import set_forward_ranges

    return set_forward_ranges(load_main_deck())


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


def check_lookups_real(q, poles, table_n, meta, nv, case="real_data_xie"):
    """K2 and K4 on a forward's own queries xi_e [B, Q] (``case``): K2 on the chi_R pole grid, K4 on
    the log-EDF grid (``meta``, nv entries) with g zeroed where the forward overwrites the lookup (beyond
    the velocity grid); g seeded by a generator of its own.  Returns {kernel: {real_data_ms, ...}}."""
    import torch

    g = torch.tensor(np.random.default_rng(SEED + 3).standard_normal(q.shape), dtype=torch.float32, device=q.device)
    vx0, vdx = float(meta[0, 0]), float(meta[0, 1])
    g4 = torch.where((q < vx0) | (q > vx0 + vdx * (nv - 1)), 0.0, g).contiguous()
    lin, ok_lin = lookup_bwd_case("lin", q, g, (float(poles[0]), float(poles[1] - poles[0])), table_n)
    cubic, ok_cubic = lookup_bwd_case("cubic", q, g4, meta, nv)
    emit({"phase": "kernel_check", "kernel": "lin_lookup_bwd+cubic_lookup_bwd", "case": case, "queries": list(q.shape),
          "tol": LOOKUP_BWD_TOL, "cases": {"lin_lookup_bwd": lin, "cubic_lookup_bwd": cubic}, "ok": ok_lin and ok_cubic})
    if not (ok_lin and ok_cubic):
        raise RuntimeError(f"K2/K4 on the {case} queries disagree with their plain twins: {lin}, {cubic}")
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
                *args[11:13], args[13][cut].contiguous(), *(a[:2] for a in args[14:]))
        yield (f"L{width}", rows) if noise is None else (f"L{width}", rows, noise[:2, cut].contiguous())


def check_tail(diag, params):
    """K5 against its twin in float64 (``tail_fwd_misses``) on the forward's own lookup outputs [128, 1,
    5120, 10]; on a small case with two gradient points, two species, flow and drift
    (``two_species_tail_case``), on that case at TAIL_BWD_MANY_ANGLES (angles in several chunks); and on 2
    lineouts of the main operands cut to TAIL_BWD_RAGGED_L wavelengths (the block edges).  The small cases
    draw from generators of their own.  Same limits for all."""
    from tsadar_tpu_torch.ops import spectrum_tail

    ff = diag.model.electron_form_factor
    args = inputs = ff.tail_args(params(), diag.model.weight)
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


def tail_bwd_misses(label, g, args, report, f32_ratio=None):
    """K6 against its twin in float64 on (g, args), per output (the float32 twin's own
    miss beside it); with ``f32_ratio``, an output that the float32 twin misses by more than its
    limit may miss by that ratio times the twin's miss, up to TAIL_IAW_BWD_CEILING of the output's
    scale.  Fills ``report`` and returns (all ok, max |kernel - float64 twin|)."""
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
        if f32_ratio is not None:
            tol = max(tol, min(f32_ratio * miss_w, TAIL_IAW_BWD_CEILING * scales[name]))
        entry = {"scale": scales[name], "kernel_vs_f64": miss_k, "plain_f32_vs_f64": miss_w, "tol": tol,
                 "ok": bool(torch.isfinite(k).all()) and miss_k <= tol}
        report[f"{label}:{name}"] = entry
        ok = ok and entry["ok"]
        worst = max(worst, miss_k)
    return ok, worst


def two_species_tail_case(rng, device, n_angles=3, L=96):
    """(g, the tail's fifteen arguments) of a small synthetic case for the branches of K6
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
    lf = (-0.5 * xie**2).contiguous()  # a Maxwellian's log f_e at the phase velocities, less its peak's -0.92
    chi = (1.0 / (1.0 + xie**2) - 0.5).contiguous()  # smooth and O(1), like chi_R
    g = t(rng.standard_normal((B, L)))
    lfc = t(np.full(B, -0.92))
    return g, (lf, chi, ne, Te, lam, Va, ud, A, Z, Ti, fract, t(np.resize([0.5, 0.3, 0.2], n_angles)), sarad, omgs, lfc)


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
    args = inputs = ff.tail_args(params(), diag.model.weight)
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
    args = inputs = ff.tail_args(params(), diag.model.weight)
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


def arts_models(cfg, sas, device, dtype=None, mode_2v="table", projection="fourier"):
    """(diagnostic, unbatched parameters) of the ARTS deck, a 2V deck's form factor in ``mode_2v`` with
    ``projection``.  The port projects by the exact NUDFT on the card and by the fft2 slice on the CPU,
    as the JAX package does by backend; the CPU reference here is given the card's projection, so that
    the two devices compute the same function."""
    from tsadar_tpu_torch import ThomsonParams, ThomsonScatteringDiagnostic

    diag = ThomsonScatteringDiagnostic(cfg, sas, device=device, dtype=dtype, mode_2v=mode_2v)
    if diag.model.dim == 2:
        ff = diag.model.electron_form_factor
        ff.projection = projection
        if diag.device.type == "cpu" and projection == "fourier":
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
    # K7 reads T's quad layout: the pack kernel builds it from T's three column slices (rows C apart), and
    # must give T and the plain twin's quads bit for bit
    segs = (T[:, :nvx], T[:, nvx : 2 * nvx], T[:, 2 * nvx :])
    (T_packed, T4), (_, T4_plain) = cb.chi_bilinear_pack(*segs), cb.plain_pack(*segs)
    pack_exact = bool(torch.equal(T_packed, T) and torch.equal(T4, T4_plain))
    out, out32, out64 = cb.chi_bilinear_fwd(bq, xq, T4, meta), cb.plain_fwd(bq, xq, T, meta), cb.plain_fwd(*d(bq, xq, T, meta))
    rows_same = rowmix_indices(R, bq)[0] == rowmix_indices(R, bq.double())[0]
    report = {"queries": int(bq.numel()), "pack_exact": pack_exact}
    ok, worst_val = pack_exact and bool(torch.isfinite(out).all()), 0.0
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
    T_deck, T4_deck = cb.chi_bilinear_pack(f1d, df1d, chiR)  # f1d is a column slice of the projection
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
    T4 = cb.plain_pack(T[:, :nvx], T[:, nvx : 2 * nvx], T[:, 2 * nvx :])[1]
    fwd = lambda b, x, tab: (lambda: cb.chi_bilinear_fwd(b, x, tab, meta))  # noqa: E731
    # yardstick: grid_sample's bilinear interpolation of ONE segment's values (rows made periodic by a copy of row 0)
    img = torch.cat([T[:, :nvx], T[:1, :nvx]])[None, None]
    grid = torch.stack([(xq - v0x) / (dvx * (nvx - 1)) * 2.0 - 1.0, torch.remainder(bq, 2 * math.pi) / math.pi - 1.0], dim=-1)[None, None]
    lib = lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True)  # noqa: E731
    b_ms, b_by = bound_ms(4 * (8 * Q + R * C + 4), 60 * Q)
    # an empty kernel, launched and timed as every kernel is: the floor under each time of the line
    floor = lambda: cb.launch_floor(dev)  # noqa: E731
    floor_ms, floor_kernel_ms = device_times_ms(floor), kernel_ms(floor, "launch_floor_kernel")
    rows["chi_bilinear_fwd"] = dict(
        max_abs_err=worst_val, ms=device_times_ms(fwd(bq, xq, T4)), ms_deck_queries=device_times_ms(fwd(bq_deck, xq_deck, T4_deck)),
        kernel_ms=kernel_ms(fwd(bq, xq, T4), "chi_bilinear_fwd_kernel"),
        kernel_ms_deck_queries=kernel_ms(fwd(bq_deck, xq_deck, T4_deck), "chi_bilinear_fwd_kernel"),
        plain_ms=device_times_ms(lambda: cb.plain_fwd(bq, xq, T, meta)), bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor_ms,
        launch_floor_kernel_ms=floor_kernel_ms,
        library_ms=device_times_ms(lib), library_computes="grid_sample: one segment's values, 1 of K7's 6 outputs",
    )
    # the layout step: T and T4 from the deck's three tables, in place of the concatenation that built T alone
    b_ms, b_by = bound_ms(4 * (R * C + R * C + 4 * R * C), 0)
    rows["chi_bilinear_pack"] = dict(
        max_abs_err=0.0,  # chi_case held T and T4 to the twin's bit for bit on every query set
        ms=device_times_ms(lambda: cb.chi_bilinear_pack(f1d, df1d, chiR)), plain_ms=device_times_ms(lambda: cb.plain_pack(f1d, df1d, chiR)),
        kernel_ms=kernel_ms(lambda: cb.chi_bilinear_pack(f1d, df1d, chiR), "chi_bilinear_pack_kernel"),
        bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor_ms, launch_floor_kernel_ms=floor_kernel_ms, library_ms=None,
        cat_ms=device_times_ms(lambda: torch.cat([f1d, df1d, chiR], dim=-1)),
        library_computes="none: torch.cat (cat_ms) builds T alone, what the pack replaced",
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
        max_abs_err=worst_dT, ms=device_times_ms(bwd(bq, xq, T, g)), launch_floor_ms=floor_ms,
        kernel_ms=kernel_ms(bwd(bq, xq, T, g), "chi_bilinear_bwd_kernel"),
        kernel_ms_deck_queries=kernel_ms(bwd(bq_deck, xq_deck, T_deck, g_deck), "chi_bilinear_bwd_kernel"),
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
        ok = launches == {k: int(k in ARTS_FWD_KERNELS) for k in wrappers} and sane and err <= FWD_TOL
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
    from tsadar_tpu_torch.inverse.loops import _angular_loop_
    from tsadar_tpu_torch.utils.process.batches import angular_batch

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
    batch = loss_fn.device_batch(angular_batch(all_data, slice(lineouts["start"], lineouts["end"])))
    start = ThomsonParams.create(few_cfg["parameters"], 1, activate=True, device=loss_fn.ts_diag.device, dtype=loss_fn.ts_diag.dtype, batch=False)
    prof = profile_run(lambda: _angular_loop_(few_cfg, loss_fn, start, batch), few, ms_per_step, "arts_fit_profile", "step")
    emit(prof)
    return launches, steps_run, prof


def check_lookups_arts_1v(ff, params, rng, shapes, queries):
    """K1-K4 and both K9 modes at an ARTS 1V deck's shapes -- one row, ``queries`` (npts x angles) xi_e, the
    2043-entry pole table, the 256-point log-EDF and the PV integrand [1, 1024] -- on the operands that the form
    factor ``ff`` builds from ``params`` (K9's transposed mode, K2 and K4 on seeded cotangents).  K9 is held to
    its float32 and float64 twins at PV_TOL of max |table|, one row being a partial block of its 32.  K1 and K3
    are held to their twins in float32 (every query) and in float64 on the same float32 operands, at LOOKUP_TOL
    of max |table|.  K1's second output jumps from cell to cell: against float64 it is compared where both
    precisions put the query into the same cell, and the others are counted.  K3 extrapolates its edge
    polynomial with an unclamped t, which far from the grid (|xi_e| reaches 15 on a grid of +-8) is rounding
    noise in any float32 form, and the forward overwrites every query beyond the grid: K3 is compared up to 1.5
    cells beyond either end, as at the whole-shot shapes.  K2 and K4: ``check_lookups_real``."""
    import torch

    from tsadar_tpu_torch.core.physics.form_factor import _batch_of_one
    from tsadar_tpu_torch.core.physics.interp import lin_cell
    from tsadar_tpu_torch.ops import cubic_lookup, lin_lookup

    physical = _batch_of_one(params())
    xie, log_fe, meta, table, _ = ff._lookup_inputs_1v(physical)
    q = xie.reshape(1, -1).contiguous()
    x0, dx, n = ff.pv_x0, ff.pv_dx, table.shape[1]
    ratdf = ff._pv_integrand(log_fe, physical["electron"]["v"])
    if (q.shape[1], n, log_fe.shape[1], tuple(ratdf.shape)) != (queries, 2043, 256, (1, 1024)):
        raise RuntimeError(f"{shapes}: Q, pole table, EDF, PV integrand = {q.shape[1]}, {n}, {log_fe.shape[1]}, {tuple(ratdf.shape)}")

    g = torch.tensor(rng.standard_normal((1, n)), dtype=torch.float32, device=ratdf.device)
    report, ok, _ = pv_case(f"{shapes}_ratdf", ratdf, g, ff._pv_coef)
    emit({"phase": "kernel_check", "kernel": "pv_tables_fwd+bwd", "shapes": shapes, "B": 1, "N": ratdf.shape[1],
          "tol": PV_TOL, "cases": report, "ok": ok})
    if not ok:
        raise RuntimeError(f"pv_tables at the {shapes} shapes disagrees with its plain twins: {report}")

    got, f32, f64 = lin_lookup.lin_lookup_fwd(q, table, x0, dx), lin_lookup.plain(q, table, x0, dx), lin_lookup.plain(q.double(), table.double(), x0, dx)
    same = lin_cell(q, x0, dx, n)[1] == lin_cell(q.double(), x0, dx, n)[1]
    scale = float(table.abs().max())
    errs = {"value_vs_f32": float((got[0] - f32[0]).abs().max()), "value_vs_f64": float((got[0].double() - f64[0]).abs().max()),
            "slope_vs_f32": float((got[1] - f32[1]).abs().max()), "slope_vs_f64_same_cell": float(((got[1].double() - f64[1]).abs() * same).max())}
    ok = all(e <= LOOKUP_TOL * scale for e in errs.values())
    emit({"phase": "kernel_check", "kernel": "lin_lookup_fwd", "shapes": shapes, "queries": list(q.shape), "table": list(table.shape),
          **errs, "queries_in_another_cell_in_f64": int((~same).sum()), "scale": scale, "tol": LOOKUP_TOL * scale, "ok": ok})
    if not ok:
        raise RuntimeError(f"lin_lookup_fwd at the {shapes} shapes disagrees with its plain twins: {errs} against {LOOKUP_TOL * scale:.3e}")

    v0, dv = float(meta[0, 0]), float(meta[0, 1])
    near = (q >= v0 - 1.5 * dv) & (q <= v0 + (log_fe.shape[1] + 0.5) * dv)
    got, f32 = cubic_lookup.cubic_lookup_fwd(q, log_fe, meta), cubic_lookup.plain(q, log_fe, meta)
    f64 = cubic_lookup.plain(q.double(), log_fe.double(), meta.double())
    scale = float(log_fe.abs().max())
    errs = {f"{name}_vs_{ref_name}": float(((g.double() - r).abs() * near).max())
            for name, g, refs in zip(("value", "dvalue_dt"), got, zip(f32, f64)) for ref_name, r in zip(("f32", "f64"), refs)}
    ok = all(e <= LOOKUP_TOL * scale for e in errs.values())
    emit({"phase": "kernel_check", "kernel": "cubic_lookup_fwd", "shapes": shapes, "queries": list(q.shape), "table": list(log_fe.shape),
          **errs, "queries_compared": int(near.sum()), "queries_beyond_1.5_cells": int((~near).sum()),
          "scale": scale, "tol": LOOKUP_TOL * scale, "ok": ok})
    if not ok:
        raise RuntimeError(f"cubic_lookup_fwd at the {shapes} shapes disagrees with its plain twins: {errs} against {LOOKUP_TOL * scale:.3e}")
    check_lookups_real(q, ff.pv_poles, n, meta, log_fe.shape[1], case=f"{shapes}_xie")


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
    101675, one batch (``load_main_deck``)."""
    from tsadar_tpu_torch.inverse.fitter import _lineout_selection

    cfg = load_main_deck()
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


def lineouts_of(cfg, sa, all_data, pixels):
    """(deck, angles, batch) of the real lineouts at ``pixels``: the deck's batch size set to their number."""
    rows = [list(cfg["data"]["lineouts"]["val"]).index(p) for p in pixels]
    check_cfg = copy.deepcopy(cfg)
    check_cfg["optimizer"]["batch_size"] = len(rows)
    return check_cfg, {"sa": sa["sa"], "weights": sa["weights"][rows]}, real_batch(all_data, rows)


def cpu_nudft(loss_fn):
    """``loss_fn`` with its CPU diagnostic projecting by NUDFT, as the card does (``arts_models``)."""
    ff = loss_fn.ts_diag.model.electron_form_factor
    if loss_fn.ts_diag.device.type == "cpu" and loss_fn.ts_diag.model.dim == 2:
        ff._project_all_fourier = lambda vx, DF, betas: ff._project_all_nudft(vx, DF)
    return loss_fn


def real_data_grad_check(cfg, sa, batch, phase, f32_rule=False, lost_to_float32=(), wrappers=None, mode_2v="table",
                         projection="fourier", **about):
    """Loss and gradient of ``batch`` at the deck's start values: the card (float32, kernels) against the port's CPU
    plain path in float64, the loss to LOSS_TOL and each gradient to GRAD_TOL of its largest entry.  ``batch`` is a
    1D deck's lineouts (``lineouts_of``), an angular deck's window or its ``{"b1", "b2"}`` windows; an angular deck's
    parameters are unbatched, and its CPU diagnostic projects by NUDFT as the card's does (``cpu_nudft``).

    With ``f32_rule`` the plain path also runs in float32 on the CPU, and a gradient that the card misses by more
    than GRAD_TOL (one near its zero; the ARTS 1V deck's, at its narrow resonance) passes only as float32's own
    miss: within GRAD_F32_RATIO times the CPU float32 plain path's miss, under GRAD_ZERO_MISS (nearer float64 than
    zeros are), and within F32_TWIN_GRAD_TOL of that path's largest entry of the path itself, which computes the
    card's float32 function.  A gradient named in ``lost_to_float32`` that float32 misses by GRAD_ZERO_MISS or more
    is held to the float32 path alone.  ``mode_2v`` and ``projection`` set a 2V deck's form factor on every
    device.  ``about`` goes into the printed line.  Returns the card's launches (``wrappers``' counts)."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams

    angular = "angular" in cfg["other"]["extraoptions"]["spectype"]
    n = 1 if angular else cfg["optimizer"]["batch_size"]
    results = {}
    runs = (("f64", "cpu", None), ("card", "cuda", None)) + ((("f32", "cpu", torch.float32),) if f32_rule else ())
    for name, device, dtype in runs:
        loss_fn = cpu_nudft(LossFunction(cfg, sa, batch.get("b1", batch), device=device, dtype=dtype, mode_2v=mode_2v))
        loss_fn.ts_diag.model.electron_form_factor.projection = projection
        params = ThomsonParams.create(cfg["parameters"], n, activate=True, device=device, dtype=loss_fn.ts_diag.dtype,
                                      batch=not angular)
        read_and_zero(wrappers or {})
        (value, _), grads = loss_fn.value_and_grad(params, batch)
        results[name] = float(value), {k: g.double().cpu() for k, g in grads.items()}, read_and_zero(wrappers or {})
    (loss_ref, g_ref, _), (loss, g_card, launches) = results["f64"], results["card"]
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    miss = lambda g, ref: {k: float((g[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ref}  # noqa: E731
    report, extra = miss(g_card, g_ref), {}
    beyond = sorted(k for k in report if report[k] > GRAD_TOL)
    grads_ok = not beyond
    if f32_rule:
        g32 = results["f32"][1]
        f32, twin = miss(g32, g_ref), miss(g_card, g32)
        lost = {k for k in lost_to_float32 if f32[k] >= GRAD_ZERO_MISS}
        grads_ok = all(twin[k] <= F32_TWIN_GRAD_TOL
                       and (k in lost or report[k] <= GRAD_F32_RATIO * f32[k] and report[k] < GRAD_ZERO_MISS) for k in beyond)
        extra = {"plain_f32_cpu_grad_err_of_max": f32, "card_vs_plain_f32_grad_err_of_its_max": twin,
                 "held_as_float32": beyond, "grad_f32_ratio": GRAD_F32_RATIO, "grad_zero_miss": GRAD_ZERO_MISS,
                 "plain_f32_grad_tol": F32_TWIN_GRAD_TOL, "lost_to_float32": sorted(lost),
                 "plain_f32_cpu_loss_rel_err": abs(results["f32"][0] - loss_ref) / abs(loss_ref)}
    finite = all(bool(torch.isfinite(g).all()) for g in g_card.values())
    ok = finite and loss_err <= LOSS_TOL and grads_ok
    emit({"phase": phase, **about, "e_data": list(np.shape(batch.get("b1", batch)["e_data"])), "multiplexed": "b1" in batch,
          "loss": loss, "loss_f64_cpu": loss_ref, "loss_rel_err": loss_err, "loss_tol": LOSS_TOL,
          "grad_err_of_max_per_parameter": report, "grad_tol": GRAD_TOL,
          "grad_max_per_parameter": {k: float(g.abs().max()) for k, g in g_ref.items()}, **extra, "launches": launches, "ok": ok})
    if not ok:
        raise RuntimeError(f"{phase}: loss or gradient on the card disagrees with the CPU plain path: {loss_err:.3e}, {report}")
    return launches


def real_data_fit(cfg, loss_fn, batch, wrappers, smi):
    """``_1d_adam_loop_`` on the 128 real lineouts: FIT_STEPS adam steps at FIT_LR in chunks of 8, then
    ``bench_whole_shot.py``'s quality gate; the same fit again under the device's trace, K1-K6 and both K9 modes run
    once a step.  Returns the launches (``DeviceRuns``) and every step's loss."""
    import torch

    from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_

    fit_cfg = fit_config(cfg, N_LINEOUTS, FIT_STEPS)
    record = {}
    best_loss, best = _1d_adam_loop_(fit_cfg, loss_fn, None, batch, record=record)
    torch.cuda.synchronize()
    with on_device(wrappers) as launches:
        _1d_adam_loop_(fit_cfg, loss_fn, None, batch)
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
          "launcher_calls": launches.calls, "graph_replays": launches.replays,
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
    return launches, losses


# the graph against the eager steps on the real-data fit: GRAPH_STEPS adam steps with per-lineout best-so-far
GRAPH_STEPS = 20
GRAPH_LOSS_RTOL = 1e-5  # of each eager loss (the graph's Adam keeps its step count on the card, in float32)
GRAPH_LEAF_TOL = 1e-5  # of each fitted leaf's largest |entry|: a lineout's best-so-far taken at another step misses by ~lr


@contextlib.contextmanager
def eager_loop(capturable=False):
    """Inside, the adam loop runs every step eagerly on the card (its CUDA graph off), with Adam built
    ``capturable`` (as the graph's is) or as the eager loop builds it."""
    from tsadar_tpu_torch.inverse import loops

    graphed, optimizer = loops._graphed, loops.optimizer
    loops._graphed = lambda device, ranks, epochs: False
    loops.optimizer = lambda method, leaves, lr, **_: optimizer(method, leaves, lr, capturable=capturable)
    try:
        yield
    finally:
        loops._graphed, loops.optimizer = graphed, optimizer


def graph_against_eager(cfg, loss_fn, batch, steps=GRAPH_STEPS):
    """``steps`` adam steps of ``cfg``'s fit with per-lineout best-so-far, graphed, eager, and eager with Adam
    capturable: {the graphed losses' largest relative miss of the eager ones, the graphed leaves' largest miss of the
    eager capturable ones as a share of each leaf's largest |entry| (the same best-so-far rows: the same arithmetic,
    apart from the kernels' float atomics), the graphed fit's captures and replays, the losses}."""
    from tsadar_tpu_torch.core.params import get_filter_spec
    from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_
    from tsadar_tpu_torch.utils import trace

    fit_cfg = copy.deepcopy(cfg)
    fit_cfg["optimizer"].update(num_epochs=steps, track_best="per_lineout")

    def fit():
        record = {}
        trace.clear()
        _, weights = _1d_adam_loop_(fit_cfg, loss_fn, None, batch, record=record)
        leaves = [p.detach().double().cpu() for p in get_filter_spec(fit_cfg["parameters"], weights).values()]
        return np.asarray(record["losses"]), leaves, trace.counters()

    graph = fit()
    with eager_loop():
        eager = fit()
    with eager_loop(capturable=True):
        eager_capturable = fit()
    trace.clear()
    return {"loss_miss": float(np.max(np.abs(graph[0] / eager[0] - 1.0))),
            "leaf_miss": max(float((g - e).abs().max() / e.abs().max()) for g, e in zip(graph[1], eager_capturable[1])),
            "captures": graph[2].get("fit.graph.captures", 0), "replays": graph[2].get("fit.graph.replays", 0),
            "eager_replays": eager[2].get("fit.graph.replays", 0) + eager_capturable[2].get("fit.graph.replays", 0),
            "graph_losses": graph[0].tolist(), "eager_losses": eager[0].tolist()}


def real_data_fit_graph(cfg, loss_fn, batch, smi):
    """The real-data fit's step as a CUDA graph against the same steps run eagerly (``graph_against_eager``): the
    losses to GRAPH_LOSS_RTOL, the best-so-far leaves to GRAPH_LEAF_TOL, one capture and GRAPH_STEPS - 1 replays."""
    got = graph_against_eager(fit_config(cfg, N_LINEOUTS, GRAPH_STEPS), loss_fn, batch)
    checks = {"losses": got["loss_miss"] <= GRAPH_LOSS_RTOL, "best_so_far": got["leaf_miss"] <= GRAPH_LEAF_TOL,
              "captured_once": got["captures"] == 1, "replays": got["replays"] == GRAPH_STEPS - 1,
              "eager_not_replayed": got["eager_replays"] == 0}
    ok = all(checks.values())
    emit({"phase": "real_data_fit_graph", "lineouts": N_LINEOUTS, "steps": GRAPH_STEPS, **got,
          "loss_rtol": GRAPH_LOSS_RTOL, "leaf_tol": GRAPH_LEAF_TOL, "checks": checks, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"real_data_fit_graph: checks {checks}, loss miss {got['loss_miss']:.3e}, "
                           f"leaf miss {got['leaf_miss']:.3e}")


def deck_pair(*parts):
    """(defaults, inputs) of the deck directory ``ROOT/parts``."""
    return [yaml.safe_load((ROOT.joinpath(*parts) / f"{n}.yaml").read_text()) for n in ("defaults", "inputs")]


def main_deck_pair():
    """(defaults, inputs) of the main deck, ``tests/configs/time_test_*.yaml``, as written."""
    return [yaml.safe_load((ROOT / "tests" / "configs" / f"time_test_{n}.yaml").read_text()) for n in ("defaults", "inputs")]


def load_main_deck(**other):
    """The main deck merged as written, with ``other`` set as given.  The deck asks for the raw-data
    visualizer, which the port draws inside a run where matplotlib imports (on the card's machine the run's
    ``figures`` tag says why not)."""
    from tsadar_tpu_torch.utils.config import merge_configs

    cfg = merge_configs(*main_deck_pair())
    cfg["other"].update(other)
    return cfg


def main_deck_grad_check():
    """Loss and gradient of the main deck's lineouts at batch sizes 2 (pixels 500, 505) and 1 (505), the
    card against the CPU float64 plain path at grad_check's limits: K9's last tile and the tails' grids
    at the fit's own batch sizes.  Alone, pixel 505's m gradient is 7e-4 of its Te gradient at the
    deck's start, and float32 (the plain forms on the CPU as the card) misses it by 6e-2 of itself:
    such a gradient is held to GRAD_F32_RATIO times the CPU float32 plain path's own miss."""
    from tsadar_tpu_torch.inverse.fitter import _lineout_selection
    from tsadar_tpu_torch.utils.process.prepare import prepare_data

    cfg = _lineout_selection(load_main_deck())
    all_data, sa, _ = prepare_data(cfg, cfg["data"]["shotnum"])
    for pixels in ((500, 505), (505,)):
        real_data_grad_check(*lineouts_of(cfg, sa, all_data, pixels), f"main_deck_grad_check_b{len(pixels)}", f32_rule=True,
                             pixels=list(pixels))


def deck_fit_launches(launches, nfev, forwards, features=1, table_bwd=True):
    """Every backward kernel of the 1V path launched once an evaluation, every forward kernel ``features``
    times (both features are computed where a deck loads both) an evaluation and a forward of the
    postprocess, nothing else: (ok, want).  Without ``table_bwd`` (a deck whose EDF is not fitted) the tables'
    cotangents (K2, K4, K9's transposed mode) have nothing to carry and do not run."""
    bwd = ("lin_lookup_bwd", "cubic_lookup_bwd", "spectrum_tail_bwd", "pv_tables_bwd")
    table = ("lin_lookup_bwd", "cubic_lookup_bwd", "pv_tables_bwd")
    want = {k: (nfev * int(table_bwd or k not in table) if k in bwd else features * (nfev + forwards))
            if k in REAL_FIT_KERNELS else 0 for k in launches}
    return launches == want and nfev > 0, want


def main_deck_fit(wrappers, smi):
    """``fitter.fit`` on the main deck as written: scipy L-BFGS-B on the card (float32, K1-K6 and both K9
    modes once an evaluation), the fitted parameters against test_1d_data.py's validated values."""
    import torch

    from tsadar_tpu_torch.inverse import fitter

    record = {}
    read_and_zero(wrappers)
    t0 = time.perf_counter()
    final, loss = fitter.fit(load_main_deck(), record=record)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_and_zero(wrappers)
    scipy = record["scipy"]
    nfev = sum(scipy["nfev"])
    launches_ok, want = deck_fit_launches(launches, nfev, forwards=1)  # the postprocess's array loss: one forward
    fitted = {k: [float(v) for v in final[k]] for k in MAIN_DECK_TRUTH}
    gates = {k: abs(fitted[k][0] - val) / val <= tol for k, (val, tol) in MAIN_DECK_TRUTH.items()}
    pins = {k: [abs(g - w) / w for g, w in zip(fitted[k], MAIN_DECK_PINS[k])] for k in MAIN_DECK_PINS}
    finite = all(np.isfinite(v).all() for v in fitted.values()) and np.isfinite(loss)
    ok = launches_ok and finite and all(gates.values())
    emit({"phase": "main_deck_fit", "pixels": [int(p) for p in final["lineout pixel"]], "loss": loss, "fitted": fitted,
          "truth_and_rtol": MAIN_DECK_TRUTH, "gates": gates, "pin_misses": pins, "pin_rtol": MAIN_DECK_PIN_RTOL,
          "pins_within_rtol": {k: all(m <= MAIN_DECK_PIN_RTOL for m in v) for k, v in pins.items()},
          "scipy_message": scipy["message"], "nit": scipy["nit"], "nfev": scipy["nfev"], "scipy_seconds": scipy["seconds"],
          "launches": launches, "launches_per_evaluation": {k: v / nfev for k, v in launches.items() if v},
          "seconds": seconds, "stage_seconds": {k: record[k] for k in ("setup_seconds", "fit_seconds", "postprocess_seconds")},
          "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"main_deck_fit: launches {launches} (want {want}), gates {gates}, fitted {fitted}")
    return launches


def main_deck_postprocess(wrappers, smi, device=None):
    """The main deck's postprocess with sigmas and refits, as ``fitter.fit`` runs it, after a fit cut to
    MAIN_DECK_SHORT_FIT iterations (a fit stopped early, so that a refit has something to improve):
    ``refit_thresh`` 0 flags both lineouts, lineout 0 is skipped as in the JAX package, lineout 1 is fitted
    again alone (batch size 1, the deck's 1000 iterations, warm-started from lineout 0) and must land in
    (batch 0, slot 1); every sigma finite and non-zero.  The Hessian runs on the CPU in float64.  Returns
    the final parameters and the record."""
    import torch

    from tsadar_tpu_torch.inverse.fitter import _lineout_selection, load_data_for_fitting
    from tsadar_tpu_torch.inverse.loops import one_d_loop
    from tsadar_tpu_torch.utils.process import postprocess

    cfg = _lineout_selection(load_main_deck(calc_sigmas=True, refit=True, refit_thresh=0.0))
    all_data, sa, axes = load_data_for_fitting(cfg)
    indices = np.arange(len(all_data["e_data"]))
    short = copy.deepcopy(cfg)
    short["optimizer"]["num_epochs"] = MAIN_DECK_SHORT_FIT
    weights, _, loss_fn = one_d_loop(short, all_data, sa, indices, len(indices) // cfg["optimizer"]["batch_size"], device=device)
    record = {}
    read_and_zero(wrappers)
    t0 = time.perf_counter()
    final = postprocess.postprocess(cfg, indices, all_data, axes, loss_fn, sa, weights, record)
    if device is None:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_and_zero(wrappers)
    nfev_refit = sum(record["refit_scipy"]["nfev"]) if "refit_scipy" in record else 0
    # forwards: the refits' recalculation, the refit's own array loss, the final recalculation
    launches_ok, want = deck_fit_launches(launches, nfev_refit, forwards=3)
    refits = record.get("refits", [])
    sigmas = {k: [float(x) for x in v] for k, v in final["sigmas"].items()}
    sigma_ok = len(sigmas) == 6 and all(np.isfinite(v).all() and np.all(np.abs(v) > 0) and len(v) == 2 for v in sigmas.values())
    refit_ok = [(r["lineout"], r["batch"], r["slot"], r["written"]) for r in refits] == [(1, 0, 1, True)]
    ok = launches_ok and sigma_ok and refit_ok
    emit({"phase": "main_deck_postprocess", "first_fit_iterations": MAIN_DECK_SHORT_FIT, "refits": refits,
          "refit_scipy": record.get("refit_scipy"), "refit_ok": refit_ok, "sigmas": sigmas, "sigmas_finite_nonzero": sigma_ok,
          "fitted": {k: [float(v) for v in final[k]] for k in MAIN_DECK_TRUTH}, "launches": launches, "launches_want": want,
          "nfev_refit": nfev_refit, "seconds": seconds,
          "stage_seconds": {"refit": record["refit_seconds"], "hessian_cpu_f64": record["recalc_hessian_seconds"],
                            "array_loss": record["recalc_arrayloss_seconds"], "recalculation": record["postprocessing_seconds"]},
          "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"main_deck_postprocess: launches {launches} (want {want}), refits {refits}, sigmas {sigmas}")
    return final, record


# ---------------------------------------------------------------- the rest of the 1V fitter

LBFGS_SEED = 7  # tests/test_inverse/test_1d_random.py's device L-BFGS setup
LBFGS_STEPS = 150
LBFGS_LOSS_CEILING = 1e-4
LBFGS_RTOL = 0.1  # every active parameter against the truth (that test's _assert_recovered)
LBFGS_ACTIVE = {"electron": ("Te", "ne", "m"), "general": ("amp1", "amp2", "lam")}
IAW_PINS = {"Te_electron": ([0.7497, 0.8844], 5e-2), "Va_general": ([-1.885, -1.817], 5e-2),
            "amp3_general": ([0.9707, 0.9590], 5e-2), "ud_general": ([-2.477, -0.987], 2e-1)}  # test_1d_iaw_data.py
IAW_LOSS_CEILING = 1e-3
SHOT_111411_PINS = {"amp1_general": [0.8623, 0.8476], "amp2_general": [1.0648, 0.9956], "lam_general": [525.40, 525.47],
                    "Te_electron": [0.7363, 0.7381], "ne_electron": [0.5371, 0.5337], "m_electron": [2.414, 2.416]}
SHOT_111411_RTOL = {"lam_general": 5e-3}  # the rest 3e-2 (test_1d_data_111411.py)
SHOT_111411_LOSS_CEILING = 5e-3
IMAGING_PINS = {"Te_electron": [0.413, 0.417], "ne_electron": [0.170, 0.173]}  # test_imaging_data.py, rtol 5e-2
IMAGING_LOSS_CEILING = 2.5e-2
# K5 at the IAW deck's ion window, where the whole window is the ion-acoustic feature: at most TAIL_EPW_TOL of
# each lineout's peak, or TAIL_IAW_RATIO times the float32 twin's own miss where float32 itself misses by more
ION_TAIL_TOL = TAIL_EPW_TOL


def load_1d_deck():
    """``tests/configs/1d-{defaults,inputs}.yaml`` merged, with the forward ranges set (the synthetic 1D deck)."""
    from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges

    decks = [yaml.safe_load((ROOT / "tests" / "configs" / f"1d-{n}.yaml").read_text()) for n in ("defaults", "inputs")]
    return set_forward_ranges(merge_configs(*decks))


def perturb(rng, params):
    """test_1d_random.py's draw of the six active values."""
    params["electron"]["fe"]["params"]["m"]["val"] = float(rng.uniform(2.0, 3.5))
    params["electron"]["Te"]["val"] = float(rng.uniform(0.5, 1.5))
    params["electron"]["ne"]["val"] = float(rng.uniform(0.1, 0.7))
    params["general"]["amp1"]["val"] = float(rng.uniform(0.5, 2.5))
    params["general"]["amp2"]["val"] = float(rng.uniform(0.5, 2.5))
    params["general"]["lam"]["val"] = float(rng.uniform(523, 527))
    return params


def lbfgs_fit(wrappers, smi, device=None):
    """``one_d_loop`` with ``method: lbfgs`` (the device L-BFGS) on test_1d_random.py's seed-7 setup: the 1D
    deck's spectrum at a drawn truth (the CPU float64 forward) fitted from a second draw, LBFGS_STEPS steps;
    the value at the last step under LBFGS_LOSS_CEILING and every active parameter within LBFGS_RTOL of the
    truth; K1-K6 and both K9 modes once an evaluation."""
    import torch

    from tsadar_tpu_torch import ThomsonParams, ThomsonScatteringDiagnostic, get_scattering_angles
    from tsadar_tpu_torch.inverse.loops import one_d_loop

    cfg = load_1d_deck()
    sas = get_scattering_angles(cfg)
    rng = np.random.default_rng(LBFGS_SEED)
    cfg["parameters"] = perturb(rng, cfg["parameters"])
    one = {"e_amps": np.ones((1, 1)), "i_amps": np.ones((1, 1)), "noise_e": np.zeros((1, 1)), "noise_i": np.zeros((1, 1))}
    truth = ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu")
    with torch.no_grad():
        ThryE, ThryI, _, _ = ThomsonScatteringDiagnostic(cfg, sas, device="cpu")(truth, one)
        truth = {g: {k: float(v.reshape(-1)[0]) for k, v in truth.get_unnormed_params()[g].items() if k in names}
                 for g, names in LBFGS_ACTIVE.items()}
    cfg["parameters"] = perturb(rng, cfg["parameters"])
    cfg["optimizer"].update(method="lbfgs", num_epochs=LBFGS_STEPS, batch_size=1)
    all_data = {"e_data": ThryE.numpy(), "i_data": ThryI.numpy(), "e_amps": one["e_amps"], "i_amps": one["i_amps"],
                "noiseE": one["noise_e"], "noiseI": one["noise_i"]}
    record = {}
    read_and_zero(wrappers)
    t0 = time.perf_counter()
    weights, loss, _ = one_d_loop(cfg, all_data, sas, np.arange(1), 1, device=device, record=record)
    if device is None:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_and_zero(wrappers)
    evaluations = sum(record["evaluations"])
    fitted = {g: {k: float(v.reshape(-1)[0]) for k, v in weights[0].get_unnormed_params()[g].items() if k in names}
              for g, names in LBFGS_ACTIVE.items()}
    rel = {f"{g}.{k}": abs(fitted[g][k] - v) / abs(v) for g, d in truth.items() for k, v in d.items()}
    want = {k: evaluations * int(k in REAL_FIT_KERNELS) for k in launches}
    gates = {"loss": loss < LBFGS_LOSS_CEILING, "recovered": all(r <= LBFGS_RTOL for r in rel.values()),
             "finite": bool(np.isfinite(record["losses"]).all()), "launches": launches == want}
    ok = all(gates.values())
    emit({"phase": "lbfgs_fit", "seed": LBFGS_SEED, "steps": LBFGS_STEPS, "loss": loss, "loss_ceiling": LBFGS_LOSS_CEILING,
          "truth": truth, "fitted": fitted, "rel_err": rel, "rtol": LBFGS_RTOL, "gates": gates, "evaluations": evaluations,
          "evaluations_per_step": evaluations / LBFGS_STEPS, "ms_per_step": 1e3 * sum(record["seconds"]) / LBFGS_STEPS,
          "ms_per_evaluation": 1e3 * sum(record["seconds"]) / evaluations, "seconds": seconds,
          "launches": launches, "launches_per_evaluation": {k: v / evaluations for k, v in launches.items() if v},
          "evaluations_by_step": record["evaluations"], "stepsizes": record["stepsizes"],
          "unit_steps": sum(s == 1.0 for s in record["stepsizes"]),
          "losses_every_10th": record["losses"][::10], "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"lbfgs_fit: gates {gates}, loss {loss:.3e}, relative errors {rel}, launches {launches}")
    return launches


def load_iaw_deck(**other):
    """``configs/1d/{defaults,inputs}.yaml`` set as test_1d_iaw_data.py sets them: ps lineouts 535:735:100,
    ``other`` as given."""
    from tsadar_tpu_torch.utils.config import merge_configs

    cfg = merge_configs(*deck_pair("configs", "1d"))
    cfg["data"]["lineouts"].update({"start": 535, "end": 735, "skip": 100})
    cfg["other"].update(other)
    return cfg


def ion_tail_misses(label, args, report):
    """K5 against its float64 twin on ``args`` over the whole (ion) window: at most ION_TAIL_TOL of each
    lineout's peak, or TAIL_IAW_RATIO times the float32 twin's own miss of that peak where it is larger."""
    import torch

    from tsadar_tpu_torch.ops import spectrum_tail

    got, want = spectrum_tail.spectrum_tail_fwd(*args), spectrum_tail.plain(*args)
    ref = spectrum_tail.plain(*(a.double() for a in args))
    peak = ref.abs().amax(1)
    miss = lambda x: float(((x.double() - ref).abs().amax(1) / peak).max())  # noqa: E731
    kernel, plain32 = miss(got), miss(want)
    tol = max(ION_TAIL_TOL, TAIL_IAW_RATIO * plain32)
    entry = {"operands": list(args[0].shape), "peak": [float(p) for p in peak], "kernel_vs_f64_of_row_peak": kernel,
             "plain_f32_vs_f64_of_row_peak": plain32, "tol": tol,
             "ok": bool(torch.isfinite(got).all()) and kernel <= tol}
    report[label] = entry
    return entry["ok"], float((got - want).abs().max())


def check_tail_ion_window(loss_fn, rng):
    """K5 and K6 on the IAW deck's ion-window operands (its two lineouts at test_1d_iaw_data.py's fitted
    Te, Va, ud and amp3): K5 against its float64 twin (``ion_tail_misses``), K6 per output against its float64
    twin (``tail_bwd_misses``) on a seeded cotangent over the deck's IAW fit windows, as the loss makes it;
    where the float32 twin itself misses by more than the limits, each may miss by TAIL_IAW_RATIO times that
    (K6's outputs up to TAIL_IAW_BWD_CEILING of their scale)."""
    import torch

    from tsadar_tpu_torch import ThomsonParams
    from tsadar_tpu_torch.core.params.distributions import inv_act
    from tsadar_tpu_torch.core.physics.constants import C

    cfg = loss_fn.cfg
    diag = loss_fn.ts_diag
    params = ThomsonParams.create(cfg["parameters"], 2, activate=True, device=diag.device, dtype=diag.dtype)
    with torch.no_grad():
        for key, (vals, _) in IAW_PINS.items():  # each lineout at its own pin
            name, group = key.rsplit("_", 1)
            g = params.electron.params if group == "electron" else params.general.params
            x = (np.asarray(vals) - g.shifts[name]) / g.scales[name]
            g.normed[name].copy_(torch.as_tensor(inv_act(x, g.activated[name])))
        ff = diag.model.ion_form_factor
        args = ff.tail_args(params(), diag.model.weight)
        fr = cfg["data"]["fit_rng"]
        lam = 2.0 * math.pi * C / ff.omgs.double() * 1e7
        window = ((lam > fr["iaw_min"]) & (lam < fr["iaw_cf_min"])) | ((lam > fr["iaw_cf_max"]) & (lam < fr["iaw_max"]))
        B, G, L, NA = args[0].shape
        noise = torch.tensor(rng.standard_normal((B, L)), dtype=torch.float32, device=ff.omgs.device)
        noise = torch.where(window, noise, 0.0)
        fwd, bwd = {}, {}
        fwd_ok, fwd_err = ion_tail_misses("iaw_deck_ion_window", args, fwd)
        bwd_ok, bwd_err = tail_bwd_misses("iaw_deck_ion_window", noise, args, bwd, f32_ratio=TAIL_IAW_RATIO)
    lam_range = [float(lam.min()), float(lam.max())]
    emit({"phase": "kernel_check", "kernel": "spectrum_tail_fwd", "shapes": "iaw_deck_ion_window", "window_nm": lam_range,
          "Va_ud": {k: IAW_PINS[k][0] for k in ("Va_general", "ud_general")}, "max_abs_err": fwd_err, "cases": fwd, "ok": fwd_ok})
    emit({"phase": "kernel_check", "kernel": "spectrum_tail_bwd", "shapes": "iaw_deck_ion_window", "window_nm": lam_range,
          "fit_window_wavelengths": int(window.sum()), "max_abs_err": bwd_err, "per_output": bwd, "ok": bwd_ok})
    if not (fwd_ok and bwd_ok):
        raise RuntimeError(f"the tail kernels at the IAW deck's ion window miss their float64 twins: {fwd}, "
                           f"{ {n: r for n, r in bwd.items() if not r['ok']} }")


def iaw_deck_grad_check():
    """The IAW deck's loss (its IAW arm alone) and gradient (Te, Va, ud, amp3) at its two lineouts, the card
    against the CPU float64 plain path at grad_check's limits, with main_deck_grad_check_b1's float32 rule
    for the gradients (the CPU float32 plain path misses Te's and Va's by ~0.6 and ~0.5 of their largest
    entries: the lookups' query gradient from the Landau term cancels at the ion window); then the tail
    kernels at its ion window (``check_tail_ion_window``), where K6's Te and Va cotangents are held closely."""
    from tsadar_tpu_torch import LossFunction
    from tsadar_tpu_torch.inverse.fitter import _lineout_selection
    from tsadar_tpu_torch.utils.process.prepare import prepare_data

    cfg = _lineout_selection(load_iaw_deck())
    all_data, sa, _ = prepare_data(cfg, cfg["data"]["shotnum"])
    pixels = cfg["data"]["lineouts"]["val"]
    real_data_grad_check(*lineouts_of(cfg, sa, all_data, pixels), "iaw_deck_grad_check", f32_rule=True, pixels=list(pixels))
    check_tail_ion_window(LossFunction(cfg, sa, real_batch(all_data)), np.random.default_rng(SEED + 9))


def deck_fit(cfg, wrappers):
    """``fitter.fit`` on ``cfg`` on the card: (final parameters, loss, record, launches, seconds)."""
    import torch

    from tsadar_tpu_torch.inverse import fitter

    record = {}
    read_and_zero(wrappers)
    t0 = time.perf_counter()
    final, loss = fitter.fit(cfg, record=record)
    torch.cuda.synchronize()
    return final, loss, record, read_and_zero(wrappers), time.perf_counter() - t0


def pin_misses(final, pins):
    return {k: [float(abs(g - w) / abs(w)) for g, w in zip(final[k][:2], vals)] for k, vals in pins.items()}


def iaw_deck_fit(wrappers, smi):
    """``fitter.fit`` on the IAW deck with ``calc_sigmas``, ``refit`` and ``refit_thresh`` 1e-9 (module 3 of
    the L-BFGS-B deck fits): test_1d_iaw_data.py's pins, loss, the refit of lineout 1 in (batch 0, slot 1),
    all 8 sigmas finite and non-zero, lineout 0's positive; the seconds of the fit, the refit and the Hessian."""
    final, loss, record, launches, seconds = deck_fit(load_iaw_deck(calc_sigmas=True, refit=True, refit_thresh=1e-9),
                                                           wrappers)
    nfev = sum(record["scipy"]["nfev"]) + sum(record.get("refit_scipy", {}).get("nfev", []))
    # forwards of the postprocess: the refits' recalculation, the refit's own array loss, the final recalculation
    launches_ok, want = deck_fit_launches(launches, nfev, forwards=3, features=2, table_bwd=False)
    misses = pin_misses(final, {k: v for k, (v, _) in IAW_PINS.items()})
    sig = np.stack([final["sigmas"][k] for k in ("electron.Te", "general.Va", "general.amp3", "general.ud")], axis=1)
    refits = record.get("refits", [])
    gates = {"pins": all(m <= IAW_PINS[k][1] for k, v in misses.items() for m in v), "loss": loss < IAW_LOSS_CEILING,
             "refit_slot": [(r["lineout"], r["batch"], r["slot"]) for r in refits] == [(1, 0, 1)],
             "sigmas": sig.shape == (2, 4) and bool(np.isfinite(sig).all() and (sig != 0).all()),
             "lineout0_local_optimum": bool((sig[0] > 0).all()), "launches": launches_ok}
    ok = all(gates.values())
    emit({"phase": "iaw_deck_fit", "lineouts": [int(p) for p in final["lineout pixel"]], "loss": loss,
          "fitted": {k: [float(x) for x in final[k]] for k in IAW_PINS}, "pins_and_rtol": IAW_PINS, "pin_misses": misses,
          "sigmas": {k: [float(x) for x in v] for k, v in final["sigmas"].items()}, "refits": refits, "gates": gates,
          "scipy": record["scipy"], "refit_scipy": record.get("refit_scipy"), "launches": launches, "launches_want": want,
          "seconds": seconds, "stage_seconds": {"setup": record["setup_seconds"], "fit": record["fit_seconds"],
                                                 "refit": record["refit_seconds"], "hessian_cpu_f64": record["recalc_hessian_seconds"],
                                                 "postprocess": record["postprocess_seconds"]},
          "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"iaw_deck_fit: gates {gates}, misses {misses}, sigmas {sig}, launches {launches} (want {want})")
    return launches


def shot_111411_fit(wrappers, smi):
    """``fitter.fit`` on the main deck with test_1d_data_111411.py's changes (shot 111411; Te 0.8, ne 0.5, lam
    526.5): its pins, amplitudes inside (0.1, 3.0), the two lineouts agreeing to 5 % on Te and ne, loss."""
    cfg = load_main_deck()
    cfg["data"]["shotnum"] = 111411
    for group, name, val in (("electron", "Te", 0.8), ("electron", "ne", 0.5), ("general", "lam", 526.5)):
        cfg["parameters"][group][name]["val"] = val
    final, loss, record, launches, seconds = deck_fit(cfg, wrappers)
    launches_ok, want = deck_fit_launches(launches, sum(record["scipy"]["nfev"]), forwards=1)
    misses = pin_misses(final, SHOT_111411_PINS)
    Te, ne = final["Te_electron"][:2], final["ne_electron"][:2]
    gates = {"pins": all(m <= SHOT_111411_RTOL.get(k, 3e-2) for k, v in misses.items() for m in v),
             "amplitudes": all(0.1 < a < 3.0 for k in ("amp1_general", "amp2_general") for a in final[k][:2]),
             "Te_agree": bool(abs(Te[0] - Te[1]) / Te.mean() < 0.05), "ne_agree": bool(abs(ne[0] - ne[1]) / ne.mean() < 0.05),
             "loss": float(np.sum(loss)) < SHOT_111411_LOSS_CEILING, "launches": launches_ok}
    ok = all(gates.values())
    emit({"phase": "shot_111411_fit", "loss": loss, "fitted": {k: [float(x) for x in final[k]] for k in SHOT_111411_PINS},
          "pin_misses": misses, "gates": gates, "scipy": record["scipy"], "launches": launches, "launches_want": want,
          "seconds": seconds, "stage_seconds": {k: record[k] for k in ("setup_seconds", "fit_seconds", "postprocess_seconds")},
          "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"shot_111411_fit: gates {gates}, misses {misses}, launches {launches} (want {want})")
    return launches


def imaging_112059_fit(wrappers, smi):
    """``fitter.fit`` on the main deck with test_imaging_data.py's changes (shot 112059, EPW_CCD; pixels
    500:510:5, adam for 30 epochs, batch 2, ``detailed_breakdown`` on): its loss and pins, and the record's
    breakdown (``spec_comps``, ``IRF``, ``detailed_axis``) finite for every batch and both features."""
    import torch

    from tsadar_tpu_torch.inverse import fitter

    cfg = load_main_deck()
    cfg["data"]["shotnum"] = 112059
    cfg["data"]["lineouts"].update({"type": "pixel", "start": 500, "end": 510, "skip": 5})
    cfg["optimizer"].update({"method": "adam", "num_epochs": 30, "batch_size": 2})
    cfg.setdefault("plotting", {})["detailed_breakdown"] = True
    record = {}
    with on_device(wrappers) as launches:
        t0 = time.perf_counter()
        final, loss = fitter.fit(cfg, record=record)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    steps = cfg["optimizer"]["num_epochs"]
    # per step K1-K6 and both K9 modes; the postprocess's array loss one forward; the breakdown one unreduced
    # forward (K1, K3, K9: its tail is the plain one)
    want = {k: (steps + (1 if k in FORWARD_KERNELS else 0) + (1 if k in BREAKDOWN_KERNELS else 0)) * int(k in REAL_FIT_KERNELS)
            for k in launches}
    fits = record["fits"]
    batches = [tuple(int(i) for i in b) for b in np.reshape(np.arange(len(final["Te_electron"])), (-1, 2))]
    breakdown = {f: all(b in fits[f]["spec_comps"] and bool(np.isfinite(fits[f]["spec_comps"][b]).all())
                        and bool(np.isfinite(fits[f]["detailed_axis"][b]).all()) for b in batches)
                 and bool(np.isfinite(fits[f]["IRF"]).all()) for f in ("ele", "ion")}
    misses = pin_misses(final, IMAGING_PINS)
    gates = {"loss": float(np.asarray(loss).ravel()[0]) < IMAGING_LOSS_CEILING,
             "pins": all(m <= 5e-2 for v in misses.values() for m in v), "breakdown": all(breakdown.values()),
             "launches": launches == want}
    ok = all(gates.values())
    emit({"phase": "imaging_112059_fit", "loss": loss, "fitted": {k: [float(x) for x in final[k]] for k in IMAGING_PINS},
          "pin_misses": misses, "gates": gates, "breakdown_finite": breakdown,
          "spec_comps_shapes": {f: {str(b): list(np.shape(v)) for b, v in fits[f]["spec_comps"].items()} for f in ("ele", "ion")},
          "launches": launches, "launcher_calls": launches.calls, "graph_replays": launches.replays,
          "launches_want": want, "seconds": seconds,
          "stage_seconds": {k: record[k] for k in ("setup_seconds", "fit_seconds", "postprocess_seconds")}, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"imaging_112059_fit: gates {gates}, misses {misses}, launches {launches} (want {want})")
    return launches


def arbitrary_1v():
    """The main deck's 2 real lineouts with ``fe.type: arbitrary`` (``init_m`` 3.0; its pointwise EDF active):
    the forward on the card against the CPU float64 path (FWD_TOL of peak), then loss and gradient
    (``real_data_grad_check``'s limits and float32 rule)."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams
    from tsadar_tpu_torch.inverse.fitter import _lineout_selection
    from tsadar_tpu_torch.utils.process.prepare import prepare_data

    cfg = _lineout_selection(load_main_deck())
    cfg["parameters"]["electron"]["fe"]["type"] = "arbitrary"
    cfg["parameters"]["electron"]["fe"]["params"]["init_m"] = 3.0
    all_data, sa, _ = prepare_data(cfg, cfg["data"]["shotnum"])
    batch = real_batch(all_data)
    spectra = {}
    for device in ("cpu", "cuda"):
        loss_fn = LossFunction(cfg, sa, batch, device=device)
        params = ThomsonParams.create(cfg["parameters"], 2, activate=True, device=device, dtype=loss_fn.ts_diag.dtype)
        with torch.no_grad():
            spectra[device] = loss_fn.ts_diag(params, batch)[0].double().cpu()
    err = float((spectra["cuda"] - spectra["cpu"]).abs().max() / spectra["cpu"].abs().max())
    ok = err <= FWD_TOL and bool(torch.isfinite(spectra["cuda"]).all())
    emit({"phase": "arbitrary_1v_forward", "pixels": list(cfg["data"]["lineouts"]["val"]), "nvx": cfg["parameters"]["electron"]["fe"]["nvx"],
          "max_err_of_peak": err, "tol": FWD_TOL, "ok": ok})
    if not ok:
        raise RuntimeError(f"arbitrary_1v: the forward on the card misses the CPU float64 path by {err:.3e} of peak")
    pixels = cfg["data"]["lineouts"]["val"]
    real_data_grad_check(*lineouts_of(cfg, sa, all_data, pixels), "arbitrary_1v_grad_check", f32_rule=True, pixels=list(pixels))


# ---------------------------------------------------------------- the normal entry point: the CLI and the runner

SERIES_TOL = 5e-3  # of each spectrum's peak: float32 on the card against the CPU float64 series
SERIES_F32_RATIO = 2.0  # ... or this many times the CPU float32 plain forms' own miss, where that is larger
WHOLE_SHOT = {"start": 300, "end": 812, "skip": 4}  # e2e_whole_shot.py's lineouts: 128, one batch
WHOLE_SHOT_OPTIMIZER = {"method": "adam", "num_epochs": 200, "learning_rate": 2e-2, "batch_size": 128}
WHOLE_SHOT_WINDOW = (500, 508)
STAGE_METRICS = ("setup_time", "fit_time", "refitting time", "postprocessing time", "plotting time", "postprocess_time",
                 "total_time")
FIT_METRICS = ("fit_lossfn_init_time", "fit_param_init_time", "fit_first_dispatch_time")  # the adam loop's parts of fit_time
# configs/arts-2d names no flm_type for its spherical-harmonic EDF, and both packages need one: the f1 of
# tests/configs/arts2d_test_inputs.yaml (Mora-Yahi) completes it
ARTS_FE_PARAMS = {"flm_type": "mora-yahi", "LTx": 225000.0, "LTy": 400000.0}


def write_decks(directory, defaults, inputs):
    directory.mkdir(parents=True, exist_ok=True)
    for name, deck in (("defaults", defaults), ("inputs", inputs)):
        (directory / f"{name}.yaml").write_text(yaml.safe_dump(deck))
    return directory


def run_of(runs_dir, run_id):
    """(the run's directory, its run.json) under a tracker root."""
    (run_dir,) = [p.parent for p in Path(runs_dir).rglob("run.json") if p.parent.name.endswith(run_id)]
    return run_dir, json.loads((run_dir / "run.json").read_text())


def metric(meta, name):
    return meta["metrics"][name][-1]["value"]


def jax_figure_names(artifacts):
    """The figures under ``plots/`` that the JAX package draws for a run whose other files are these (its
    ``plotters``' rules): the series overplot of a forward run; an ARTS image and its fit, the fit window's
    two panels where its ``.nc`` is, the fit's rows and the EDF where its file is; for a 1D fit, each loaded
    feature's data and fit, best and worst lineouts and two-panel image where its ``.nc`` is, the loss
    histograms and one figure a fitted parameter (a column ``{parameter}_{species}`` of the CSV)."""
    import csv

    binary, table = Path(artifacts) / "binary", Path(artifacts) / "csv" / "learned_parameters.csv"
    names = set()
    if (binary / "electron_data.npz").exists() or (binary / "ion_data.npz").exists():
        names.add("simulated_data.png")
    if (binary / "angular_fit_and_data.npz").exists():
        names |= {"angular_data_vs_fit.png"} | ({"fit_and_data.png"} if (binary / "fit_and_data.nc").exists() else set())
        names |= {"angular_lineouts.png"} if table.exists() else set()
    elif table.exists():
        with open(table) as f:
            columns = next(csv.reader(f))[1:]
        names |= {"loss_histograms.png"} | {"{1}_{0}.png".format(*c.rsplit("_", 1)) for c in columns if "_" in c}
    if (binary / "distribution_function.npz").exists():
        names.add("distribution_function.png")
    for sp in ("ele", "ion"):
        if (binary / f"{sp}_fit_and_data.npz").exists():
            names |= {f"{sp}_data_vs_fit.png", f"best_{sp}_lineouts.png", f"worst_{sp}_lineouts.png"}
            names |= {f"fit_and_data_{sp}.png"} if (binary / f"{sp}_fit_and_data.nc").exists() else set()
    return {f"plots/{n}" for n in names}


def figures_check(run_dir, meta):
    """The run's ``figures`` tag held to the port's rule (``utils.plotting``): where matplotlib cannot be imported
    (the card's machine), ``not drawn`` with the ImportError naming matplotlib, and no PNG in the run; where it
    can, ``drawn`` and every figure of ``jax_figure_names`` under ``plots/``.  Returns (report, ok)."""
    from tsadar_tpu_torch.utils import plotting

    drawable, reason = plotting.available()
    artifacts = Path(run_dir) / "artifacts"
    tag = meta["tags"].get("figures")
    pngs = sorted(str(p.relative_to(artifacts)) for p in artifacts.rglob("*.png"))
    if drawable:
        missing = sorted(jax_figure_names(artifacts) - set(pngs))
        ok = tag == "drawn" and not missing
    else:
        missing = []
        ok = tag == f"not drawn: {reason}" and "matplotlib" in reason and not pngs
    return {"tag": tag, "matplotlib": drawable, "pngs": len(pngs), "missing": missing}, ok


def csv_columns(path):
    """{column: values} of a CSV in pandas' to_csv layout (index first), numbers as floats."""
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    return {name: np.array([float(r[i]) if r[i] else np.nan for r in rows[1:]]) for i, name in enumerate(rows[0]) if i}


class tracker_root:
    """``TSADAR_RUNS_DIR`` (and the export's staging directory) in a fresh temporary directory while the
    block runs, put back after: the in-process phases leave no run behind for the next."""

    def __enter__(self):
        import os
        import tempfile

        self.tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_runs_")
        self.saved = {k: os.environ.get(k) for k in ("TSADAR_RUNS_DIR", "TSADAR_S3_STAGING_DIR", "MLFLOW_EXPORT")}
        os.environ["TSADAR_RUNS_DIR"] = str(Path(self.tmp.name) / "runs")
        os.environ["TSADAR_S3_STAGING_DIR"] = str(Path(self.tmp.name) / "staging")
        return Path(self.tmp.name)

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self.tmp.cleanup()


# the child of cli_forward_subprocess: the command line as ``python -m tsadar_tpu_torch`` runs it, then the
# launch counts of the kernels named in its first argument, on stderr after LAUNCH_MARK.  The counts start at 0
# with the process, and the forward mode is all the child does.
LAUNCH_MARK = "chip_smoke launches:"
CLI_CHILD = f"""
import json, runpy, sys
names = json.loads(sys.argv.pop(1))
module = sys.argv.pop(1)
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    from tsadar_tpu_torch.utils import trace
    counts = {{k: trace.counters().get(f"ops.launches[{{k}}]", 0) for k in names}}
    print("{LAUNCH_MARK}", json.dumps(counts), file=sys.stderr)
"""


def series_reference(deck, dtype):
    """The spectra of ``configs/<deck>`` from the port's ``forward_pass`` on the CPU in ``dtype`` (outside any
    run)."""
    from tsadar_tpu_torch.forward.calc_series import forward_pass
    from tsadar_tpu_torch.utils.config import merge_configs

    return forward_pass(merge_configs(*deck_pair("configs", deck)), device="cpu", dtype=dtype)


def series_misses(card, ref64, ref32):
    """Each spectrum's miss of the CPU float64 reference as a share of its peak, beside the CPU float32 plain
    forms' own miss and the limit (SERIES_TOL, or SERIES_F32_RATIO times the float32 miss where larger):
    (misses, all within the limit)."""
    peak = np.abs(ref64).max(axis=-1).ravel()
    card_miss = np.abs(card - ref64).max(axis=-1).ravel() / peak
    f32_miss = np.abs(ref32 - ref64).max(axis=-1).ravel() / peak
    limit = np.maximum(SERIES_TOL, SERIES_F32_RATIO * f32_miss)
    return ({"card": card_miss.tolist(), "cpu_f32": f32_miss.tolist(), "limit": limit.tolist()},
            bool((card_miss <= limit).all()))


def cli_forward_subprocess(wrappers, smi):
    """``python -m tsadar_tpu_torch --cfg configs/1d --mode forward`` in a child process from the repository
    root (CLI_CHILD): rc 0; the run's ``binary/electron_data.npz`` and ``ion_data.npz`` each one finite
    spectrum of 1024 points, held to the CPU float64 ``forward_pass`` of the deck as ``cli_series`` holds its
    entries; K1, K3, K5 and K9 launched once per feature in the child, nothing else.  The child loads the
    kernels from ``_build/`` (built above, not rebuilt); its wall seconds hold the interpreter's start, the
    imports and the kernels' loading."""
    import os

    import torch

    names = json.dumps(list(wrappers))
    with tracker_root() as tmp:
        env = dict(os.environ)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", CLI_CHILD, names, "tsadar_tpu_torch", "--cfg", "configs/1d", "--mode", "forward"],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        marks = [ln for ln in out.stderr.splitlines() if ln.startswith(LAUNCH_MARK)]
        launches = json.loads(marks[-1][len(LAUNCH_MARK):]) if marks else None
        card, meta, figures, ok = {}, None, None, out.returncode == 0
        if ok:
            (run_dir,) = [p.parent for p in (tmp / "runs").rglob("run.json")]
            for feature in ("electron", "ion"):
                card[feature] = np.load(run_dir / "artifacts" / "binary" / f"{feature}_data.npz", allow_pickle=True)["Sim"]
                ok = ok and card[feature].shape == (1, 1, 1024) and bool(np.isfinite(card[feature]).all())
            meta = json.loads((run_dir / "run.json").read_text())
            figures, figures_ok = figures_check(run_dir, meta)
            ok = ok and meta["tags"].get("status") == "completed" and figures_ok
    misses = {}
    if ok:
        ref64, ref32 = series_reference("1d", torch.float64), series_reference("1d", torch.float32)
        for i, feature in enumerate(("electron", "ion")):
            misses[feature], within = series_misses(card[feature], ref64[i], ref32[i])
            ok = ok and within
    want = {k: 2 * int(k in FORWARD_KERNELS) for k in wrappers}
    ok = ok and launches == want
    emit({"phase": "cli_forward_subprocess", "rc": out.returncode, "wall_seconds": seconds,
          "shapes": {k: list(v.shape) for k, v in card.items()}, "misses_of_peak": misses, "tol": SERIES_TOL,
          "f32_ratio": SERIES_F32_RATIO, "spectrum_calc_time": metric(meta, "spectrum_calc_time") if meta else None,
          "figures": figures, "launches": launches, "launches_want": want, "stderr_tail": out.stderr[-2000:], "gpu": smi,
          "ok": ok})
    if not ok:
        raise RuntimeError(f"cli_forward_subprocess: rc {out.returncode}, misses {misses}, figures {figures}, launches "
                           f"{launches} (want {want}):\n{out.stderr[-4000:]}")
    return launches


def cli_series(wrappers, smi):
    """``runner.run("configs/1d_series", "series")`` on the card: 7 entries, each sweeping Z of two ion species
    (K5 at its two-species instantiation), Te, Ti and ne.  Each entry's electron and ion spectrum against the
    CPU float64 ``forward_pass`` (SERIES_TOL of its peak, or SERIES_F32_RATIO times the CPU float32 plain
    forms' own miss where larger); K1, K3, K5 and K9 once per entry and feature, nothing else; the ``.nc``
    files equal to the ``.npz``; ``spectrum_calc_time`` in run.json; ms per entry."""
    import torch

    from tsadar_tpu_torch import runner
    from tsadar_tpu_torch.utils.ncwriter import read_dataset

    record = {}
    with tracker_root() as tmp:
        read_and_zero(wrappers)
        run_id = runner.run(str(ROOT / "configs" / "1d_series"), "series", record=record)
        torch.cuda.synchronize()
        launches = read_and_zero(wrappers)
        run_dir, meta = run_of(tmp / "runs", run_id)
        figures, figures_ok = figures_check(run_dir, meta)
        card, nc_equal = {}, {}
        for feature in ("electron", "ion"):
            base = run_dir / "artifacts" / "binary" / f"{feature}_data"
            npz = np.load(base.with_suffix(".npz"), allow_pickle=True)
            card[feature] = npz["Sim"]
            variables, coords = read_dataset(base.with_suffix(".nc"))
            nc_equal[feature] = bool(np.array_equal(variables["Sim"], np.squeeze(npz["Sim"]))
                                     and np.array_equal(coords["Wavelength"], np.squeeze(npz["Wavelength"])))
    entries = card["electron"].shape[0]
    ref64, ref32 = series_reference("1d_series", torch.float64), series_reference("1d_series", torch.float32)
    misses = {}
    ok = entries == 7 and all(nc_equal.values()) and "spectrum_calc_time" in meta["metrics"] and figures_ok
    for i, feature in enumerate(("electron", "ion")):
        misses[feature], within = series_misses(card[feature], ref64[i], ref32[i])
        ok = ok and card[feature].shape == (7, 1, 1024) and bool(np.isfinite(card[feature]).all()) and within
    want = {k: 2 * entries * int(k in FORWARD_KERNELS) for k in launches}
    ok = ok and launches == want
    ms = [1e3 * s for s in record["entry_seconds"]]
    emit({"phase": "cli_series", "entries": entries, "species": 2, "misses_of_peak": misses, "tol": SERIES_TOL,
          "f32_ratio": SERIES_F32_RATIO, "nc_equals_npz": nc_equal, "spectrum_calc_time": metric(meta, "spectrum_calc_time"),
          "ms_per_entry": ms, "median_ms_per_entry": statistics.median(ms), "median_ms_per_entry_after_first": statistics.median(ms[1:]),
          "figures": figures, "launches": launches, "launches_want": want, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"cli_series: misses {misses}, nc {nc_equal}, figures {figures}, launches {launches} (want {want})")
    return launches


def arts_cli_decks():
    """``configs/arts-2d`` as written, with the spherical-harmonic f1 it leaves unnamed (ARTS_FE_PARAMS)."""
    defaults, inputs = deck_pair("configs", "arts-2d")
    inputs["parameters"]["electron"]["fe"]["params"].update(ARTS_FE_PARAMS)
    return defaults, inputs


def cli_forward_arts(wrappers, smi):
    """``runner.run`` of the ARTS deck (``configs/arts-2d``, its f1 completed) in forward mode on the card: one
    full image through the chi tables' layout step and K7, each once; the image within FWD_TOL of its peak of
    the CPU float64 ``forward_pass`` with the card's projection (NUDFT); the angular ``.npz`` and ``.nc``."""
    import torch

    from tsadar_tpu_torch import runner
    from tsadar_tpu_torch.core.physics.form_factor import FormFactor
    from tsadar_tpu_torch.forward.calc_series import forward_pass
    from tsadar_tpu_torch.utils.config import merge_configs

    defaults, inputs = arts_cli_decks()
    with tracker_root() as tmp:
        deck = write_decks(tmp / "arts-2d", defaults, inputs)
        read_and_zero(wrappers)
        t0 = time.perf_counter()
        run_id = runner.run(str(deck), "forward")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_and_zero(wrappers)
        run_dir, meta = run_of(tmp / "runs", run_id)
        figures, figures_ok = figures_check(run_dir, meta)
        binary = run_dir / "artifacts" / "binary"
        files = sorted(p.name for p in binary.iterdir())
        image = np.load(binary / "angular_fit_and_data.npz")["fit"]
    fourier = FormFactor._project_all_fourier
    FormFactor._project_all_fourier = lambda self, vx, DF, betas: self._project_all_nudft(vx, DF)
    try:
        ref = np.squeeze(forward_pass(merge_configs(defaults, inputs), device="cpu")[0])
    finally:
        FormFactor._project_all_fourier = fourier
    err = float(np.abs(image - ref).max() / np.abs(ref).max())
    want = {k: int(k in ARTS_FWD_KERNELS) for k in launches}
    present = {"angular_fit_and_data.npz", "fit_and_data.nc", "distribution_function.npz"} <= set(files)
    ok = (launches == want and present and image.shape == ref.shape and bool(np.isfinite(image).all()) and err <= FWD_TOL
          and figures_ok)
    emit({"phase": "cli_forward_arts", "image": list(image.shape), "max_err_of_peak": err, "tol": FWD_TOL, "files": files,
          "seconds": seconds, "spectrum_calc_time": metric(meta, "spectrum_calc_time"), "figures": figures,
          "launches": launches, "launches_want": want, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"cli_forward_arts: {err:.3e} of peak, files {files}, figures {figures}, launches {launches} "
                           f"(want {want})")
    return launches


def cli_main_deck_fit(wrappers, smi):
    """The main deck through the command line in-process, ``cli.main(["--cfg", dir, "--mode", "fit"])``: the
    deck's two files as written but ``calc_sigmas: true``, with ``MLFLOW_EXPORT`` set.  The CSV's pixels 500
    and 505 within test_1d_data.py's upstream tolerances, ``csv/sigmas.csv`` finite and non-zero,
    ``binary/ele_fit_and_data.nc``, the stage metrics in the tracker, the export's mirror
    (``artifacts/<run_id>/...`` and ``ingest-<run_id>-0.txt`` reading ``ready``), and the launches of
    ``main_deck_fit`` an evaluation (an evaluation is one K6 launch: the postprocess's Hessian runs on the
    CPU)."""
    import os

    import torch

    from tsadar_tpu_torch import cli

    defaults, inputs = main_deck_pair()
    inputs.setdefault("other", {})["calc_sigmas"] = True
    with tracker_root() as tmp:
        deck = write_decks(tmp / "main_deck", defaults, inputs)
        os.environ["MLFLOW_EXPORT"] = "1"
        read_and_zero(wrappers)
        t0 = time.perf_counter()
        run_id = cli.main(["--cfg", str(deck), "--mode", "fit"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_and_zero(wrappers)
        run_dir, meta = run_of(tmp / "runs", run_id)
        art = run_dir / "artifacts"
        table = csv_columns(art / "csv" / "learned_parameters.csv")
        sigmas = csv_columns(art / "csv" / "sigmas.csv")
        bucket = tmp / "staging" / "remote-mlflow-staging"
        marker = bucket / f"ingest-{run_id}-0.txt"
        exported = sorted(str(p.relative_to(bucket / "artifacts" / run_id)) for p in (bucket / "artifacts" / run_id).rglob("*") if p.is_file())
        figures, figures_ok = figures_check(run_dir, meta)
        gates = {"figures": figures_ok, "csv_pixels": table["lineout pixel"].tolist() == [500.0, 505.0],
                 "upstream_tolerances": all(abs(table[k][0] - val) / val <= tol for k, (val, tol) in MAIN_DECK_TRUTH.items()),
                 "sigmas": len(sigmas) == 6 and all(np.isfinite(v).all() and (v != 0).all() and len(v) == 2 for v in sigmas.values()),
                 "nc": (art / "binary" / "ele_fit_and_data.nc").is_file(),
                 "stage_metrics": all(k in meta["metrics"] for k in STAGE_METRICS) and meta["tags"].get("status") == "completed",
                 "export": marker.is_file() and marker.read_text() == "ready" and "run.json" in exported
                 and "artifacts/csv/learned_parameters.csv" in exported and "artifacts/sigmas.nc" in exported}
    nfev = launches["spectrum_tail_bwd"]
    gates["launches"], want = deck_fit_launches(launches, nfev, forwards=1)  # the postprocess's array loss: one forward
    ok = all(gates.values())
    emit({"phase": "cli_main_deck_fit", "fitted": {k: table[k].tolist() for k in MAIN_DECK_TRUTH}, "truth_and_rtol": MAIN_DECK_TRUTH,
          "pin_misses": {k: [abs(g - w) / w for g, w in zip(table[k], MAIN_DECK_PINS[k])] for k in MAIN_DECK_PINS},
          "sigmas": {k: v.tolist() for k, v in sigmas.items()}, "gates": gates, "figures": figures, "exported": exported, "nfev": nfev,
          "stage_seconds": {k: metric(meta, k) for k in STAGE_METRICS}, "seconds": seconds,
          "launches": launches, "launches_want": want, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"cli_main_deck_fit: gates {gates}, launches {launches} (want {want})")
    return launches


def whole_shot_decks():
    """The main deck as ``e2e_whole_shot.py`` sets it up: lineouts 300:812:4 (128), adam, 200 epochs, lr 2e-2,
    one batch of 128, ``calc_sigmas: true``."""
    defaults, inputs = main_deck_pair()
    inputs.setdefault("data", {})["lineouts"] = {"type": "pixel", **WHOLE_SHOT}
    inputs.setdefault("optimizer", {}).update(WHOLE_SHOT_OPTIMIZER)
    inputs.setdefault("other", {})["calc_sigmas"] = True
    return defaults, inputs


def cli_whole_shot_fit(wrappers, smi):
    """The whole-shot fit of shot 101675 with sigmas through ``runner.run`` on the card (``e2e_whole_shot.py``'s
    deck): ``bench_whole_shot.py``'s ``quality_ok`` gates that the run's outputs carry -- Te, ne and m at
    pixels 500-508 read from ``learned_parameters.csv``, the fit's loss (the tracker's ``overall loss``) under
    1e-3, the fit (``fit_time``) under 60 s; its median-lineout gate needs the fit's own row losses, which no
    file of the run holds (``real_data_fit`` keeps that gate), so the postprocess's per-lineout losses are
    reported beside it -- 128 rows, 128 x 6 finite sigmas; every stage's seconds from the tracker, the
    float64 Hessian's own from the record; K1-K6 and both K9 modes once a step, the forward kernels once more
    for the postprocess."""
    import torch

    from tsadar_tpu_torch import runner

    record = {}
    with tracker_root() as tmp:
        deck = write_decks(tmp / "whole_shot", *whole_shot_decks())
        with on_device(wrappers) as launches:
            t0 = time.perf_counter()
            run_id = runner.run(str(deck), "fit", record=record)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        run_dir, meta = run_of(tmp / "runs", run_id)
        figures, figures_ok = figures_check(run_dir, meta)
        table = csv_columns(run_dir / "artifacts" / "csv" / "learned_parameters.csv")
        sigmas = csv_columns(run_dir / "artifacts" / "csv" / "sigmas.csv")
    pix = table["lineout pixel"]
    sel = (pix >= WHOLE_SHOT_WINDOW[0]) & (pix <= WHOLE_SHOT_WINDOW[1])
    at = {k: table[f"{k}_electron"][sel].tolist() for k in REAL_TRUTH}
    sig = np.stack(list(sigmas.values()), axis=1)
    fit_loss, post_losses = metric(meta, "overall loss"), np.asarray(record["losses"])
    gates = {**{k: all(abs(v - val) / val <= tol for v in at[k]) for k, (val, tol) in REAL_TRUTH.items()},
             "covered": int(sel.sum()) > 0, "final_loss": fit_loss < REAL_LOSS_CEILING,
             "fit_time": metric(meta, "fit_time") < REAL_FIT_SECONDS}
    steps = WHOLE_SHOT_OPTIMIZER["num_epochs"]
    want = {k: (steps + int(k in FORWARD_KERNELS)) * int(k in REAL_FIT_KERNELS) for k in launches}
    checks = {"quality_ok": all(gates.values()), "rows": len(pix) == 128, "sigmas": sig.shape == (128, 6) and bool(np.isfinite(sig).all()),
              "launches": launches == want, "figures": figures_ok}
    ok = all(checks.values())
    emit({"phase": "cli_whole_shot_fit", "lineouts": len(pix), "at_pixels_500_508": at, "truth_and_tol": REAL_TRUTH,
          "gates": gates, "quality_ok": all(gates.values()), "checks": checks, "figures": figures, "fit_loss": fit_loss,
          "postprocess_lineout_loss_median": float(np.median(post_losses)), "postprocess_lineout_loss_worst": float(post_losses.max()),
          "sigmas_shape": list(sig.shape), "sigma_median_abs": {k: float(np.median(np.abs(v))) for k, v in sigmas.items()},
          "stage_seconds_tracker": {k: metric(meta, k) for k in STAGE_METRICS + FIT_METRICS},
          "stage_seconds_record": {k: record[k] for k in ("setup_seconds", "fit_seconds", "refit_seconds", "recalc_arrayloss_seconds",
                                                          "recalc_hessian_seconds", "postprocessing_seconds", "artifact_seconds",
                                                          "postprocess_seconds")},
          "hessian_cpu_f64_seconds": record["recalc_hessian_seconds"], "seconds": seconds,
          "launches": launches, "launcher_calls": launches.calls, "graph_replays": launches.replays,
          "launches_want": want, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"cli_whole_shot_fit: checks {checks}, gates {gates}, at 500-508 {at}, launches {launches} (want {want})")
    return launches


# The detected-window fit of shot 112059: what the JAX package's prepare_data detects on this deck
# (tests/test_torch_feature_detector.py::test_prepare_data_detects_the_112059_windows holds these to it and to the
# port on the CPU) -- the lineout range on the EPW CCD's x axis, the blue and red fit windows [nm] to the digits
# given, and the pixels: 61 detected at skip 5, trimmed to 60 for whole batches of 20
DETECTOR_WINDOWS = {"start": -1044.540333, "end": 504.719667, "blue_min": 583.351905, "blue_max": 603.572905,
                    "red_min": 433.771905, "red_max": 459.809905}
DETECTOR_WINDOW_TOL = 5e-7
DETECTOR_PIXELS = list(range(340, 640, 5))
DETECTOR_OPTIMIZER = {"method": "adam", "num_epochs": 30, "batch_size": 20}


def detector_decks():
    """(defaults, inputs) of the detected-window deck: the main deck with test_imaging_data.py's changes as
    ``imaging_112059_fit`` sets them (shot 112059, the pixel lineouts 500:510:5 that the detector replaces, adam
    for 30 epochs, ``detailed_breakdown``), ``feature_detector.estimate_lineouts_epw`` with the deck's buffers of
    20, batches of 20, no sigmas."""
    defaults, inputs = main_deck_pair()
    inputs.setdefault("data", {}).update(shotnum=112059, lineouts={"type": "pixel", "start": 500, "end": 510, "skip": 5})
    inputs.setdefault("optimizer", {}).update(DETECTOR_OPTIMIZER)
    inputs["feature_detector"]["estimate_lineouts_epw"] = True
    inputs.setdefault("plotting", {})["detailed_breakdown"] = True
    inputs["other"]["calc_sigmas"] = False
    return defaults, inputs


def fitted_bounds(cfg):
    """{column of learned_parameters.csv: (lb, ub)} of every active parameter of a 1V deck."""
    bounds = {}
    for species, params in cfg["parameters"].items():
        for name, spec in params.items():
            if not (isinstance(spec, dict) and spec.get("active")):
                continue
            if name == "fe":
                bounds |= {f"{k}_{species}": (v["lb"], v["ub"]) for k, v in spec.get("params", {}).items()
                           if isinstance(v, dict) and "lb" in v}
            elif "lb" in spec:
                bounds[f"{name}_{species}"] = (spec["lb"], spec["ub"])
    return bounds


def detector_112059_fit(wrappers, smi):
    """The fit of shot 112059 whose lineouts and fit windows come from the feature detector, through
    ``runner.run`` from a deck directory (``detector_decks``).  The detector's windows and pixels on this machine
    against the JAX package's (DETECTOR_WINDOWS, DETECTOR_PIXELS; its host seconds inside ``prepare_data``); the
    first batch of 20's loss and gradient against the CPU float64 plain path, float32's own miss held as such
    (``real_data_grad_check``); then the run: K1-K6 and both K9 modes once a step (3 batches x 30 epochs), the
    forward kernels once more a batch for the postprocess's array loss and K1, K3, K9 once more a batch for its
    breakdown; each batch's loss falling; every fitted value finite and inside its bounds; 60 rows of
    ``learned_parameters.csv`` at the detected pixels; ms a step."""
    import torch

    from tsadar_tpu_torch import runner
    from tsadar_tpu_torch.inverse.fitter import _lineout_selection
    from tsadar_tpu_torch.utils.config import merge_configs
    from tsadar_tpu_torch.utils.process import prepare

    decks = detector_decks()
    cfg = _lineout_selection(merge_configs(*copy.deepcopy(decks)))
    detector_seconds, first_guess = [], prepare.first_guess

    def timed_first_guess(*args):
        t0 = time.perf_counter()
        try:
            return first_guess(*args)
        finally:
            detector_seconds.append(time.perf_counter() - t0)

    prepare.first_guess = timed_first_guess
    try:
        t0 = time.perf_counter()
        all_data, sa, _ = prepare.prepare_data(cfg, cfg["data"]["shotnum"])
        prepare_seconds = time.perf_counter() - t0
    finally:
        prepare.first_guess = first_guess
    lineouts, fit_rng = cfg["data"]["lineouts"], cfg["data"]["fit_rng"]
    windows = {"start": lineouts["start"], "end": lineouts["end"], **{k: fit_rng[k] for k in ("blue_min", "blue_max", "red_min", "red_max")}}
    window_misses = {k: abs(float(windows[k]) - v) for k, v in DETECTOR_WINDOWS.items()}
    detected = {"windows": all(m <= DETECTOR_WINDOW_TOL for m in window_misses.values()),
                "pixels": list(lineouts["val"]) == DETECTOR_PIXELS}
    emit({"phase": "detector_112059_windows", "windows": {k: float(v) for k, v in windows.items()}, "pinned": DETECTOR_WINDOWS,
          "misses": window_misses, "tol": DETECTOR_WINDOW_TOL, "pixels": [int(p) for p in lineouts["val"]],
          "detector_host_seconds": detector_seconds[0], "prepare_host_seconds": prepare_seconds, "checks": detected,
          "ok": all(detected.values())})
    if not all(detected.values()):
        raise RuntimeError(f"detector_112059_fit: the detector's output {windows}, pixels {lineouts['val']} is not the "
                           f"JAX package's {DETECTOR_WINDOWS}, {DETECTOR_PIXELS}")
    batch_size = DETECTOR_OPTIMIZER["batch_size"]
    first = DETECTOR_PIXELS[:batch_size]
    real_data_grad_check(*lineouts_of(cfg, sa, all_data, first), "detector_112059_grad_check", f32_rule=True,
                         wrappers=wrappers, pixels=first)

    record = {}
    with tracker_root() as tmp:
        deck = write_decks(tmp / "detector_112059", *decks)
        with on_device(wrappers) as launches:
            t0 = time.perf_counter()
            run_id = runner.run(str(deck), "fit", record=record)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        run_dir, meta = run_of(tmp / "runs", run_id)
        figures, figures_ok = figures_check(run_dir, meta)
        table = csv_columns(run_dir / "artifacts" / "csv" / "learned_parameters.csv")
    batches, epochs = len(DETECTOR_PIXELS) // batch_size, DETECTOR_OPTIMIZER["num_epochs"]
    steps = batches * epochs
    losses = np.asarray(record["adam"]["losses"], float).reshape(batches, epochs)
    bounds = fitted_bounds(cfg)
    outside = {k: int(np.sum(~np.isfinite(table[k]) | (table[k] < lb) | (table[k] > ub))) for k, (lb, ub) in bounds.items()}
    want = {k: (steps + batches * (int(k in FORWARD_KERNELS) + int(k in BREAKDOWN_KERNELS))) * int(k in REAL_FIT_KERNELS)
            for k in launches}
    ms_per_step = 1e3 * sum(record["adam"]["chunk_seconds"]) / steps
    checks = {"rows": len(table["lineout pixel"]) == len(DETECTOR_PIXELS),
              "pixels": table["lineout pixel"].tolist() == [float(p) for p in DETECTOR_PIXELS],
              "finite_in_bounds": not any(outside.values()), "loss_falls": bool((losses[:, -1] < losses[:, 0]).all()),
              "losses_finite": bool(np.isfinite(losses).all()), "launches": launches == want, "figures": figures_ok}
    ok = all(checks.values())
    emit({"phase": "detector_112059_fit", "lineouts": len(table["lineout pixel"]), "batches": batches, "epochs": epochs,
          "figures": figures,
          "batch_first_last_loss": [[float(b[0]), float(b[-1])] for b in losses], "fit_loss": metric(meta, "overall loss"),
          "fitted_median": {k: float(np.median(table[k])) for k in bounds}, "outside_bounds_or_not_finite": outside,
          "checks": checks, "ms_per_step": ms_per_step, "steps": steps, "detector_host_seconds": detector_seconds[0],
          "stage_seconds": {k: record[k] for k in ("setup_seconds", "fit_seconds", "postprocess_seconds")},
          "seconds": seconds, "launches": launches, "launcher_calls": launches.calls, "graph_replays": launches.replays,
          "launches_want": want, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"detector_112059_fit: checks {checks}, outside bounds {outside}, launches {launches} (want {want})")
    return launches


# The ARTS fit through the normal entry point (e2e_arts.py's deck: the ATS image of shot 94475, background slice
# 94477), the 2V deck's pointwise EDF on the same real image, and the multiplexed two-shot loss (shots 94475, 94477)
ARTS_1V_EPOCHS = 200
ARTS_1V_LR = 5e-3
ARTS_1V_DROP = 0.7  # e2e_arts.py's gate: the best epoch loss under this share of the first
ARTS_1V_MIN_EPOCHS = 20  # e2e_arts.py's gate: epochs counted before any early stop
ARTS_1V_CKPT_FREQ = 50
ARTS_RESUME_EPOCHS = 8  # the epochs a resumed fit is asked for beyond its checkpoint
ARTS_REAL_DATA = {"shotnum": 94475, "background": {"type": "Fit", "slice": 94477}}  # the ARTS 1V deck's
ARTS_2V_REAL_EPOCHS = 120
# rmsprop, the deck's method, at a tenth of the deck's lr: at 1e-2 the loss on this image rises from the first step,
# on the card and in float64 on the CPU, in the JAX package's angular_optax as in the port's (0.879 -> 1.87 in 7
# epochs, then the early stop; tests/test_torch_arts_fit.py); at 1e-3 it falls in both
ARTS_2V_REAL_LR = 1e-3
ARTS_2V_NVX = 128
ARTS_HESSIAN_SKIPPED = "{} active parameters exceed the hessian budget (2048)"  # the JAX package's message
MULTIPLEX_SHOTS = [94475, 94477]
MULTIPLEX_ROT = 25.0  # tests/test_inverse/test_multiplex.py's shot_rot
MULTIPLEX_STEPS = 40
MULTIPLEX_LR = 1e-3
ARTS_1V_LOST_TO_F32 = (".general.params.normed['lam']",)  # float32 misses it by ~20 times itself, on the CPU as on the card
ARTS_1V_KERNELS = ("lin_lookup_fwd", "lin_lookup_bwd", "cubic_lookup_fwd", "cubic_lookup_bwd", "pv_tables_fwd", "pv_tables_bwd")
ARTS_1V_STAGES = ("setup_time", "fit_lossfn_init_time", "fit_first_dispatch_time", "fit_time", "postprocessing time",
                  "postprocess_time", "total_time")


def arts_1v_decks(epochs=None, calc_sigmas=True, **optimizer):
    """(defaults, inputs) of the ARTS 1V deck as ``e2e_arts.py:41-52`` sets it: adam at lr 5e-3 for ``epochs``
    epochs, ``calc_sigmas``, the raw-data visualizer off; ``optimizer`` adds to the deck's optimizer."""
    defaults, inputs = (yaml.safe_load((ROOT / "tests" / "configs" / f"arts1v_test_{n}.yaml").read_text())
                        for n in ("defaults", "inputs"))
    inputs.setdefault("optimizer", {}).update(method="adam", num_epochs=epochs or ARTS_1V_EPOCHS, learning_rate=ARTS_1V_LR,
                                              **optimizer)
    inputs.setdefault("other", {})["calc_sigmas"] = calc_sigmas
    inputs.setdefault("data", {})["launch_data_visualizer"] = False
    return defaults, inputs


def arts_2v_real_deck():
    """The ARTS 2V deck (``tests/configs/arts2v_test_defaults.yaml`` + ``arts2d_test_inputs.yaml``) with the EDF
    ``bench_arts.py:33-43`` trains (``Arbitrary2V`` 128 x 128, ``init_m`` 2.5, ``learn_log``), on the ARTS 1V deck's
    real data (its own shots 10007 and 10002 are not in the repository): the deck's CCD, ``ang_res_unit`` 10,
    rmsprop at ARTS_2V_REAL_LR, ARTS_2V_REAL_EPOCHS epochs, ``calc_sigmas``."""
    from tsadar_tpu_torch.utils.config import merge_configs

    cfg = merge_configs(*[yaml.safe_load((ROOT / "tests" / "configs" / n).read_text()) for n in ARTS_2V_DECK])
    cfg["parameters"]["electron"]["fe"].update(type="arbitrary", dim=2, nvx=ARTS_2V_NVX, params={"init_m": 2.5, "learn_log": True})
    cfg["data"].update(copy.deepcopy(ARTS_REAL_DATA), launch_data_visualizer=False)
    cfg["optimizer"].update(num_epochs=ARTS_2V_REAL_EPOCHS, learning_rate=ARTS_2V_REAL_LR)
    cfg["other"]["calc_sigmas"] = True
    return cfg


def angular_window(cfg):
    """The image's lineout window in resolution units, with ``cfg`` changed as ``angular_optax`` changes it."""
    cfg["optimizer"]["batch_size"] = 1
    lineouts, unit = cfg["data"]["lineouts"], cfg["other"]["ang_res_unit"]
    lineouts["start"], lineouts["end"] = int(lineouts["start"] / unit), int(lineouts["end"] / unit)
    return slice(lineouts["start"], lineouts["end"])


def angular_steps(record):
    """(steps run, ms a step after the first chunk, which holds the kernels' first launches) of an angular fit."""
    steps, seconds = record["chunk_steps"], record["chunk_seconds"]
    later = sum(steps[1:])
    return sum(steps), (1e3 * sum(seconds[1:]) / later if later else 1e3 * seconds[0] / steps[0])


def resume_from(tmp, ckpt, latest, wrappers):
    """``python -m tsadar_tpu_torch --cfg DIR --mode fit`` in a child process (CLI_CHILD, no ``--device``): the ARTS
    1V deck from the checkpoint ``latest`` in ``ckpt``, asked for ARTS_RESUME_EPOCHS epochs beyond it, no sigmas.
    Returns (rc 0, the run completed, its epoch losses logged at epochs ``latest`` onward and only for the epochs
    left, K1-K4, K9 and K9ᵀ once an epoch in the child and the forward kernels once more for the postprocess;
    report)."""
    import os

    epochs = latest + ARTS_RESUME_EPOCHS
    deck = write_decks(tmp / f"arts1v_resume_{latest}", *arts_1v_decks(epochs, calc_sigmas=False, checkpoint_dir=str(ckpt),
                                                                        checkpoint_freq=ARTS_1V_CKPT_FREQ))
    names = json.dumps(list(wrappers))
    runs = tmp / "cli_runs"
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CLI_CHILD, names, "tsadar_tpu_torch", "--cfg", str(deck), "--mode", "fit"], cwd=ROOT,
                         env=dict(os.environ, TSADAR_RUNS_DIR=str(runs)), capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    marks = [ln for ln in out.stderr.splitlines() if ln.startswith(LAUNCH_MARK)]
    launches = json.loads(marks[-1][len(LAUNCH_MARK):]) if marks else None
    steps, status, figures, figures_ok = [], None, None, False
    if out.returncode == 0:
        (run_json,) = runs.rglob("run.json")
        meta = json.loads(run_json.read_text())
        steps, status = [m["step"] for m in meta["metrics"].get("epoch loss", [])], meta["tags"].get("status")
        figures, figures_ok = figures_check(run_json.parent, meta)
    want = {k: (ARTS_RESUME_EPOCHS + int(k in FORWARD_KERNELS)) * int(k in ARTS_1V_KERNELS) for k in wrappers}
    ok = (out.returncode == 0 and status == "completed" and steps == list(range(latest, epochs)) and launches == want
          and figures_ok)
    report = {"rc": out.returncode, "status": status, "latest": latest, "asked_epochs": epochs, "epoch_loss_steps": steps,
              "figures": figures, "launches": launches, "launches_want": want, "wall_seconds": seconds,
              "stderr_tail": "" if ok else out.stderr[-3000:]}
    return ok, report


def cli_arts_1v_fit(wrappers, smi):
    """The ARTS 1V fit through ``runner.run`` on the card, as ``e2e_arts.py`` runs it (the ATS image of shot 94475,
    adam at lr 5e-3 for 200 epochs, ``calc_sigmas``), with a checkpoint directory (``checkpoint_freq`` 50).  Gates
    (``e2e_arts.py``'s): ARTS_1V_MIN_EPOCHS epochs counted, the best epoch loss under ARTS_1V_DROP of the first,
    ``binary/sigmas_fe.npz`` finite and not all zero, the image's files and the CSV present; a checkpoint (or, had
    the fit stopped before its first, one from a fit of 8 epochs every 4), and a fit resumed from it through the
    command line in a child process that starts at ``LATEST`` and runs only the epochs left (``resume_from``);
    K1-K4, K9 and K9ᵀ once a step, the forward kernels once more for the postprocess.  The EDF file: a DLM EDF gives the final parameters no ``fe``, so neither package writes one.
    Prints the tracker's stage seconds, the epochs, ms a step and the float64 Hessian's seconds on the host."""
    import torch

    from tsadar_tpu_torch import runner
    from tsadar_tpu_torch.utils.checkpoint import latest_epoch

    t_phase = time.perf_counter()
    record = {}
    with tracker_root() as tmp:
        ckpt = tmp / "ckpt"
        deck = write_decks(tmp / "arts1v", *arts_1v_decks(checkpoint_dir=str(ckpt), checkpoint_freq=ARTS_1V_CKPT_FREQ))
        read_and_zero(wrappers)
        t0 = time.perf_counter()
        run_id = runner.run(str(deck), "fit", record=record)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_and_zero(wrappers)
        run_dir, meta = run_of(tmp / "runs", run_id)
        figures, figures_ok = figures_check(run_dir, meta)
        art = run_dir / "artifacts"
        files = sorted(str(p.relative_to(art)) for p in art.rglob("*") if p.is_file())
        sig = np.load(art / "binary" / "sigmas_fe.npz")["sigmas"]
        table = csv_columns(art / "csv" / "learned_parameters.csv")
        epoch_losses = [m["value"] for m in meta["metrics"]["epoch loss"]]
        latest = latest_epoch(ckpt)
        if latest is None:  # the fit stopped inside its first chunk: a short fit makes the checkpoints
            ckpt = tmp / "ckpt_short"
            short = write_decks(tmp / "arts1v_short", *arts_1v_decks(8, calc_sigmas=False, checkpoint_dir=str(ckpt), checkpoint_freq=4))
            runner.run(str(short), "fit")
            latest = latest_epoch(ckpt)
            read_and_zero(wrappers)
        resumed, resume_report = resume_from(tmp, ckpt, latest, wrappers) if latest is not None else (False, {})
    angular = record["angular"]
    steps, ms_per_step = angular_steps(angular)
    want = {k: (steps + int(k in FORWARD_KERNELS)) * int(k in ARTS_1V_KERNELS) for k in launches}
    gates = {"epochs_counted": len(epoch_losses) >= ARTS_1V_MIN_EPOCHS, "losses_finite": bool(np.isfinite(epoch_losses).all()),
             "loss_drop": min(epoch_losses) < ARTS_1V_DROP * epoch_losses[0],
             "sigmas": sig.shape == (1, 6) and bool(np.isfinite(sig).all()) and bool(np.any(sig != 0)),
             "files": {"binary/angular_fit_and_data.npz", "binary/fit_and_data.nc", "csv/learned_parameters.csv",
                       "binary/sigmas_fe.npz", "binary/sigma-fe.nc"} <= set(files),
             "checkpoint": latest is not None, "resumed": resumed, "launches": launches == want,
             "stage_metrics": all(k in meta["metrics"] for k in ARTS_1V_STAGES), "figures": figures_ok}
    ok = all(gates.values())
    emit({"phase": "cli_arts_1v_fit", "gates": gates, "figures": figures, "epochs_counted": len(epoch_losses), "steps_run": steps,
          "first_epoch_loss": epoch_losses[0], "best_epoch_loss": min(epoch_losses), "last_epoch_loss": epoch_losses[-1],
          "drop_tol": ARTS_1V_DROP, "ms_per_step": ms_per_step, "first_chunk_seconds": angular["chunk_seconds"][0],
          "chunks_seconds": sum(angular["chunk_seconds"]),
          "stage_seconds_tracker": {k: metric(meta, k) for k in ARTS_1V_STAGES if k in meta["metrics"]},
          "hessian_cpu_f64_seconds": record.get("recalc_hessian_seconds"), "seconds": seconds,
          "fitted": {k: v.tolist() for k, v in table.items()}, "sigmas": sig.tolist(), "files": files,
          "checkpoint_latest": latest, "resume": resume_report, "launches": launches, "launches_want": want,
          "launches_per_step": {k: launches[k] / steps for k in ARTS_1V_KERNELS}, "phase_seconds": time.perf_counter() - t_phase,
          "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"cli_arts_1v_fit: gates {gates}, launches {launches} (want {want})")
    return launches


def arts_1v_real_grad_check(wrappers):
    """The ARTS 1V deck's first batch (the window of shot 94475's image at the deck's start values): the card's
    loss and gradient against the port's CPU float64 path with the float32 rule, lam's gradient, which float32
    loses, held to the CPU float32 plain path alone (``real_data_grad_check``), K1-K4, K9 and K9ᵀ once each; then
    those kernels on the operands that the card's forward builds from this batch (``check_lookups_arts_1v``)."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams
    from tsadar_tpu_torch.inverse import fitter
    from tsadar_tpu_torch.utils.config import merge_configs
    from tsadar_tpu_torch.utils.process.batches import angular_batch

    cfg = fitter._lineout_selection(merge_configs(*arts_1v_decks()))
    all_data, sa, _ = fitter.load_data_for_fitting(cfg)
    batch = angular_batch(all_data, angular_window(cfg))
    launches = real_data_grad_check(cfg, sa, batch, "arts_1v_real_grad_check", f32_rule=True,
                                    lost_to_float32=ARTS_1V_LOST_TO_F32, wrappers=wrappers)
    want = {k: int(k in ARTS_1V_KERNELS) for k in launches}
    if launches != want:
        raise RuntimeError(f"arts_1v_real_grad_check: launches {launches} (want {want})")
    loss_fn = LossFunction(cfg, sa, batch, device="cuda")
    params = ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cuda", dtype=loss_fn.ts_diag.dtype, batch=False)
    with torch.no_grad():
        check_lookups_arts_1v(loss_fn.ts_diag.model.electron_form_factor, params, np.random.default_rng(SEED + 11),
                              "arts_1v_real", cfg["other"]["npts"] * len(sa["sa"]))


def arts_2v_real_fit(wrappers, smi):
    """``fitter.fit`` of the ARTS 2V deck's pointwise EDF (``arts_2v_real_deck``: 128 x 128 free values) on shot
    94475's image on the card: rmsprop at ARTS_2V_REAL_LR for ARTS_2V_REAL_EPOCHS epochs, ``calc_sigmas``.  Gates: every
    counted loss finite, the last under the first, the Hessian skipped with the JAX package's message (16 384 active
    parameters against its budget of 2048); the layout step, K7 and K8 once a step, the layout step and K7 once more
    for the postprocess.  Returns (launches, ms a step)."""
    import torch

    from tsadar_tpu_torch.inverse import fitter

    t_phase = time.perf_counter()
    record = {}
    read_and_zero(wrappers)
    t0 = time.perf_counter()
    _, loss = fitter.fit(arts_2v_real_deck(), record=record)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_and_zero(wrappers)
    angular = record["angular"]
    losses = angular["losses"]
    steps, ms_per_step = angular_steps(angular)
    want = {k: (steps + int(k in ARTS_FWD_KERNELS)) * int(k in ARTS_KERNELS) for k in launches}
    gates = {"losses_finite": bool(np.isfinite(losses).all()), "loss_falls": losses[-1] < losses[0],
             "hessian_skipped": record.get("sigma_error") == ARTS_HESSIAN_SKIPPED.format(ARTS_2V_NVX**2),
             "launches": launches == want}
    ok = all(gates.values())
    emit({"phase": "arts_2v_real_fit", "gates": gates, "image": list(np.shape(record["fits"]["ele"])),
          "epochs_counted": len(losses), "steps_run": steps, "first_loss": losses[0], "last_loss": losses[-1],
          "best_loss": min(losses), "ms_per_step": ms_per_step, "sigma_error": record.get("sigma_error"),
          "stage_seconds_record": {k: record[k] for k in ("setup_seconds", "fit_seconds", "postprocess_seconds")},
          "seconds": seconds, "launches": launches, "launches_want": want,
          "launches_per_step": {k: launches[k] / steps for k in ARTS_KERNELS}, "losses_every_10th": losses[::10],
          "phase_seconds": time.perf_counter() - t_phase, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"arts_2v_real_fit: gates {gates}, launches {launches} (want {want})")
    return launches, ms_per_step


def multiplex_profiles(cfg, sa, batch, loss_fn, few=4):
    """Profiles of ``few`` adam steps of the multiplexed loop (``loss_fn`` on both windows) and of the same loop on
    the first window alone, from the deck's start values: (multiplexed, single), each as ``profile_run`` gives it."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams
    from tsadar_tpu_torch.inverse.loops import _angular_loop_

    single_cfg = copy.deepcopy(cfg)
    single_cfg["data"]["shotnum"] = MULTIPLEX_SHOTS[0]
    runs = (("arts_multiplex_profile", cfg, loss_fn, batch),
            ("arts_single_window_profile", single_cfg, LossFunction(single_cfg, sa, batch["b1"]), batch["b1"]))
    out = []
    for phase, step_cfg, fn, b in runs:
        step_cfg = copy.deepcopy(step_cfg)
        step_cfg["optimizer"].update(method="adam", learning_rate=MULTIPLEX_LR, num_epochs=few, save_state=False)
        dev, dtype = fn.ts_diag.device, fn.ts_diag.dtype
        b = fn.device_batch(b)
        _angular_loop_(step_cfg, fn, ThomsonParams.create(step_cfg["parameters"], 1, activate=True, device=dev, dtype=dtype,
                                                          batch=False), b)  # warm: the kernels and tables loaded
        start = ThomsonParams.create(step_cfg["parameters"], 1, activate=True, device=dev, dtype=dtype, batch=False)
        t0 = time.perf_counter()
        _angular_loop_(step_cfg, fn, copy.deepcopy(start), b)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / few
        out.append(profile_run(lambda: _angular_loop_(step_cfg, fn, start, b), few, ms, phase, "step"))
        emit(out[-1])
    return out


def arts_multiplex(wrappers, smi, single_ms_per_step):
    """The multiplexed two-shot fit on ``arts_2v_real_fit``'s deck: shots 94475 and 94477, ``shot_rot`` 25 degrees,
    each shot prepared on its own (``fitter.prepare_multiplexed``: the JAX package's list arm cannot load them), the
    ``{"b1", "b2"}`` windows; the card's loss and ``fval`` gradient against the CPU float64 path
    (``real_data_grad_check``, NUDFT on both), then MULTIPLEX_STEPS adam steps of ``angular_optax`` on the card: every
    loss finite, the last under the first, the layout step, K7 and K8 twice a step; then a profile of a few
    multiplexed steps beside a few steps on the first window alone.  Returns the fit's launches."""
    import torch

    from tsadar_tpu_torch import angular_optax
    from tsadar_tpu_torch.inverse import fitter
    from tsadar_tpu_torch.utils.process.batches import angular_batch

    t_phase = time.perf_counter()
    cfg = arts_2v_real_deck()
    cfg["data"].update(shotnum=list(MULTIPLEX_SHOTS), shot_rot=MULTIPLEX_ROT)
    cfg = fitter._lineout_selection(cfg)
    all_data, sa, _ = fitter.prepare_multiplexed(cfg)
    fit_cfg = copy.deepcopy(cfg)
    window = angular_window(cfg)
    batch = {"b1": angular_batch(all_data, window), "b2": angular_batch(all_data, window, rot=True)}
    check_launches = real_data_grad_check(cfg, sa, batch, "arts_multiplex_grad_check", wrappers=wrappers)

    fit_cfg["optimizer"].update(method="adam", learning_rate=MULTIPLEX_LR, num_epochs=MULTIPLEX_STEPS, save_state=False)
    record = {}
    read_and_zero(wrappers)
    _, _, loss_fn = angular_optax(fit_cfg, all_data, sa, record=record)
    torch.cuda.synchronize()
    launches = read_and_zero(wrappers)
    profiles = multiplex_profiles(cfg, sa, batch, loss_fn)
    losses = record["losses"]
    steps, ms_per_step = angular_steps(record)
    want = {k: 2 * steps * int(k in ARTS_KERNELS) for k in launches}
    gates = {"losses_finite": bool(np.isfinite(losses).all()), "loss_falls": losses[-1] < losses[0],
             "launches": launches == want, "check_launches": check_launches == {k: 2 * int(k in ARTS_KERNELS) for k in launches}}
    ok = all(gates.values())
    emit({"phase": "arts_multiplex", "gates": gates, "shots": MULTIPLEX_SHOTS, "shot_rot": MULTIPLEX_ROT,
          "images": [list(all_data["e_data"].shape), list(all_data["e_data_rot"].shape)], "window": [window.start, window.stop],
          "lr": MULTIPLEX_LR, "epochs_counted": len(losses), "steps_run": steps, "first_loss": losses[0], "last_loss": losses[-1],
          "ms_per_step": ms_per_step, "single_image_ms_per_step": single_ms_per_step,
          "ms_per_step_ratio_to_single": ms_per_step / single_ms_per_step,
          "profiled_ratio_to_single": {k: profiles[0][k] / profiles[1][k] if profiles[1][k] else None
                                       for k in ("step_ms", "device_ms_per_step", "kernel_launches_per_step")},
          "launches": launches, "launches_want": want,
          "launches_per_step": {k: launches[k] / steps for k in ARTS_KERNELS}, "phase_seconds": time.perf_counter() - t_phase,
          "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"arts_multiplex: gates {gates}, launches {launches} (want {want})")
    return launches


# (source, the TPU kernel it replaces, which of the repo's ten TPU kernels); K9's transposed mode and
# K10's table cotangent have no TPU kernel of their own: they stand beside the kernel they belong to

# ----------------------------------------------------------------------------------------- the twelfth slice's paths

ROTATE_PROJ_TOL = 5e-4  # of the projections' scale: tests/test_physics/test_form_factor.py::test_nudft_projection_matches_rotation
ROTATE_FIT_STEPS = 20
EXACT_SAMPLE = 2048  # the deck's own points at which the card's exact chi values meet the CPU float64 ones
EXACT_CHI_TOL = 1e-3  # of each chi output's largest entry over those points (or 2x the CPU float32 miss, where larger)
CHI_NAMES = ("fe_vphi", "chiEI", "chiERrat")
# tests/test_physics/test_form_factor.py::test_2v_table_matches_exact's bound on the two modes' gap (its
# bi-Maxwellian, nv 64): on this deck the gap exceeds it at the resonance points in float64, in both packages
# (ROADMAP.md §3), so the full width reports it, and the cut axis holds the card's gap to the CPU float64 one
EXACT_TABLE_RTOL, EXACT_TABLE_ATOL = 2e-2, 2e-3
# the wavelength axis of the exact mode's loss and gradient check against the CPU float64 exact mode: every one of
# the deck's 241 x npts points rotates the whole 128 x 128 EDF, and the CPU oracle's forward and recomputed backward
# would take many minutes at the deck's 1024 wavelengths (246 784 points).  8 wavelengths (1928 points, ~17 s on 8
# host cores) keep every angle and the EDF; at 2 nm spacing, 556-570 nm, so that the spectral response's 0.9 nm
# Gaussian keeps a sample within half a spacing of its centre (over the deck's 400-700 nm it has none, and the
# response's normalization divides zero by zero)
EXACT_CUT_NPTS, EXACT_CUT_RANGE = 8, [556.0, 570.0]
SPH_L2_FAMILIES = ("nn", "arbitrary")
SPH_L2_SEED = 12
ARTS_OPTIMIZER_EPOCHS = 3
# what fails on the ARTS 1V deck in the JAX loop too: sm3 on its 0-d leaves, and the two that need the loss value
FAILING_OPTIMIZERS = ("sm3", "lbfgs", "polyak_sgd")
NEW_OPTIMIZERS = ("noisy_sgd", "optimistic_adam", "optimistic_adam_v2", "optimistic_gradient_descent", "rprop",
                  "sign_sgd", "sm3", "adadelta", "adafactor", "adamaxw", "adan", "fromage", "lamb", "lars", "novograd",
                  "nadamw")


def synthetic_window(cfg, target):
    """The angular loss's batch of the synthetic ARTS deck: the lineout window of ``arts_fit_data`` (``target`` a
    CPU tensor)."""
    from tsadar_tpu_torch.utils.process.batches import angular_batch

    lineouts = cfg["data"]["lineouts"]
    return angular_batch(arts_fit_data(cfg, target), slice(lineouts["start"], lineouts["end"]))


def arts_2v_rotate(wrappers, smi):
    """The ARTS 2V deck at full width (``load_arts_deck``: ``Arbitrary2V`` 128 x 128, 1024 x 241 points,
    ``num_beta`` 256) with ``projection="rotate"``: the card's 256 rotate projections against its NUDFT ones
    (ROTATE_PROJ_TOL of their scale); the forward (the layout step and K7 once) against the CPU float64 rotate
    forward (FWD_TOL of peak); loss and gradient with respect to the 16 384 EDF values against the CPU float64 path
    (``real_data_grad_check``: K7′, K7, K8 once each); ROTATE_FIT_STEPS adam steps (``_angular_loop_`` at
    ARTS_FIT_LR, the chi kernels once a step) with a falling loss.  Returns the fit's launches."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams
    from tsadar_tpu_torch.inverse.loops import _angular_loop_

    cfg, sas = load_arts_deck()
    batch = arts_batch(cfg)
    diag, params = arts_models(cfg, sas, None, projection="rotate")
    ff = diag.model.electron_form_factor
    with torch.no_grad():
        phys = params()
        vx, DF = phys["electron"]["v"], phys["electron"]["fe"]
        rot, nudft = ff._chi_tables(vx, DF)[1], ff._project_all_nudft(vx, DF)
        proj_err = float((nudft - rot).abs().max() / rot.abs().max())
        read_and_zero(wrappers)
        ThryE = diag(params, batch)[0]
        torch.cuda.synchronize()
        fwd_launches = read_and_zero(wrappers)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            diag(params, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        diag_cpu, params_cpu = arts_models(cfg, sas, "cpu", projection="rotate")
        ref = diag_cpu(params_cpu, batch)[0]
        fwd_err = float((ThryE.double().cpu() - ref).abs().max() / ref.abs().max())
    read_and_zero(wrappers)
    window = synthetic_window(cfg, ref)
    grad_launches = real_data_grad_check(cfg, sas, window, "arts_2v_rotate_grad_check", wrappers=wrappers, projection="rotate")

    fit_cfg = copy.deepcopy(cfg)
    fit_cfg["optimizer"].update(method="adam", learning_rate=ARTS_FIT_LR, num_epochs=ROTATE_FIT_STEPS, chunk_size=10)
    window = synthetic_window(fit_cfg, ref)
    loss_fn = LossFunction(fit_cfg, sas, window)
    loss_fn.ts_diag.model.electron_form_factor.projection = "rotate"
    start = ThomsonParams.create(fit_cfg["parameters"], 1, activate=True, device=loss_fn.ts_diag.device,
                                 dtype=loss_fn.ts_diag.dtype, batch=False)
    record = {}
    read_and_zero(wrappers)
    _angular_loop_(fit_cfg, loss_fn, start, window, record=record)
    torch.cuda.synchronize()
    fit_launches = read_and_zero(wrappers)
    losses = record["losses"]
    steps, step_ms = angular_steps(record)
    ok = (proj_err <= ROTATE_PROJ_TOL and fwd_err <= FWD_TOL and bool(torch.isfinite(ThryE).all())
          and fwd_launches == {k: int(k in ARTS_FWD_KERNELS) for k in wrappers}
          and grad_launches == {k: int(k in ARTS_KERNELS) for k in wrappers}
          and fit_launches == {k: steps * int(k in ARTS_KERNELS) for k in wrappers}
          and bool(np.isfinite(losses).all()) and losses[-1] < losses[0])
    emit({"phase": "arts_2v_rotate", "projections": list(rot.shape), "nudft_vs_rotate_of_scale": proj_err,
          "proj_tol": ROTATE_PROJ_TOL, "image": list(ThryE.shape), "max_err_of_peak": fwd_err, "tol": FWD_TOL,
          "forward_ms": statistics.median(times), "forward_times_ms": times, "launches": fwd_launches,
          "grad_launches": grad_launches, "fit_steps": steps, "step_ms": step_ms, "first_loss": losses[0],
          "last_loss": losses[-1], "fit_launches": fit_launches, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"arts_2v_rotate: projections {proj_err:.3e}, forward {fwd_err:.3e}, losses "
                           f"{losses[0]:.4e} -> {losses[-1]:.4e}, launches {fwd_launches} / {grad_launches} / {fit_launches}")
    return fit_launches


def exact_chi_check(ff, ff_cpu, ff_f32, phys, phys_cpu, rng):
    """The exact mode's ``calc_all_chi_vals`` at EXACT_SAMPLE seeded points of the deck's own (beta, |xi_e|, klde):
    the card against the CPU float64 form factor on the same (float32) queries, within EXACT_CHI_TOL of each
    output's largest entry, or (computed only then) twice the CPU float32 form factor's own miss:
    ({output: (card miss, float32 miss or None)}, within the limits)."""
    import torch

    f = ff._fields_2v(phys)
    idx = torch.as_tensor(rng.choice(f["beta"].numel(), EXACT_SAMPLE, replace=False), device=f["beta"].device)
    queries = [f[k].reshape(-1)[idx] for k in ("beta", "xie_mag", "klde_mag")]
    card = ff.calc_all_chi_vals(phys["electron"]["v"], phys["electron"]["fe"], *queries)
    ref = ff_cpu.calc_all_chi_vals(phys_cpu["electron"]["v"], phys_cpu["electron"]["fe"], *[q.double().cpu() for q in queries])
    misses = {n: float((c.double().cpu() - r).abs().max() / r.abs().max()) for n, c, r in zip(CHI_NAMES, card, ref)}
    f32 = None
    if max(misses.values()) > EXACT_CHI_TOL:
        f32 = ff_f32.calc_all_chi_vals(phys_cpu["electron"]["v"].float(), phys_cpu["electron"]["fe"].float(),
                                       *[q.float().cpu() for q in queries])
        f32 = {n: float((w.double() - r).abs().max() / r.abs().max()) for n, w, r in zip(CHI_NAMES, f32, ref)}
    ok = all(m <= EXACT_CHI_TOL or (f32 is not None and m <= GRAD_F32_RATIO * f32[n]) for n, m in misses.items())
    return {n: (m, f32[n] if f32 else None) for n, m in misses.items()}, ok


def arts_2v_exact(wrappers, smi):
    """The ARTS 2V deck at full width in ``mode_2v="exact"`` (Q = 246 784 points, each rotating the 128 x 128
    EDF; plain tensor code, no kernel): the chi values at EXACT_SAMPLE of the deck's points against the CPU float64
    exact mode (``exact_chi_check``); one forward and one ``value_and_grad`` of the image's loss, timed on the host
    clock, with ``torch.cuda.max_memory_allocated``; the card's exact ``calc_in_2D`` against its table mode
    (EXACT_TABLE_RTOL relative, EXACT_TABLE_ATOL of peak); the loss and gradient against the CPU float64 exact mode
    on the cut wavelength axis EXACT_CUT_NPTS, EXACT_CUT_RANGE (``real_data_grad_check``).  No chi kernel
    launches."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams
    from tsadar_tpu_torch.core.physics.form_factor import FormFactor

    cfg, sas = load_arts_deck()
    batch = arts_batch(cfg)
    diag, params = arts_models(cfg, sas, None, mode_2v="exact")
    table_diag, _ = arts_models(cfg, sas, None)
    ff = diag.model.electron_form_factor
    cpu_diag, params_cpu = arts_models(cfg, sas, "cpu", mode_2v="exact")
    ff32 = FormFactor(cfg["other"]["lamrangE"], cfg["other"]["npts"], cfg["data"]["ele_lam_shift"], sas, 1, "cpu",
                      torch.float32, ud_ang=ff.ud_angle, va_ang=ff.va_angle, mode="exact")
    with torch.no_grad():
        phys, phys_cpu = params(), params_cpu()
        chi_misses, chi_ok = exact_chi_check(ff, cpu_diag.model.electron_form_factor, ff32, phys, phys_cpu,
                                             np.random.default_rng(SEED + 12))
        read_and_zero(wrappers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ThryE = diag(params, batch)[0]
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        forward_peak = torch.cuda.max_memory_allocated()
        launches = read_and_zero(wrappers)
        exact = ff.calc_in_2D(phys)[0]
        table = table_diag.model.electron_form_factor.calc_in_2D(phys)[0]
        beyond = (table - exact).abs() > EXACT_TABLE_RTOL * exact.abs() + EXACT_TABLE_ATOL * exact.abs().max()
        table_miss = float(((table - exact).abs() / exact.abs().max()).max())
        read_and_zero(wrappers)  # the table mode's K7′ and K7
    window = synthetic_window(cfg, 0.9 * ThryE.double().cpu())
    loss_fn = LossFunction(cfg, sas, window, mode_2v="exact")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (value, _), grads = loss_fn.value_and_grad(params, loss_fn.device_batch(window))
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    vg_peak = torch.cuda.max_memory_allocated()
    grads_finite = all(bool(torch.isfinite(g).all()) for g in grads.values()) and math.isfinite(float(value))
    launches_vg = read_and_zero(wrappers)

    cut = copy.deepcopy(cfg)
    cut["other"]["npts"] = EXACT_CUT_NPTS
    cut["other"]["CCDsize"] = [cfg["other"]["CCDsize"][0], EXACT_CUT_NPTS]
    cut["other"]["lamrangE"] = EXACT_CUT_RANGE
    t0 = time.perf_counter()
    rows = cut["data"]["lineouts"]["end"] - cut["data"]["lineouts"]["start"]
    cut_launches = real_data_grad_check(cut, sas, synthetic_window(cut, torch.ones((rows, EXACT_CUT_NPTS))), "arts_2v_exact_grad_check",
                                        wrappers=wrappers, mode_2v="exact", npts=EXACT_CUT_NPTS, lamrangE=EXACT_CUT_RANGE,
                                        points=EXACT_CUT_NPTS * len(sas["sa"]))
    cut_s = time.perf_counter() - t0
    # the two modes on the cut axis: the card's exact forward against the CPU float64 one, and the card's gap
    # between the modes against the CPU float64 gap, each within FWD_TOL of the float64 exact spectrum's peak
    with torch.no_grad():
        spectra = {}
        for device in (None, "cpu"):
            for mode in ("exact", "table"):
                d, p = arts_models(cut, sas, device, mode_2v=mode)
                spectra[device, mode] = d.model.electron_form_factor.calc_in_2D(p())[0].double().cpu()
        read_and_zero(wrappers)
    peak = float(spectra["cpu", "exact"].abs().max())
    cut_exact_miss = float((spectra[None, "exact"] - spectra["cpu", "exact"]).abs().max()) / peak
    gap_card, gap_cpu = (spectra[d, "table"] - spectra[d, "exact"] for d in (None, "cpu"))
    cut_gap_miss = float((gap_card - gap_cpu).abs().max()) / peak
    none = {k: 0 for k in wrappers}
    ok = (chi_ok and cut_exact_miss <= FWD_TOL and cut_gap_miss <= FWD_TOL and grads_finite
          and bool(torch.isfinite(ThryE).all()) and bool(torch.isfinite(exact).all())
          and launches == launches_vg == cut_launches == none)
    emit({"phase": "arts_2v_exact", "points": int(exact.numel()), "image": list(ThryE.shape),
          "chi_misses_of_max_card_f32": chi_misses, "chi_tol": EXACT_CHI_TOL, "sampled_points": EXACT_SAMPLE,
          "forward_s": forward_s, "forward_peak_bytes": forward_peak, "value_and_grad_s": vg_s, "value_and_grad_peak_bytes": vg_peak,
          "loss": float(value), "grads_finite": grads_finite, "exact_vs_table_max_of_peak": table_miss,
          "points_beyond_the_table_bound": int(beyond.sum()), "table_rtol": EXACT_TABLE_RTOL,
          "table_atol_of_peak": EXACT_TABLE_ATOL, "cut_exact_vs_f64_of_peak": cut_exact_miss,
          "cut_table_gap_vs_f64_gap_of_peak": cut_gap_miss, "cut_table_vs_exact_f64_of_peak": float(gap_cpu.abs().max()) / peak,
          "cut_tol": FWD_TOL, "cut_check_s": cut_s, "launches": launches, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"arts_2v_exact: chi {chi_misses}, cut {cut_exact_miss:.3e} / {cut_gap_miss:.3e}, finite "
                           f"{grads_finite}, launches {launches} / {launches_vg} / {cut_launches}")
    return launches_vg


def seeded_edf_state(params, seed):
    """The state of ``params`` with every spherical-harmonic EDF leaf (the order m and each flm module's) moved by
    a seeded draw of 0.05 standard deviations, as float64 numpy, for both devices to load."""
    rng = np.random.default_rng(seed)
    state = {k: v.detach().double().cpu().numpy() for k, v in params.state_dict().items()}
    for k in sorted(state):
        if "distribution_functions" in k and ("flm" in k or "normed_m" in k):
            state[k] = state[k] + 0.05 * rng.standard_normal(state[k].shape)
    return state


def arts_sph_harmonics_l2(wrappers, smi):
    """The spherical-harmonic EDF at ``Nl: 2`` (five flm modules) on the ARTS 2V deck at full width, for
    ``flm_type`` ``nn`` and ``arbitrary``, every EDF leaf moved by one seeded draw (``seeded_edf_state``) on both
    devices: the card's forward (the layout step and K7 once) against the CPU float64 forward (FWD_TOL of peak).
    Returns the launches of the last family."""
    import torch

    out = {}
    for family in SPH_L2_FAMILIES:
        cfg, sas = load_arts_deck(arbitrary=False)
        cfg["parameters"]["electron"]["fe"]["params"].update(flm_type=family, Nl=2)
        batch = arts_batch(cfg)
        diag, params = arts_models(cfg, sas, None)
        diag_cpu, params_cpu = arts_models(cfg, sas, "cpu")
        state = seeded_edf_state(params_cpu, SPH_L2_SEED)
        params.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        params_cpu.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        with torch.no_grad():
            read_and_zero(wrappers)
            ThryE = diag(params, batch)[0]
            torch.cuda.synchronize()
            launches = read_and_zero(wrappers)
            ref = diag_cpu(params_cpu, batch)[0]
        err = float((ThryE.double().cpu() - ref).abs().max() / ref.abs().max())
        n_flm = len(params.electron.distribution_functions.flm)
        ok = (err <= FWD_TOL and n_flm == 5 and bool(torch.isfinite(ThryE).all())
              and launches == {k: int(k in ARTS_FWD_KERNELS) for k in wrappers})
        out[family] = {"flm_modules": n_flm, "max_err_of_peak": err, "launches": launches, "ok": ok}
        if not ok:
            emit({"phase": "arts_sph_harmonics_l2", **out, "tol": FWD_TOL, "ok": False})
            raise RuntimeError(f"arts_sph_harmonics_l2 ({family}): {err:.3e} of peak against {FWD_TOL}, {n_flm} flm, {launches}")
    emit({"phase": "arts_sph_harmonics_l2", "Nl": 2, "seed": SPH_L2_SEED, **out, "tol": FWD_TOL, "gpu": smi, "ok": True})
    return launches


BREAKDOWN_NAMES = ("modlE", "modlI", "ThryE", "ThryI", "eIRF", "iIRF", "lamAxisE", "lamAxisI", "lamAxisE_raw", "lamAxisI_raw")


def breakdown_check(card, f64, f32, tol):
    """Each breakdown output of the card against the CPU float64 breakdown, within ``tol`` of its peak or, where
    float32 itself misses (the ARTS 1V deck's narrow resonance), as float32's own miss: within GRAD_F32_RATIO
    times the CPU float32 breakdown's miss and within F32_TWIN_GRAD_TOL of that breakdown.  The unreduced stacks
    (ThryE, ThryI) have no instrument response to smooth their resonances, whose float32 values move by tens of
    percent of peak under another rounding (the card and the CPU float32 path part by 0.29 of peak on the 2V
    deck's stack, on an H100): they are held to GRAD_F32_RATIO times float32's own miss alone.  eIRF comes
    from a peak search, which picks another peak where float32 rounding reorders two prominences: its rows that
    differ from the float64 ones (by more than ``tol`` of peak) may be at most GRAD_F32_RATIO times as many as the
    CPU float32 breakdown's.  Returns ({output: misses}, all within)."""
    def rows_off(a, b):
        d = (a.double().cpu() - b.double()).abs()
        return int((d.reshape(d.shape[0], -1).amax(dim=1) > tol * float(b.abs().max())).sum()) if d.dim() > 1 else int(bool(d.max() > 0))

    report, ok = {}, True
    for name, c, r, w in zip(BREAKDOWN_NAMES, card, f64, f32):
        scale = max(float(r.abs().max()), 1e-300)
        miss, miss32 = float((c.double().cpu() - r).abs().max()) / scale, float((w.double() - r).abs().max()) / scale
        twin = float((c.double().cpu() - w.double()).abs().max()) / scale
        report[name] = {"vs_f64": miss, "f32_vs_f64": miss32, "vs_f32": twin}
        if name == "eIRF":
            report[name].update(rows_off_f64=rows_off(c, r), f32_rows_off_f64=rows_off(w, r))
            ok = ok and report[name]["rows_off_f64"] <= GRAD_F32_RATIO * report[name]["f32_rows_off_f64"]
        elif name.startswith("Thry"):
            ok = ok and miss <= max(tol, GRAD_F32_RATIO * miss32)
        else:
            ok = ok and (miss <= tol or (miss <= GRAD_F32_RATIO * miss32 and twin <= F32_TWIN_GRAD_TOL))
    return report, ok


def arts_breakdown(wrappers, smi):
    """``spectrum_breakdown`` of an ``angular_full`` image on the card against the CPU breakdown in float64 and in
    float32 (``breakdown_check``): the ARTS 2V deck at full width (every device projecting by NUDFT; FWD_TOL of
    peak; the layout step and K7 once each) and the ARTS 1V deck's real window (shot 94475; K1, K3, K9 once
    each; float32 limits that deck, and its image is held as float32's own miss).  Returns the 1V breakdown's
    launches."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams
    from tsadar_tpu_torch.inverse import fitter
    from tsadar_tpu_torch.utils.config import merge_configs
    from tsadar_tpu_torch.utils.process.batches import angular_batch

    cfg, sas = load_arts_deck()
    batch = arts_batch(cfg)
    out = {}
    for name, device, dtype in (("card", None, None), ("f64", "cpu", None), ("f32", "cpu", torch.float32)):
        diag, params = arts_models(cfg, sas, device, dtype)
        read_and_zero(wrappers)
        out[name] = diag.spectrum_breakdown(params, batch)
        if name == "card":
            torch.cuda.synchronize()
            launches_2v = read_and_zero(wrappers)
    report_2v, ok_2v = breakdown_check(out["card"], out["f64"], out["f32"], FWD_TOL)

    cfg1 = fitter._lineout_selection(merge_configs(*arts_1v_decks()))
    all_data, sa, _ = fitter.load_data_for_fitting(cfg1)
    window = angular_batch(all_data, angular_window(cfg1))
    out = {}
    for name, device, dtype in (("card", None, None), ("f64", "cpu", None), ("f32", "cpu", torch.float32)):
        loss_fn = LossFunction(cfg1, sa, window, device=device, dtype=dtype)
        p = ThomsonParams.create(cfg1["parameters"], 1, activate=True, device=loss_fn.ts_diag.device,
                                 dtype=loss_fn.ts_diag.dtype, batch=False)
        read_and_zero(wrappers)
        out[name] = loss_fn.ts_diag.spectrum_breakdown(p, window)
        if name == "card":
            torch.cuda.synchronize()
            launches_1v = read_and_zero(wrappers)
    report_1v, ok_1v = breakdown_check(out["card"], out["f64"], out["f32"], FWD_TOL)
    image_vs_f32 = float((out["card"][0].cpu() - out["f32"][0]).abs().max() / out["f64"][0].abs().max())
    ok = (ok_2v and ok_1v
          and launches_2v == {k: int(k in ARTS_FWD_KERNELS) for k in wrappers}
          and launches_1v == {k: int(k in BREAKDOWN_KERNELS) for k in wrappers})
    emit({"phase": "arts_breakdown", "arts_2v": report_2v, "tol": FWD_TOL, "arts_2v_launches": launches_2v,
          "arts_1v_window": list(np.shape(window["e_data"])), "arts_1v": report_1v, "arts_1v_image_vs_plain_f32_of_peak":
          image_vs_f32, "f32_ratio": GRAD_F32_RATIO, "plain_f32_tol": F32_TWIN_GRAD_TOL, "arts_1v_launches": launches_1v,
          "shapes_1v": [list(np.shape(a)) for a in out["card"]], "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"arts_breakdown: 2V {report_2v}, 1V {report_1v} (image {image_vs_f32:.3e}), "
                           f"launches {launches_2v} / {launches_1v}")
    return launches_1v


def arts_optimizers(wrappers, smi):
    """Each optimizer this slice ported (NEW_OPTIMIZERS) takes ARTS_OPTIMIZER_EPOCHS epochs of the ARTS 1V real-data
    fit (shot 94475's window) through ``angular_optax`` on the card: finite losses that change (the parameters moved),
    finite best parameters, K1-K4, K9 and K9ᵀ once a step.  ``sm3`` fails on this deck's 0-d leaves, in optax too;
    ``lbfgs`` and ``polyak_sgd`` fail where the JAX loop does.  Returns the launches of all the fits together."""
    import torch

    from tsadar_tpu_torch import angular_optax
    from tsadar_tpu_torch.inverse import fitter
    from tsadar_tpu_torch.utils.config import merge_configs

    base = fitter._lineout_selection(merge_configs(*arts_1v_decks(epochs=ARTS_OPTIMIZER_EPOCHS, calc_sigmas=False)))
    all_data, sa, _ = fitter.load_data_for_fitting(base)
    report, failures, total = {}, [], {k: 0 for k in wrappers}
    read_and_zero(wrappers)
    for method in NEW_OPTIMIZERS + FAILING_OPTIMIZERS[1:]:
        cfg = copy.deepcopy(base)
        cfg["optimizer"].update(method=method, chunk_size=ARTS_OPTIMIZER_EPOCHS)
        record = {}
        t0 = time.perf_counter()
        try:
            best, _, _ = angular_optax(cfg, all_data, sa, record=record)
            torch.cuda.synchronize()
        except (ValueError, TypeError) as e:
            report[method] = {"raised": f"{type(e).__name__}: {e}"[:200]}
            if method not in FAILING_OPTIMIZERS:
                failures.append(method)
            continue
        finally:
            launches = read_and_zero(wrappers)
            total = {k: total[k] + launches[k] for k in wrappers}
        losses = record["losses"]
        finite = bool(np.isfinite(losses).all()) and all(bool(torch.isfinite(p).all()) for p in best.parameters())
        steps = sum(record["chunk_steps"])
        moved = len(set(losses)) > 1
        report[method] = {"losses": losses, "seconds": time.perf_counter() - t0, "launches": launches}
        if method in FAILING_OPTIMIZERS or not (finite and moved) or launches != {
                k: steps * int(k in ARTS_1V_KERNELS) for k in wrappers}:
            failures.append(method)
    ok = not failures
    emit({"phase": "arts_optimizers", "epochs": ARTS_OPTIMIZER_EPOCHS, "window": list(np.shape(all_data["e_data"])),
          "methods": report, "failures": failures, "launches": total, "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"arts_optimizers: {failures}: {json.dumps({m: report.get(m) for m in failures}, default=str)[:3000]}")
    return total


def run_bo_subprocess(wrappers, smi):
    """``python -m tsadar_tpu_torch.run_bo --cfg DIR --init_points 1 --n_iter 1`` in a child process (CLI_CHILD) on
    the main deck (``tests/configs/time_test_*``, the raw-data visualizer off): rc 0, two tracked runs, each with its
    decks and the status ``completed``, a finite target printed; K1-K6 and both K9 modes launched in the child.
    Returns the child's launches."""
    import os

    names = json.dumps(list(wrappers))
    defaults, inputs = main_deck_pair()
    inputs.setdefault("data", {})["launch_data_visualizer"] = False
    with tracker_root() as tmp:
        cfg_dir = tmp / "bo"
        write_decks(cfg_dir, defaults, inputs)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", CLI_CHILD, names, "tsadar_tpu_torch.run_bo", "--cfg", str(cfg_dir),
                              "--init_points", "1", "--n_iter", "1"], cwd=ROOT, env=dict(os.environ), capture_output=True,
                             text=True, timeout=600)
        seconds = time.perf_counter() - t0
        marks = [ln for ln in out.stderr.splitlines() if ln.startswith(LAUNCH_MARK)]
        launches = json.loads(marks[-1][len(LAUNCH_MARK):]) if marks else None
        runs = sorted(p.parent for p in (tmp / "runs").rglob("run.json"))
        status = [json.loads((r / "run.json").read_text())["tags"].get("status") for r in runs]
        decks_logged = all((r / "artifacts" / "defaults.yaml").exists() for r in runs)
        figures = [figures_check(r, json.loads((r / "run.json").read_text())) for r in runs]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{"target"')]
    best = json.loads(lines[-1]) if lines else None
    ok = (out.returncode == 0 and best is not None and math.isfinite(best["target"]) and len(runs) == 2
          and status == ["completed"] * 2 and decks_logged and launches is not None
          and all(launches[k] > 0 for k in REAL_FIT_KERNELS) and all(f_ok for _, f_ok in figures))
    emit({"phase": "run_bo", "rc": out.returncode, "wall_seconds": seconds, "best": best, "runs": len(runs),
          "status": status, "figures": [f for f, _ in figures], "launches": launches, "stderr_tail": out.stderr[-1500:],
          "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"run_bo: rc {out.returncode}, best {best}, runs {len(runs)} {status}, launches {launches}:\n"
                           f"{out.stderr[-4000:]}")
    return launches


# The multi-GPU sharding (``tsadar_tpu_torch.parallel``): a one-rank NCCL group through torchrun and the command
# line, then two gloo ranks sharing the one card (NCCL refuses two ranks on one device), each fitting half of the
# whole shot's lineouts and then splitting the ARTS 2V deck's chi points
# each step's loss against real_data_fit's loop on the data that the child prepared: the first DIST_EARLY_STEPS to
# DIST_EARLY_RTOL, every one to DIST_ONE_RANK_LOSS_RTOL.  Two 200-step runs of that loop in one process on the same data
# give the same losses for 20 steps and then part, as the card's atomics sum in no fixed order: the phase reports the
# spread between real_data_fit and its own reference run (``card_spread_of_two_runs``)
DIST_EARLY_STEPS = 20
DIST_EARLY_RTOL = 1e-5
DIST_ONE_RANK_LOSS_RTOL = 0.3
DIST_ARTS_STEPS = 20
DIST_MARK = "chip_smoke rank:"
# the child of dist_one_rank_nccl under torchrun: the command line as ``python -m tsadar_tpu_torch`` runs it, with
# fitter.fit's record kept, init_process_group noted and the data that rank 0 prepared written (pickled all_data and
# sa), then (on stderr after DIST_MARK) the rank's kernel launches, collectives, backend and the adam loop's losses
DIST_CLI_CHILD = f"""
import json, os, pickle, runpy, sys
import torch.distributed as dist
names = json.loads(sys.argv.pop(1))
module = sys.argv.pop(1)
prepared_path = sys.argv.pop(1)
group, init = {{}}, dist.init_process_group
def traced(*args, **kwargs):
    init(*args, **kwargs)
    group.update(backend=dist.get_backend(), world=dist.get_world_size())
dist.init_process_group = traced
from tsadar_tpu_torch.inverse import fitter
from tsadar_tpu_torch.parallel import dist as par
captured, fit, prepare = {{}}, fitter.fit, fitter.load_data_for_fitting
fitter.fit = lambda config, device=None, record=None: fit(config, device=device, record=captured)
def noted_prepare(config):
    out = prepare(config)
    with open(prepared_path, "wb") as f:
        pickle.dump(out[:2], f)
    return out
fitter.load_data_for_fitting = noted_prepare
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    from tsadar_tpu_torch.utils import trace
    counts = {{k: trace.counters().get(f"ops.launches[{{k}}]", 0) for k in names}}
    adam = captured.get("adam", {{}})
    print("{DIST_MARK}", json.dumps({{"rank": int(os.environ.get("RANK", "0")), "launches": counts, "collectives": par.COUNTS,
          "group": group, "losses": adam.get("losses"), "chunk_seconds": adam.get("chunk_seconds")}}), file=sys.stderr, flush=True)
"""
# the ranks of dist_two_ranks_whole_shot and dist_arts_2v_points under torchrun: chip_smoke.dist_worker
DIST_WORKER = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.exit(chip_smoke.dist_worker(sys.argv[2], sys.argv[3]))
"""


def kernel_wrappers():
    """{name: the raw kernel wrapper} of every kernel of the port, by the name of the C function it launches (whose
    launches ``ops.build.launch`` counts as ``ops.launches[<name>]``)."""
    from tsadar_tpu_torch.ops import chi_bilinear, cubic_lookup, lin_lookup, pv_tables, spectrum_tail

    return {
        "lin_lookup_fwd": lin_lookup.lin_lookup_fwd,
        "lin_lookup_bwd": lin_lookup.lin_lookup_bwd,
        "cubic_lookup_fwd": cubic_lookup.cubic_lookup_fwd,
        "cubic_lookup_bwd": cubic_lookup.cubic_lookup_bwd,
        "spectrum_tail_fwd": spectrum_tail.spectrum_tail_fwd,
        "spectrum_tail_bwd": spectrum_tail.spectrum_tail_bwd,
        "chi_bilinear_fwd": chi_bilinear.chi_bilinear_fwd,
        "chi_bilinear_pack": chi_bilinear.chi_bilinear_pack,
        "chi_bilinear_bwd": chi_bilinear.chi_bilinear_bwd,
        "pv_tables_fwd": pv_tables.pv_tables_fwd,
        "pv_tables_bwd": pv_tables.pv_tables_bwd,
        "lin_lookup_meta_fwd": lin_lookup.lin_lookup_meta_fwd,
        "lin_lookup_meta_bwd": lin_lookup.lin_lookup_meta_bwd,
    }


def launch_sizes(wrappers):
    """Wrap each raw kernel wrapper in its module so that every launch notes the leading size of its first operand
    (the rows of a 1V kernel, the queries of K7 and K8, the table rows of the layout step): (the wrappers by name,
    {name: [sizes]})."""
    import importlib

    sizes, noted_wrappers = {k: [] for k in wrappers}, {}
    for k, fn in wrappers.items():
        def noted(*args, _fn=fn, _k=k, **kwargs):
            sizes[_k].append(int(args[0].shape[0]))
            return _fn(*args, **kwargs)

        setattr(importlib.import_module(fn.__module__), fn.__name__, noted)
        noted_wrappers[k] = noted
    return noted_wrappers, sizes


def read_sizes(sizes):
    """{name: the distinct sizes noted} and the notes emptied."""
    out = {k: sorted(set(v)) for k, v in sizes.items() if v}
    for v in sizes.values():
        v.clear()
    return out


def same_bits(a, b):
    """Whether two dicts of arrays hold the same keys and, under each, the same bits."""
    return a.keys() == b.keys() and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def dist_one_rank_nccl(wrappers, smi, real_cfg, real_sa, real_all, real_losses):
    """The whole-shot fit of shot 101675 (``real_data_fit``'s: 128 lineouts, 200 adam steps at 2e-2; no sigmas)
    through ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m tsadar_tpu_torch --cfg DIR --mode
    fit`` with ``optimizer.parallel: true`` and ``TSADAR_MULTIHOST=1`` (the hook that starts the process group, here
    a group of one): rc 0, the group NCCL with one rank, collectives called, K1-K6 and both K9 modes 200 times (the
    forward kernels once more for the postprocess), ``bench_whole_shot.py``'s gates read from the run's CSV and
    tracker, and the losses (a world of one is an identity) against ``real_data_fit``'s loop run here on the data
    that the child prepared (scipy's streak-background fit can end in either of two mirror solutions, so two
    processes can prepare different data): the first DIST_EARLY_STEPS to DIST_EARLY_RTOL, every one to
    DIST_ONE_RANK_LOSS_RTOL; the reference runs its steps eagerly, as the sharded child does.  Where the child's
    data are ``real_data_prepare``'s bits, the reference run and ``real_data_fit`` (graphed) are two runs of one fit
    on one input: their largest difference is the card's own spread.
    Returns the child's launches."""
    import os
    import pickle

    from tsadar_tpu_torch import LossFunction
    from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_

    names = json.dumps(list(wrappers))
    defaults, inputs = whole_shot_decks()
    inputs["optimizer"]["parallel"] = True
    inputs["other"]["calc_sigmas"] = False
    with tracker_root() as tmp:
        deck = write_decks(tmp / "dist_one_rank", defaults, inputs)
        child, prepared = tmp / "dist_cli_child.py", tmp / "prepared.pkl"
        child.write_text(DIST_CLI_CHILD)
        env = dict(os.environ, TSADAR_MULTIHOST="1", TSADAR_DIST_TIMEOUT="300",
                   PYTHONPATH=os.pathsep.join(filter(None, (str(ROOT), os.environ.get("PYTHONPATH")))))
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                              str(child), names, "tsadar_tpu_torch", str(prepared), "--cfg", str(deck), "--mode", "fit"],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        marks = [json.loads(ln[len(DIST_MARK):]) for ln in out.stderr.splitlines() if ln.startswith(DIST_MARK)]
        rank = marks[-1] if marks else {}
        runs = [p.parent for p in (tmp / "runs").rglob("run.json")]
        gates, at, meta, figures = {}, {}, None, (None, False)
        if out.returncode == 0 and len(runs) == 1:
            meta = json.loads((runs[0] / "run.json").read_text())
            figures = figures_check(runs[0], meta)
            table = csv_columns(runs[0] / "artifacts" / "csv" / "learned_parameters.csv")
            pix = table["lineout pixel"]
            sel = (pix >= WHOLE_SHOT_WINDOW[0]) & (pix <= WHOLE_SHOT_WINDOW[1])
            at = {k: table[f"{k}_electron"][sel].tolist() for k in REAL_TRUTH}
            gates = {**{k: all(abs(v - val) / val <= tol for v in at[k]) for k, (val, tol) in REAL_TRUTH.items()},
                     "covered": int(sel.sum()) > 0, "rows": len(pix) == N_LINEOUTS,
                     "final_loss": metric(meta, "overall loss") < REAL_LOSS_CEILING,
                     "fit_time": metric(meta, "fit_time") < REAL_FIT_SECONDS}
        child_data = pickle.loads(prepared.read_bytes()) if prepared.exists() else None
    steps = WHOLE_SHOT_OPTIMIZER["num_epochs"]
    launches = rank.get("launches")
    want = {k: (steps + int(k in FORWARD_KERNELS)) * int(k in REAL_FIT_KERNELS) for k in wrappers}
    ref_losses, same_data, spread = [], None, None
    if child_data is not None:
        child_all, child_sa = child_data
        same_data = same_bits(child_all, real_all) and same_bits(child_sa, real_sa)
        batch, record = real_batch(child_all), {}
        fit_cfg = fit_config(real_cfg, N_LINEOUTS, FIT_STEPS)
        with eager_loop():  # the child's sharded loop runs eagerly: the reference takes the same arithmetic
            _1d_adam_loop_(fit_cfg, LossFunction(fit_cfg, child_sa, batch), None, batch, record=record)
        read_and_zero(wrappers)
        ref_losses = record["losses"]
        if same_data:
            spread = float(np.abs(np.asarray(real_losses) / np.asarray(ref_losses) - 1.0).max())
    losses = rank.get("losses") or []
    miss = np.abs(np.asarray(losses) / np.asarray(ref_losses) - 1.0) if ref_losses and len(losses) == len(ref_losses) else None
    loss_miss = float(miss.max()) if miss is not None else math.inf
    early_miss = float(miss[:DIST_EARLY_STEPS].max()) if miss is not None else math.inf
    checks = {"rc": out.returncode == 0, "one_run": len(runs) == 1,
              "nccl": rank.get("group") == {"backend": "nccl", "world": 1},
              "collectives": (rank.get("collectives") or {}).get("all_reduce", 0) > 0, "launches": launches == want,
              "quality_ok": bool(gates) and all(gates.values()), "data_written": child_data is not None,
              "losses": early_miss <= DIST_EARLY_RTOL and loss_miss <= DIST_ONE_RANK_LOSS_RTOL, "figures": figures[1]}
    ok = all(checks.values())
    emit({"phase": "dist_one_rank_nccl", "command": "python -m torch.distributed.run --standalone --nproc_per_node 1 "
          "-m tsadar_tpu_torch --cfg DIR --mode fit", "lineouts": N_LINEOUTS, "steps": steps, "checks": checks,
          "figures": figures[0],
          "gates": gates, "at_pixels_500_508": at, "truth_and_tol": REAL_TRUTH, "group": rank.get("group"),
          "collectives": rank.get("collectives"), "first_loss": losses[0] if losses else None,
          "final_loss": losses[-1] if losses else None, "child_data_same_bits_as_real_data_prepare": same_data,
          "max_rel_loss_miss_of_reference": loss_miss, "loss_rtol": DIST_ONE_RANK_LOSS_RTOL,
          "max_rel_loss_miss_first_steps": early_miss, "first_steps": DIST_EARLY_STEPS,
          "first_steps_rtol": DIST_EARLY_RTOL,
          "rel_loss_miss_at_steps_0_10_20_50_100_199": ([float(miss[i]) for i in (0, 10, 20, 50, 100, 199) if i < len(miss)]
                                                         if miss is not None else None),
          "card_spread_of_two_runs": spread,
          "fit_time": metric(meta, "fit_time") if meta else None, "ms_per_step": (1e3 * sum(rank["chunk_seconds"]) / steps
                                                                                 if rank.get("chunk_seconds") else None),
          "wall_seconds": seconds, "launches": launches, "launches_want": want, "stderr_tail": out.stderr[-1500:],
          "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"dist_one_rank_nccl: checks {checks}, gates {gates}:\n{out.stderr[-4000:]}")
    return launches


def _first_step(loss_fn, cfg, batch, ranks, n):
    """The loss and the gradient (gathered: the whole batch's) at the deck's start values, this rank's rows."""
    from tsadar_tpu_torch import ThomsonParams
    from tsadar_tpu_torch.parallel import dist as par

    local, _ = par.shard_params(cfg, ThomsonParams.create(cfg["parameters"], n, activate=True), ranks)
    with loss_fn.sharded(ranks):
        (value, _), grads = loss_fn.value_and_grad(local, par.shard_batch(batch, ranks))
    return float(value), {k: par.gather_points(g, ranks, n).double().cpu().numpy() for k, g in grads.items()}


def dist_whole_shot_rank(wrappers, sizes, out_dir):
    """One rank of ``dist_two_ranks_whole_shot``: rank 0 prepares shot 101675's 128 lineouts and hands them over,
    each rank takes the first step's loss and gradient on its rows and then fits them (``_1d_adam_loop_`` with the
    ranks: FIT_STEPS adam steps at FIT_LR); its result, and the gradient as ``whole_shot_grads.npz``."""
    import torch

    from tsadar_tpu_torch import LossFunction
    from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_
    from tsadar_tpu_torch.parallel import dist as par
    from tsadar_tpu_torch.utils.process.prepare import prepare_data

    cfg = load_real_deck(*REAL_PIXELS, N_LINEOUTS)
    cfg, (all_data, sa, _) = par.broadcast_object((cfg, prepare_data(cfg, cfg["data"]["shotnum"])) if par.rank() == 0 else None)
    fit_cfg = fit_config(cfg, N_LINEOUTS, FIT_STEPS)
    fit_cfg["optimizer"]["parallel"] = True
    batch = real_batch(all_data)
    loss_fn = LossFunction(fit_cfg, sa, batch)
    ranks = par.fit_group(fit_cfg)
    first_loss, first_grads = _first_step(loss_fn, fit_cfg, batch, ranks, N_LINEOUTS)
    if par.rank() == 0:
        np.savez(Path(out_dir) / "whole_shot_grads.npz", **{k: v for k, v in first_grads.items()})
    torch.cuda.synchronize()
    read_and_zero(wrappers)
    read_sizes(sizes)
    record = {}
    best_loss, best = _1d_adam_loop_(fit_cfg, loss_fn, None, batch, record=record, ranks=ranks)
    torch.cuda.synchronize()
    launches, rows = read_and_zero(wrappers), read_sizes(sizes)
    local, _ = par.shard_params(fit_cfg, best, ranks)
    with torch.no_grad(), loss_fn.sharded(ranks):
        row_loss = loss_fn.__loss__(local, par.shard_batch(batch, ranks))[1][2]
    row_loss = par.gather_points(row_loss, ranks, N_LINEOUTS).double().cpu().numpy()
    fitted = {k: v.detach().double().cpu().numpy().tolist() for k, v in best.get_unnormed_params()["electron"].items()
              if k in REAL_TRUTH}
    return {"rows": ranks.bounds(N_LINEOUTS), "first_loss": first_loss, "launches": launches, "launch_rows": rows,
            "losses": record["losses"], "best_loss": best_loss, "chunk_seconds": record["chunk_seconds"],
            "row_loss": row_loss.tolist(), "fitted": fitted, "pixels": list(cfg["data"]["lineouts"]["val"])}


def dist_arts_rank(wrappers, sizes, out_dir, target_path):
    """One rank of ``dist_arts_2v_points``: the ARTS 2V deck at full width with ``shard_2v_points``, the loss and
    EDF gradient at the deck's start, then DIST_ARTS_STEPS adam steps of ``angular_optax``; its result, and the
    gradient (rank 0) and final EDF as ``arts_2v_rank{r}.npz``."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams, angular_optax
    from tsadar_tpu_torch.core.params import get_filter_spec
    from tsadar_tpu_torch.parallel import dist as par
    from tsadar_tpu_torch.utils.process.batches import angular_batch

    cfg, sas = load_arts_deck()
    cfg["other"]["shard_2v_points"] = True
    cfg["optimizer"].update(method="adam", learning_rate=ARTS_FIT_LR, num_epochs=DIST_ARTS_STEPS, chunk_size=10)
    all_data = arts_fit_data(cfg, torch.from_numpy(np.load(target_path)["target"]))
    lineouts = cfg["data"]["lineouts"]
    batch = angular_batch(all_data, slice(lineouts["start"], lineouts["end"]))
    loss_fn = LossFunction(cfg, sas, batch)
    params = ThomsonParams.create(cfg["parameters"], 1, activate=True, batch=False)
    read_and_zero(wrappers)
    read_sizes(sizes)
    (value, _), grads = loss_fn.value_and_grad(params, batch, get_filter_spec(cfg["parameters"], params))
    (grad,) = grads.values()
    torch.cuda.synchronize()
    first_launches, first_rows = read_and_zero(wrappers), read_sizes(sizes)
    record = {}
    best, _, _ = angular_optax(copy.deepcopy(cfg), all_data, sas, record=record)
    torch.cuda.synchronize()
    launches, rows = read_and_zero(wrappers), read_sizes(sizes)
    fval = best.electron.distribution_functions.fval.detach().cpu().numpy()
    np.savez(Path(out_dir) / f"arts_2v_rank{par.rank()}.npz", fval=fval, grad=grad.double().cpu().numpy())
    return {"first_loss": float(value), "first_launches": first_launches, "first_launch_rows": first_rows,
            "launches": launches, "launch_rows": rows, "losses": record["losses"], "steps": sum(record["chunk_steps"]),
            "chunk_seconds": record["chunk_seconds"], "queries": cfg["other"]["npts"] * len(sas["sa"])}


def dist_worker(out_dir, target_path):
    """A rank of the two-rank phases, started by torchrun: the process group with gloo named (two ranks share the
    one card), then ``dist_whole_shot_rank`` and ``dist_arts_rank``; writes ``rank{r}.json`` into ``out_dir``.  A
    failure raises and ends the rank with a non-zero code (torchrun then stops the other)."""
    import torch

    from tsadar_tpu_torch.parallel import dist as par

    wrappers, sizes = launch_sizes(kernel_wrappers())
    device = par.init_from_env("cuda", backend="gloo")
    try:
        out = {"rank": par.rank(), "world": par.world_size(), "backend": torch.distributed.get_backend(),
               "device": str(device)}
        out["whole_shot"] = dist_whole_shot_rank(wrappers, sizes, out_dir)
        out["arts_2v"] = dist_arts_rank(wrappers, sizes, out_dir, target_path)
        out["collectives"] = dict(par.COUNTS)
        (Path(out_dir) / f"rank{par.rank()}.json").write_text(json.dumps(out))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def dist_two_ranks(smi, arts_target, out_dir):
    """Two ranks on the one card (``python -m torch.distributed.run --standalone --nproc_per_node 2`` of
    DIST_WORKER, gloo named): their results by rank, read from ``out_dir``, and the command's rc and seconds."""
    import os

    np.savez(Path(out_dir) / "arts_target.npz", target=arts_target.numpy())
    child = Path(out_dir) / "dist_worker.py"
    child.write_text(DIST_WORKER)
    env = dict(os.environ, TSADAR_DIST_TIMEOUT="300")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                          str(child), str(ROOT), str(out_dir), str(Path(out_dir) / "arts_target.npz")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    ranks = [json.loads(p.read_text()) for p in sorted(Path(out_dir).glob("rank*.json"))]
    if out.returncode != 0 or len(ranks) != 2:
        emit({"phase": "dist_two_ranks", "rc": out.returncode, "ranks_reporting": len(ranks),
              "stderr_tail": out.stderr[-3000:], "gpu": smi, "ok": False})
        raise RuntimeError(f"the two-rank phases: rc {out.returncode}, {len(ranks)} ranks reported:\n{out.stderr[-4000:]}")
    return ranks, out, seconds


def dist_two_ranks_whole_shot(wrappers, smi, ranks, out, seconds, out_dir, loss_fn, batch, cfg):
    """``dist_two_ranks``' whole-shot half: each of the two gloo ranks fit 64 of the 128 lineouts (K1-K6 and both K9
    modes FIT_STEPS times on each rank, at 64 rows each launch); the first step's loss and gradient against this
    process's single-rank card run (LOSS_TOL, GRAD_TOL of each gradient's largest entry), ``bench_whole_shot.py``'s
    gates on the gathered parameters, the same final loss on both ranks; each rank's ms a step (two processes share
    the card: a number for the record)."""
    import torch

    from tsadar_tpu_torch import ThomsonParams

    params = ThomsonParams.create(cfg["parameters"], N_LINEOUTS, activate=True)
    (value, _), grads = loss_fn.value_and_grad(params, batch)
    ref_loss, ref_grads = float(value), {k: g.double().cpu().numpy() for k, g in grads.items()}
    got = dict(np.load(Path(out_dir) / "whole_shot_grads.npz"))
    ws = [r["whole_shot"] for r in ranks]
    loss_err = abs(ws[0]["first_loss"] - ref_loss) / abs(ref_loss)
    grad_err = {k: float(np.abs(got[k] - ref_grads[k]).max() / np.abs(ref_grads[k]).max()) if k in got else math.inf
                for k in ref_grads}
    pixels = np.asarray(ws[0]["pixels"])
    sel = np.where((pixels >= REAL_WINDOW[0]) & (pixels <= REAL_WINDOW[1]))[0]
    at = {k: [float(v) for v in np.asarray(ws[0]["fitted"][k])[sel]] for k in REAL_TRUTH}
    gates = {k: all(abs(v - truth) / truth <= tol for v in at[k]) for k, (truth, tol) in REAL_TRUTH.items()}
    fit_seconds = [sum(w["chunk_seconds"]) for w in ws]
    gates |= {"covered": len(sel) > 0, "final_loss": ws[0]["losses"][-1] < REAL_LOSS_CEILING,
              "lineout_median": float(np.median(ws[0]["row_loss"])) < REAL_LOSS_CEILING,
              "fit_time": max(fit_seconds) < REAL_FIT_SECONDS}
    half = N_LINEOUTS // 2
    want = {k: FIT_STEPS * int(k in REAL_FIT_KERNELS) for k in wrappers}
    checks = {"gloo_two_ranks": all(r["backend"] == "gloo" and r["world"] == 2 for r in ranks),
              "launches": all(w["launches"] == want for w in ws),
              "rows_64": all(w["launch_rows"] == {k: [half] for k in REAL_FIT_KERNELS} for w in ws),
              "first_loss": loss_err <= LOSS_TOL, "first_grads": all(e <= GRAD_TOL for e in grad_err.values()),
              "quality_ok": all(gates.values()),
              "same_final_loss": ws[0]["best_loss"] == ws[1]["best_loss"] and ws[0]["losses"] == ws[1]["losses"]}
    ok = all(checks.values())
    emit({"phase": "dist_two_ranks_whole_shot", "ranks": 2, "backend": "gloo", "lineouts": N_LINEOUTS,
          "rows_per_rank": [w["rows"] for w in ws], "steps": FIT_STEPS, "checks": checks, "gates": gates,
          "at_pixels_500_510": at, "truth_and_tol": REAL_TRUTH, "first_loss": ws[0]["first_loss"],
          "first_loss_single_rank_card": ref_loss, "first_loss_rel_err": loss_err, "loss_tol": LOSS_TOL,
          "first_grad_err_of_max": grad_err, "grad_tol": GRAD_TOL, "final_loss": [w["losses"][-1] for w in ws],
          "best_loss": [w["best_loss"] for w in ws], "median_lineout_loss": float(np.median(ws[0]["row_loss"])),
          "fit_seconds_per_rank": fit_seconds, "ms_per_step_per_rank": [1e3 * f / FIT_STEPS for f in fit_seconds],
          "launches_per_rank": [w["launches"] for w in ws], "launch_rows_per_rank": [w["launch_rows"] for w in ws],
          "collectives_per_rank": [r["collectives"] for r in ranks], "command_seconds": seconds,
          "stderr_tail": out.stderr[-1000:], "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"dist_two_ranks_whole_shot: checks {checks}, gates {gates}, grads {grad_err}")
    return [w["launches"] for w in ws]


def dist_arts_2v_points(wrappers, smi, ranks, out_dir, arts_cfg, arts_sas, target):
    """``dist_two_ranks``' ARTS half: the 2V deck at full width with ``shard_2v_points`` on two gloo ranks, half of
    its chi points a rank; the loss and EDF gradient at the start against this process's unsharded card run
    (LOSS_TOL, GRAD_TOL), the layout step, K7 and K8 once a step on each rank with K7 and K8 at half the points,
    DIST_ARTS_STEPS adam steps whose loss falls, and the final EDF the same bits on both ranks."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams
    from tsadar_tpu_torch.utils.process.batches import angular_batch

    cfg = copy.deepcopy(arts_cfg)
    all_data = arts_fit_data(cfg, target)
    lineouts = cfg["data"]["lineouts"]
    batch = angular_batch(all_data, slice(lineouts["start"], lineouts["end"]))
    loss_fn = LossFunction(cfg, arts_sas, batch)
    params = ThomsonParams.create(cfg["parameters"], 1, activate=True, batch=False)
    (value, _), grads = loss_fn.value_and_grad(params, batch)
    ref_loss, (ref_grad,) = float(value), [g.double().cpu().numpy() for g in grads.values()]
    del loss_fn
    torch.cuda.empty_cache()
    arts = [r["arts_2v"] for r in ranks]
    npz = [np.load(Path(out_dir) / f"arts_2v_rank{r}.npz") for r in range(2)]
    queries = arts[0]["queries"]
    half = queries // 2
    loss_err = abs(arts[0]["first_loss"] - ref_loss) / abs(ref_loss)
    grad_err = float(np.abs(npz[0]["grad"] - ref_grad).max() / np.abs(ref_grad).max())
    steps = arts[0]["steps"]
    want = {k: steps * int(k in ARTS_KERNELS) for k in wrappers}
    first_want = {k: int(k in ARTS_KERNELS) for k in wrappers}
    rows_ok = all(a["launch_rows"].get("chi_bilinear_fwd") == [half] and a["launch_rows"].get("chi_bilinear_bwd") == [half]
                  and a["first_launch_rows"].get("chi_bilinear_fwd") == [half] for a in arts)
    losses = arts[0]["losses"]
    checks = {"first_loss": loss_err <= LOSS_TOL, "first_grad": grad_err <= GRAD_TOL,
              "first_launches": all(a["first_launches"] == first_want for a in arts),
              "launches": all(a["launches"] == want for a in arts) and steps == DIST_ARTS_STEPS,
              "half_the_points": rows_ok and queries == 2 * half, "loss_falls": losses[-1] < losses[0],
              "finite": bool(np.isfinite(losses).all()) and all(bool(np.isfinite(z["fval"]).all()) for z in npz),
              "same_parameters": bool(np.array_equal(npz[0]["fval"], npz[1]["fval"])) and arts[0]["losses"] == arts[1]["losses"]}
    ok = all(checks.values())
    ms = [1e3 * sum(a["chunk_seconds"]) / a["steps"] for a in arts]
    emit({"phase": "dist_arts_2v_points", "ranks": 2, "backend": "gloo", "queries": queries, "queries_per_rank": half,
          "steps": steps, "lr": ARTS_FIT_LR, "checks": checks, "first_loss": arts[0]["first_loss"],
          "first_loss_unsharded_card": ref_loss, "first_loss_rel_err": loss_err, "loss_tol": LOSS_TOL,
          "first_grad_err_of_max": grad_err, "grad_tol": GRAD_TOL, "first_loss_last_loss": [losses[0], losses[-1]],
          "ms_per_step_per_rank": ms, "launches_per_rank": [a["launches"] for a in arts],
          "launch_rows_per_rank": [a["launch_rows"] for a in arts], "gpu": smi, "ok": ok})
    if not ok:
        raise RuntimeError(f"dist_arts_2v_points: checks {checks}, loss {loss_err:.3e}, grad {grad_err:.3e}")
    return [a["launches"] for a in arts]


KERNELS = {
    "lin_lookup_fwd": ("tsadar_tpu_torch/csrc/lin_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:84", "K1"),
    "lin_lookup_bwd": ("tsadar_tpu_torch/csrc/lin_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:193", "K2"),
    "cubic_lookup_fwd": ("tsadar_tpu_torch/csrc/cubic_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:314", "K3"),
    "cubic_lookup_bwd": ("tsadar_tpu_torch/csrc/cubic_lookup.cu", "tsadar_tpu/ops/interp_kernel2.py:416", "K4"),
    "spectrum_tail_fwd": ("tsadar_tpu_torch/csrc/spectrum_tail.cu", "tsadar_tpu/ops/spectrum_kernel.py:380", "K5"),
    "spectrum_tail_bwd": ("tsadar_tpu_torch/csrc/spectrum_tail_bwd.cu", "tsadar_tpu/ops/spectrum_kernel.py:407", "K6"),
    "chi_bilinear_fwd": ("tsadar_tpu_torch/csrc/chi_bilinear.cu", "tsadar_tpu/ops/bilinear_kernel.py:132", "K7"),
    "chi_bilinear_pack": ("tsadar_tpu_torch/csrc/chi_bilinear.cu", "tsadar_tpu/ops/bilinear_kernel.py:132", "K7, its table layout"),
    "chi_bilinear_bwd": ("tsadar_tpu_torch/csrc/chi_bilinear.cu", "tsadar_tpu/ops/bilinear_kernel.py:253", "K8"),
    "pv_tables_fwd": ("tsadar_tpu_torch/csrc/pv_tables.cu", "tsadar_tpu/ops/pv_kernel.py:85", "K9"),
    "pv_tables_bwd": ("tsadar_tpu_torch/csrc/pv_tables.cu", "tsadar_tpu/ops/pv_kernel.py:85", "K9, transposed mode"),
    "lin_lookup_meta_fwd": ("tsadar_tpu_torch/csrc/lin_lookup.cu", "tsadar_tpu/ops/interp_kernel.py:84", "K10"),
    "lin_lookup_meta_bwd": ("tsadar_tpu_torch/csrc/lin_lookup.cu", "tsadar_tpu/core/physics/interp.py:1227", "K10, table cotangent"),
}
# the port's device functions by name (csrc/*.cu), as the profiler lists them
PORT_KERNEL_NAMES = ("lin_lookup", "cubic_lookup", "spectrum_tail", "pv_tables", "sum_shares", "chi_bilinear")
FORWARD_KERNELS = ("lin_lookup_fwd", "cubic_lookup_fwd", "spectrum_tail_fwd", "pv_tables_fwd")
BREAKDOWN_KERNELS = ("lin_lookup_fwd", "cubic_lookup_fwd", "pv_tables_fwd")  # the unreduced 1V spectrum's
ARTS_FWD_KERNELS = ("chi_bilinear_pack", "chi_bilinear_fwd")
ARTS_KERNELS = ARTS_FWD_KERNELS + ("chi_bilinear_bwd",)
PADDED_KERNELS = ("lin_lookup_meta_fwd", "lin_lookup_meta_bwd")
REAL_FIT_KERNELS = tuple(k for k in KERNELS if k not in ARTS_KERNELS + PADDED_KERNELS)  # K1-K6 and both K9 modes


# the device function that each launcher starts, as the profiler names it (csrc/*.cu); a launcher's second kernel
# (K9's share sum, K6's finish) is left out
DEVICE_KERNELS = {
    "lin_lookup_fwd": "lin_lookup_kernel", "lin_lookup_bwd": "lin_lookup_bwd_kernel",
    "cubic_lookup_fwd": "cubic_lookup_kernel", "cubic_lookup_bwd": "cubic_lookup_bwd_kernel",
    "spectrum_tail_fwd": "spectrum_tail_kernel", "spectrum_tail_bwd": "spectrum_tail_bwd_kernel",
    "chi_bilinear_fwd": "chi_bilinear_fwd_kernel", "chi_bilinear_pack": "chi_bilinear_pack_kernel",
    "chi_bilinear_bwd": "chi_bilinear_bwd_kernel", "pv_tables_fwd": "pv_tables_fwd_kernel",
    "pv_tables_bwd": "pv_tables_bwd_kernel", "lin_lookup_meta_fwd": "lin_lookup_meta_kernel",
    "lin_lookup_meta_bwd": "lin_lookup_meta_bwd_kernel",
}


TRACE_MARGIN_S = 0.25  # idle seconds at each end of an ``on_device`` trace


class Launches(dict):
    """{name: launcher calls} of ``read_and_zero``, with ``replays``: the replays of a graphed adam step over the
    same calls (counter ``fit.graph.replays``).  A replay runs the captured step's kernels and calls no launcher."""

    replays = 0


class DeviceRuns(dict):
    """{name: runs of its kernel on the device} of ``on_device``, with the same span's launcher ``calls`` and
    ``replays`` (a ``Launches``): under a graph only the device's trace counts what ran."""

    calls, replays = {}, 0


def read_and_zero(wrappers):
    """{name: launches} of each kernel named in ``wrappers`` since the last call (a ``Launches``), and the counters
    zeroed."""
    from tsadar_tpu_torch.utils import trace

    counts = trace.counters()
    trace.clear()
    launches = Launches({k: counts.get(f"ops.launches[{k}]", 0) for k in wrappers})
    launches.replays = counts.get("fit.graph.replays", 0)
    return launches


def device_runs(events, names):
    """{name: runs on the device of ``DEVICE_KERNELS[name]``} in ``events`` (a profiler's ``key_averages()``)."""
    from torch.autograd import DeviceType

    runs = dict.fromkeys(names, 0)
    by_kernel = {DEVICE_KERNELS[k]: k for k in names}
    for e in events:
        # the function's name without "void", its namespaces, template arguments and parameters
        bare = re.split(r"[<(]", re.sub(r"^void\s+|\(anonymous namespace\)::", "", e.key), maxsplit=1)[0].split("::")[-1]
        if e.device_type == DeviceType.CUDA and bare.strip() in by_kernel:
            runs[by_kernel[bare.strip()]] += e.count
    return runs


@contextlib.contextmanager
def on_device(wrappers):
    """Counts the kernels of ``wrappers`` that run on the device inside, a graph's replays included: the counters
    zeroed and torch.profiler's device trace on; after, the ``DeviceRuns`` yielded holds each kernel's runs, the
    launcher calls and the replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    read_and_zero(wrappers)
    runs = DeviceRuns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace keeps only what ran between its start and its stop on the host's clock: a margin on both sides,
        # so that the device's own clock, which drifts from the host's, puts no kernel outside the window
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        yield runs
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    runs.update(device_runs(prof.key_averages(), wrappers))
    runs.calls = read_and_zero(wrappers)
    runs.replays = runs.calls.replays


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
    from tsadar_tpu_torch.ops import build

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
             "chi_bilinear_fwd": ptxas_usage(logs.get("chi_bilinear", ""), "chi_bilinear_fwd_kernel"),
             "chi_bilinear_pack": ptxas_usage(logs.get("chi_bilinear", ""), "chi_bilinear_pack_kernel"),
             "chi_bilinear_bwd": ptxas_usage(logs.get("chi_bilinear", ""), "chi_bilinear_bwd_kernel")}
    emit({"phase": "sass", "instructions": {k: sass_instructions(k) for k in build.SOURCES}})

    cfg = load_deck()
    sas = get_scattering_angles(cfg)
    draws = draw_lineouts(N_LINEOUTS)
    diag = ThomsonScatteringDiagnostic(cfg, sas)
    params = make_params(cfg, draws, N_LINEOUTS, None, None)
    batch = make_batch(N_LINEOUTS)
    wrappers = kernel_wrappers()
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
    real_data_grad_check(*lineouts_of(real_cfg, real_sa, real_all, REAL_CHECK_PIXELS), "real_data_grad_check",
                         pixels=list(REAL_CHECK_PIXELS))
    real_fit_launches, real_fit_losses = real_data_fit(real_cfg, real_loss_fn, real_fit_batch, wrappers, smi)
    real_data_fit_graph(real_cfg, real_loss_fn, real_fit_batch, smi)

    # 4b. this slice's path: the main deck as written through fitter.fit (scipy L-BFGS-B on the card), loss
    # and gradient at its batch sizes, then its postprocess with a refit and the sigma-Hessian
    main_deck_grad_check()
    main_fit_launches = main_deck_fit(wrappers, smi)
    main_deck_postprocess(wrappers, smi)

    # 4c. this slice's paths: the device L-BFGS, the IAW deck (its ion window's tail kernels too), shots 111411
    # and 112059 (the latter with the spectrum breakdown) through fitter.fit, and the pointwise 1V EDF
    path_launches = {"lbfgs_fit": lbfgs_fit(wrappers, smi)}
    iaw_deck_grad_check()
    path_launches["iaw_deck_fit"] = iaw_deck_fit(wrappers, smi)
    path_launches["shot_111411_fit"] = shot_111411_fit(wrappers, smi)
    path_launches["imaging_112059_fit"] = imaging_112059_fit(wrappers, smi)
    arbitrary_1v()

    # 4d. this slice's paths: the normal entry point -- the command line in a child process (forward), the
    # runner's series and ARTS forward, the main deck through cli.main with sigmas and the export, and the
    # whole-shot fit of shot 101675 with sigmas through runner.run
    path_launches["cli_forward_subprocess"] = cli_forward_subprocess(wrappers, smi)
    path_launches["cli_series"] = cli_series(wrappers, smi)
    path_launches["cli_forward_arts"] = cli_forward_arts(wrappers, smi)
    path_launches["cli_main_deck_fit"] = cli_main_deck_fit(wrappers, smi)
    path_launches["cli_whole_shot_fit"] = cli_whole_shot_fit(wrappers, smi)

    # 4e. this slice's paths: the ARTS 1V fit through runner.run from shot 94475's real data (checkpoints, a
    # resume, the sigmas), its first batch's loss and gradient, the 2V deck's pointwise EDF through fitter.fit on
    # the same image, and the multiplexed two-shot fit (shots 94475 and 94477, the EDF turned by 25 degrees)
    path_launches["cli_arts_1v_fit"] = cli_arts_1v_fit(wrappers, smi)
    arts_1v_real_grad_check(wrappers)
    path_launches["arts_2v_real_fit"], arts_2v_ms = arts_2v_real_fit(wrappers, smi)
    path_launches["arts_multiplex"] = arts_multiplex(wrappers, smi, arts_2v_ms)

    # 4f. this slice's paths: the rest of the 2V physics and of the library surface -- the rotate projection (K7′,
    # K7, K8) and the exact mode (no kernel) at the ARTS deck's full width, the spherical-harmonic EDF at Nl 2, the
    # angular breakdown, the optax optimizers ported last on the ARTS 1V real-data fit, and run_bo in a child process
    path_launches["arts_2v_rotate"] = arts_2v_rotate(wrappers, smi)
    path_launches["arts_2v_exact"] = arts_2v_exact(wrappers, smi)
    path_launches["arts_sph_harmonics_l2"] = arts_sph_harmonics_l2(wrappers, smi)
    path_launches["arts_breakdown"] = arts_breakdown(wrappers, smi)
    path_launches["arts_optimizers"] = arts_optimizers(wrappers, smi)
    path_launches["run_bo"] = run_bo_subprocess(wrappers, smi)

    # 4g. this slice's path: the fit of shot 112059 whose lineouts and fit windows the feature detector finds, through
    # runner.run (the detector's output against the JAX package's, loss and gradient, K1-K6 and both K9 modes at B = 20)
    path_launches["detector_112059_fit"] = detector_112059_fit(wrappers, smi)

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
    from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_

    record, best_loss, errors, (loss_fn, fit_batch) = run_fit(cfg, sas, draws, N_LINEOUTS, FIT_STEPS, diag)
    torch.cuda.synchronize()
    with on_device(wrappers) as fit_launches:  # the same fit again under the device's trace
        _1d_adam_loop_(fit_config(cfg, N_LINEOUTS, FIT_STEPS), loss_fn, None, fit_batch)
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
          "launcher_calls": fit_launches.calls, "graph_replays": fit_launches.replays,
          "first_loss": losses[0], "last_loss": losses[-1], "best_loss": best_loss, "losses_finite": bool(np.isfinite(losses).all()),
          "median_rel_err": {k: medians[k] for k in FIT_TOL}, "max_rel_err": {k: float(errors[k].max()) for k in FIT_TOL},
          "tol": FIT_TOL, "median_lam_abs_err_nm": medians["lam_nm"], "max_lam_abs_err_nm": float(errors["lam_nm"].max()),
          "ms_per_step": ms_per_step, "steps_per_s": 1e3 / ms_per_step, "lineout_steps_per_s": N_LINEOUTS * 1e3 / ms_per_step,
          "fit_seconds": sum(record["chunk_seconds"]), "chunk_median_ms_per_step": statistics.median(chunk_ms),
          "chunk_ms_per_step": chunk_ms, "losses_every_10th": losses[::10], "gpu": smi, "ok": fit_ok})
    if not fit_ok:
        raise RuntimeError(f"fit: launches {fit_launches}, best loss {best_loss:.3e} of first {losses[0]:.3e}, "
                           f"median errors {medians} against {FIT_TOL}")
    few = 4  # steps under the profiler, from the deck's start values again
    emit(profile_run(lambda: _1d_adam_loop_(fit_config(cfg, N_LINEOUTS, few), loss_fn, None, fit_batch), few, ms_per_step,
                     "fit_profile", "step"))

    # 8. the third slice's path: the ARTS 2V forward, its gradient and the angular fit through K7 and K8
    arts_fwd_launches, arts_target = arts_forward(arts_cfg, arts_sas, arts_diag, arts_params, wrappers, smi)
    arts_grad_check(arts_cfg, arts_sas, arts_target, wrappers)
    arts_fit_launches, arts_steps, arts_prof = arts_fit(arts_cfg, arts_sas, arts_target, wrappers, smi)
    for k in ARTS_KERNELS:  # each chi kernel's device time inside the ARTS fit step
        rows[k]["ms_arts_step"] = sum(r["ms"] for r in arts_prof["port_kernels"] if k + "_kernel" in r["name"])
    # the deck's own EDF family (spherical harmonics with the Mora-Yahi f1, nvx 128, nvr 64), and the
    # ARTS 1V deck (a DLM EDF on nvx 256 through the unreduced 1V spectrum: K1 and K3 at 2048 x 241 queries)
    arts_other_forward("arts_spherical_harmonics_forward", *load_arts_deck(arbitrary=False), ARTS_FWD_KERNELS, wrappers)
    arts_1v = load_arts_deck(arbitrary=False, names=ARTS_1V_DECK)
    with torch.no_grad():
        arts_1v_ff, arts_1v_params = arts_models(*arts_1v, None)
        check_lookups_arts_1v(arts_1v_ff.model.electron_form_factor, arts_1v_params, rng, "arts_1v",
                              arts_1v[0]["other"]["npts"] * len(arts_1v[1]["sa"]))
    arts_other_forward("arts_1v_forward", *arts_1v, ("lin_lookup_fwd", "cubic_lookup_fwd", "pv_tables_fwd"), wrappers,
                       plain_f32_tol=ARTS_1V_F32_TOL)

    # 9. this slice's paths: the multi-GPU sharding -- a one-rank NCCL group through torchrun and the command line,
    # then two gloo ranks on the one card: the whole-shot fit, half of the lineouts a rank, and the ARTS 2V deck,
    # half of its chi points a rank
    import tempfile

    path_launches["dist_one_rank_nccl"] = dist_one_rank_nccl(wrappers, smi, real_cfg, real_sa, real_all,
                                                          real_fit_losses)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as dist_dir:
        dist_ranks, dist_out, dist_seconds = dist_two_ranks(smi, arts_target, dist_dir)
        for r, counts in enumerate(dist_two_ranks_whole_shot(wrappers, smi, dist_ranks, dist_out, dist_seconds, dist_dir,
                                                             real_loss_fn, real_fit_batch, real_cfg)):
            path_launches[f"dist_two_ranks_whole_shot_rank{r}"] = counts
        for r, counts in enumerate(dist_arts_2v_points(wrappers, smi, dist_ranks, dist_dir, arts_cfg, arts_sas, arts_target)):
            path_launches[f"dist_arts_2v_points_rank{r}"] = counts

    def launches_of(k):
        """(launches on its main path, that path's fit's, fit steps): the ARTS path (K7, K8), K10's drive on the
        real-data operands, the real-data path (K9), or the first slices' synthetic 1V path (K1-K6)."""
        if k in ARTS_KERNELS:
            return arts_fwd_launches if k in ARTS_FWD_KERNELS else arts_fit_launches, arts_fit_launches, arts_steps
        if k in PADDED_KERNELS:
            return padded_launches, {}, 0
        if k.startswith("pv_tables"):
            return real_fwd_launches if k in FORWARD_KERNELS else real_fit_launches, real_fit_launches, FIT_STEPS
        return fwd_launches if k in FORWARD_KERNELS else fit_launches, fit_launches, FIT_STEPS

    def counted(path, counts, k):
        """``k``'s launches on ``path``; for a path counted on the device (``DeviceRuns``), its launcher calls and
        graph replays beside them."""
        calls = {f"{path}_launcher_calls": counts.calls[k], f"{path}_graph_replays": counts.replays} \
            if isinstance(counts, DeviceRuns) else {}
        return {f"{path}_launches": counts.get(k, 0), **calls}

    def kernel_row(k):
        on_path, fit, steps = launches_of(k)
        return {"name": k, "tpu_kernel": KERNELS[k][2], "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
                "launches": on_path[k], **counted("fit", fit, k), "launches_per_fit_step": fit.get(k, 0) / steps if steps else 0.0,
                **counted("real_data_fit", real_fit_launches, k), **counted("main_deck_fit", main_fit_launches, k),
                **{f: v for path, counts in path_launches.items() for f, v in counted(path, counts, k).items()},
                **rows[k], **({"ptxas": ptxas[k]} if k in ptxas else {})}

    emit({"kernels": [kernel_row(k) for k in wrappers]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
