"""The harness's arithmetic on made-up inputs: roofline counts, the whole-units rate, the trace's reduction,
the module check, the seed's start values."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import common, devtrace, roofline, units, window  # noqa: E402

# PERF.md §6's bound column (ms) at the main path's shapes: B = 128, Q = 51 200 a row, tail [128, 1, 5120, 10]
PERF_BOUNDS_MS = {"K1": 0.0238, "K2": 0.0160, "K3": 0.0235, "K4": 0.0157, "K5": 0.0225, "K6": 0.0450, "K9": 0.00325}
SHAPES = {"K1": {"Q": 51200, "n": 2043}, "K2": {"Q": 51200, "n": 2043}, "K3": {"Q": 51200, "n": 320},
          "K4": {"Q": 51200, "n": 320}, "K5": {"G": 1, "L": 5120, "NA": 10, "S": 1},
          "K6": {"G": 1, "L": 5120, "NA": 10, "S": 1}, "K9": {"N": 1024}}


@pytest.mark.parametrize("op", sorted(PERF_BOUNDS_MS))
def test_roofline_counts_match_the_kernel_table(op):
    ms = roofline.OPERATIONS[op](B=128, **SHAPES[op]) * 1e3
    assert ms == pytest.approx(PERF_BOUNDS_MS[op], rel=5e-3)


def test_least_seconds_counts_steps_and_units():
    kernels = {"K1": {"shape": SHAPES["K1"], "per_step": 1, "per_unit": 1}}
    one = roofline.lin_lookup_fwd(B=4, **SHAPES["K1"])
    assert roofline.least_seconds(kernels, 4, steps=10, units=2) == pytest.approx(12 * one)


def test_whole_units_on_a_fake_clock():
    now = [0.0]
    durations = [3.0, 4.0, 5.0, 6.0]

    def clock():
        return now[0]

    def unit(i):
        now[0] += durations[i]
        return i

    results, spans, window_s = window.run_window(unit, 8.0, clock=clock)
    assert results == [0, 1, 2] and window_s == 12.0  # the unit that crosses 8 s is finished, not cut
    assert spans == [(0.0, 3.0), (3.0, 7.0), (7.0, 12.0)]
    assert window.per_unit(window_s, len(results)) == 4.0
    with pytest.raises(ValueError):
        window.per_unit(1.0, 0)


def test_forbidden_modules_compares_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "tsadar_tpu", "tsadar_tpu.core", "tsadar_tpu_torch",
            "tsadar_tpu_torch.core", "jaxtyping", "numpy"]
    assert common.forbidden_modules(mods) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla", "tsadar_tpu", "tsadar_tpu.core"]


def test_the_port_kernels_are_read_from_the_sources():
    names = common.port_kernel_names()
    assert {"lin_lookup_kernel", "spectrum_tail_bwd_kernel", "pv_tables_fwd_kernel", "sum_shares", "spectrum_tail_kernel", "spectrum_tail_bwd_finish_kernel"} <= names


def test_trace_reduction():
    events = [("anchor fill", 100.0, 100.001),
              ("void (anonymous namespace)::lin_lookup_kernel(float const*)", 100.010, 100.030),
              ("void at::native::elementwise_kernel<128, 4>(int)", 100.020, 100.040),  # overlaps the first
              ("Memcpy DtoH (Device -> Pinned)", 100.540, 100.550)]
    host = [("fit", 0.0, 1.0), ("hessian", 0.2, 0.6)]
    s = devtrace.summarize(events, t_anchor=0.0, t_stop=0.6, spans=host, port_names={"lin_lookup_kernel"})
    assert s["window_s"] == pytest.approx(0.6)
    assert s["busy_s"] == pytest.approx(0.030 + 0.010)  # the union, without the anchor
    assert s["launches"] == 2 and s["kernels"]["lin_lookup_kernel"]["group"] == devtrace.PORT
    assert s["seconds"][devtrace.PORT] == pytest.approx(0.020) and s["seconds"][devtrace.OTHER] == pytest.approx(0.030)
    gap, label = s["breakdown"]["idle_gaps"][0][1], s["breakdown"]["idle_gaps"][0][0]
    assert gap == pytest.approx(0.5) and label == "hessian"  # the gap 0.04-0.54 s lies in the hessian span
    assert s["breakdown"]["device_ops"][0][0] == "elementwise_kernel"


def test_start_values_depend_on_seed_and_unit_and_keep_the_bounds():
    params = {"electron": {"Te": {"val": 0.5, "lb": 0.01, "ub": 1.5}, "fe": {"params": {"m": {"val": 2.0, "lb": 2.0, "ub": 5.0}}}}}
    band = {"electron.Te": 0.1, "electron.m": 0.1}
    a = units.start_values(params, band, 2**31 + 11, 0)
    assert a == units.start_values(params, band, 2**31 + 11, 0)
    assert a != units.start_values(params, band, 2**31 + 12, 0) and a != units.start_values(params, band, 2**31 + 11, 1)
    assert abs(a[("electron", "Te")] - 0.5) <= 0.05 and 2.0 <= a[("electron", "m")] <= 2.2
    moved = units.with_values(params, a)
    assert moved["electron"]["fe"]["params"]["m"]["val"] == a[("electron", "m")] and params["electron"]["Te"]["val"] == 0.5
