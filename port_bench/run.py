#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``tsadar_tpu_torch``): one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up (timed as ``setup_s``): the port's kernels built or loaded, the cell's
data prepared, every shape of the window warmed by a short unit.  The window
then repeats whole units (a fit, or a run through the entry point), each from
its own start values drawn from the seed, until ``--seconds`` have passed at
the end of one; its end-to-end metric is the window's seconds over its units.
With ``--trace 1`` the first unit of the window runs under ``torch.profiler``
(device activity) and the per-layer metrics are read.  After the window the
program's state is freed and the plain reference (``reference/``) checks what
the units produced (``harness/verify.py``).

Earlier lines tell the card, the host, each unit and each check; the last line
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks`` (each
compared number with its limit), which the last lines of standard error
repeat.  Without the cards the cell asks for, or with JAX or the JAX package
loaded after set-up, after the window or before the result, it prints no
result and exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the harness, and the checkout that holds the program

from harness import common, devtrace, units as units_mod, verify, window  # noqa: E402

NO_RESULT = 3


def fail(message):
    print(f"port_bench: {message}", file=sys.stderr, flush=True)
    raise SystemExit(NO_RESULT)


def check_modules(when):
    found = common.forbidden_modules()
    if found:
        fail(f"{when}, sys.modules holds {found}: nothing the benchmark runs may load JAX or the JAX package")


def host_spans(kind, result, t0, t1):
    """[(label, host start, host end)] of one unit: the whole unit, and for a run its stages from its record."""
    spans = [(kind, t0, t1)]
    if kind == "run" and "setup_seconds" in result:
        post, fit, setup = result["postprocess_seconds"], result["fit_seconds"], result["setup_seconds"]
        s = t1 - post - fit - setup
        h = s + setup + fit + result["arrayloss_seconds"]
        spans += [("prepare", s, s + setup), ("fit", s + setup, s + setup + fit),
                  ("postprocess", s + setup + fit, t1), ("hessian", h, h + result["hessian_seconds"])]
    return spans


def bench(name, seed, seconds, trace, device="cuda", adjust=None):
    """One run of workload ``name``: (the result's JSON object, the checks' table).  ``adjust(config, traffic)``
    (the tests' rehearsals at a small size) changes the two in place before set-up."""
    import torch

    workdir = common.set_environment()
    entry, config, traffic, limits = common.workload(name)
    if adjust is not None:
        adjust(config, traffic)
    on_card = device == "cuda"
    common.emit({"phase": "card", "device": torch.cuda.get_device_name(0) if on_card else "cpu",
                 "nvidia_smi": common.smi() if on_card else None, "host_cores": os.cpu_count(),
                 "torch_threads": torch.get_num_threads(), "torch": torch.__version__})

    t0 = time.perf_counter()
    if on_card:
        from tsadar_tpu_torch.ops import build

        build.build()
        torch.cuda.reset_peak_memory_stats()
    build_s = time.perf_counter() - t0
    if traffic["unit"] == "fit":
        units = units_mod.FitUnits(config, traffic, seed, device=device)
    else:
        units = units_mod.RunUnits(config, traffic, seed, workdir / name, device=device)
    units.warm()
    check_modules("after set-up")
    setup_s = time.perf_counter() - T_START
    common.emit({"phase": "setup", "setup_s": setup_s, "build_s": build_s, "prepare_s": units.prepare_s})

    tracer = devtrace.DeviceTrace() if trace else None
    failed = []

    def unit(i):
        try:
            return units(i)
        except Exception as e:  # noqa: BLE001  a unit that raises is a failed unit; the window goes on
            failed.append({"index": i, "error": f"{type(e).__name__}: {e}"})
            return {"index": i, "error": str(e)}

    def between(i):
        if tracer is not None and i == 0:
            tracer.start()
        elif tracer is not None and i == 1:
            tracer.stop()

    results, spans, window_s = window.run_window(unit, seconds, between=between)
    if on_card:
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    check_modules("after the window")
    stages = ("setup_seconds", "fit_seconds", "postprocess_seconds", "hessian_seconds")
    for r, (a, b) in zip(results, spans):
        common.emit({"phase": "unit", "index": r["index"], "seconds": b - a, "epochs": r.get("epochs"),
                     "best_loss": min(r["losses"]) if r.get("losses") else None, "error": r.get("error"),
                     **{k: r[k] for k in stages if k in r}})

    kind = units.kind
    metrics = {}
    ctx = {"trace": None, "traced": [r for r in results[:1] if "error" not in r], "units": [r for r in results if "error" not in r],
           "setup": {"prepare_s": units.prepare_s}, "kernels": config["kernels"], "B": units.n}
    if tracer is not None:
        host = [s for r, (a, b) in zip(results, spans) for s in host_spans(kind, r, a, b)]
        ctx["trace"] = devtrace.summarize(tracer.device_events(), tracer.t_anchor, tracer.t_stop, host,
                                          common.port_kernel_names())
        if ctx["trace"]:
            common.emit({"phase": "trace", "window_s": ctx["trace"]["window_s"], "busy_s": ctx["trace"]["busy_s"],
                         "launches": ctx["trace"]["launches"], "seconds": ctx["trace"]["seconds"],
                         "steps": sum(u["epochs"] for u in ctx["traced"]),
                         "port_kernels": {k: v for k, v in ctx["trace"]["kernels"].items() if v["group"] == devtrace.PORT}})
        for m in common.metrics_of(name, "per_layer"):
            value = common.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        per_unit = window.per_unit(window_s, len(results))
        for m in common.metrics_of(name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else per_unit
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the answers read back, the program's state freed, then the reference on the same device
    checked = verify.checked_units(len(results), seed, traffic["checked_units"])
    answers = {i: units.answer(results[i]) for i in checked if "error" not in results[i]}
    for r in results:
        r.pop("weights", None)
    units.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from reference.fits import Problem

    if on_card:  # the reference's float64 takes no TF32; said so for any float32 it meets
        torch.backends.cuda.matmul.fp32_precision = torch.backends.cudnn.conv.fp32_precision = "ieee"
    t0 = time.perf_counter()
    problem = Problem(units.source_deck, device)
    lr = problem.cfg["optimizer"]["learning_rate"]
    numbers = []
    for i in checked:
        if i in answers:
            numbers.append(verify.unit_numbers(problem, units, results[i], answers[i], lr))
        else:
            numbers.append({k: float("nan") for k in limits})
        common.emit({"phase": "check", "unit": i, "numbers": numbers[-1]})
    ok, table = verify.judge(numbers, limits)
    common.emit({"phase": "reference", "seconds": time.perf_counter() - t0, "units_checked": checked})

    dev = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": entry["chips"], "memory_peak_bytes": memory_peak}
    out = {"correct": ok and not failed, "attempted": len(results), "failed": len(failed), "metrics": metrics, "device": dev}
    if ctx["trace"]:
        dev["busy_s"], dev["window_s"] = ctx["trace"]["busy_s"], ctx["trace"]["window_s"]
        out["breakdown"] = ctx["trace"]["breakdown"]
    if failed:
        common.emit({"phase": "failed", "units": failed[:5]})
    out["checks"] = table
    return out, table


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    entry = common.workload(args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        fail(f"the cell asks for {entry['chips']} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    out, table = bench(args.workload, args.seed, args.seconds, bool(args.trace))
    for k, t in table.items():
        print(f"check {k}: {t['value']:.6g} (limit {t['limit']:.6g})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    check_modules("before the result")  # the reference's imports included
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
