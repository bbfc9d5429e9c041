#!/usr/bin/env python3
"""The readings that the limits of ``limits/<workload>.json`` are set from (not run by the benchmark's runs).

    python3 port_bench/calibrate.py --workload <name> --seeds 12 --control-seeds 3 --fault-seeds 3

On the card, at the cell's own size, in one process: the cell's set-up, then

* ``sound``: one unit of the window for each seed, judged as a run judges it
  (``harness/verify.py``): the lower readings;
* ``control``: the reference put in the program's place in the precision below the
  configuration's float32: bfloat16 where PyTorch's autocast puts it (``bf16``: a whole
  fit, judged as a unit is); and, for what they show, the first three adam steps of the
  reference in float32 (``f32``) and in float32 with TF32 matmuls (``tf32``, with a
  float32 matmul's error under that setting, which shows that it took);
* ``fault``: one unit for each seed with each fault of ``harness/faults.py`` planted in
  the program, judged as a run judges it.

One JSON line per reading.  The workload is looked up in ``BENCHMARK.json``: a
cell is listed there before it is calibrated.
"""

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import common, units as units_mod, verify  # noqa: E402


def tf32(on):
    """TF32 for float32 matmuls and convolutions on (the control) or off; returns a float32 matmul's relative
    error against float64 under the setting, which shows whether it took."""
    import torch

    mode = "tf32" if on else "ieee"
    torch.backends.cuda.matmul.fp32_precision = mode
    torch.backends.cudnn.conv.fp32_precision = mode
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(1024, 1024, device="cuda", generator=g)
    exact = a.double() @ a.double()
    return float(((a @ a).double() - exact).abs().max() / exact.abs().max())


def readings(name, seeds, control_seeds, fault_seeds, faults=None):
    import torch

    from reference.fits import Problem
    from harness.faults import FAULTS
    from tsadar_tpu_torch.ops import build

    device = "cuda"
    workdir = common.set_environment()
    _, config, traffic, _ = common.workload(name)
    build.build()
    if traffic["unit"] == "fit":
        units = units_mod.FitUnits(config, traffic, 0, device=device)
    else:
        units = units_mod.RunUnits(config, traffic, 0, workdir / name, device=device)
    units.warm()
    tf32(False)
    problem = Problem(units.source_deck, device)
    lr = problem.cfg["optimizer"]["learning_rate"]
    out = []

    def judge(kind, seed, label=None):
        units.seed = seed
        result = units(0)
        numbers = verify.unit_numbers(problem, units, result, units.answer(result), lr)
        row = {"reading": kind, "fault": label, "seed": seed, "epochs": result["epochs"], "numbers": numbers}
        common.emit(row)
        out.append(row)
        result.pop("weights", None)

    for seed in seeds:
        judge("sound", seed)
    lower = {"f32": (torch.float32, False), "tf32": (torch.float32, True), "bf16": (torch.float32, False)}
    controls = {k: Problem(units.source_deck, device, dtype) for k, (dtype, _) in lower.items()}
    epochs = problem.cfg["optimizer"]["num_epochs"]
    for seed in control_seeds:
        units.seed = seed
        values = units.values(0)
        ref = problem.fit(problem.params(values), lr, 3)[0]
        for k, (_, use_tf32) in lower.items():
            matmul_err = tf32(use_tf32)
            c = controls[k]
            numbers = {}
            if k == "bf16":  # a whole fit, as a unit of the window, under bfloat16 autocast
                with torch.autocast(device_type=device, dtype=torch.bfloat16):
                    got, fitted = c.fit(c.params(values), lr, epochs)
                state = {n: t.detach().float().cpu().numpy() for n, t in fitted.state_dict().items()}
                final = problem.loss(problem.params(values, state=state))
                numbers = {"final_loss": verify.rel(min(got), final), "fit_drop": final / ref[0], "epochs": len(got)}
            else:
                got = c.fit(c.params(values), lr, 3)[0]
            tf32(False)
            numbers["loss_steps"] = max(verify.rel(g, r) for g, r in zip(got, ref))
            row = {"reading": "control", "precision": k, "seed": seed, "matmul_rel_err": matmul_err, "numbers": numbers}
            common.emit(row)
            out.append(row)
    for label in faults or FAULTS:
        with FAULTS[label]():
            for seed in fault_seeds:
                judge("fault", seed, label)
    units.close()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=1000)
    parser.add_argument("--faults", nargs="*")
    a = parser.parse_args()
    s = a.first_seed
    readings(a.workload, range(s, s + a.seeds), range(s + 100, s + 100 + a.control_seeds),
             range(s + 200, s + 200 + a.fault_seeds), a.faults)


if __name__ == "__main__":
    main()
