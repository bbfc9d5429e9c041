"""The control of each cell's check, on the card: the reference put in the program's place in bfloat16
(PyTorch's autocast) has to fail the cell's ``loss_steps`` limit.

At a size a test run holds (the whole-shot deck on 64 of its lineouts; the ARTS image whole), three
seeds; ``calibrate.py`` reads the same control at the cells' own sizes, whole fits included.  Skips
without a CUDA card: TF32 and the card's bfloat16 are the card's.
"""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import common, units, verify  # noqa: E402

SEEDS = (2**31 + 41, 2**31 + 42, 2**31 + 43)
ARTS = {"name": "arts_1v_fit", "config": "arts_1v_94475", "traffic": "run_with_sigmas", "chips": 1}  # not listed yet


def source_deck(name):
    from reference.tsadar_ref.utils.config import merge_configs

    bench = common.manifest()
    bench["workloads"] = bench["workloads"] + [ARTS]
    _, config, traffic, limits = common.workload(name, bench)
    if "lineouts" in traffic:
        traffic["lineouts"] = {"start": 500, "end": 564, "skip": 1}
    defaults, inputs = units.cell_decks(config, traffic)
    return merge_configs(defaults, inputs), config["assumed"]["start_band"], limits


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whole_shot_every_pixel", "arts_1v_fit"])
def test_the_bfloat16_control_fails(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control is read on a CUDA card")
    from reference.fits import Problem

    deck, band, limits = source_deck(name)
    ref, control = Problem(copy.deepcopy(deck), "cuda"), Problem(copy.deepcopy(deck), "cuda", torch.float32)
    lr = ref.cfg["optimizer"]["learning_rate"]
    for seed in SEEDS:
        values = units.start_values(ref.cfg["parameters"], band, seed, 0)
        want = ref.fit(ref.params(values), lr, 3)[0]
        with torch.autocast(device_type="cuda", dtype=torch.bfloat16):
            got = control.fit(control.params(values), lr, 3)[0]
        gap = max(verify.rel(g, w) for g, w in zip(got, want))
        assert gap > limits["loss_steps"], (seed, gap)
