"""The sharded port through its command line under ``torchrun``, and the rules of its process group, on the CPU.

* ``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
  tsadar_tpu_torch --cfg DIR --mode fit --device cpu`` on the small deck of
  ``test_runner_paths._small_decks()`` (shot 101675, 2 lineouts, adam, 10
  epochs) with ``optimizer.parallel: true``: both ranks exit 0, rank 0 alone
  registers one run and writes its files, and its ``learned_parameters.csv``
  matches the same command in one process (no group: the fit unsharded) to
  1e-4 relative.  Each process prepares the shot's data on its own, and
  scipy's streak-background fit ends in either of two mirror solutions
  (ROADMAP.md §3; every streaked deck fits that background): run alone the two
  files agree to 9e-16, beside five other test workers m parted by 1.15e-6 at
  one lineout.  The two ranks themselves share rank 0's data.
* the backend rule: gloo for CPU ranks, nccl for CUDA ranks unless the caller
  names gloo, NCCL on CPU ranks refused; two ranks on one
  card raise under NCCL, naming the cause, and share it under gloo (the card
  stubbed); a rank asking for the card where there is none raises
  ``resolve_device``'s error: there is no quiet move to the CPU.
"""

import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from tsadar_tpu_torch.parallel import dist as par

from .test_torch_cli import _env, _write_decks
from .test_utils.test_runner_paths import _small_decks


def _fit(tmp_path, name, launcher):
    defaults, inputs = _small_decks()
    defaults["optimizer"]["parallel"] = True
    _write_decks(tmp_path / "cfg", defaults, inputs)
    env = _env(tmp_path) | {"TSADAR_RUNS_DIR": str(tmp_path / name), "TSADAR_DIST_TIMEOUT": "120"}
    out = subprocess.run([sys.executable, *launcher, "-m", "tsadar_tpu_torch", "--cfg", "cfg", "--mode", "fit", "--device",
                          "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    runs = [p.parent for p in (tmp_path / name).rglob("run.json")]
    assert len(runs) == 1, runs  # one run, rank 0's
    return pd.read_csv(runs[0] / "artifacts" / "csv" / "learned_parameters.csv"), out


def test_torchrun_two_ranks_fit_matches_one_process(tmp_path):
    sharded, out = _fit(tmp_path, "runs_torchrun", ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2"])
    assert "lineout batch data-parallel over 2 of 2 ranks" in out.stdout + out.stderr
    single, _ = _fit(tmp_path, "runs_single", [])
    assert list(sharded.columns) == list(single.columns) and len(sharded) == 2
    for col in single.columns:
        if np.issubdtype(single[col].dtype, np.number):
            np.testing.assert_allclose(sharded[col].to_numpy(), single[col].to_numpy(), rtol=1e-4, err_msg=col)


def test_backend_rule():
    assert par.backend_for("cpu") == "gloo" and par.backend_for("cuda") == "nccl"
    assert par.backend_for("cuda", "gloo") == "gloo" and par.backend_for("cpu", "gloo") == "gloo"
    with pytest.raises(ValueError, match="NCCL runs on CUDA ranks only"):
        par.backend_for("cpu", "nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        par.backend_for("cuda", "mpi")


def test_two_ranks_on_one_card_raise_under_nccl(monkeypatch):
    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    assert par.rank_device("cuda", local_rank=0) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one device"):
        par.rank_device("cuda", local_rank=1)
    assert par.rank_device("cuda", "gloo", local_rank=1) == torch.device("cuda", 0)  # shared, as the caller named
    assert chosen == [0, 0]


def test_a_rank_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        par.rank_device("cuda", local_rank=0)
    assert par.rank_device("cpu") == torch.device("cpu")
