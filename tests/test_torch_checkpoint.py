"""Checkpoints and the angular loop's tracker outputs (``tsadar_tpu_torch.utils.checkpoint``, ``loops._angular_loop_``), on the CPU.

On the small ARTS 2V loss of ``tests/test_torch_arts_loss.py`` in float64:

* a fit of 8 epochs with ``checkpoint_freq`` 4 and chunks of 4 leaves
  ``epoch_3.pt`` and ``epoch_7.pt`` and ``LATEST`` 7 (a checkpoint after each
  chunk whose epochs hold a multiple of 4, labelled with its last epoch, as
  the JAX loop labels them); a fit of 12 epochs from that directory resumes at
  epoch 7 and runs the 5 epochs 7..11; its losses and its best ``fval`` are
  bit-equal to those of an uninterrupted fit of 13 steps (the resumed fit
  redoes the label's epoch from the state after it, as the JAX loop does),
  for adam (``torch.optim.Adam``) and for yogi (an optimizer of
  ``inverse.optimizers``);
* an early stop inside a chunk writes no checkpoint for that chunk;
* ``save_state`` snapshots the best parameters at every ``save_state_freq``-th
  counted epoch into ``state_weights.txt``, logged with the run, beside one
  ``epoch loss`` a counted epoch and ``fit_first_dispatch_time``.
"""

import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import tsadar_tpu_torch as port
from tsadar_tpu_torch.inverse import loops
from tsadar_tpu_torch.utils import mlflow_shim as mlflow
from tsadar_tpu_torch.utils.checkpoint import latest_epoch

from .test_torch_arts_loss import _all_data, _config, _ScriptedLoss
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


def _fit(method, epochs, ckpt_dir=None, freq=4, **opt):
    cfg, sas = _config()
    cfg["optimizer"].update(method=method, learning_rate=2e-3, num_epochs=epochs, chunk_size=4, **opt)
    if ckpt_dir is not None:
        cfg["optimizer"].update(checkpoint_dir=str(ckpt_dir), checkpoint_freq=freq)
    record = {}
    best, _, _ = port.angular_optax(cfg, _all_data(0), sas, device="cpu", record=record)
    return record, best


@pytest.mark.parametrize("method", ["adam", "yogi"])
def test_a_resumed_fit_is_bit_equal_to_an_uninterrupted_one(tmp_path, method):
    ckpt = tmp_path / "ckpt"
    first, _ = _fit(method, 8, ckpt)
    assert sorted(os.listdir(ckpt)) == ["LATEST", "epoch_3.pt", "epoch_7.pt"] and latest_epoch(ckpt) == 7
    assert first["start_epoch"] == 0 and len(first["losses"]) == 8
    resumed, best = _fit(method, 12, ckpt)
    assert resumed["start_epoch"] == 7 and resumed["chunk_steps"] == [4, 1] and len(resumed["losses"]) == 5
    assert latest_epoch(ckpt) == 10  # the chunk of epochs 7..10 holds epoch 8
    whole, whole_best = _fit(method, 13)
    assert whole["losses"][:8] == first["losses"]
    assert resumed["losses"] == whole["losses"][8:]
    # both fits' best parameters are their last: the losses fall all the way
    assert np.all(np.diff(whole["losses"]) < 0)
    assert torch.equal(best.electron.distribution_functions.fval, whole_best.electron.distribution_functions.fval)


def test_no_checkpoint_after_an_early_stop(tmp_path, monkeypatch):
    scripted = _ScriptedLoss([1.0] + [2.0] * 30)  # six rising epochs after the first stop the fit at epoch 6
    monkeypatch.setattr(loops, "LossFunction", lambda *a, **k: scripted)
    cfg, sas = _config()
    cfg["optimizer"].update(num_epochs=12, chunk_size=4, checkpoint_dir=str(tmp_path), checkpoint_freq=4)
    record = {}
    port.angular_optax(cfg, _all_data(0), sas, device="cpu", record=record)
    assert len(record["losses"]) == 7 and record["chunk_steps"] == [4, 4]
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "epoch_3.pt"] and latest_epoch(tmp_path) == 3


def test_state_snapshots_and_epoch_metrics_go_to_the_run(tmp_path, monkeypatch):
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path))
    mlflow.set_experiment("checkpoint-tests")
    with mlflow.start_run(run_name="snapshots"):
        record, best = _fit("adam", 6, save_state=True, save_state_freq=4)
    (run_json,) = Path(tmp_path).rglob("run.json")
    metrics = json.loads(run_json.read_text())["metrics"]
    assert [m["step"] for m in metrics["epoch loss"]] == list(range(6))
    assert [m["value"] for m in metrics["epoch loss"]] == record["losses"]
    assert len(metrics["fit_first_dispatch_time"]) == 1
    snaps = pickle.loads((run_json.parent / "artifacts" / "state_weights.txt").read_bytes())
    assert sorted(snaps) == [0, 4]
    # the snapshot at epoch 4 is taken after the chunk of epochs 4..5, the fit's last: the fit's best parameters
    want = best.get_unnormed_params()["electron"]
    assert snaps[4]["electron"].keys() == want.keys() == snaps[0]["electron"].keys()
    assert np.array_equal(snaps[4]["electron"]["f"], want["f"].detach().numpy())
    assert not np.array_equal(snaps[0]["electron"]["f"], snaps[4]["electron"]["f"])
