"""The adam loop's CUDA graph (``tsadar_tpu_torch.inverse.loops``): when it engages, and that its steps are the eager ones.

* ``_graphed`` engages the graph only on the card, unsharded, with at least ``GRAPH_MIN_EPOCHS`` (12) epochs, the
  fewest at which a graphed fit beat the eager one on the card.
* On the CPU every fit runs eagerly: no capture, no replay, ``num_epochs`` losses, and the same bits as the
  loop's eager arithmetic written out here (``torch.optim.Adam`` as built before the graph, the best-so-far by
  ``torch.where``).
* The graph's step (``_StepGraph``) rehearsed on the CPU: with stand-ins for the stream and the graph (the
  capture runs its step once, as the first replay would on the card, and each later replay runs the step into the
  captured output) a fit counts one capture and ``num_epochs - 1`` replays, one ``fit.step`` span a step with a
  ``fit.capture`` and ``fit.replay`` span in it, ``num_epochs`` losses, and the eager fit's bits.
* On the card (``cuda``), 20 graphed steps of the real-data whole-shot deck against the eager steps.  This file
  imports no JAX, so that it runs on the card: ``python -m pytest --noconftest tests/test_torch_fit_graph.py``.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import __graft_entry__ as ge
import tsadar_tpu_torch as port
from tsadar_tpu_torch.core.params import get_filter_spec
from tsadar_tpu_torch.inverse import loops
from tsadar_tpu_torch.utils import trace

from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.fixture(autouse=True)
def empty_records():
    trace.clear()
    yield
    trace.clear()


def _setup(epochs, track_best="overall", batch_size=2):
    cfg = ge._small_config(batch_size)
    cfg["optimizer"].update(method="adam", learning_rate=1e-2, num_epochs=epochs, chunk_size=3, track_best=track_best)
    cfg["other"]["extraoptions"].update(load_ion_spec=False, fit_IAW=False)
    batch = ge._make_batch(batch_size)
    return cfg, port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu"), batch


def _eager_reference(cfg, loss_fn, batch):
    """(losses, best loss, fitted leaves) of the loop's eager arithmetic, written out."""
    params = loops._init_params(cfg, None, device=CPU, dtype=loss_fn.ts_diag.dtype)
    trainable = get_filter_spec(cfg["parameters"], params)
    leaves = list(trainable.values())
    batch = loss_fn.device_batch(batch)
    opt = torch.optim.Adam(leaves, lr=cfg["optimizer"]["learning_rate"], betas=(0.9, 0.999), eps=1e-8)
    per_lineout = cfg["optimizer"]["track_best"] == "per_lineout"
    best_loss = torch.tensor(np.inf, dtype=torch.float64)
    best_rows = torch.full((batch["e_data"].shape[0],), np.inf, dtype=torch.float64)
    best, losses = [p.detach().clone() for p in leaves], []
    for _ in range(cfg["optimizer"]["num_epochs"]):
        (value, aux), grads = loss_fn.value_and_grad(params, batch, trainable)
        for p, g in zip(leaves, grads.values()):
            p.grad = g
        opt.step()
        with torch.no_grad():
            improved = value < best_loss
            best_loss = torch.where(improved, value, best_loss)
            if per_lineout:
                improved = aux[2] < best_rows
                best_rows = torch.where(improved, aux[2], best_rows)
            best = [torch.where(improved, p, b) for p, b in zip(leaves, best)]
        losses.append(float(value))
    with torch.no_grad():
        for p, b in zip(leaves, best):
            p.copy_(b)
        if per_lineout:
            best_loss = loss_fn.__loss__(params, batch)[0]
    return losses, float(best_loss), [p.detach().clone() for p in leaves]


def _fit(cfg, loss_fn, batch):
    record = {}
    best_loss, weights = loops._1d_adam_loop_(cfg, loss_fn, None, batch, record=record)
    return record, best_loss, [p.detach() for p in get_filter_spec(cfg["parameters"], weights).values()]


@pytest.mark.parametrize("device, sharded, epochs, engages", [
    (CUDA, False, 12, True), (CUDA, False, 200, True), (CUDA, False, 2, False), (CUDA, False, 1, False),
    (CUDA, True, 200, False), (CPU, False, 200, False), (CUDA, False, 11, False), (CUDA, False, 3, False),
])
def test_the_graph_engages_on_an_unsharded_card_fit_with_a_step_to_replay(device, sharded, epochs, engages):
    assert loops._graphed(device, object() if sharded else None, epochs) is engages


@pytest.mark.parametrize("track_best", ["overall", "per_lineout"])
@pytest.mark.parametrize("epochs", [1, 2, 4])
def test_a_cpu_fit_runs_eagerly_with_the_eager_bits(epochs, track_best):
    cfg, loss_fn, batch = _setup(epochs, track_best)
    losses, best_loss, leaves = _eager_reference(cfg, loss_fn, batch)
    record, got_loss, got = _fit(cfg, loss_fn, batch)
    counters = trace.counters()
    assert counters.get("fit.graph.captures", 0) == 0 and counters.get("fit.graph.replays", 0) == 0
    assert record["losses"] == losses and len(losses) == epochs
    assert got_loss == best_loss
    assert all(torch.equal(a, b) for a, b in zip(got, leaves))


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: its capture ran the step once (on the card the first
    replay runs it); every later replay runs the step into the captured output, in place, as the card's does."""

    steps = []

    def __init__(self):
        self.replays = 0

    def replay(self):
        if self.replays:
            graphed = self.steps[-1]
            graphed.value.copy_(graphed.step())
        self.replays += 1

    def reset(self):
        pass


@contextlib.contextmanager
def _capture(graph, stream=None):
    yield


@pytest.fixture
def cpu_graph(monkeypatch):
    """The graph's step on the CPU: every fit engages it, with the stand-ins above and Adam as built today (a
    capturable Adam takes CUDA tensors only)."""
    _Graph.steps = made = []
    init = loops._StepGraph.__init__

    def keep(self, step, device):
        init(self, step, device)
        made.append(self)

    monkeypatch.setattr(loops._StepGraph, "__init__", keep)
    monkeypatch.setattr(loops, "_graphed", lambda device, ranks, epochs: epochs >= loops.EAGER_STEPS + 2)
    monkeypatch.setattr(loops, "_side_stream", lambda device: _Stream())
    real_optimizer = loops.optimizer
    monkeypatch.setattr(loops, "optimizer", lambda method, leaves, lr, capturable=False: real_optimizer(method, leaves, lr))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _capture)
    return made


@pytest.mark.parametrize("track_best", ["overall", "per_lineout"])
def test_the_graph_step_rehearsed_on_the_cpu_takes_the_eager_steps(cpu_graph, track_best):
    epochs = 7
    cfg, loss_fn, batch = _setup(epochs, track_best)
    losses, best_loss, leaves = _eager_reference(cfg, loss_fn, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        record, got_loss, got = _fit(cfg, loss_fn, batch)
    (graphed,) = cpu_graph
    assert graphed.graph is None and graphed.value is None  # released when the fit returned
    counters = trace.counters()
    assert counters["fit.graph.captures"] == 1 and counters["fit.graph.replays"] == epochs - loops.EAGER_STEPS
    assert record["losses"] == losses and len(losses) == epochs
    assert got_loss == best_loss
    assert all(torch.equal(a, b) for a, b in zip(got, leaves))
    records = trace.spans()
    children = {}
    for r in records:
        children.setdefault(r["parent"], []).append(r["name"])
    steps = [r for r in records if r["name"] == "fit.step"]
    assert len(steps) == epochs
    inner = [[n for n in children.get(s["index"], []) if n.startswith("fit.")] for s in steps]
    assert inner == [["fit.best"]] + [["fit.capture", "fit.replay"]] + [["fit.replay"]] * (epochs - 2)
    capture = next(r for r in records if r["name"] == "fit.capture")
    assert children[capture["index"]] == ["loss.forward", "loss.backward", "optimizer.step", "fit.best"]


@pytest.mark.cuda
def test_twenty_graph_steps_of_the_real_data_deck_are_the_eager_steps():
    """128 lineouts of shot 101675 (pixels 300:812:4), 20 adam steps at lr 2e-2 with per-lineout best-so-far
    (``chip_smoke.graph_against_eager``): the graphed fit's losses within 1e-5 relative of the eager fit's, and the
    same best-so-far rows as the same arithmetic run eagerly (Adam capturable), to 1e-5 of each leaf's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured on the card")
    import chip_smoke
    from tsadar_tpu_torch.utils.process.prepare import prepare_data

    cfg = chip_smoke.load_real_deck(*chip_smoke.REAL_PIXELS, chip_smoke.N_LINEOUTS)
    all_data, sa, _ = prepare_data(cfg, cfg["data"]["shotnum"])
    batch = chip_smoke.real_batch(all_data)
    fit_cfg = chip_smoke.fit_config(cfg, chip_smoke.N_LINEOUTS, 20)
    got = chip_smoke.graph_against_eager(fit_cfg, port.LossFunction(fit_cfg, sa, batch), batch, steps=20)
    assert got["captures"] == 1 and got["replays"] == 19 and got["eager_replays"] == 0
    assert got["loss_miss"] <= 1e-5, got["loss_miss"]
    assert got["leaf_miss"] <= 1e-5, got["leaf_miss"]
