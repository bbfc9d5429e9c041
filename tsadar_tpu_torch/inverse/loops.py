"""Optimizer loops for 1D (batched-lineout) fitting.

Counterpart of ``tsadar_tpu.inverse.loops`` for ``method: adam``:
``_1d_adam_loop_`` (adam epochs with best-so-far tracking) and ``one_d_loop``
(the batch dispatch with the optional sequential warm start).  The scipy and
L-BFGS loops and the angular fit are not ported yet (ROADMAP.md §1 items 11
and 12).

Adam is ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8): the same update as
``optax.adam``.  The whole lineout batch is one set of [B] parameters, so one
step is one forward and one backward of the batch; there is no mesh.
"""

import copy
import time

import numpy as np
import torch

from ..core.params.ts_params import ThomsonParams, get_filter_spec
from .loss import LossFunction


def _init_params(config, previous_weights, batch_size=None, device=None, dtype=None):
    """Parameters to start a fit from: a copy of ``previous_weights``, or the deck's values."""
    if previous_weights is not None:
        return copy.deepcopy(previous_weights)  # the optimizer updates in place; leave the caller's untouched
    bs = batch_size if batch_size is not None else config["optimizer"]["batch_size"]
    return ThomsonParams.create(config["parameters"], bs, activate=True, device=device, dtype=dtype)


def _slice_batch(all_data, rows):
    """Model-facing batch dict for a set of lineout rows (1D spectypes)."""
    return {
        "e_data": all_data["e_data"][rows],
        "e_amps": all_data["e_amps"][rows],
        "i_data": all_data["i_data"][rows],
        "i_amps": all_data["i_amps"][rows],
        "noise_e": all_data["noiseE"][rows],
        "noise_i": all_data["noiseI"][rows],
    }


def _1d_adam_loop_(config, loss_fn: LossFunction, previous_weights, batch, record=None):
    """Adam epochs over one lineout batch: ``(best loss, best parameters)``.

    The semantics of the JAX loop: the pre-update loss is credited to the
    post-update parameters; ``optimizer.track_best: per_lineout`` keeps each
    lineout's best-so-far parameters by its own row loss and reports the
    assembled parameters' actual joint loss; ``num_epochs == 0`` returns
    ``(inf, initial parameters)``.

    Best-so-far lives on the device (``torch.where``); the host reads nothing
    until the fit is over.  ``optimizer.chunk_size`` (default 8) matters only
    to a run that records: with ``record`` (a dict) given, the host reads the
    losses once per chunk of that many steps:
    ``record["losses"]`` gets every step's pre-update loss and
    ``record["chunk_seconds"]`` / ``record["chunk_steps"]`` the host time of
    each chunk, synchronized at its end.
    """
    dev, dtype = loss_fn.ts_diag.device, loss_fn.ts_diag.dtype
    ts_params = _init_params(config, previous_weights, device=dev, dtype=dtype)
    trainable = get_filter_spec(config["parameters"], ts_params)
    leaves = list(trainable.values())
    per_lineout = config["optimizer"].get("track_best", "overall") == "per_lineout"

    num_epochs = config["optimizer"]["num_epochs"]
    if num_epochs == 0:
        return np.inf, ts_params

    batch = loss_fn.device_batch(batch)  # once per fit, not per step
    opt = torch.optim.Adam(leaves, lr=config["optimizer"]["learning_rate"], betas=(0.9, 0.999), eps=1e-8)
    best_loss = torch.full((), np.inf, dtype=dtype, device=dev)
    best_rows = torch.full((batch["e_data"].shape[0],), np.inf, dtype=dtype, device=dev)
    best = [p.detach().clone() for p in leaves]

    chunk = max(1, int(config["optimizer"].get("chunk_size", 8)))
    done = 0
    while done < num_epochs:
        length = min(chunk, num_epochs - done)
        t0 = time.perf_counter()
        values = []
        for _ in range(length):
            (value, aux), grads = loss_fn.value_and_grad(ts_params, batch, trainable)
            for p, g in zip(leaves, grads.values()):
                p.grad = g
            opt.step()
            with torch.no_grad():
                improved = value < best_loss
                best_loss = torch.where(improved, value, best_loss)
                if per_lineout:  # every trainable leaf is per lineout ([B]): select by the row's own loss
                    improved = aux[2] < best_rows
                    best_rows = torch.where(improved, aux[2], best_rows)
                best = [torch.where(improved, p, b) for p, b in zip(leaves, best)]
            values.append(value)
        if record is not None:
            losses = torch.stack(values).tolist()  # the chunk's one host read; synchronizes
            record.setdefault("losses", []).extend(losses)
            record.setdefault("chunk_seconds", []).append(time.perf_counter() - t0)
            record.setdefault("chunk_steps", []).append(length)
        done += length

    with torch.no_grad():
        for p, b in zip(leaves, best):
            p.copy_(b)
        if per_lineout:
            # the assembled parameters mix epochs per lineout: report their actual joint loss
            best_loss = loss_fn.__loss__(ts_params, batch)[0]
    for p in leaves:
        p.grad = None
    return float(best_loss), ts_params


def one_d_loop(config, all_data, sa, batch_indices, num_batches, device=None, dtype=None):
    """Batched-lineout fitting loop: ``(parameters per batch, summed best loss, loss function)``."""
    method = config["optimizer"]["method"]
    if method != "adam":
        raise NotImplementedError(f"optimizer method {method!r} is not ported yet (ROADMAP.md §1 item 11)")
    bs = config["optimizer"]["batch_size"]
    loss_fn = LossFunction(config, sa, _slice_batch(all_data, slice(0, bs)), device=device, dtype=dtype)

    batch_indices = np.reshape(batch_indices, (-1, bs))
    all_weights, overall_loss, previous_weights = [], 0.0, None
    for i_batch in range(num_batches):
        batch = _slice_batch(all_data, batch_indices[i_batch])
        best_loss, best_weights = _1d_adam_loop_(config, loss_fn, previous_weights, batch)
        all_weights.append(best_weights)
        overall_loss += best_loss
        if config["optimizer"].get("sequential", False):
            previous_weights = best_weights
    return all_weights, overall_loss, loss_fn
