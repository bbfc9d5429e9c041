"""Optimizer loops: 1D (batched-lineout) fitting and the angular (ARTS) fit.

Counterpart of ``tsadar_tpu.inverse.loops``: ``_1d_adam_loop_`` (adam epochs
with best-so-far tracking), ``_1d_scipy_loop_`` (scipy's minimizer on the
host, ``method: l-bfgs-b`` as the main deck asks, with the loss and its
gradient from the device), ``_1d_device_lbfgs_loop_`` (``method: lbfgs``:
``optax.lbfgs()`` with its zoom line search, transcribed in ``lbfgs.py``, on
the loss's device), ``one_d_loop`` (the batch dispatch with the optional
sequential warm start) and ``angular_optax`` with its step loop
``_angular_loop_`` (one ARTS image or two multiplexed ones, the optimizer by
its optax name, early stopping, checkpoints and state snapshots).

The optimizers are ``optimizers.optimizer``'s, with optax's arithmetic.  The
whole lineout batch is one set of [B] parameters, so one step is one forward
and one backward of the batch.

In a process group (``parallel.dist``; ``torchrun``) ``one_d_loop`` shards the
lineout batch, as the JAX loop lays it over its mesh (``_fit_mesh``): the
fitting ranks (``dist.fit_ranks``) each take contiguous rows of the batch and
of every per-lineout leaf, the loss of those rows is the whole batch's
(``LossFunction.sharded``), and the fitted rows are gathered on every rank of
the world.  Adam is elementwise and runs on each rank's rows, with the
gradients of replicated leaves summed over the ranks; the device L-BFGS takes
every inner product over all ranks; scipy's minimizer runs on every rank on
the whole flat vector, whose gradient is gathered in full, so that its
iterates are the same bits on every rank (checked at the end).  The
optimizer's decisions (best-so-far, the line search's branches) read global
values only, so every rank calls the same collectives.  ``pallas_sharded:
false`` (the JAX loop's plain-XLA guard against a partitioner fault) is
accepted and logged; the kernels still run: the card has no plain path.

The loops log to the tracker (``utils.mlflow_shim``) what the JAX loops log:
``fit_lossfn_init_time`` (the loss function's set-up), ``batch loss`` per
batch, in the adam loop ``fit_param_init_time``, ``fit_first_dispatch_time``
and ``fit_final_loss_time``, and in the angular loop ``epoch loss`` per epoch
and ``fit_first_dispatch_time``.
"""

import copy
import functools
import os
import pickle
import tempfile

import numpy as np
import torch

from ..core.params.ts_params import ThomsonParams, get_filter_spec, jax_path, ravel_order
from ..parallel import dist as par
from ..utils import mlflow_shim as mlflow
from ..utils import trace
from ..utils.console import log_info
from ..utils.process.batches import angular_batch, to_numpy
from . import lbfgs
from .loss import LossFunction, ravel, unravel_into
from .optimizers import optimizer


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


def _shard(config, ts_params, batch, ranks):
    """(parameters, batch, leaf mask) of this rank's rows; the whole of both, and no mask, without ``ranks``."""
    if ranks is None:
        return ts_params, batch, None
    local, mask = par.shard_params(config, ts_params, ranks)
    return local, par.shard_batch(batch, ranks), mask


def _replicated(trainable, ts_params, mask):
    """Which of the ``trainable`` leaves (in order) every rank holds whole (none without a mask)."""
    if mask is None:
        return [False] * len(trainable)
    names = {jax_path(n): n for n, _ in ts_params.named_parameters()}
    return [not mask[names[k]] for k in trainable]


def _summed_grads(grads, replicated, ranks):
    """``grads`` (a list) with those of the replicated leaves summed over the ranks."""
    if ranks is None or not any(replicated):
        return grads
    summed = iter(par.allreduce_grads([g for g, r in zip(grads, replicated) if r], ranks))
    return [next(summed) if r else g for g, r in zip(grads, replicated)]


def _unshard(local, ts_params, ranks, mask):
    """The whole batch's parameters on every fitting rank: ``ts_params`` with every rank's rows of ``local``."""
    return local if ranks is None else par.unshard_params(local, ts_params, ranks, mask)


EAGER_STEPS = 1  # eager steps before the capture: Adam's state, the allocator's blocks, cuBLAS's and cuFFT's set-up
# the fewest epochs at which a graphed fit beat the eager one at 1, 128 and 512 lineouts on an H100 (PERF.md §6):
# at 512 the capture and its memory pool cost about 0.1 s a fit, which 8 epochs did not win back
GRAPH_MIN_EPOCHS = 12


def _graphed(device, ranks, num_epochs):
    """Whether the adam loop replays its step as a CUDA graph: on the card, unsharded (the sharded step's
    collectives stay eager), and with enough epochs to pay for the capture."""
    return device.type == "cuda" and ranks is None and num_epochs >= GRAPH_MIN_EPOCHS


@functools.cache
def _side_stream(device):
    """The stream the eager steps run and the capture records on, one per device for the process: the
    allocator keeps a stream's freed blocks for that stream, so one stream lets each fit reuse the last one's."""
    return torch.cuda.Stream(device)


class _StepGraph:
    """One fit's step on the card: ``EAGER_STEPS`` calls of ``step`` on a side stream, then the
    step captured once as a CUDA graph and replayed once a call, the captured step included (capture runs
    nothing).  Each call returns the step's pre-update loss as a tensor of its own.  ``release()`` drops the
    graph and hands its memory pool back to the allocator."""

    def __init__(self, step, device):
        self.step, self.device, self.eager = step, device, EAGER_STEPS
        self.graph = self.value = None

    def __call__(self):
        if self.eager:
            self.eager -= 1
            side, main = _side_stream(self.device), torch.cuda.current_stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                value = self.step()
            main.wait_stream(side)
            return value
        if self.graph is None:
            with trace.span("fit.capture"):
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, stream=_side_stream(self.device)):
                    self.value = self.step()
            trace.count("fit.graph.captures")
        with trace.span("fit.replay"):
            self.graph.replay()
        trace.count("fit.graph.replays")
        return self.value.clone()

    def release(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.value = None


def _1d_adam_loop_(config, loss_fn: LossFunction, previous_weights, batch, record=None, ranks=None):
    """Adam epochs over one lineout batch: ``(best loss, best parameters)``.

    The semantics of the JAX loop: the pre-update loss is credited to the
    post-update parameters; ``optimizer.track_best: per_lineout`` keeps each
    lineout's best-so-far parameters by its own row loss and reports the
    assembled parameters' actual joint loss; ``num_epochs == 0`` returns
    ``(inf, initial parameters)``.

    Best-so-far lives on the device (``torch.where`` into tensors updated in
    place); the host reads nothing until the fit is over.
    ``optimizer.chunk_size`` (default 8) matters only to a run that records:
    with ``record`` (a dict) given, the host reads the losses once per chunk
    of that many steps: ``record["losses"]`` gets every step's pre-update
    loss and ``record["chunk_seconds"]`` / ``record["chunk_steps"]`` the host
    time of each chunk, synchronized at its end.

    On the card, unsharded, and with at least ``GRAPH_MIN_EPOCHS`` epochs
    (``_graphed``), one step is a CUDA graph: ``EAGER_STEPS`` eager steps set
    up Adam's state (built ``capturable``) and the allocator, the next step is
    captured, and every step from it on is a replay (``_StepGraph``): the same
    step function, the same ``num_epochs`` steps in the same order.  A
    capture that fails raises.  Elsewhere every step runs eagerly.  Each step
    is a ``fit.step`` span, with a ``fit.capture`` and ``fit.replay`` span in
    the graph's; the counters ``fit.graph.captures`` and ``fit.graph.replays``
    count them, and ``ops.launches[...]`` counts the launches of the eager
    and captured steps only.

    The tracker gets ``fit_param_init_time`` (the parameters' and the
    optimizer's set-up), ``fit_first_dispatch_time`` (the first step, read
    back: the kernels' loading, and their build where none is cached, falls
    in it) and, with ``per_lineout``, ``fit_final_loss_time``.

    With ``ranks`` (``parallel.dist.Ranks``) this rank fits its rows of the
    batch: the loss and best-so-far are the whole batch's, ``per_lineout``
    selects by the rank's own rows, and the parameters returned hold every
    rank's rows.
    """
    dev, dtype = loss_fn.ts_diag.device, loss_fn.ts_diag.dtype
    num_epochs = config["optimizer"]["num_epochs"]
    with trace.span("fit", method="adam", B=batch["e_data"].shape[0]):
        with trace.timed("fit.init") as init:
            full = _init_params(config, previous_weights, device=dev, dtype=dtype)
            per_lineout = config["optimizer"].get("track_best", "overall") == "per_lineout"
            if num_epochs == 0:
                return np.inf, full

            ts_params, batch, mask = _shard(config, full, batch, ranks)
            trainable = get_filter_spec(config["parameters"], ts_params)
            leaves = list(trainable.values())
            replicated = _replicated(trainable, ts_params, mask)
            batch = loss_fn.device_batch(batch)  # once per fit, not per step
            graphed = _graphed(dev, ranks, num_epochs)
            opt = optimizer("adam", leaves, config["optimizer"]["learning_rate"], capturable=graphed)
            best_loss = torch.full((), np.inf, dtype=dtype, device=dev)
            best_rows = torch.full((batch["e_data"].shape[0],), np.inf, dtype=dtype, device=dev)
            best = [p.detach().clone() for p in leaves]

        def step():
            with loss_fn.sharded(ranks):
                (value, aux), grads = loss_fn.value_and_grad(ts_params, batch, trainable)
            with trace.span("optimizer.step"):
                for p, g in zip(leaves, _summed_grads(list(grads.values()), replicated, ranks)):
                    p.grad = g
                opt.step()
            with trace.span("fit.best"), torch.no_grad():
                improved = value < best_loss
                torch.where(improved, value, best_loss, out=best_loss)
                if per_lineout:  # every trainable leaf is per lineout ([B]): select by the row's own loss
                    improved = aux[2] < best_rows
                    torch.where(improved, aux[2], best_rows, out=best_rows)
                for p, b in zip(leaves, best):
                    torch.where(improved, p, b, out=b)
            return value

        run_step = _StepGraph(step, dev) if graphed else step
        chunk = max(1, int(config["optimizer"].get("chunk_size", 8)))
        done = 0
        mlflow.log_metrics({"fit_param_init_time": round(init.seconds, 2)})
        while done < num_epochs:
            length = min(chunk, num_epochs - done)
            with trace.timed("fit.chunk") as in_chunk:
                values = []
                for _ in range(length):
                    first = done == 0 and not values
                    with trace.timed("fit.step") as one:
                        values.append(run_step())
                    if first:
                        with trace.timed("fit.readback") as readback:
                            float(values[0])  # the first step, read back
                        mlflow.log_metrics({"fit_first_dispatch_time": round(one.seconds + readback.seconds, 2)})
                if record is not None:
                    with trace.span("fit.readback"):
                        losses = torch.stack(values).tolist()  # the chunk's one host read; synchronizes
            if record is not None:
                record.setdefault("losses", []).extend(losses)
                record.setdefault("chunk_seconds", []).append(in_chunk.seconds)
                record.setdefault("chunk_steps", []).append(length)
            done += length
        if graphed:
            run_step.release()

        with torch.no_grad():
            for p, b in zip(leaves, best):
                p.copy_(b)
            if per_lineout:
                # the assembled parameters mix epochs per lineout: report their actual joint loss
                with trace.timed("fit.final_loss") as final:
                    with loss_fn.sharded(ranks):
                        best_loss = float(loss_fn.__loss__(ts_params, batch)[0])
                mlflow.log_metrics({"fit_final_loss_time": round(final.seconds, 2)})
        for p in leaves:
            p.grad = None
    return float(best_loss), _unshard(ts_params, full, ranks, mask)


def _1d_scipy_loop_(config, loss_fn: LossFunction, previous_weights, batch, record=None, ranks=None):
    """scipy's minimizer over the flat active parameters of one lineout batch: ``(final loss, parameters)``.

    The JAX loop's call as it makes it: ``optimizer.method`` (``l-bfgs-b`` in
    the decks), the gradient from autograd when ``grad_method`` is ``AD``, and
    only ``disp`` and ``maxiter = num_epochs`` as options.  The parameters live
    on the loss's device: each evaluation writes the float64 vector into them
    and reads the loss and its flat gradient back (``_scipy_objective``, as
    ``LossFunction.vg_loss`` does).
    ``record`` (a dict), if given, gets scipy's ``message``, ``nit``, ``nfev``,
    ``success`` and the seconds of the minimization, one entry a call.

    With ``ranks`` every fitting rank runs scipy on the whole vector: an
    evaluation writes it into the whole parameters, the rank's rows of them
    go into its shard, and the shard's gradient is gathered into the whole
    vector's layout; every rank then sees the same values and gradients, and
    its iterates are the same bits as rank 0's (checked at the end).
    """
    import scipy.optimize as spopt

    dev, dtype = loss_fn.ts_diag.device, loss_fn.ts_diag.dtype
    ts_params = _init_params(config, previous_weights, device=dev, dtype=dtype)
    trainable = get_filter_spec(config["parameters"], ts_params)
    order = ravel_order(trainable)
    leaves = [trainable[k] for k in order]
    ad = config["optimizer"]["grad_method"] == "AD"
    with trace.timed("fit", method=config["optimizer"]["method"], B=config["optimizer"]["batch_size"]) as fit:
        res = spopt.minimize(
            _scipy_objective(config, loss_fn, ts_params, batch, ranks, order, ad),
            ravel(leaves),
            method=config["optimizer"]["method"],
            jac=ad,
            options={"disp": config["optimizer"].get("disp", False), "maxiter": config["optimizer"]["num_epochs"]},
        )
    if ranks is not None and not np.array_equal(par.broadcast_object(np.asarray(res["x"]), src=0), res["x"]):
        raise RuntimeError("the ranks' scipy iterates parted: the sharded loss or gradient differs between ranks")
    if record is not None:
        for key, val in (("message", str(res.message)), ("nit", int(res.get("nit", -1))), ("nfev", int(res.nfev)),
                         ("success", bool(res.success)), ("seconds", fit.seconds)):
            record.setdefault(key, []).append(val)
    unravel_into(res["x"], leaves)
    for p in leaves:
        p.grad = None
    return float(res["fun"]), ts_params


def _scipy_objective(config, loss_fn, ts_params, batch, ranks, order, ad):
    """scipy's objective: the whole vector in, written into ``ts_params``; the whole batch's loss (and, with
    ``ad``, the whole flat gradient in ``order``) out.  With ``ranks`` it is evaluated on this rank's rows of
    ``ts_params``, and every rank gets the same values."""
    trainable = get_filter_spec(config["parameters"], ts_params)
    local, local_batch, mask = _shard(config, ts_params, batch, ranks)
    local_batch = loss_fn.device_batch(local_batch)  # once per fit, not per evaluation
    local_trainable = get_filter_spec(config["parameters"], local)
    replicated = _replicated(local_trainable, local, mask)
    n = config["optimizer"]["batch_size"]

    def write(x):
        unravel_into(x, [trainable[k] for k in order])
        if ranks is not None:  # this rank's rows into its shard
            start, stop = ranks.bounds(n)
            with torch.no_grad():
                for k, rep in zip(local_trainable, replicated):
                    local_trainable[k].copy_(trainable[k] if rep else trainable[k][start:stop])

    def objective(x):
        write(x)
        with loss_fn.sharded(ranks):
            if not ad:
                with torch.no_grad():
                    return float(loss_fn.__loss__(local, local_batch)[0])
            (value, _), grads = loss_fn.value_and_grad(local, local_batch, local_trainable)
        grads = dict(zip(grads, _summed_grads(list(grads.values()), replicated, ranks)))
        whole = {k: g if ranks is None or rep else par.gather_points(g, ranks, n)
                 for (k, g), rep in zip(grads.items(), replicated)}
        return float(value), ravel([whole[k] for k in order])

    return objective


def _1d_device_lbfgs_loop_(config, loss_fn: LossFunction, previous_weights, batch, record=None, ranks=None):
    """``num_epochs`` L-BFGS steps over the flat active parameters of one lineout batch: ``(value, parameters)``.

    The JAX loop's steps: ``optax.lbfgs()`` with the zoom line search
    (``lbfgs.step``), the value and gradient of each step reused from the line
    search that ended there.  As there, the value returned is the one at the
    start of the last step and the parameters are those after it
    (``num_epochs == 0``: ``(inf, initial parameters)``).  The vector lives on
    the loss's device in its dtype, in the ``ravel_pytree`` order.  ``record``
    (a dict), if given, gets per step the value (``losses``), the loss
    evaluations (``evaluations``) and the step size (``stepsizes``), and the
    seconds of the loop (``seconds``), one entry a call.

    With ``ranks`` the vector holds this rank's rows, and every inner product
    of the memory and the line search is taken over all ranks
    (``parallel.dist.global_dot``): the steps are the unsharded ones.
    """
    dev, dtype = loss_fn.ts_diag.device, loss_fn.ts_diag.dtype
    full = _init_params(config, previous_weights, device=dev, dtype=dtype)
    ts_params, batch, mask = _shard(config, full, batch, ranks)
    trainable = get_filter_spec(config["parameters"], ts_params)
    order = ravel_order(trainable)
    leaves = [trainable[k] for k in order]
    replicated = _replicated({k: trainable[k] for k in order}, ts_params, mask)
    batch = loss_fn.device_batch(batch)  # once per fit, not per evaluation
    dot = None
    if ranks is not None:
        per_row = torch.cat([torch.full((p.numel(),), not r, dtype=torch.bool, device=dev)
                             for p, r in zip(leaves, replicated)])
        dot = par.global_dot(per_row, ranks)
    evaluations = 0

    def write(x):
        with torch.no_grad():
            for p, v in zip(leaves, torch.split(x, [p.numel() for p in leaves])):
                p.copy_(v.view_as(p))

    def value_and_grad(x):
        nonlocal evaluations
        evaluations += 1
        write(x)
        with loss_fn.sharded(ranks):
            (value, _), grads = loss_fn.value_and_grad(ts_params, batch, trainable)
        grads = _summed_grads([grads[k] for k in order], replicated, ranks)
        return value, torch.cat([g.reshape(-1) for g in grads])

    x = torch.cat([p.detach().reshape(-1) for p in leaves])
    state, value = lbfgs.init(x), np.inf
    with trace.timed("fit", method="lbfgs", B=config["optimizer"]["batch_size"]) as fit:
        for _ in range(config["optimizer"]["num_epochs"]):
            evaluations = 0
            with trace.span("fit.step"):
                x, value, state = lbfgs.step(x, state, value_and_grad, dot=dot)
            if record is not None:
                record.setdefault("losses", []).append(value)
                record.setdefault("evaluations", []).append(evaluations)
                record.setdefault("stepsizes", []).append(state.learning_rate)
    if record is not None:
        record.setdefault("seconds", []).append(fit.seconds)
    write(x)
    for p in leaves:
        p.grad = None
    return float(value), _unshard(ts_params, full, ranks, mask)


def one_d_loop(config, all_data, sa, batch_indices, num_batches, device=None, dtype=None, record=None):
    """Batched-lineout fitting loop: ``(parameters per batch, summed best loss, loss function)``.

    ``method: adam`` and ``lbfgs`` share one loss function over the batches; a
    scipy method makes a fresh one per batch, as the JAX loop does, and returns
    the last.  ``record`` (a dict) goes to the batch's loop (``_1d_adam_loop_``,
    ``_1d_scipy_loop_`` or ``_1d_device_lbfgs_loop_``).

    In a process group every rank of the world calls it: the fitting ranks
    (``parallel.dist.fit_group``) share each batch, and every rank returns the
    whole batch's parameters and loss (the ranks past the fitting ones
    receive them from rank 0).
    """
    method = config["optimizer"]["method"]
    bs = config["optimizer"]["batch_size"]
    with trace.timed("fit.lossfn_init") as init:
        loss_fn = LossFunction(config, sa, _slice_batch(all_data, slice(0, bs)), device=device, dtype=dtype)
    mlflow.log_metrics({"fit_lossfn_init_time": round(init.seconds, 2)})
    ranks = par.fit_group(config, device)
    if ranks is not None:
        log_info(f"lineout batch data-parallel over {ranks.size} of {par.world_size()} ranks")
        if not config["optimizer"].get("pallas_sharded", True):
            log_info("optimizer.pallas_sharded: false has no effect here: each rank runs the kernels on its rows")
    fits = ranks is None or ranks.member

    batch_indices = np.reshape(batch_indices, (-1, bs))
    all_weights, overall_loss, previous_weights = [], 0.0, None
    for i_batch in range(num_batches):
        batch = _slice_batch(all_data, batch_indices[i_batch])
        on = ranks if fits else None
        if not fits:  # no lineouts here: the structure that rank 0's result is received into
            best_loss = 0.0
            best_weights = _init_params(config, previous_weights, device=loss_fn.ts_diag.device, dtype=loss_fn.ts_diag.dtype)
        elif method == "adam":
            best_loss, best_weights = _1d_adam_loop_(config, loss_fn, previous_weights, batch, record=record, ranks=on)
        elif method == "lbfgs":
            best_loss, best_weights = _1d_device_lbfgs_loop_(config, loss_fn, previous_weights, batch, record=record,
                                                             ranks=on)
        else:
            loss_fn = LossFunction(config, sa, batch, device=device, dtype=dtype)
            best_loss, best_weights = _1d_scipy_loop_(config, loss_fn, previous_weights, batch, record=record, ranks=on)
        if ranks is not None and ranks.size < par.world_size():
            par.broadcast_tensors(list(best_weights.state_dict().values()))
            best_loss = par.broadcast_object(best_loss)
        all_weights.append(best_weights)
        mlflow.log_metrics({"batch loss": float(best_loss)}, step=i_batch)
        overall_loss += best_loss
        if config["optimizer"].get("sequential", False):
            previous_weights = best_weights
    return all_weights, overall_loss, loss_fn


def angular_optax(config, all_data, sa, device=None, dtype=None, record=None):
    """ARTS fit of one image, or of two multiplexed ones, with early stopping: ``(best parameters, last counted
    epoch's loss, loss function)``.

    The set-up of the JAX loop, then ``_angular_loop_``.  ``config`` is changed
    as there: batch size 1, and the lineout window divided by
    ``other.ang_res_unit``.  The parameters are unbatched, made from the deck.
    With a list ``data.shotnum`` the batch is ``{"b1", "b2"}``: the window of
    the image and of the second shot's (``*_rot``), whose theory is the EDF
    rotated by ``data.shot_rot``.  The tracker gets ``fit_lossfn_init_time``.
    ``record``: see ``_angular_loop_``.
    """
    with trace.timed("fit.lossfn_init") as init:
        config["optimizer"]["batch_size"] = 1
        lineouts, unit = config["data"]["lineouts"], config["other"]["ang_res_unit"]
        lineouts["start"], lineouts["end"] = int(lineouts["start"] / unit), int(lineouts["end"] / unit)
        sl = slice(lineouts["start"], lineouts["end"])
        batch1 = angular_batch(all_data, sl)
        multiplexed = isinstance(config["data"].get("shotnum"), list)
        batch = {"b1": batch1, "b2": angular_batch(all_data, sl, rot=True)} if multiplexed else batch1
        loss_fn = LossFunction(config, sa, batch1, device=device, dtype=dtype)
    mlflow.log_metrics({"fit_lossfn_init_time": round(init.seconds, 2)})
    dev, dtype = loss_fn.ts_diag.device, loss_fn.ts_diag.dtype
    ts_params = ThomsonParams.create(config["parameters"], 1, activate=True, device=dev, dtype=dtype, batch=False)
    epoch_loss = _angular_loop_(config, loss_fn, ts_params, batch, record=record)
    return ts_params, epoch_loss, loss_fn


def _unnormed_snapshot(config, ts_params, best):
    """The unnormed parameters, as numpy, of ``ts_params`` with its trainable leaves set to ``best``."""
    snap = copy.deepcopy(ts_params)
    with torch.no_grad():
        for p, b in zip(get_filter_spec(config["parameters"], snap).values(), best):
            p.copy_(b)
    return to_numpy(snap.get_unnormed_params())


def _log_state_weights(state_weights):
    """The snapshots {epoch: parameters}, pickled into ``state_weights.txt`` and logged as an artifact."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "state_weights.txt")
        with open(path, "wb") as fh:
            fh.write(pickle.dumps(state_weights))
        mlflow.log_artifact(path)


def _angular_loop_(config, loss_fn: LossFunction, ts_params, batch, record=None):
    """The steps of the ARTS fit: leaves the best-so-far parameters in ``ts_params`` (unbatched) and
    returns the last counted epoch's loss.

    The semantics of the JAX loop.  ``optimizer.method`` names the optimizer
    (``optimizers.METHODS``).  Each step's pre-update loss is credited to the
    post-update parameters; best-so-far (from the JAX loop's initial 100.0)
    lives on the device; the host reads the losses once per
    ``optimizer.chunk_size`` steps (default 8) and replays the per-epoch stop
    counters over them: more than five improvements smaller than 1e-6 in a
    row, or more than five rising epochs, end the fit, chunk-granular.

    With ``optimizer.checkpoint_dir`` the fit first resumes from the newest
    checkpoint there (at its epoch label, with a fresh best-so-far and fresh
    stop counters, as the JAX loop does), and saves the trainable leaves and
    the optimizer's state (``utils.checkpoint``) after a chunk whose counted
    epochs include a multiple of ``optimizer.checkpoint_freq`` (default 50),
    labelled with its last counted epoch, unless the fit stopped in it.  With
    ``optimizer.save_state`` the best parameters so far are snapshotted at
    each counted epoch that is a multiple of ``optimizer.save_state_freq``;
    the snapshots are pickled into ``state_weights.txt`` and logged as an
    artifact at the end.  The tracker gets ``epoch loss`` for each counted
    epoch (its step the epoch) and ``fit_first_dispatch_time`` (the first
    chunk, read back).  ``record`` (a dict), if given, gets ``losses`` (every
    counted epoch), ``chunk_seconds``, ``chunk_steps`` and ``start_epoch``.

    In a process group every rank runs this loop on the same replicated
    parameters (the 2V form factor may split its points between them,
    ``other.shard_2v_points``): the losses, and so the stop rules and the
    optimizer's state, are the same on every rank, and rank 0 writes the
    checkpoints.
    """
    from ..utils.checkpoint import restore_checkpoint, save_checkpoint

    dev, dtype = loss_fn.ts_diag.device, loss_fn.ts_diag.dtype
    opt_cfg = config["optimizer"]
    with trace.span("fit", method=opt_cfg["method"], B=1):
        with trace.span("fit.init"):
            trainable = get_filter_spec(config["parameters"], ts_params)
            leaves = list(trainable.values())
            opt = optimizer(opt_cfg["method"], leaves, opt_cfg["learning_rate"])
            ckpt_dir, ckpt_freq = opt_cfg.get("checkpoint_dir"), opt_cfg.get("checkpoint_freq", 50)
            start_epoch = restore_checkpoint(ckpt_dir, trainable, opt) if ckpt_dir else 0
            if start_epoch:
                log_info(f"resumed angular fit from checkpoint at epoch {start_epoch}")

            batch = loss_fn.device_batch(batch)  # once per fit, not per step
            best_loss_dev = torch.full((), 100.0, dtype=dtype, device=dev)
            best = [p.detach().clone() for p in leaves]
        epoch_loss, best_loss = 0.0, 100.0
        stalled_epochs = rising_epochs = 0
        state_weights = {}
        chunk = max(1, int(opt_cfg.get("chunk_size", 8)))
        num_epochs = opt_cfg["num_epochs"]
        i_epoch, stop = start_epoch, False
        while i_epoch < num_epochs and not stop:
            length = min(chunk, num_epochs - i_epoch)
            with trace.timed("fit.chunk") as in_chunk:
                values = []
                for _ in range(length):
                    with trace.span("fit.step"):
                        (value, _), grads = loss_fn.value_and_grad(ts_params, batch, trainable)
                        with trace.span("optimizer.step"):
                            for p, g in zip(leaves, grads.values()):
                                p.grad = g
                            opt.step()
                        with trace.span("fit.best"), torch.no_grad():
                            improved = value < best_loss_dev
                            best_loss_dev = torch.where(improved, value, best_loss_dev)
                            best = [torch.where(improved, p, b) for p, b in zip(leaves, best)]
                    values.append(value)
                with trace.span("fit.readback"):
                    losses = torch.stack(values).tolist()  # the chunk's one host read; synchronizes
                if i_epoch == start_epoch:
                    mlflow.log_metrics({"fit_first_dispatch_time": round(in_chunk.seconds, 2)})
                n_counted = length  # the epochs a per-epoch loop would have reached
                for j, epoch_loss in enumerate(losses):
                    mlflow.log_metrics({"epoch loss": epoch_loss}, step=i_epoch + j)
                    if epoch_loss < best_loss:
                        improvement, best_loss = best_loss - epoch_loss, epoch_loss
                        if improvement < 1e-6:
                            stalled_epochs += 1
                            stop = stalled_epochs > 5
                            if stop:
                                log_info("Minimizer exited due to change in loss < 1e-6")
                        else:
                            stalled_epochs = rising_epochs = 0
                    elif epoch_loss > best_loss:
                        rising_epochs += 1
                        stop = rising_epochs > 5
                        if stop:
                            log_info("Minimizer exited due to increase in loss")
                    if stop:
                        n_counted = j + 1
                        break
                counted = range(i_epoch, i_epoch + n_counted)
                if opt_cfg.get("save_state", False):
                    hits = [e for e in counted if e % opt_cfg["save_state_freq"] == 0]
                    if hits:
                        snap = _unnormed_snapshot(config, ts_params, best)
                        state_weights.update((e, snap) for e in hits)
                # no checkpoint past an early stop: a resume would go on with a fit that has ended; in a process group
                # the ranks' states are the same, and rank 0 writes them
                if ckpt_dir and not stop and any(e % ckpt_freq == 0 for e in counted) and mlflow.writer():
                    save_checkpoint(ckpt_dir, trainable, opt, i_epoch + n_counted - 1)
                if record is not None:
                    record.setdefault("losses", []).extend(losses[:n_counted])
                    record.setdefault("chunk_seconds", []).append(in_chunk.seconds)
                    record.setdefault("chunk_steps", []).append(length)
            i_epoch += length

        with torch.no_grad():
            for p, b in zip(leaves, best):
                p.copy_(b)
        for p in leaves:
            p.grad = None
        if record is not None:
            record["start_epoch"] = start_epoch
        _log_state_weights(state_weights)
    return epoch_loss
