"""Multi-GPU sharding: one rank per device over ``torch.distributed``.

The counterpart of ``tsadar_tpu.parallel.mesh`` and of the JAX fit loop's
mesh helpers (``_fit_mesh``, ``_batched_leaf_mask``, ``_shard_fit_state``).
Where JAX lays one program over a device mesh and lets GSPMD insert the
collectives, the port runs one process per device (``torchrun``), each with
its own host thread driving its own card, and calls the collectives itself:

* the 1D fit shards its lineout batch: each of the fitting ranks takes
  contiguous rows of the batch and of every per-lineout parameter leaf
  (``shard_params``), runs the kernels on them, and the loss's means and
  penalties are summed over the ranks before any non-linear step
  (``inverse.loss``);
* the 2V table mode shards its chi evaluation points (``FormFactor``'s
  ``shard_points``): each rank looks its slice up and ``gather_points``
  returns the whole arrays to every rank.

A loss that every rank computes identically (the same value from the same
all-reduced sums) is the rule that the collectives' backward passes are
written for:

* ``sum_replicated``: all-reduce SUM forward, identity backward (each rank's
  gradient is then its own shard's share of the global loss's);
* ``gather_points``: a rank's slice written into zeros of the full length and
  all-reduced (gloo takes ``all_reduce`` and ``broadcast`` of CUDA tensors, not
  ``all_gather``), and the rank's own slice of the cotangent backward;
* ``scatter_points`` and ``replicated_input``, their adjoints: the rank's slice
  forward with the gathered cotangent backward, and the identity forward with
  the cotangent summed over the ranks backward (a replicated table read by
  every rank's slice of the queries);
* ``allreduce_grads``: after a backward, the SUM over the ranks of the
  gradients of leaves that every rank holds whole but that each rank's shard
  touched only in part.

``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient again
in its backward: under a replicated loss that is W times too large, so the
port does not use it.

The process group comes from ``torchrun``'s variables (``init_from_env``):
``nccl`` for CUDA ranks, ``gloo`` for CPU ranks, ``gloo`` for CUDA ranks only
when the caller names it (``backend="gloo"``), which is how two ranks share one
card: NCCL refuses that, and the port raises with the cause.  ``COUNTS`` holds
the collectives this process called.
"""

import contextlib
import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

COUNTS = {"all_reduce": 0, "broadcast": 0}
_LOCAL = [False]  # inside local(): this rank works alone
TIMEOUT_ENV = "TSADAR_DIST_TIMEOUT"  # seconds a collective may wait (torch's default when unset)


def initialized():
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size():
    return dist.get_world_size() if initialized() else 1


def rank():
    return dist.get_rank() if initialized() else 0


def backend_for(device, backend=None):
    """The backend of ranks on ``device``: ``backend``, else nccl for CUDA and gloo for the CPU.  NCCL on CPU ranks
    raises."""
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError("NCCL runs on CUDA ranks only; CPU ranks take gloo")
    return backend


def rank_device(device=None, backend=None, local_rank=None):
    """This rank's device: ``cuda:LOCAL_RANK`` (made current), or the CPU when ``device`` is "cpu".

    Under NCCL each rank needs a card of its own: a LOCAL_RANK beyond the
    visible cards raises.  Under gloo, named by the caller, ranks beyond the
    visible cards share them in turn (two ranks on one card).
    """
    device = resolve_device(device)
    if device.type == "cpu":
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", "0")) if local_rank is None else local_rank
    count = torch.cuda.device_count()
    if local_rank >= count:
        if backend_for(device, backend) == "nccl":
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own ({count} visible): NCCL refuses two ranks on one "
                f"device; start at most {count} ranks a host, or name the gloo backend (backend='gloo')"
            )
        local_rank %= count
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def init_from_env(device=None, backend=None, init_method="env://", world=None, rank_=None, timeout=None):
    """Join the process group that ``torchrun`` describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``; or ``world`` and ``rank_`` with another ``init_method``): this rank's
    device.  ``timeout`` (seconds; default ``$TSADAR_DIST_TIMEOUT``, else torch's) bounds every collective."""
    dev = rank_device(device, backend)
    timeout = timeout if timeout is not None else os.environ.get(TIMEOUT_ENV)
    kwargs = {"timeout": datetime.timedelta(seconds=float(timeout))} if timeout else {}
    if world is not None:
        kwargs.update(world_size=world, rank=rank_)
    dist.init_process_group(backend=backend_for(dev, backend), init_method=init_method, **kwargs)
    return dev


def wanted():
    """Whether this process is to join a process group: ``TSADAR_MULTIHOST`` is set, or ``torchrun`` started more
    than one rank."""
    return bool(os.environ.get("TSADAR_MULTIHOST")) or int(os.environ.get("WORLD_SIZE", "1")) > 1


@contextlib.contextmanager
def process_group(device=None):
    """The process group for the block, when ``wanted()`` and none is up yet, destroyed at its end, errors
    included; otherwise nothing."""
    start = wanted() and not initialized()
    if start:
        init_from_env(device)
    try:
        yield
    finally:
        if start and initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def local():
    """Inside the block this rank works alone: no fit is sharded and no point set split (rank 0's postprocess)."""
    prev, _LOCAL[0] = _LOCAL[0], True
    try:
        yield
    finally:
        _LOCAL[0] = prev


def sharing():
    """Whether a fit or a point set may be shared between the ranks here (a group is up, outside ``local()``)."""
    return initialized() and not _LOCAL[0]


@dataclasses.dataclass(frozen=True)
class Ranks:
    """The ranks that share one piece of work: this rank's index among them, their number, their process
    group (None: the whole world), and whether this rank is one of them."""

    index: int
    size: int
    group: object = None
    member: bool = True

    def bounds(self, n):
        """(start, stop) of this rank's contiguous share of ``n`` items (the first n % size ranks take one more)."""
        q, r = divmod(n, self.size)
        start = self.index * q + min(self.index, r)
        return start, start + q + (self.index < r)


def fit_ranks(config, world, device=None):
    """How many of ``world`` ranks fit the lineout batch: ``_fit_mesh``'s rule.

    ``optimizer.parallel`` (default: on for CUDA, off for the CPU) off means
    one; on, the largest count up to ``world`` that divides
    ``optimizer.batch_size`` (a batch is never padded).
    """
    parallel = config["optimizer"].get("parallel", None)
    if parallel is None:
        parallel = torch.device(device or "cuda").type == "cuda"
    if not parallel:
        return 1
    bs = config["optimizer"]["batch_size"]
    n = max(1, min(world, bs))
    while bs % n:
        n -= 1
    return n


def fit_group(config, device=None):
    """The ``Ranks`` of a sharded 1D fit, or None outside a process group (and inside ``local()``).

    Every rank of the world calls it (a subgroup is made collectively); ranks
    past ``fit_ranks`` are no members: they take no lineouts and receive the
    result (``broadcast_params``).
    """
    if not sharing():
        return None
    n, world, me = fit_ranks(config, world_size(), device), world_size(), rank()
    group = None if n == world else dist.new_group(list(range(n)))
    return Ranks(index=me if me < n else 0, size=n, group=group, member=me < n)


def point_ranks():
    """The ``Ranks`` of the world, sharing a 2V point set, or None where there is no one to share with."""
    if not sharing() or world_size() == 1:
        return None
    return Ranks(index=rank(), size=world_size())


def _all_reduce(t, group):
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def _gathered(x, ranks, n):
    out = x.new_zeros((n,) + tuple(x.shape[1:]))
    start, stop = ranks.bounds(n)
    out[start:stop] = x
    return _all_reduce(out, ranks.group)


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, n):
        ctx.span = ranks.bounds(n)
        return _gathered(x, ranks, n)

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.span
        return g[start:stop], None, None


class _ScatterPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks, ctx.n = ranks, x.shape[0]
        start, stop = ranks.bounds(x.shape[0])
        return x[start:stop].clone()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g.contiguous(), ctx.ranks, ctx.n), None


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def sum_replicated(x, ranks):
    """The SUM of ``x`` over the ranks on every rank; its backward is the identity (a replicated loss)."""
    return _SumReplicated.apply(x, ranks.group)


def gather_points(x, ranks, n):
    """The whole [n, ...] array on every rank from each rank's rows ``ranks.bounds(n)`` of it; backward, the
    rank's own rows of the cotangent."""
    return _GatherPoints.apply(x, ranks, n)


def scatter_points(x, ranks):
    """This rank's rows ``ranks.bounds(len(x))`` of ``x``, which every rank holds whole; backward, the cotangent
    gathered from every rank's rows."""
    return _ScatterPoints.apply(x, ranks)


def replicated_input(x, ranks):
    """``x``, which every rank holds whole and each reads in part; backward, the cotangent summed over the
    ranks."""
    return _ReplicatedInput.apply(x, ranks.group)


def allreduce_grads(grads, ranks):
    """The SUM over the ranks of each of ``grads`` (one collective for them all): the gradients of replicated
    leaves after a backward.  Returns new tensors."""
    if not grads:
        return []
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), ranks.group)
    return [f.view_as(g) for f, g in zip(torch.split(flat, [g.numel() for g in grads]), grads)]


def global_dot(mask, ranks):
    """The inner product over every rank of flat vectors whose entries ``mask`` marks as this rank's rows (True)
    or as replicated on every rank (False, counted once)."""
    w = torch.where(mask, 1.0, float(ranks.index == 0)).to(torch.float64)

    def dot(a, b):
        return _all_reduce(torch.sum(w.to(a.dtype) * a * b).reshape(1), ranks.group)[0]

    return dot


def broadcast_object(obj, src=0):
    """``obj`` from rank ``src`` on every rank (picklable host data: numpy arrays, dicts)."""
    COUNTS["broadcast"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_tensors(tensors, src=0):
    """Overwrite each of ``tensors`` on every rank with rank ``src``'s, one collective a dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        COUNTS["broadcast"] += 1
        dist.broadcast(flat, src=src)
        with torch.no_grad():
            for t, f in zip(ts, torch.split(flat, [t.numel() for t in ts])):
                t.copy_(f.view_as(t))


# ---------------------------------------------------------------- the lineout batch and its parameters


def batched_leaf_mask(config, ts_params):
    """{state name: per lineout?} of ``ts_params`` (a ``ThomsonParams``): ``_batched_leaf_mask``'s rule, a leaf
    is per lineout when its shape differs from the same leaf of a ``num_params=1`` instance (not by its leading
    dimension: with ``nvx == batch_size`` the velocity grid stays whole)."""
    from ..core.params.ts_params import ThomsonParams

    ref = ThomsonParams(config["parameters"], 1, activate=True).state_dict()
    return {k: tuple(v.shape) != tuple(ref[k].shape) for k, v in ts_params.state_dict().items()}


def shard_batch(batch, ranks):
    """This rank's contiguous rows of every entry of a lineout batch dict."""
    out = {}
    for k, v in batch.items():
        start, stop = ranks.bounds(len(v))
        out[k] = v[start:stop]
    return out


def shard_params(config, ts_params, ranks, mask=None):
    """A ``ThomsonParams`` of this rank's rows of ``ts_params`` (per-lineout leaves cut, the rest copied), and the
    leaf mask."""
    from ..core.params.ts_params import ThomsonParams

    mask = batched_leaf_mask(config, ts_params) if mask is None else mask
    full = ts_params.state_dict()
    n = config["optimizer"]["batch_size"]
    start, stop = ranks.bounds(n)
    ref = next(iter(full.values()))
    local = ThomsonParams(config["parameters"], stop - start, activate=True).to(device=ref.device, dtype=ref.dtype)
    local.load_state_dict({k: v[start:stop] if mask[k] else v for k, v in full.items()})
    return local, mask


def unshard_params(local, ts_params, ranks, mask):
    """Write every rank's rows of ``local`` into the per-lineout leaves of ``ts_params`` on every rank (one
    collective a leaf) and ``local``'s other leaves as they are; returns ``ts_params``."""
    full, mine = ts_params.state_dict(), local.state_dict()
    with torch.no_grad():
        for k, t in full.items():
            t.copy_(_gathered(mine[k].detach(), ranks, t.shape[0]) if mask[k] else mine[k])
    return ts_params
