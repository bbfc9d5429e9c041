"""A pool of CPU ranks in a ``gloo`` process group, for the port's sharding tests.

``RankPool(world, store)`` spawns ``world`` processes once (a module fixture
keeps them across its cases, so the spawn and the imports are paid once); each
joins one process group through a file store (``file://``: no TCP port, so
pytest-xdist's workers never meet) and then runs the tasks it is handed, one
at a time, with one PyTorch intra-op thread.  ``run(task, *args)`` hands every
rank the function ``task`` of this module and returns the ranks' results in
rank order; a rank that raises fails the call with its traceback, and a call
that does not end within ``TIMEOUT`` seconds fails too and ends the pool (the
group's collectives time out in that time as well).  The tasks import the
port only, never JAX: the JAX oracle runs in the test's own process.
"""

import multiprocessing as mp
import queue
import traceback

import numpy as np

TIMEOUT = 120


def _serve(rank, world, store, tasks, results):
    import torch

    torch.set_num_threads(1)
    from tsadar_tpu_torch.parallel import dist as par

    par.init_from_env("cpu", init_method=f"file://{store}", world=world, rank_=rank, timeout=TIMEOUT)
    try:
        while True:
            job = tasks.get()
            if job is None:
                break
            name, args = job
            try:
                results.put((rank, True, globals()[name](*args)))
            except Exception:  # the parent raises it
                results.put((rank, False, traceback.format_exc()))
    finally:
        torch.distributed.destroy_process_group()


class RankPool:
    def __init__(self, world, store):
        ctx = mp.get_context("spawn")
        self.world, self.results = world, ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_serve, args=(r, world, str(store), self.tasks[r], self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, task, *args, timeout=TIMEOUT):
        """``task(*args)`` on every rank: the results by rank."""
        for q in self.tasks:
            q.put((task.__name__, args))
        out, errors = {}, []
        try:
            for _ in range(self.world):
                rank, ok, value = self.results.get(timeout=timeout)
                (out.__setitem__(rank, value) if ok else errors.append(f"rank {rank}:\n{value}"))
        except queue.Empty:
            self.close()
            raise TimeoutError(f"{task.__name__}: {self.world - len(out) - len(errors)} ranks gave no result in {timeout} s")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [out[r] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------- the tasks (run on every rank)


def _physical(ts_params):
    out = ts_params.get_unnormed_params()
    return {f"{g}.{k}": np.asarray(v.detach()).copy() for g, d in out.items() for k, v in d.items()}


def toy_losses(x, T, w):
    """Two losses over rows ``x`` [n, 3] (split between the ranks), a replicated table ``T`` [3] and a replicated
    scalar ``w``, built from every collective: (their values, the gradients of x, T and w after
    ``allreduce_grads`` summed w's), and the inner product over the ranks of x's rows and w (w counted once)."""
    import torch

    from tsadar_tpu_torch.parallel import dist as par

    ranks = par.Ranks(index=par.rank(), size=par.world_size())
    x, T, w = (torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (x, T, w))
    rows = par.scatter_points(x, ranks)
    y = par.gather_points((rows * par.replicated_input(T, ranks)).sum(-1) * w, ranks, x.shape[0])
    loss_a = (y**2).sum()  # replicated after the gather
    loss_b = par.sum_replicated((rows**2).sum() * w, ranks)  # a sum over the rows, then the replicated loss
    out = []
    for loss in (loss_a, loss_b):
        gx, gT, gw = (torch.zeros_like(a) if g is None else g
                      for g, a in zip(torch.autograd.grad(loss, (x, T, w), allow_unused=True), (x, T, w)))
        (gw,) = par.allreduce_grads([gw], ranks)
        out.append((float(loss.detach()), gx.numpy(), gT.numpy(), float(gw)))
    start, stop = ranks.bounds(x.shape[0])
    mask = torch.tensor([True] * (stop - start) + [False])
    flat = torch.cat([x.detach()[start:stop, 0], w.detach().reshape(1)])
    return out, float(par.global_dot(mask, ranks)(flat, flat))


def one_d_loop(cfg, all_data, num_batches):
    """``one_d_loop`` on the CPU in the group: (summed loss, physical parameters per batch, record, collectives)."""
    from tsadar_tpu_torch import get_scattering_angles
    from tsadar_tpu_torch.inverse.loops import one_d_loop as loop
    from tsadar_tpu_torch.parallel import dist as par

    before = dict(par.COUNTS)
    record = {}
    n = len(all_data["e_data"])
    weights, loss, _ = loop(cfg, all_data, get_scattering_angles(cfg), np.arange(n), num_batches, device="cpu",
                            record=record)
    return loss, [_physical(w) for w in weights], record, {k: v - before[k] for k, v in par.COUNTS.items()}


def uneven_value_and_grad(cfg, batch, state):
    """The loss and gradient at the parameters ``state`` (a whole batch's state dict) with the batch split between
    every rank of the world, unevenly where the rank count does not divide it: (loss, {leaf: the whole batch's
    gradient}, this rank's rows, its row losses)."""
    import torch

    from tsadar_tpu_torch import LossFunction, ThomsonParams, get_scattering_angles
    from tsadar_tpu_torch.parallel import dist as par

    n = cfg["optimizer"]["batch_size"]
    loss_fn = LossFunction(cfg, get_scattering_angles(cfg), batch, device="cpu")
    full = ThomsonParams.create(cfg["parameters"], n, activate=True, device="cpu")
    full.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    ranks = par.Ranks(index=par.rank(), size=par.world_size())
    local, _ = par.shard_params(cfg, full, ranks)
    with loss_fn.sharded(ranks):
        (value, aux), grads = loss_fn.value_and_grad(local, par.shard_batch(batch, ranks))
    whole = {k: par.gather_points(g, ranks, n).numpy() for k, g in grads.items()}
    return float(value), whole, ranks.bounds(n), aux[2].numpy()


def chi_2v_value_and_grad(ff_args, lam_range, f2, vx, w, shard):
    """Value and gradient (fe, Te, ne) of sum(S w) over ``FormFactor.calc_in_2D`` (the JAX test's loss)."""
    import torch

    from tsadar_tpu_torch.core.physics.form_factor import FormFactor

    ff = FormFactor(lam_range, device="cpu", dtype=torch.float64, shard_points=shard, **ff_args)
    fe = torch.tensor(f2, requires_grad=True)
    Te, ne = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (0.5, 0.2))
    one = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    params = {"electron": {"Te": Te, "ne": ne, "fe": fe, "v": torch.tensor(vx)},
              "general": {"lam": one(526.5), "ne_gradient": one(0.0), "Te_gradient": one(0.0), "ud": one(0.0),
                          "Va": one(0.0)},
              "ion-1": {"A": one(1.0), "Z": one(1.0), "Ti": one(0.2), "fract": one(1.0)}}
    S, _ = ff.calc_in_2D(params)
    value = torch.sum(S.squeeze() * torch.tensor(w)[:, None])
    grads = torch.autograd.grad(value, (fe, Te, ne))
    return float(value.detach()), [g.numpy() for g in grads], S.detach().numpy()


def angular_optax(cfg, all_data, sas):
    """``angular_optax`` on the CPU in the group: (losses, the best trainable leaves, collectives)."""
    from tsadar_tpu_torch.core.params import get_filter_spec
    from tsadar_tpu_torch.inverse.loops import angular_optax as loop
    from tsadar_tpu_torch.parallel import dist as par

    before = dict(par.COUNTS)
    record = {}
    best, _, _ = loop(cfg, all_data, sas, device="cpu", record=record)
    leaves = {k: v.detach().numpy().copy() for k, v in get_filter_spec(cfg["parameters"], best).items()}
    return record["losses"], leaves, {k: v - before[k] for k, v in par.COUNTS.items()}
