"""The sharded 1D fit (``tsadar_tpu_torch.parallel``) on CPU ranks against the JAX package's sharded and unsharded fits.

The port shards a lineout batch between ranks of a ``gloo`` process group, one
process a rank (``tests/torch_dist.py``: groups of 2 and 4 ranks, spawned once
for this module); the JAX package lays the same batch over its virtual
8-device CPU mesh (``tests/conftest.py``).  On the small 1D deck of
``__graft_entry__`` (batch 8, float64), the twins of
``tests/test_parallel/test_sharding.py``:

* ``one_d_loop`` with adam (2 epochs) and with scipy's L-BFGS-B (2
  iterations), at 2 and 4 ranks: the summed loss and every fitted parameter,
  on every rank, against the port unsharded to 1e-10 relative (only the order
  of the sums differs), against the JAX package's sharded and unsharded fits
  to the port's own tolerances against JAX (adam 1e-8,
  ``tests/test_torch_adam_loop.py``; scipy 1e-6, ``tests/test_torch_scipy_loop.py``);
* ``fit_ranks``: ``_fit_mesh``'s trimming (batch 6 on 8 -> 6, 7 -> 7, 1 -> 1,
  ``parallel: false`` and the CPU's default -> 1), and a fit of batch 6 on 4
  ranks: 3 fit, the fourth receives the result, all equal to the unsharded
  fit;
* the leaf mask with ``nvx == batch_size``: the velocity grid stays whole, the
  per-lineout leaves are cut;
* the collectives' backward passes, on a small function of split rows, a
  replicated table and a replicated scalar, against one process's autograd;

and the loss itself: a batch of 5 split 3 + 2 (and 2 + 1 + 1 + 1), so the
shards' masked means hold different counts, with ``fe_decrease_strict``
(an ``Arbitrary1V`` EDF spread per lineout, so that the tan fires),
``bound_penalty`` (an inactive Z out of its bounds) and ``moment_loss`` on:
the value and every gradient equal the unsharded ones to 1e-12 relative (of
each leaf's largest entry for the gradients).  A collective whose backward
multiplied by the rank count would fail it.  With Te spread per lineout as
well, one lineout lies near a narrow resonance, where the rounding of a
batched product that depends on the batch's rows (a 1-row shard against the
5-row batch) is magnified: that lineout's spectrum moves by 5.7e-12 of its
peak between the two shapes with no sharding at all, and its gradients by
2.7e-12 of their largest entry under 4 ranks; that case holds the value to
1e-12 and the gradients to 1e-11.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tsadar_tpu.inverse.loops import _fit_mesh, one_d_loop as jax_one_d_loop
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.inverse.loops import one_d_loop
from tsadar_tpu_torch.parallel import dist as par

from . import torch_dist
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

BATCH = 8
SHARDED_RTOL = 1e-10
JAX_RTOL = {"adam": 1e-8, "l-bfgs-b": 1e-6}


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {w: torch_dist.RankPool(w, tmp_path_factory.mktemp(f"store{w}") / "store") for w in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


def _all_data(n):
    d = ge._make_batch(n)
    return {"e_data": d["e_data"], "i_data": d["i_data"], "e_amps": d["e_amps"], "i_amps": d["i_amps"],
            "noiseE": d["noise_e"], "noiseI": d["noise_i"]}


def _cfg(method, batch=BATCH, parallel=True):
    cfg = ge._small_config(batch)
    cfg["optimizer"].update(method=method, learning_rate=1e-2, num_epochs=2, chunk_size=2, parallel=parallel)
    return cfg


def _physical(ts_params):
    out = ts_params.get_unnormed_params()
    return {f"{g}.{k}": np.asarray(v) for g, d in out.items() for k, v in d.items()}


@pytest.fixture(scope="module")
def jax_fits():
    """{(method, parallel): (summed loss, physical parameters)} of the JAX package's ``one_d_loop``, made once."""
    done = {}

    def fit(method, parallel):
        if (method, parallel) not in done:
            cfg = _cfg(method, parallel=parallel)
            assert (_fit_mesh(cfg) is not None) == parallel
            weights, loss, _ = jax_one_d_loop(cfg, _all_data(BATCH), jax_angles(cfg), np.arange(BATCH), 1)
            done[method, parallel] = float(loss), _physical(weights[0])
        return done[method, parallel]

    return fit


def _unsharded(cfg, all_data):
    weights, loss, _ = one_d_loop(cfg, all_data, port.get_scattering_angles(cfg), np.arange(len(all_data["e_data"])), 1,
                                  device="cpu")
    return float(loss), torch_dist._physical(weights[0])


def _assert_params(got, want, rtol, label):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=0, err_msg=f"{label}: {k}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("method", ["adam", "l-bfgs-b"])
def test_one_d_loop_data_parallel_matches_single(pools, jax_fits, method, world):
    cfg = _cfg(method)
    results = pools[world].run(torch_dist.one_d_loop, cfg, _all_data(BATCH), 1)
    single_loss, single = _unsharded(_cfg(method, parallel=False), _all_data(BATCH))
    for rank, (loss, weights, record, counts) in enumerate(results):
        assert counts["all_reduce"] > 0, f"rank {rank} called no collective"
        np.testing.assert_allclose(loss, single_loss, rtol=SHARDED_RTOL, err_msg=f"rank {rank}")
        _assert_params(weights[0], single, SHARDED_RTOL, f"rank {rank} against the port unsharded")
        assert loss == results[0][0]  # every rank reports the same bits
    if method == "adam":
        assert len(results[0][2]["losses"]) == 2 and results[0][2]["losses"] == results[-1][2]["losses"]
    for parallel in (True, False):
        jax_loss, jax_params = jax_fits(method, parallel)
        np.testing.assert_allclose(results[0][0], jax_loss, rtol=JAX_RTOL[method])
        _assert_params(results[0][1][0], jax_params, JAX_RTOL[method], f"against JAX, parallel {parallel}")


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_backward_passes_for_a_replicated_loss(pools, world):
    """Every collective of ``parallel.dist`` on rows split unevenly (5 on 2 or 4 ranks): the losses and the gradients
    of the rows, a replicated table and a replicated scalar (its partial gradients summed by ``allreduce_grads``)
    equal one process's autograd of the same function to 1e-13; a collective whose backward summed again (W times
    the gradient) fails this."""
    rng = np.random.default_rng(5)
    x, T, w = rng.standard_normal((5, 3)), rng.standard_normal(3), 0.7
    xt, Tt, wt = (torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (x, T, w))
    y = (xt * Tt).sum(-1) * wt
    want = []
    for loss in ((y**2).sum(), (xt**2).sum() * wt):
        gx, gT, gw = (torch.zeros_like(a) if g is None else g
                      for g, a in zip(torch.autograd.grad(loss, (xt, Tt, wt), retain_graph=True, allow_unused=True),
                                      (xt, Tt, wt)))
        want.append((float(loss), gx.numpy(), gT.numpy(), float(gw)))
    for rank, (got, dot) in enumerate(pools[world].run(torch_dist.toy_losses, x, T, w)):
        for (value, gx, gT, gw), (v0, gx0, gT0, gw0) in zip(got, want):
            np.testing.assert_allclose([value, gw], [v0, gw0], rtol=1e-13, err_msg=f"rank {rank}")
            np.testing.assert_allclose(gx, gx0, rtol=1e-13, atol=1e-15, err_msg=f"rank {rank}")
            np.testing.assert_allclose(gT, gT0, rtol=1e-13, atol=1e-15, err_msg=f"rank {rank}")
        np.testing.assert_allclose(dot, np.sum(x[:, 0] ** 2) + w**2, rtol=1e-13)


def test_fit_ranks_trims_to_batch_divisor(pools):
    for bs, want in ((6, 6), (7, 7), (1, 1), (8, 8)):
        cfg = _cfg("adam", batch=bs)
        jax_mesh = _fit_mesh(cfg)
        assert par.fit_ranks(cfg, 8, "cpu") == want == (1 if jax_mesh is None else jax_mesh.devices.size)
    assert par.fit_ranks(_cfg("adam", batch=8, parallel=False), 8, "cpu") == 1 and _fit_mesh(_cfg("adam", parallel=False)) is None
    unset = _cfg("adam")
    del unset["optimizer"]["parallel"]
    assert par.fit_ranks(unset, 8, "cpu") == 1 and _fit_mesh(unset) is None  # off by default on the CPU
    assert par.fit_ranks(unset, 8, "cuda") == 8  # on by default on the card
    assert par.fit_ranks(_cfg("adam", batch=6), 4, "cpu") == 3

    # a batch of 6 on 4 ranks: three fit two lineouts each, the fourth takes none and receives the result
    cfg = _cfg("adam", batch=6)
    results = pools[4].run(torch_dist.one_d_loop, cfg, _all_data(6), 1)
    single_loss, single = _unsharded(_cfg("adam", batch=6, parallel=False), _all_data(6))
    for rank, (loss, weights, _, counts) in enumerate(results):
        np.testing.assert_allclose(loss, single_loss, rtol=SHARDED_RTOL, err_msg=f"rank {rank}")
        _assert_params(weights[0], single, SHARDED_RTOL, f"rank {rank}")
        assert counts["broadcast"] == 2  # the parameters and the loss, from rank 0
    assert results[3][2] == {}  # the fourth rank ran no loop


def test_param_sharding_mask_protects_grid_leaves():
    cfg = _cfg("adam")
    cfg["parameters"]["electron"]["fe"]["nvx"] = BATCH  # the collision
    full = port.ThomsonParams.create(cfg["parameters"], BATCH, activate=True, device="cpu")
    mask = par.batched_leaf_mask(cfg, full)
    vx = "electron.distribution_functions.vx"
    assert full.state_dict()[vx].shape == (BATCH,)  # the coincidence is actually present
    assert not mask[vx] and mask["ions.0.params.normed.Ti"] and mask["electron.distribution_functions.normed_m"]
    for index in range(BATCH):
        local, _ = par.shard_params(cfg, full, par.Ranks(index=index, size=BATCH))
        state = local.state_dict()
        assert state[vx].shape == (BATCH,) and torch.equal(state[vx], full.state_dict()[vx])  # whole
        assert state["ions.0.params.normed.Ti"].shape == (1,)  # one row a rank
        assert torch.equal(state["general.params.normed.lam"], full.state_dict()["general.params.normed.lam"][index:index + 1])


def _penalty_case(n, spread_te):
    cfg = ge._small_config(n)
    cfg["parameters"]["electron"]["fe"].update(type="arbitrary", params={"init_m": 2.5}, fe_decrease_strict=True)
    cfg["parameters"]["ion-1"]["Z"]["val"] = 30.0  # beyond ub 25: the bound penalty fires
    cfg["optimizer"].update(bound_penalty=True, moment_loss=True)
    full = port.ThomsonParams.create(cfg["parameters"], n, activate=True, device="cpu")
    rng = np.random.default_rng(3)
    with torch.no_grad():  # each lineout's EDF its own, with bumps: sign(v) df/dv > 0 somewhere
        fval = full.electron.distribution_functions.fval
        fval.mul_(torch.as_tensor(1.0 + 0.2 * rng.standard_normal(fval.shape)))
        if spread_te:
            full.electron.params.normed["Te"].add_(torch.as_tensor(0.3 * rng.standard_normal(n)))
    return cfg, ge._make_batch(n), {k: v.numpy().copy() for k, v in full.state_dict().items()}, full


@pytest.mark.parametrize("spread_te, grad_tol", [(False, 1e-12), (True, 1e-11)])
@pytest.mark.parametrize("world", [2, 4])
def test_loss_over_uneven_shards_with_penalties_matches_unsharded(pools, world, spread_te, grad_tol):
    n = 5
    cfg, batch, state, full = _penalty_case(n, spread_te)
    loss_fn = port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu")
    (want, aux), grads = loss_fn.value_and_grad(full, batch)
    with torch.no_grad():
        physical = full()
        assert float(loss_fn.penalties(physical, full)) > 0 and float(loss_fn.bound_penalty(full)) > 0
        v, fe = physical["electron"]["v"], physical["electron"]["fe"]
        assert float(torch.sum(torch.clamp(torch.sign(v[..., 1:]) * torch.diff(fe, dim=-1), min=0.0))) > 0  # the tan fires
    results = pools[world].run(torch_dist.uneven_value_and_grad, cfg, batch, state)
    spans = [r[2] for r in results]
    assert spans[0] == (0, 3 if world == 2 else 2) and len({b - a for a, b in spans}) == 2  # shards of unequal size
    for rank, (value, whole, (start, stop), rows) in enumerate(results):
        np.testing.assert_allclose(value, float(want), rtol=1e-12, err_msg=f"rank {rank}")
        np.testing.assert_allclose(rows, aux[2][start:stop].numpy(), rtol=1e-12)  # the row losses stay the rank's own
        assert whole.keys() == grads.keys()
        for k, g in grads.items():
            g = g.numpy()
            np.testing.assert_allclose(whole[k], g, rtol=0, atol=grad_tol * np.abs(g).max(), err_msg=f"rank {rank}: {k}")
