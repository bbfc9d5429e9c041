"""The 2V chi-point sharding (``other.shard_2v_points``) on CPU ranks against the JAX package's, sharded and not.

The port splits table mode's chi evaluation points between the ranks of a
``gloo`` group (2 and 4 ranks, ``tests/torch_dist.py``); the JAX package puts
a sharding constraint on them over its virtual 8-device CPU mesh.  In float64:

* the twin of ``tests/test_parallel/test_sharding.py::test_2v_point_sharded_value_and_grad_matches_unsharded``:
  ``FormFactor.calc_in_2D`` of a Maxwellian 2D EDF (nv 64, 256 wavelengths,
  8 angles, 64 table rows; 2048 points, split 1024 / 512 a rank) under the
  loss sum(S w): the spectrum, the loss and its gradients with respect to the
  EDF, Te and ne, on every rank, against the port unsharded (the spectrum and
  the loss to 1e-12, the gradients to 1e-10 of their largest entry: the
  tables' cotangent is summed over the ranks in another order) and against the
  JAX package's sharded and unsharded ``value_and_grad`` (1e-8 relative and
  1e-8 of each gradient's largest entry);
* three adam epochs of ``angular_optax`` on the small ARTS 2V deck of
  ``tests/test_torch_arts_loss.py`` (the 32 x 32 pointwise EDF trainable)
  with ``shard_2v_points: true`` on 2 and 4 ranks: every rank's losses and
  best EDF the same bits as rank 0's (the same optimizer on replicated
  parameters), against the port unsharded (1e-10) and the JAX package's
  ``angular_optax`` with and without the flag (its last loss and best EDF to
  1e-9, the port's tolerance against the JAX loop there).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsadar_tpu.core.physics.form_factor import FormFactor as JaxFormFactor
from tsadar_tpu.inverse.loops import angular_optax as jax_angular_optax
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path

from . import torch_dist
from .test_torch_arts_loss import FVAL, _all_data, _config
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

NV = 64
FF_ARGS = dict(npts=256, lam_shift=0.0, scattering_angles={"sa": np.linspace(50, 70, 8)}, num_grad_points=1, ud_ang=0.0,
               va_ang=0.0, num_beta=64)
LAM_RANGE = [450, 650]
EPOCHS = 3


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {w: torch_dist.RankPool(w, tmp_path_factory.mktemp(f"store{w}") / "store") for w in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


def _edf():
    vmax = 6.0
    dv = 2 * vmax / NV
    vx = np.linspace(-vmax + dv / 2, vmax - dv / 2, NV)
    f2 = np.exp(-(vx[:, None] ** 2 + vx[None, :] ** 2) / 2)
    return vx, f2 / np.sum(f2) / dv**2


def _jax_value_and_grad(shard):
    vx, f2 = _edf()
    ff = JaxFormFactor(LAM_RANGE, shard_points=shard, **FF_ARGS)
    assert (ff._point_sharding is not None) == shard
    w = jnp.cos(jnp.arange(256, dtype=jnp.float64))

    def loss(fe, Te, ne):
        p = {"electron": {"Te": Te, "ne": ne, "fe": fe, "v": jnp.asarray(vx)},
             "general": {"lam": jnp.asarray(526.5), "ne_gradient": jnp.asarray(0.0), "Te_gradient": jnp.asarray(0.0),
                         "ud": jnp.asarray(0.0), "Va": jnp.asarray(0.0)},
             "ion-1": {"A": jnp.asarray(1.0), "Z": jnp.asarray(1.0), "Ti": jnp.asarray(0.2), "fract": jnp.asarray(1.0)}}
        S, _ = ff.calc_in_2D(p)
        return jnp.sum(jnp.squeeze(S) * w[:, None])

    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(jnp.asarray(f2), jnp.asarray(0.5), jnp.asarray(0.2))
    return float(value), [np.asarray(g) for g in grads]


def _close_grads(got, want, tol, label):
    for name, a, b in zip(("dfe", "dTe", "dne"), got, want):
        scale = float(np.max(np.abs(b))) or 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=f"{label}: {name}")


@pytest.mark.parametrize("world", [2, 4])
def test_2v_point_sharded_value_and_grad_matches_unsharded(pools, world):
    vx, f2 = _edf()
    w = np.cos(np.arange(256, dtype=np.float64))
    args = (FF_ARGS, LAM_RANGE, f2, vx, w)
    v0, g0, S0 = torch_dist.chi_2v_value_and_grad(*args, False)  # here: no group, the flag would do nothing
    results = pools[world].run(torch_dist.chi_2v_value_and_grad, *args, True)
    for rank, (v1, g1, S1) in enumerate(results):
        np.testing.assert_allclose(S1, S0, rtol=1e-12, atol=1e-12 * np.abs(S0).max(), err_msg=f"rank {rank}")
        np.testing.assert_allclose(v1, v0, rtol=1e-12, err_msg=f"rank {rank}")
        _close_grads(g1, g0, 1e-10, f"rank {rank} against the port unsharded")
        for a, b in zip(g1, results[0][1]):
            np.testing.assert_array_equal(a, b)  # every rank holds the same gradient
    for shard in (True, False):
        jv, jg = _jax_value_and_grad(shard)
        np.testing.assert_allclose(results[0][0], jv, rtol=1e-8)
        _close_grads(results[0][1], jg, 1e-8, f"against JAX, shard_points {shard}")


@pytest.fixture(scope="module")
def jax_angular():
    """{shard_2v_points: (last loss, best EDF)} of the JAX package's ``angular_optax``."""
    out = {}
    for shard in (True, False):
        cfg, sas = _config()
        cfg["optimizer"].update(num_epochs=EPOCHS, chunk_size=EPOCHS)
        cfg["other"]["shard_2v_points"] = shard
        best, loss, loss_fn = jax_angular_optax(cfg, _all_data(0), sas)
        assert (loss_fn.ts_diag.model.electron_form_factor._point_sharding is not None) == shard
        out[shard] = float(loss), np.asarray(leaves_by_path(best)[FVAL])
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_angular_optax_matches_unsharded(pools, jax_angular, world):
    cfg, sas = _config()
    cfg["optimizer"].update(num_epochs=EPOCHS, chunk_size=EPOCHS)
    single = {}
    best, _, _ = port.angular_optax(copy.deepcopy(cfg), _all_data(0), sas, device="cpu", record=single)
    fval = best.electron.distribution_functions.fval.detach().numpy()
    sharded = copy.deepcopy(cfg)
    sharded["other"]["shard_2v_points"] = True
    results = pools[world].run(torch_dist.angular_optax, sharded, _all_data(0), sas)
    for rank, (losses, leaves, counts) in enumerate(results):
        # a step: the chi arrays gathered forward, the tables' cotangent summed backward (only the EDF trains, so
        # the queries take no gradient and no gather)
        assert counts["all_reduce"] == 2 * EPOCHS
        assert losses == results[0][0] and np.array_equal(leaves[FVAL], results[0][1][FVAL])  # the same bits
        np.testing.assert_allclose(losses, single["losses"], rtol=1e-10, err_msg=f"rank {rank}")
        np.testing.assert_allclose(leaves[FVAL], fval, rtol=0, atol=1e-10 * np.abs(fval).max(), err_msg=f"rank {rank}")
    assert len(results[0][0]) == EPOCHS and results[0][0][-1] < results[0][0][0]
    for shard, (jloss, jfval) in jax_angular.items():
        np.testing.assert_allclose(results[0][0][-1], jloss, rtol=1e-9, err_msg=f"JAX, shard_2v_points {shard}")
        np.testing.assert_allclose(results[0][1][FVAL], jfval, rtol=0, atol=1e-9 * np.abs(jfval).max())
