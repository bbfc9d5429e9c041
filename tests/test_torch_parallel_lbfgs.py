"""The sharded device L-BFGS (``method: lbfgs``) on CPU ranks against the JAX package's sharded and unsharded fits.

The twin of ``tests/test_parallel/test_sharding.py::test_one_d_loop_lbfgs_data_parallel_matches_single``:
``one_d_loop`` on the small 1D deck of ``__graft_entry__`` (batch 8, 2 steps,
float64) on 2 and 4 ``gloo`` ranks (``tests/torch_dist.py``).  L-BFGS is not
elementwise: every inner product of its memory and of its line search is taken
over all ranks (``parallel.dist.global_dot``), so each rank takes the
unsharded steps on its rows.  The loss and every fitted parameter, on every
rank, against the port unsharded to 1e-10 relative, and against the JAX
package's fits on its 8-device mesh and on one device to 1e-8 (the port's
tolerance against the JAX loop, ``tests/test_torch_lbfgs.py``).  A rank that
ran its own L-BFGS on its shard alone would take other steps and fail.
"""

import numpy as np
import pytest

from . import torch_dist
from .test_torch_parallel import BATCH, SHARDED_RTOL, _all_data, _assert_params, _cfg, _unsharded, jax_fits  # noqa: F401
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

JAX_RTOL = 1e-8


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {w: torch_dist.RankPool(w, tmp_path_factory.mktemp(f"store{w}") / "store") for w in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


@pytest.mark.parametrize("world", [2, 4])
def test_one_d_loop_lbfgs_data_parallel_matches_single(pools, jax_fits, world):  # noqa: F811
    results = pools[world].run(torch_dist.one_d_loop, _cfg("lbfgs"), _all_data(BATCH), 1)
    single_loss, single = _unsharded(_cfg("lbfgs", parallel=False), _all_data(BATCH))
    for rank, (loss, weights, record, counts) in enumerate(results):
        np.testing.assert_allclose(loss, single_loss, rtol=SHARDED_RTOL, err_msg=f"rank {rank}")
        _assert_params(weights[0], single, SHARDED_RTOL, f"rank {rank} against the port unsharded")
        assert record["evaluations"] == results[0][2]["evaluations"]  # the same line searches on every rank
        assert counts["all_reduce"] > len(record["losses"])  # the loss's sums and the inner products
    for parallel in (True, False):
        jax_loss, jax_params = jax_fits("lbfgs", parallel)
        np.testing.assert_allclose(results[0][0], jax_loss, rtol=JAX_RTOL)
        _assert_params(results[0][1][0], jax_params, JAX_RTOL, f"against JAX, parallel {parallel}")
