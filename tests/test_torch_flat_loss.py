"""The port's flat scipy interface of the loss against the JAX package's, on the CPU in float64.

* The flat vector of the active parameters (``core.params.ravel_order``) is
  JAX's ``ravel_pytree(diff)[0]`` element for element, leaf path for leaf path,
  with every active leaf spread by a seeded draw so that no two leaves hold
  the same values: on ``__graft_entry__._small_config(4)`` and on the main
  deck's parameters (``tests/configs/time_test_{defaults,inputs}.yaml``, 2
  lineouts).  JAX flattens a ``ParamGroup``'s names sorted (amp1, amp2, lam),
  not in their registration order (lam, amp1, amp2).
* ``vg_loss`` and ``loss`` at the same x against ``LossFunction.vg_loss`` /
  ``loss`` with ``method: l-bfgs-b``, on the small deck with and without its
  IAW feature: the values to 1e-10 relative; the flat gradient leaf by leaf,
  each to 1e-10 of that leaf's largest entry but lam's, which is held to 1e-7:
  lam's gradient is a difference of terms ~1e8 times larger (the spectrum
  shifts with lam as a whole), so float64 keeps 8 of its digits and the two
  packages' summation orders part at ~1.6e-8 of its largest entry (the
  others at <= 4e-11; the same cancellation costs float32 all of lam's
  gradient, ``tests/test_torch_loss.py``).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import yaml
from jax import numpy as jnp
from jax.flatten_util import ravel_pytree

from __graft_entry__ import _make_batch, _small_config
from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec
from tsadar_tpu.core.params import partition
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.config import merge_configs
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import thomson_params_from_partitions
from tsadar_tpu_torch.core.params import get_filter_spec, ravel_order
from tsadar_tpu_torch.inverse.loss import ravel, unravel_into

from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CONFIGS = Path(__file__).resolve().parent / "configs"
GRAD_TOL = 1e-10  # of each leaf's largest |gradient|
LAM_GRAD_TOL = 1e-7  # lam's gradient cancels ~8 digits (module docstring)


def _main_deck():
    decks = [yaml.safe_load((CONFIGS / f"time_test_{n}.yaml").read_text()) for n in ("defaults", "inputs")]
    return merge_configs(*decks)


def _spread(cfg, B, seed):
    """JAX (diff, static) with every active leaf spread by a seeded draw, and the port's parameters from them."""
    tp = JaxParams.create(cfg["parameters"], num_params=B, batch=True, activate=True)
    diff, static = partition(tp, jax_filter_spec(cfg["parameters"], tp))
    rng = np.random.default_rng(seed)
    diff = jax.tree.map(lambda x: x + 0.3 * jnp.asarray(rng.standard_normal(x.shape)), diff)
    return diff, static, thomson_params_from_partitions(cfg["parameters"], diff, static, device="cpu")


@pytest.mark.parametrize("deck", ["small", "main"])
def test_flat_vector_is_jax_ravel(deck):
    cfg, B = (_small_config(4), 4) if deck == "small" else (_main_deck(), 2)
    diff, _, pp = _spread(cfg, B, seed=1)
    want, _ = ravel_pytree(diff)
    trainable = get_filter_spec(cfg["parameters"], pp)
    order = ravel_order(trainable)
    jax_paths = [jax.tree_util.keystr(path) for path, _ in jax.tree_util.tree_flatten_with_path(diff)[0]]
    assert order == jax_paths
    assert order != list(trainable)  # the registration order differs: the sort matters
    got = ravel([trainable[k] for k in order])
    assert got.dtype == np.float64 and got.shape == want.shape == (6 * B,)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(np.unique(got)) == got.size  # every entry its own value: the order is really tested
    # and back: a vector written into the parameters reads out unchanged
    x = np.random.default_rng(2).standard_normal(got.size)
    unravel_into(x, [trainable[k] for k in order])
    np.testing.assert_array_equal(ravel([trainable[k] for k in order]), x)


def _losses(cfg, batch):
    cfg["optimizer"]["method"] = "l-bfgs-b"
    jl = JaxLoss(cfg, jax_angles(cfg), batch)
    pl = port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu")
    return jl, pl


@pytest.mark.parametrize("features", ["epw", "epw_iaw"])
def test_vg_loss_and_loss_match_jax(features):
    B = 4
    cfg = _small_config(B)
    if features == "epw":
        cfg["other"]["extraoptions"].update(load_ion_spec=False, fit_IAW=False)
    batch = _make_batch(B)
    jl, pl = _losses(cfg, batch)
    diff, static, pp = _spread(cfg, B, seed=3)
    x0, jl.unravel_weights = ravel_pytree(diff)
    x = np.asarray(x0) + 0.05 * np.random.default_rng(4).standard_normal(x0.size)  # a point of its own

    want_value, want_grad = jl.vg_loss(x, static, batch)
    got_value, got_grad = pl.vg_loss(x, pp, batch)
    assert isinstance(got_value, float) and got_grad.dtype == np.float64 and got_grad.shape == x.shape
    np.testing.assert_allclose(got_value, want_value, rtol=1e-10)
    trainable = get_filter_spec(cfg["parameters"], pp)
    order = ravel_order(trainable)
    for i, path in enumerate(order):
        w, g = want_grad[i * B : (i + 1) * B], got_grad[i * B : (i + 1) * B]
        tol = LAM_GRAD_TOL if path.endswith("['lam']") else GRAD_TOL
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(), err_msg=path)
    # the parameters now hold x
    np.testing.assert_array_equal(ravel([trainable[k] for k in order]), x)

    y = x + 0.02
    np.testing.assert_allclose(pl.loss(y, pp, batch), jl.loss(y, static, batch), rtol=1e-10)
