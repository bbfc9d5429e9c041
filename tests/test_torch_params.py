"""The port's parameter modules against the JAX package's, in float64.

The same normalized state (carried by ``convert.thomson_params_from_jax``)
must give the same physical parameters: the DLM EDF interpolated in m, the
Maxwellian, the sigmoid activation and (lb, ub) scaling, the ion-fraction
renormalization and Ti tying.  Tolerance 1e-14 relative: same operations.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu_torch.convert import state_key, thomson_params_from_jax
from tsadar_tpu_torch.utils.config import merge_configs

CONFIGS = os.path.join(os.path.dirname(__file__), "configs")


def _param_cfg(fe_type):
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, f"time_test_{n}.yaml"))) for n in ("defaults", "inputs")]
    cfg = copy.deepcopy(merge_configs(*decks)["parameters"])
    cfg["electron"]["fe"]["type"] = fe_type
    ion2 = copy.deepcopy(cfg["ion-1"])
    ion2["Ti"]["same"] = True
    ion2["fract"]["val"] = 0.5
    ion2["Z"]["val"] = 1.0
    cfg["ion-2"] = ion2
    return cfg


def _flat(tree):
    return {k: np.asarray(v) for k, v in _leaves(tree)}


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), v) for p, v in flat]


@pytest.mark.parametrize("fe_type,activate", [("dlm", True), ("dlm", False), ("mx", True)])
def test_physical_parameters_match_jax(fe_type, activate):
    cfg = _param_cfg(fe_type)
    B = 4
    jp = JaxParams.create(cfg, num_params=B, batch=True, activate=activate)
    rng = np.random.default_rng(0)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jp)
    leaves = {}
    for path, leaf in flat:
        key, value = jax.tree_util.keystr(path), np.array(leaf)
        if key.endswith("normed_m") or "['Te']" in key or "['ne']" in key or "['fract']" in key:
            value = value + 0.1 * rng.standard_normal(value.shape)  # m across its table, spread Te/ne/fract
        leaves[key] = value
    jp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v) for v in leaves.values()])
    tp = thomson_params_from_jax(cfg, leaves, activate=activate, device="cpu")
    assert set(tp.state_dict()) == {state_key(k) for k in leaves}

    want = jp()
    with torch.no_grad():
        got = tp()
    assert got.keys() == want.keys()
    for group in want:
        for name, w in want[group].items():
            w = np.asarray(w)
            g = got[group][name].numpy()
            if name == "v":  # the port keeps one velocity grid, JAX one per lineout
                w = w[0]
            np.testing.assert_allclose(g, w, rtol=1e-14, atol=1e-300, err_msg=f"{group}.{name}")
    np.testing.assert_array_equal(got["ion-2"]["Ti"].numpy(), got["ion-1"]["Ti"].numpy())


def test_create_matches_jax_initial_state():
    cfg = _param_cfg("dlm")
    jax_state = {state_key(k): v for k, v in _flat(JaxParams.create(cfg, num_params=3, batch=True, activate=True)).items()}
    import tsadar_tpu_torch as port

    state = port.ThomsonParams.create(cfg, 3, activate=True, device="cpu").state_dict()
    assert state.keys() == jax_state.keys()
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), jax_state[k], rtol=1e-15, atol=0, err_msg=k)
