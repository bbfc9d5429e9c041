"""The port's parameter modules against the JAX package's, in float64.

The same normalized state (carried by ``convert.thomson_params_from_jax``)
must give the same physical parameters: the DLM EDF interpolated in m, the
Maxwellian, the sigmoid activation and (lb, ub) scaling, the ion-fraction
renormalization and Ti tying.  Tolerance 1e-14 relative: same operations.
The trainable leaves (``get_filter_spec``), ``get_unnormed_params`` and
``get_fitted_params`` are held to the JAX package's too.
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
from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec
from tsadar_tpu.core.params import partition
from tsadar_tpu_torch.convert import leaves_by_path, leaves_of, state_key, thomson_params_from_jax
from tsadar_tpu_torch.core.params import get_filter_spec
from tsadar_tpu_torch.core.params.ts_params import jax_path
from tsadar_tpu_torch.utils.config import merge_configs

CONFIGS = os.path.join(os.path.dirname(__file__), "configs")


def _param_cfg(fe_type):
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, f"time_test_{n}.yaml"))) for n in ("defaults", "inputs")]
    cfg = copy.deepcopy(merge_configs(*decks)["parameters"])
    cfg["electron"]["fe"]["type"] = fe_type
    cfg["electron"]["fe"]["params"]["init_m"] = 3.0  # Arbitrary1V's start
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


@pytest.mark.parametrize("fe_type,activate", [("dlm", True), ("dlm", False), ("mx", True), ("arbitrary", True)])
def test_physical_parameters_match_jax(fe_type, activate):
    cfg = _param_cfg(fe_type)
    B = 4
    jp = JaxParams.create(cfg, num_params=B, batch=True, activate=activate)
    rng = np.random.default_rng(0)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jp)
    leaves = {}
    for path, leaf in flat:
        key, value = jax.tree_util.keystr(path), np.array(leaf)
        if key.endswith("normed_m") or key.endswith("fval") or "['Te']" in key or "['ne']" in key or "['fract']" in key:
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
            # Arbitrary1V's f = 10^-(7 s)^2 turns the filter's last-digit differences (a matmul sums in
            # another order than the scan) into ~2 ln(10) (7 s)^2 ulp of f: up to ~1e-13 at f ~ 1e-15
            rtol = 1e-12 if (fe_type, name) == ("arbitrary", "fe") else 1e-14
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-300, err_msg=f"{group}.{name}")
    np.testing.assert_array_equal(got["ion-2"]["Ti"].numpy(), got["ion-1"]["Ti"].numpy())


def test_create_matches_jax_initial_state():
    cfg = _param_cfg("dlm")
    jax_state = {state_key(k): v for k, v in _flat(JaxParams.create(cfg, num_params=3, batch=True, activate=True)).items()}
    import tsadar_tpu_torch as port

    state = port.ThomsonParams.create(cfg, 3, activate=True, device="cpu").state_dict()
    assert state.keys() == jax_state.keys()
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), jax_state[k], rtol=1e-15, atol=0, err_msg=k)


@pytest.mark.parametrize("fe_type,fe_active", [("dlm", True), ("dlm", False), ("mx", True), ("arbitrary", True)])
def test_trainable_leaves_match_jax_filter_spec(fe_type, fe_active):
    cfg = _param_cfg(fe_type)
    cfg["electron"]["fe"]["active"] = fe_active
    cfg["ion-2"]["Ti"]["active"] = True  # an ion leaf too
    jp = JaxParams.create(cfg, num_params=3, batch=True, activate=True)
    diff, static = partition(jp, jax_filter_spec(cfg, jp))
    want = set(leaves_by_path(diff))
    assert leaves_by_path(diff).keys() | leaves_by_path(static).keys() == set(_flat(jp))

    import tsadar_tpu_torch as port

    tp = port.ThomsonParams.create(cfg, 3, activate=True, device="cpu")
    for p in tp.parameters():
        p.requires_grad_(True)  # whatever it was before: the spec sets every leaf
    trainable = get_filter_spec(cfg, tp)
    assert set(trainable) == want and ".ions[1].params.normed['Ti']" in want
    assert (".electron.distribution_functions.normed_m" in want) == (fe_type == "dlm" and fe_active)
    assert (".electron.distribution_functions.fval" in want) == (fe_type == "arbitrary" and fe_active)
    for name, p in tp.named_parameters():
        assert p.requires_grad == (jax_path(name) in want), name
        assert state_key(jax_path(name)) == name
        if jax_path(name) in want:
            assert trainable[jax_path(name)] is p
    assert set(leaves_of(tp)) == set(_flat(jp))


@pytest.mark.parametrize("fe_type", ["dlm", "mx", "arbitrary"])
def test_unnormed_and_fitted_params_match_jax(fe_type):
    cfg = _param_cfg(fe_type)
    jp = JaxParams.create(cfg, num_params=3, batch=True, activate=True)
    tp = thomson_params_from_jax(cfg, _flat(jp), activate=True, device="cpu")
    want = jp.get_unnormed_params()
    with torch.no_grad():
        got = tp.get_unnormed_params()
    assert {g: set(d) for g, d in got.items()} == {g: set(d) for g, d in want.items()}
    assert ("m" in got["electron"]) == (fe_type == "dlm") and "fe" not in got["electron"]
    for group in want:
        for name, w in want[group].items():
            rtol = 1e-12 if name == "f" else 1e-14  # Arbitrary1V's EDF: see test_physical_parameters_match_jax
            np.testing.assert_allclose(got[group][name].numpy(), np.asarray(w), rtol=rtol, err_msg=f"{group}.{name}")
    want_fitted, want_n = jp.get_fitted_params(cfg)
    with torch.no_grad():
        got_fitted, got_n = tp.get_fitted_params(cfg)
    assert got_n == want_n and {g: set(d) for g, d in got_fitted.items()} == {g: set(d) for g, d in want_fitted.items()}


def test_butterworth_matches_jax_scan():
    """The filter as one float64-built matrix against the JAX package's scan, forward and backward, in float64
    (and the float32 matrix against the float32 scan)."""
    from tsadar_tpu.core.params.distributions import second_order_butterworth as jax_butterworth
    from tsadar_tpu_torch.core.params.distributions import second_order_butterworth

    rng = np.random.default_rng(3)
    signal = rng.standard_normal((3, 320))
    cot = rng.standard_normal((3, 320))
    for method in ("forward_backward", "forward", "backward"):
        want, vjp = jax.vjp(lambda x: jax_butterworth(x, 100, 6, method), jnp.asarray(signal))
        x = torch.tensor(signal, requires_grad=True)
        got = second_order_butterworth(x, 100, 6, method)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-13 * np.abs(want).max(), err_msg=method)
        (g,) = torch.autograd.grad(got, x, torch.as_tensor(cot))
        want_g = np.asarray(vjp(jnp.asarray(cot))[0])
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=1e-13 * np.abs(want_g).max(), err_msg=method)
    want32 = np.asarray(jax_butterworth(jnp.asarray(signal, dtype=jnp.float32), 100, 6))
    got32 = second_order_butterworth(torch.tensor(signal, dtype=torch.float32), 100, 6).numpy()
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-5 * np.abs(want32).max())


def test_arbitrary1v_normalized():
    """``tests/test_params/test_ts_params.py::test_arbitrary1v_normalized`` on the port: three positive EDFs of
    unit integral, equal to the JAX module's."""
    from tsadar_tpu.core.params import Arbitrary1V as JaxArbitrary1V
    from tsadar_tpu_torch.core.params.distributions import Arbitrary1V

    cfg = {"type": "arbitrary", "dim": 1, "nvx": 512, "active": False, "params": {"init_m": 2.5}}
    a = Arbitrary1V(cfg, 3, activate=False)
    with torch.no_grad():
        f = a().numpy()
    assert f.shape == (3, 512)
    dv = float(a.vx[1] - a.vx[0])
    np.testing.assert_allclose(f.sum(axis=-1) * dv, 1.0, rtol=1e-10)
    assert (f > 0).all()
    want = np.asarray(JaxArbitrary1V.create(cfg, 3, batch=True, activate=False)())
    np.testing.assert_allclose(f, want, rtol=1e-12)
    np.testing.assert_allclose(a.fval.detach().numpy(), np.asarray(JaxArbitrary1V.create(cfg, 3, batch=True, activate=False).fval), rtol=1e-15)
