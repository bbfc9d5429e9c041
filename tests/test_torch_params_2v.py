"""The 2V electron distributions of the port against the JAX package, on the CPU in float64.

``Arbitrary2V`` and ``SphericalHarmonics`` with its three flm families
(``mora-yahi``, ``arbitrary``, ``nn``): the port's own construction from the
deck (except the MLPs' random draws), and every leaf carried from the JAX
pytree by ``convert.thomson_params_from_jax`` after a seeded perturbation, so
that both packages compute the same EDF from the same numbers: f(vx, vy) to
1e-12 of its peak, the filter spec leaf for leaf, and the gradient of a scalar
of the EDF with respect to every trainable leaf to 1e-10 of its largest entry.
"""

import copy
import hashlib
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import combine, partition
from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec
from tsadar_tpu.core.params import spherical as jsph
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path, leaves_of, thomson_params_from_jax
from tsadar_tpu_torch.core.params import get_filter_spec
from tsadar_tpu_torch.core.params import spherical as psph
from tsadar_tpu_torch.utils.config import merge_configs

HERE = os.path.dirname(__file__)
CONFIGS = os.path.join(HERE, "configs")
FAMILIES = {
    "arbitrary2v": dict(type="arbitrary", params=dict(init_m=2.5, learn_log=True)),
    "arbitrary2v-linear": dict(type="arbitrary", params=dict(init_m=3.0, learn_log=False)),
    "mora-yahi": dict(type="sphericalharmonic", params=dict(flm_type="mora-yahi", init_m=2.2, LTx=225000.0, LTy=400000.0, Nl=1, nvr=24)),
    "arbitrary-vr": dict(type="sphericalharmonic", params=dict(flm_type="arbitrary", init_m=2.7, Nl=1, nvr=24)),
    "nn": dict(type="sphericalharmonic", params=dict(flm_type="nn", init_m=2.4, Nl=1, nvr=24)),
}


def _param_cfg(family):
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, n))) for n in ("arts2v_test_defaults.yaml", "arts2d_test_inputs.yaml")]
    cfg = merge_configs(*decks)["parameters"]
    cfg["electron"]["fe"] = dict(active=True, dim=2, nvx=32, **copy.deepcopy(FAMILIES[family]))
    return cfg


def _perturbed(jp, seed):
    """The JAX parameters with every floating leaf of the EDF module but the grids moved by a seeded draw."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(jp)
    rng = np.random.default_rng(seed)
    leaves = {}
    for path, leaf in flat:
        key, value = jax.tree_util.keystr(path), np.array(leaf)
        trainable = any(s in key for s in ("fval", "normed_m", "log_10_LT", "flm_sign", "flm_mag"))
        if "distribution_functions" in key and trainable:
            value = value + 0.05 * rng.standard_normal(value.shape)
        leaves[key] = value
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v) for v in leaves.values()]), leaves


@pytest.mark.parametrize("family", list(FAMILIES))
def test_edf_filter_spec_and_gradient_match_jax(family):
    cfg = _param_cfg(family)
    jp, leaves = _perturbed(JaxParams.create(cfg, num_params=1, batch=False, activate=True), seed=0)
    tp = thomson_params_from_jax(cfg, leaves, activate=True, device="cpu")
    assert leaves_of(tp).keys() == leaves.keys()

    want = jp()
    got = tp()
    fe = np.asarray(want["electron"]["fe"])
    assert got["electron"]["fe"].shape == (32, 32) and got["electron"]["Te"].dim() == 0
    np.testing.assert_allclose(got["electron"]["fe"].detach().numpy(), fe, rtol=0, atol=1e-12 * fe.max())
    np.testing.assert_array_equal(got["electron"]["v"].numpy(), np.asarray(want["electron"]["v"]))
    np.testing.assert_allclose(float(fe.sum() * (12.0 / 32) ** 2), 1.0, rtol=1e-12)

    spec = jax_filter_spec(cfg, jp)
    diff, static = partition(jp, spec)
    trainable = get_filter_spec(cfg, tp)
    assert set(trainable) == set(leaves_by_path(diff)) and trainable

    cot = np.random.default_rng(1).standard_normal((32, 32))
    g_ref = leaves_by_path(jax.grad(lambda d: jnp.sum(combine(d, static)()["electron"]["fe"] * cot))(diff))
    grads = torch.autograd.grad(torch.sum(tp()["electron"]["fe"] * torch.tensor(cot)), list(trainable.values()))
    for path, g in zip(trainable, grads):
        ref = g_ref[path]
        assert g.shape == ref.shape, path
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-10 * max(np.abs(ref).max(), 1e-300), err_msg=path)


@pytest.mark.parametrize("family", ["arbitrary2v", "mora-yahi", "arbitrary-vr"])
def test_created_from_the_deck_like_jax(family):
    """Without ``convert``: the port's own construction gives JAX's leaves (the MLP family draws its own weights)."""
    cfg = _param_cfg(family)
    want = leaves_by_path(JaxParams.create(cfg, num_params=1, batch=False, activate=True))
    got = leaves_of(port.ThomsonParams.create(cfg, 1, activate=True, device="cpu", batch=False))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_allclose(got[path], w, rtol=1e-13, atol=1e-13, err_msg=path)


def test_get_unnormed_and_fitted_params_report_the_harmonics():
    cfg = _param_cfg("mora-yahi")
    jp = JaxParams.create(cfg, num_params=1, batch=False, activate=True)
    tp = port.ThomsonParams.create(cfg, 1, activate=True, device="cpu", batch=False)
    want, n_want = jp.get_fitted_params(cfg)
    got, n_got = tp.get_fitted_params(cfg)
    assert n_got == n_want
    flm_w, flm_g = want["electron"]["flm"], got["electron"]["flm"]
    assert set(flm_g) == set(flm_w)
    for l in (0, 1):
        for m, w in flm_w[l].items():
            np.testing.assert_allclose(flm_g[l][m].detach().numpy(), np.asarray(w), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(flm_g["fvxvy"].detach().numpy(), np.asarray(flm_w["fvxvy"]), rtol=1e-11, atol=1e-300)
    np.testing.assert_allclose(float(got["electron"]["m"]), float(want["electron"]["m"]), rtol=1e-14)


def test_real_spherical_harmonics_match_jax():
    rng = np.random.default_rng(2)
    polar, azim = rng.uniform(-np.pi, np.pi, 50), rng.choice([0.0, np.pi], 50)
    for l, m in ((1, 0), (1, 1), (2, 0), (2, 2)):  # every order is ported: l <= 4 in tests/test_torch_spherical.py
        want = np.asarray(jsph.real_sph_harm(l, m, jnp.asarray(polar), jnp.asarray(azim)))
        got = psph.real_sph_harm(l, m, torch.tensor(polar), torch.tensor(azim)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match="0 <= m <= l"):
        psph.real_sph_harm(1, 2, torch.tensor(polar), torch.tensor(azim))


def test_interp1d_matches_jnp_interp_with_right_fill():
    rng = np.random.default_rng(3)
    xp = np.linspace(0.1, 5.0, 17)
    fp = rng.standard_normal(17)
    x = np.concatenate([rng.uniform(-1.0, 7.0, 40), xp[[0, 5, -1]]])
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp), right=1e-16))
    got = psph.interp1d(torch.tensor(x), torch.tensor(xp), torch.tensor(fp), right=1e-16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_batched_2d_distributions_raise_like_jax():
    cfg = _param_cfg("arbitrary2v")
    with pytest.raises(NotImplementedError, match="Batch mode"):
        port.ThomsonParams.create(cfg, 2, activate=True, device="cpu")


def test_the_ports_arts_asset_is_the_jax_packages_file():
    root = os.path.dirname(HERE)
    digests = [hashlib.sha256(open(os.path.join(root, pkg, "external", "arts_angular.npz"), "rb").read()).hexdigest()
               for pkg in ("tsadar_tpu", "tsadar_tpu_torch")]
    assert digests[0] == digests[1]
