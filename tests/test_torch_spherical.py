"""Spherical harmonics of any order in the port against the JAX package, on the CPU in float64.

* ``real_sph_harm(l, m)`` for every l <= 4 and 0 <= m <= l against
  ``jax.scipy.special.sph_harm_y``'s real part (the JAX package's
  ``real_sph_harm``), at the grid's own angles (polar = arctan2(vy, vx) over
  [-pi, pi], azimuth 0 or pi by the sign of vy) and at seeded ones, to 1e-14
  absolute (the functions are O(1); measured <= 3.4e-16);
* the spherical-harmonic EDF at ``Nl: 2`` (five flm modules: (1, 0), (1, 1),
  (2, 0), (2, 1), (2, 2)) with ``flm_type`` ``nn`` and ``arbitrary``, every
  leaf carried from the JAX pytree by ``convert.thomson_params_from_jax``
  after a seeded perturbation: f(vx, vy) to 1e-12 of its peak and the
  gradient of a seeded scalar of it with respect to every trainable leaf to
  1e-10 of each leaf's largest entry (``test_torch_params_2v.py``'s limits),
  and the whole ARTS diagnostic's image to 1e-10 of peak;
* Mora-Yahi beyond l = 1 raises in both packages.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from tsadar_tpu.core.diagnostic import ThomsonScatteringDiagnostic as JaxDiagnostic
from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import combine, partition
from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec
from tsadar_tpu.core.params import spherical as jsph
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path, leaves_of, thomson_params_from_jax
from tsadar_tpu_torch.core.params import get_filter_spec
from tsadar_tpu_torch.core.params import spherical as psph

from .test_torch_arts_forward import _batch, _config
from .test_torch_params_2v import _param_cfg, _perturbed
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

LM = [(l, m) for l in range(1, 5) for m in range(l + 1)]


def _angles():
    """The EDF grid's (polar, azimuth), as both packages form them, then seeded draws over [-pi, pi]."""
    vx = np.linspace(-5.8, 5.8, 30)
    VX, VY = np.meshgrid(vx, vx)
    rng = np.random.default_rng(2)
    polar = np.concatenate([np.arctan2(VY, VX).ravel(), rng.uniform(-np.pi, np.pi, 200), [0.0, np.pi, -np.pi]])
    azim = np.concatenate([np.arccos(VY / np.abs(VY)).ravel(), rng.choice([0.0, np.pi], 203)])
    return polar, azim


@pytest.mark.parametrize("l, m", LM)
def test_real_sph_harm_matches_jax(l, m):
    polar, azim = _angles()
    want = np.asarray(jsph.real_sph_harm(l, m, jnp.asarray(polar), jnp.asarray(azim)))
    got = psph.real_sph_harm(l, m, torch.tensor(polar), torch.tensor(azim))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)


def _nl2(family):
    cfg = _param_cfg(family)
    cfg["electron"]["fe"]["params"]["Nl"] = 2
    return cfg


@pytest.mark.parametrize("family", ["nn", "arbitrary-vr"])
def test_the_nl2_edf_matches_jax(family):
    cfg = _nl2(family)
    jp, leaves = _perturbed(JaxParams.create(cfg, num_params=1, batch=False, activate=True), seed=3)
    tp = thomson_params_from_jax(cfg, leaves, activate=True, device="cpu")
    assert leaves_of(tp).keys() == leaves.keys()
    assert tp.electron.distribution_functions.lm_list == [(1, 0), (1, 1), (2, 0), (2, 1), (2, 2)]
    assert len(tp.electron.distribution_functions.flm) == 5

    want = np.asarray(jp()["electron"]["fe"])
    got = tp()["electron"]["fe"]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-12 * want.max())

    diff, static = partition(jp, jax_filter_spec(cfg, jp))
    trainable = get_filter_spec(cfg, tp)
    assert set(trainable) == set(leaves_by_path(diff))
    assert any("flm'][4]" in p or "flm[4]" in p for p in trainable)  # the (2, 2) module's leaves train too
    cot = np.random.default_rng(4).standard_normal(want.shape)
    g_ref = leaves_by_path(jax.grad(lambda d: jnp.sum(combine(d, static)()["electron"]["fe"] * cot))(diff))
    grads = torch.autograd.grad(torch.sum(tp()["electron"]["fe"] * torch.tensor(cot)), list(trainable.values()))
    for path, g in zip(trainable, grads):
        ref = g_ref[path]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-10 * max(np.abs(ref).max(), 1e-300), err_msg=path)


def test_the_nl2_diagnostic_matches_jax():
    cfg, sas = _config(size=64, dist_type=None)
    cfg["data"]["lineouts"].update(start=8, end=56)
    fe = cfg["parameters"]["electron"]["fe"]
    fe["params"] = dict(flm_type="arbitrary", init_m=2.7, Nl=2, nvr=24)
    jp, leaves = _perturbed(JaxParams.create(cfg["parameters"], num_params=1, batch=False, activate=True), seed=5)
    tp = thomson_params_from_jax(cfg["parameters"], leaves, activate=True, device="cpu")
    want = np.asarray(JaxDiagnostic(cfg, scattering_angles=sas)(jp, _batch(cfg))[0])
    with torch.no_grad():
        got = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")(tp, _batch(cfg))[0].numpy()
    assert got.shape == want.shape == (48, 64) and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * want.max())


def test_mora_yahi_beyond_l1_raises_in_both_packages():
    cfg = copy.deepcopy(_param_cfg("mora-yahi"))
    cfg["electron"]["fe"]["params"]["Nl"] = 2
    with pytest.raises(NotImplementedError, match="Mora-Yahi only supports l=1"):
        JaxParams.create(cfg, num_params=1, batch=False, activate=True)
    with pytest.raises(NotImplementedError, match="Mora-Yahi only supports l=1"):
        port.ThomsonParams.create(cfg, 1, activate=True, device="cpu", batch=False)
