"""The port's whole forward model against the JAX package's, on the CPU in float64.

* The whole-shot deck (``time_test_*``: npts 5120, P9's 10 angles, a DLM EDF on
  nvx = 320, the EPW with the iawfilter notch) at B = 2 lineouts with
  different parameters, carried from the JAX ``ThomsonParams`` by
  ``convert.thomson_params_from_jax``: ThryE to 1e-10 of peak (same
  operations; only the frameworks' rounding differs).
* The 1d deck against the committed self-golden ``ThryE-1d-self.npy`` at that
  golden's own tolerance (rtol 1e-7), and with the IAW feature and the iawoff
  notch switched on, against the JAX diagnostic.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from tsadar_tpu.core.diagnostic import ThomsonScatteringDiagnostic as JaxDiagnostic
from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.utils.config import merge_configs as jax_merge
from tsadar_tpu.utils.config import set_forward_ranges as jax_ranges
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import thomson_params_from_jax
from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges

HERE = os.path.dirname(__file__)
CONFIGS = os.path.join(HERE, "configs")
SELF_GOLDEN = os.path.join(HERE, "test_forward", "ThryE-1d-self.npy")
# parameters spread per lineout: the activated (sigmoid) ones, which stay inside their bounds
SPREAD = ("Te", "ne", "lam", "amp1", "amp2")


def _decks(prefix):
    return [yaml.safe_load(open(os.path.join(CONFIGS, f"{prefix}{n}.yaml"))) for n in ("defaults", "inputs")]


def _batch(B):
    return {"e_amps": np.ones((B, 1)), "i_amps": np.ones((B, 1)), "noise_e": np.zeros((B, 1)), "noise_i": np.zeros((B, 1))}


def _jax_and_port(cfg, B, seed):
    """JAX parameters of B lineouts, SPREAD and m varied by a seeded draw, and the port's copy."""
    jp = JaxParams.create(cfg["parameters"], num_params=B, batch=True, activate=True)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jp)
    rng = np.random.default_rng(seed)
    leaves = {}
    for path, leaf in flat:
        key, value = jax.tree_util.keystr(path), np.array(leaf)
        if key.endswith("normed_m") or any(f"['{name}']" in key for name in SPREAD):
            value = value + 0.2 * rng.standard_normal(value.shape)
        leaves[key] = value
    jp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v) for v in leaves.values()])
    return jp, thomson_params_from_jax(cfg["parameters"], leaves, activate=True, device="cpu")


def _compare(cfg, B, seed, rtol_peak):
    jp, tp = _jax_and_port(cfg, B, seed)
    want = JaxDiagnostic(cfg, scattering_angles=jax_angles(cfg))(jp, _batch(B))
    with torch.no_grad():
        got = port.ThomsonScatteringDiagnostic(cfg, port.get_scattering_angles(cfg), device="cpu")(tp, _batch(B))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and tuple(g.shape) == w.shape
        assert np.isfinite(w).all() and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rtol_peak * max(np.abs(w).max(), 1e-300))
    return got


def test_whole_shot_forward_matches_jax():
    cfg = set_forward_ranges(merge_configs(*_decks("time_test_")))
    assert cfg["other"]["npts"] == 5120 and cfg["parameters"]["electron"]["fe"]["nvx"] == 320
    jcfg = jax_ranges(jax_merge(*_decks("time_test_")))
    assert jcfg == cfg
    ThryE = _compare(cfg, B=2, seed=0, rtol_peak=1e-10)[0]
    assert ThryE.shape == (2, 1024) and not torch.allclose(ThryE[0], ThryE[1])


def test_1d_forward_matches_self_golden():
    cfg = set_forward_ranges(merge_configs(*_decks("1d-")))
    params = port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu")
    with torch.no_grad():
        ThryE = port.ThomsonScatteringDiagnostic(cfg, port.get_scattering_angles(cfg), device="cpu")(
            params, {"e_amps": np.array([1]), "i_amps": np.array([1]), "noise_e": np.array([0]), "noise_i": np.array([0])}
        )[0]
    golden = np.load(SELF_GOLDEN)
    np.testing.assert_allclose(ThryE.numpy(), golden, rtol=1e-7, atol=1e-10 * golden.max())


def test_1d_forward_with_ion_feature_matches_jax():
    cfg = set_forward_ranges(merge_configs(*_decks("1d-")))
    cfg["other"]["extraoptions"]["load_ion_spec"] = True
    cfg["other"]["iawoff"] = 1
    # probe inside the ion window, or the whole IAW feature underflows to 0 and normalizes to NaN
    cfg["parameters"]["general"]["lam"]["val"] = 526.5
    ThryE, ThryI = _compare(copy.deepcopy(cfg), B=2, seed=1, rtol_peak=1e-10)[:2]
    assert ThryI.shape == (2, 1024) and torch.isfinite(ThryI).all()


def test_1d_forward_with_blue_red_normalization_matches_jax():
    cfg = set_forward_ranges(merge_configs(*_decks("1d-")))
    cfg["other"]["PhysParams"]["norm"] = 1  # amp1/amp2 scale each side of the probe to its own peak
    _compare(cfg, B=2, seed=2, rtol_peak=1e-10)


def test_angular_spectype_is_not_ported_yet():
    cfg = set_forward_ranges(merge_configs(*_decks("1d-")))
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.ThomsonScatteringDiagnostic(cfg, {"sa": np.ones(10), "weights": np.ones(10)}, device="cpu")
