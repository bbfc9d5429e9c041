"""Shot 111411 (the other calibration branch of the temporal EPW streak): the port's loss and gradient against
JAX's, and its fit.

The main deck (``tests/configs/time_test_*``) with
``tests/test_inverse/test_1d_data_111411.py``'s changes: shot 111411 and a
start at Te 0.8, ne 0.5, lam 526.5; pixels 500 and 505, one batch; the raw-data
visualizer off.  Each package's data pipeline feeds its own loss at the start
values, on the CPU in float64: the tolerances of
``tests/test_torch_iaw_deck.py``.  ``test_data_111411`` (slow-marked, as the
JAX test is) runs the deck through the port's ``fitter.fit(device="cpu")`` and
holds it to that test's guards and pins.
"""

import os

import numpy as np
import pytest
import yaml

from tsadar_tpu.utils.config import merge_configs
from tsadar_tpu_torch.inverse import fitter

from .test_torch_iaw_deck import assert_same_losses, deck_losses
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def deck_111411():
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, f"time_test_{n}.yaml"))) for n in ("defaults", "inputs")]
    cfg = merge_configs(*decks)
    cfg["data"]["launch_data_visualizer"] = False  # a figure: tests/test_torch_figures.py
    cfg["data"]["shotnum"] = 111411
    cfg["parameters"]["electron"]["Te"]["val"] = 0.8
    cfg["parameters"]["electron"]["ne"]["val"] = 0.5
    cfg["parameters"]["general"]["lam"]["val"] = 526.5
    return cfg


def test_111411_loss_and_gradient_match_jax():
    want, got = deck_losses(deck_111411())
    assert_same_losses(want, got, active={"Te", "ne", "normed_m", "amp1", "amp2", "lam"})


@pytest.mark.slow
def test_data_111411():
    """``tests/test_inverse/test_1d_data_111411.py`` on the port, in float64 on the CPU."""
    got, loss = fitter.fit(deck_111411(), device="cpu")
    for key in ("amp1_general", "amp2_general"):
        assert np.all(got[key][:2] > 0.1) and np.all(got[key][:2] < 3.0), key
    for key in ("Te_electron", "ne_electron"):
        v = got[key][:2]
        assert abs(v[0] - v[1]) / v.mean() < 0.05, key
    assert float(np.asarray(loss).sum()) < 5e-3
    pinned = {"amp1_general": [0.8623, 0.8476], "amp2_general": [1.0648, 0.9956], "lam_general": [525.40, 525.47],
              "Te_electron": [0.7363, 0.7381], "ne_electron": [0.5371, 0.5337], "m_electron": [2.414, 2.416]}
    for key, vals in pinned.items():
        np.testing.assert_allclose(got[key][:2], vals, rtol=5e-3 if key == "lam_general" else 3e-2, err_msg=key)
