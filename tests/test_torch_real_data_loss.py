"""Loss and gradient of the port on shot 101675's real lineouts against the JAX package's, float64 on the CPU.

The whole-shot deck (``tests/configs/time_test_*``: npts 5120, 10 angles, DLM
on nvx 320) at its own lineouts, pixels 500 and 505, each package's data
pipeline (``prepare_data``) feeding its own ``LossFunction`` at the deck's
start values (``ThomsonParams.create(..., activate=True)``): the loss to 1e-10
relative and each active parameter's gradient to 1e-8 of its largest entry.
This is the first stage of the real-data fit that ``chip_smoke.py`` runs on the
card at 128 lineouts.  The two pipelines share scipy's background fits
(``test_torch_data_pipeline.same_scipy_fits``: scipy's own fit is not
deterministic on that model).
"""

import copy
import os

import numpy as np
import pytest
import yaml

from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import get_filter_spec, partition
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.config import merge_configs
from tsadar_tpu.utils.process.prepare import prepare_data as jax_prepare
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path
from tsadar_tpu_torch.inverse.fitter import _lineout_selection
from tsadar_tpu_torch.utils.process.prepare import prepare_data

from .test_torch_data_pipeline import same_scipy_fits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALUE_TOL = 1e-10
GRAD_TOL = 1e-8  # of each leaf's largest |gradient|


def _deck():
    decks = [yaml.safe_load(open(os.path.join(ROOT, "tests", "configs", f"time_test_{n}.yaml"))) for n in ("defaults", "inputs")]
    cfg = merge_configs(*decks)
    cfg["data"]["launch_data_visualizer"] = False  # matplotlib; not ported
    return _lineout_selection(cfg)  # the deck's own lineouts, 500:510:5, one batch of 2


def _batch(data):
    return {
        "e_data": data["e_data"], "e_amps": data["e_amps"][:, None], "i_data": data["i_data"],
        "i_amps": data["i_amps"][:, None], "noise_e": data["noiseE"], "noise_i": data["noiseI"],
    }


@pytest.fixture(scope="module")
def losses():
    """((loss, aux), gradients by JAX leaf path) of JAX, then of the port."""
    cfg = _deck()
    assert cfg["data"]["lineouts"]["val"] == [500, 505]
    jax_cfg, port_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    with same_scipy_fits():
        data, sa, _ = jax_prepare(jax_cfg, jax_cfg["data"]["shotnum"])
        port_data, port_sa, _ = prepare_data(port_cfg, port_cfg["data"]["shotnum"])
    batch = _batch(data)
    jl = JaxLoss(jax_cfg, sa, batch)
    tp = JaxParams.create(jax_cfg["parameters"], 2, batch=True, activate=True)
    diff, static = partition(tp, get_filter_spec(jax_cfg["parameters"], tp))
    (value, aux), grad = jl._vg_func_(diff, static, batch)
    want = (float(value), np.asarray(aux[0]), np.asarray(aux[2])), leaves_by_path(grad)

    batch = _batch(port_data)
    pl = port.LossFunction(port_cfg, port_sa, batch, device="cpu")
    params = port.ThomsonParams.create(port_cfg["parameters"], 2, activate=True, device="cpu")
    (value, aux), grad = pl.value_and_grad(params, batch)
    got = (float(value), aux[0].numpy(), aux[2].numpy()), {k: g.numpy() for k, g in grad.items()}
    return want, got


def test_real_data_loss_matches_jax(losses):
    ((want, want_E, want_rows), _), ((got, got_E, got_rows), _) = losses
    assert np.isfinite(got) and got > 0.0
    np.testing.assert_allclose(got, want, rtol=VALUE_TOL)
    np.testing.assert_allclose(got_rows, want_rows, rtol=VALUE_TOL)
    assert got_E.shape == want_E.shape == (2, 1024)
    np.testing.assert_allclose(got_E, want_E, rtol=0, atol=VALUE_TOL * np.abs(want_E).max())


def test_real_data_gradient_matches_jax(losses):
    (_, want), (_, got) = losses
    assert set(got) == set(want) and len(got) == 6  # Te, ne, m, amp1, amp2, lam
    for path, w in want.items():
        assert np.abs(w).max() > 0.0, path
        np.testing.assert_allclose(got[path], w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=path)
