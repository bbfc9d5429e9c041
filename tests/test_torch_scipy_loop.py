"""The port's scipy loop (``_1d_scipy_loop_``, ``one_d_loop`` with ``method: l-bfgs-b``) against the JAX package's.

On the CPU in float64, on ``tests/test_inverse/test_1d_random.py``'s seed-42
setup (its 1D deck with perturbed truth and a perturbed start; the data are the
JAX forward at the truth, one lineout):

* the JAX loop and the port's, both with the deck's scipy options
  (``maxiter = num_epochs``, nothing else), cut at 10 iterations: the loss and
  every fitted parameter agree to 1e-6 relative (measured 2e-8 and <= 2.2e-9;
  at 20 iterations, with the loss at 4e-6, 4e-6 and 1.7e-7);
* run to scipy's own stop: the loss is under 1e-4 (the JAX test's gate),
  every active parameter is within 10 % of the truth (its recovery gate), and
  the two loops still agree to 1e-4: L-BFGS-B stops on the relative reduction
  of a loss of ~6e-9 in a valley flat enough that the two packages' last-digit
  differences in the gradient move the stopping point by up to 1e-5 relative;
  the record carries scipy's message, ``nit`` and ``nfev``;
* ``one_d_loop`` over two batches with the sequential warm start: a fresh
  loss function per batch (the last one returned), the second batch starting
  from the first one's result; ``method: lbfgs`` (the device L-BFGS) runs the
  same two batches with one loss function.
"""

import copy

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tsadar_tpu.core.diagnostic import ThomsonScatteringDiagnostic as JaxDiagnostic
from tsadar_tpu.inverse.loops import _1d_scipy_loop_ as jax_scipy_loop
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.inverse.loops import _1d_scipy_loop_, one_d_loop

from .test_inverse import test_1d_random as random_test
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ACTIVE = ("Te", "ne", "m", "lam", "amp1", "amp2")


@pytest.fixture(scope="module")
def setup():
    """(config at the perturbed start, the JAX truth parameters, the data batch of the truth's spectrum)."""
    config, gt, _, _, _ = random_test._setup(seed=42)
    ThryE, ThryI, _, _ = JaxDiagnostic(config, scattering_angles=jax_angles(config))(gt, random_test.DUMMY_BATCH)
    batch = {"e_data": np.asarray(ThryE), "i_data": np.asarray(ThryI), "e_amps": np.ones((1, 1)), "i_amps": np.ones((1, 1)),
             "noise_e": np.zeros((1, 1)), "noise_i": np.zeros((1, 1))}
    config["optimizer"]["batch_size"] = 1
    return config, gt, batch


def _values(unnormed):
    return {k: float(np.asarray(v.detach() if isinstance(v, torch.Tensor) else v).reshape(-1)[0])
            for g in ("electron", "general") for k, v in unnormed[g].items() if k in ACTIVE}


def _both(config, batch, num_epochs=None):
    cfg = copy.deepcopy(config)
    if num_epochs is not None:
        cfg["optimizer"]["num_epochs"] = num_epochs
    want_loss, want = jax_scipy_loop(cfg, JaxLoss(cfg, jax_angles(cfg), batch), None, batch)
    record = {}
    loss_fn = port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu")
    got_loss, got = _1d_scipy_loop_(cfg, loss_fn, None, batch, record=record)
    assert isinstance(got_loss, float) and isinstance(got, port.ThomsonParams)
    assert all(p.grad is None for p in got.parameters())
    return want_loss, _values(want.get_unnormed_params()), got_loss, _values(got.get_unnormed_params()), record


def test_scipy_loop_follows_jax_trajectory(setup):
    config, _, batch = setup
    want_loss, want, got_loss, got, record = _both(config, batch, num_epochs=10)
    assert record["nit"] == [10]
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for k in ACTIVE:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_scipy_loop_converges_and_recovers_truth(setup):
    config, gt, batch = setup
    want_loss, want, got_loss, got, record = _both(config, batch)
    assert got_loss < 1e-4 and want_loss < 1e-4
    assert record["success"] == [True] and record["nit"][0] <= config["optimizer"]["num_epochs"]
    assert record["nfev"][0] >= record["nit"][0] and "CONVERGENCE" in record["message"][0]
    truth = _values(gt.get_unnormed_params())
    for k in ACTIVE:
        np.testing.assert_allclose(got[k], truth[k], rtol=0.1, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_one_d_loop_scipy_two_batches_with_warm_start():
    cfg = ge._small_config(2)
    cfg["optimizer"].update(method="l-bfgs-b", grad_method="AD", num_epochs=3, sequential=True)
    data = ge._make_batch(4)
    data["e_data"][2:] *= 1.5  # the second batch's data differ from the first's
    all_data = {"e_data": data["e_data"], "i_data": data["i_data"], "e_amps": data["e_amps"], "i_amps": data["i_amps"],
                "noiseE": data["noise_e"], "noiseI": data["noise_i"]}
    sas = port.get_scattering_angles(cfg)
    record = {}
    weights, overall, loss_fn = one_d_loop(cfg, all_data, sas, np.arange(4), 2, device="cpu", record=record)
    assert len(weights) == 2 and all(isinstance(w, port.ThomsonParams) for w in weights)
    assert np.isfinite(overall) and len(record["nit"]) == 2
    assert loss_fn.e_norm == pytest.approx(float(data["e_data"][2:].max()))  # the last batch's own loss function
    cold = copy.deepcopy(cfg)
    cold["optimizer"]["sequential"] = False
    weights_cold, _, _ = one_d_loop(cold, all_data, sas, np.arange(4), 2, device="cpu")
    te = lambda w: w.electron.params.normed["Te"].detach()  # noqa: E731
    torch.testing.assert_close(te(weights[0]), te(weights_cold[0]), rtol=0, atol=0)
    assert not torch.equal(te(weights[1]), te(weights_cold[1]))
    cfg["optimizer"]["method"] = "lbfgs"  # the device L-BFGS, which raised here until it was ported
    record = {}
    weights, overall, lbfgs_loss_fn = one_d_loop(cfg, all_data, sas, np.arange(4), 2, device="cpu", record=record)
    assert len(weights) == 2 and np.isfinite(overall) and len(record["losses"]) == 2 * cfg["optimizer"]["num_epochs"]
    assert lbfgs_loss_fn.e_norm == pytest.approx(float(data["e_data"][:2].max()))  # one loss function for both batches
