"""The port's 1D adam loop: its host-facing contract, and ten steps against the JAX loop.

On the CPU in float64, on the small 1D deck of ``__graft_entry__`` and its
seeded data batch:

* the four cases of ``tests/test_inverse/test_adam_loop.py``: the loop improves
  the loss and returns the best-so-far as (float, ThomsonParams); zero epochs
  return (inf, initial parameters); chunking does not change the trajectory;
  ``track_best: per_lineout`` matches a manual replay that keeps, per lineout,
  the post-update parameters of that row's lowest pre-update loss;
* ten adam steps at lr 1e-2 against ``tsadar_tpu.inverse.loops._1d_adam_loop_``
  from the same start: best loss and every fitted parameter to 1e-8 relative
  (``torch.optim.Adam`` and ``optax.adam`` are the same update).  This runs
  with the EPW feature alone, as the whole-shot deck does: with the IAW windows
  on this deck's random data the loss is so sharp in lam that the two
  trajectories, whose lam gradients agree to 4e-10 at the start, part by a
  factor ~10 per step (1e-7 in the loss after ten), which says nothing about
  either loop;
* ``one_d_loop`` over two batches with the sequential warm start, and one
  step of each L-BFGS (scipy's, and the device L-BFGS against the JAX loop).
"""

import copy

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tsadar_tpu.inverse.loops import _1d_adam_loop_ as jax_adam_loop
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.core.params import get_filter_spec
from tsadar_tpu_torch.inverse.loops import _1d_adam_loop_, _init_params, _slice_batch, one_d_loop


def _config(batch_size, epw_only=False, **optimizer):
    cfg = ge._small_config(batch_size)
    cfg["optimizer"].update(method="adam", learning_rate=1e-2, **optimizer)
    if epw_only:
        cfg["other"]["extraoptions"].update(load_ion_spec=False, fit_IAW=False)
    return cfg


def _setup(batch_size=2, epw_only=False, **optimizer):
    cfg = _config(batch_size, epw_only, **optimizer)
    batch = ge._make_batch(batch_size)
    return cfg, port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu"), batch


def _physical(ts_params):
    out = ts_params.get_unnormed_params()
    return {f"{g}.{k}": np.asarray(v.detach()) for g, d in out.items() for k, v in d.items()}


def test_adam_loop_improves_and_returns_best():
    cfg, loss_fn, batch = _setup(num_epochs=8)
    record = {}
    best_loss, best_weights = _1d_adam_loop_(cfg, loss_fn, None, batch, record=record)
    assert isinstance(best_loss, float) and np.isfinite(best_loss)
    assert isinstance(best_weights, port.ThomsonParams)
    losses = record["losses"]
    assert len(losses) == 8 and record["chunk_steps"] == [8] and best_loss == min(losses) < losses[0]
    # the pre-update loss is credited to the post-update parameters: the best
    # parameters are those AFTER the step whose loss was lowest (here the last)
    assert losses.index(best_loss) == 7
    with torch.no_grad():
        after = float(loss_fn.__loss__(best_weights, batch)[0])
    assert after < best_loss
    assert all(p.grad is None for p in best_weights.parameters())


def test_adam_loop_zero_epochs_returns_init():
    cfg, loss_fn, batch = _setup(num_epochs=0)
    best_loss, best_weights = _1d_adam_loop_(cfg, loss_fn, None, batch)
    assert best_loss == np.inf
    assert isinstance(best_weights, port.ThomsonParams)
    init = port.ThomsonParams.create(cfg["parameters"], 2, activate=True, device="cpu")
    for (k, a), b in zip(best_weights.state_dict().items(), init.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_adam_loop_chunking_matches_per_step():
    cfg, loss_fn, batch = _setup(num_epochs=6, chunk_size=4)  # 4 + 2 tail
    record = {}
    loss_chunked, w_chunked = _1d_adam_loop_(cfg, loss_fn, None, batch, record=record)
    assert record["chunk_steps"] == [4, 2]
    cfg2, loss_fn2, batch2 = _setup(num_epochs=6, chunk_size=1)
    loss_single, w_single = _1d_adam_loop_(cfg2, loss_fn2, None, batch2)  # no record: the host reads only the result
    assert loss_chunked == loss_single
    for (k, a), b in zip(_physical(w_chunked).items(), _physical(w_single).values()):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_adam_loop_per_lineout_best_tracking():
    n_rows, epochs, lr = 4, 7, 0.3  # the large rate makes rows overshoot at different epochs
    cfg, loss_fn, batch = _setup(n_rows, num_epochs=epochs, chunk_size=3, track_best="per_lineout")
    cfg["optimizer"]["learning_rate"] = lr
    loss_pl, w_pl = _1d_adam_loop_(cfg, loss_fn, None, batch)

    # manual replay of the trajectory
    ts = port.ThomsonParams.create(cfg["parameters"], n_rows, activate=True, device="cpu")
    trainable = get_filter_spec(cfg["parameters"], ts)
    opt = torch.optim.Adam(list(trainable.values()), lr=lr)
    tes, rowss = [], []
    for _ in range(epochs):
        (_, aux), grads = loss_fn.value_and_grad(ts, batch, trainable)
        rowss.append(aux[2].numpy())
        for p, g in zip(trainable.values(), grads.values()):
            p.grad = g
        opt.step()
        tes.append(ts.electron.params.normed["Te"].detach().numpy().copy())
    rowss, tes = np.array(rowss), np.array(tes)
    best_epoch = rowss.argmin(axis=0)
    assert len(set(best_epoch.tolist())) > 1  # the selection really engages
    expected_te = tes[best_epoch, np.arange(n_rows)]
    np.testing.assert_allclose(w_pl.electron.params.normed["Te"].detach().numpy(), expected_te, rtol=1e-12)
    # the returned scalar is the assembled parameters' actual joint loss
    with torch.no_grad():
        assert loss_pl == float(loss_fn.__loss__(w_pl, batch)[0])


@pytest.fixture(scope="module")
def ten_steps_of_jax():
    cfg = _config(2, epw_only=True, num_epochs=10, chunk_size=5)
    batch = ge._make_batch(2)
    loss_fn = JaxLoss(cfg, jax_angles(cfg), batch)
    best_loss, best = jax_adam_loop(cfg, loss_fn, None, batch)
    unnormed = best.get_unnormed_params()
    return best_loss, {f"{g}.{k}": np.asarray(v) for g, d in unnormed.items() for k, v in d.items()}


def test_ten_adam_steps_match_jax(ten_steps_of_jax):
    want_loss, want = ten_steps_of_jax
    cfg, loss_fn, batch = _setup(epw_only=True, num_epochs=10, chunk_size=5)
    got_loss, best = _1d_adam_loop_(cfg, loss_fn, None, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-8)
    got = _physical(best)
    assert got.keys() == want.keys()
    moved = 0
    init = _physical(port.ThomsonParams.create(cfg["parameters"], 2, activate=True, device="cpu"))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-8, atol=0, err_msg=k)
        moved += int(not np.allclose(got[k], init[k], rtol=1e-4))
    assert moved == 6  # Te, ne, m, amp1, amp2, lam: exactly the active parameters moved


def test_fitted_params_report_the_active_ones():
    cfg, _, _ = _setup()
    ts = port.ThomsonParams.create(cfg["parameters"], 2, activate=True, device="cpu")
    fitted, n = ts.get_fitted_params(cfg["parameters"])
    assert n == 6 and sorted(fitted["electron"]) == ["Te", "m", "ne"] and sorted(fitted["general"]) == ["amp1", "amp2", "lam"]
    assert fitted["ion-1"] == {}


def test_previous_weights_are_left_untouched():
    cfg, loss_fn, batch = _setup(num_epochs=2)
    start = _init_params(cfg, None, device="cpu")
    before = copy.deepcopy(start.state_dict())
    _, best = _1d_adam_loop_(cfg, loss_fn, start, batch)
    assert best is not start
    for k, v in start.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    assert not torch.equal(best.electron.params.normed["Te"], start.electron.params.normed["Te"])


def test_one_d_loop_runs_batches_with_warm_start():
    cfg = ge._small_config(2)
    cfg["optimizer"].update(method="adam", learning_rate=1e-2, num_epochs=2, sequential=True)
    data = ge._make_batch(4)
    all_data = {"e_data": data["e_data"], "i_data": data["i_data"], "e_amps": data["e_amps"], "i_amps": data["i_amps"],
                "noiseE": data["noise_e"], "noiseI": data["noise_i"]}
    assert _slice_batch(all_data, [2, 3])["noise_e"].shape == (2, 1024)
    weights, overall, loss_fn = one_d_loop(cfg, all_data, port.get_scattering_angles(cfg), np.arange(4), 2, device="cpu")
    assert len(weights) == 2 and all(isinstance(w, port.ThomsonParams) for w in weights)
    assert np.isfinite(overall) and isinstance(loss_fn, port.LossFunction)
    # the second batch started from the first one's result, not from the deck
    cold = copy.deepcopy(cfg)
    cold["optimizer"]["sequential"] = False
    weights_cold, _, _ = one_d_loop(cold, all_data, port.get_scattering_angles(cfg), np.arange(4), 2, device="cpu")
    te = lambda w: w.electron.params.normed["Te"].detach()  # noqa: E731
    torch.testing.assert_close(te(weights[0]), te(weights_cold[0]), rtol=0, atol=0)
    assert not torch.equal(te(weights[1]), te(weights_cold[1]))


@pytest.mark.parametrize("method", ["l-bfgs-b", "lbfgs"])
def test_one_d_loop_refuses_unported_optimizers(method):
    """Both optimizers that raised here until they were ported now run: ``l-bfgs-b`` (scipy on the host,
    ``tests/test_torch_scipy_loop.py``) and ``lbfgs`` (the device L-BFGS, ``tests/test_torch_lbfgs.py``), whose
    one step lands where the JAX package's ``_1d_device_lbfgs_loop_`` does (1e-8 relative)."""
    cfg = ge._small_config(2)
    cfg["optimizer"].update(method=method, num_epochs=1)
    data = ge._make_batch(2)
    all_data = {"e_data": data["e_data"], "i_data": data["i_data"], "e_amps": data["e_amps"], "i_amps": data["i_amps"],
                "noiseE": data["noise_e"], "noiseI": data["noise_i"]}
    weights, overall, _ = one_d_loop(cfg, all_data, port.get_scattering_angles(cfg), np.arange(2), 1, device="cpu")
    assert len(weights) == 1 and np.isfinite(overall)
    if method == "lbfgs":
        from tsadar_tpu.inverse.loops import _1d_device_lbfgs_loop_ as jax_lbfgs_loop

        want_loss, want = jax_lbfgs_loop(cfg, JaxLoss(cfg, jax_angles(cfg), data), None, data)
        np.testing.assert_allclose(overall, float(want_loss), rtol=1e-8)
        got, want = _physical(weights[0]), {f"{g}.{k}": np.asarray(v) for g, d in want.get_unnormed_params().items()
                                            for k, v in d.items()}
        for k in ("electron.Te", "electron.ne", "electron.m", "general.amp1", "general.amp2", "general.lam"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
