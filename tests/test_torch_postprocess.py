"""The port's postprocess (``tsadar_tpu_torch.utils.process.postprocess``) against the JAX package's, on the CPU.

On ``__graft_entry__._small_config`` (EPW and IAW fitted, npts 1024, nvx 64)
with its active parameters spread per lineout by a seeded draw, float64:

* ``batch_flat_hessian`` at B = 4, chunked (one Hessian-vector product per
  active parameter) and ``force_dense``: every entry within 5e-8 of the
  Hessian's largest entry of JAX's (measured 1.2e-8 and 1.5e-8; the ne and lam
  second derivatives cancel ~7 digits, so their blocks part at ~1.4e-7 of their
  own largest entries while the others agree to <= 3e-10), and ``get_sigmas``
  on each to 1e-5 relative (measured 1.2e-6, 1.4e-6).  The port's
  reverse-over-reverse product and JAX's forward-over-reverse give the same
  matrix; the two forms of the port agree with each other.
* ``recalculate_with_chosen_weights`` over two batches of two, with sigmas:
  the fitted spectra to 1e-10 of their largest entry, the per-lineout losses
  and squared deviations to 1e-7 relative (errors over the theory itself,
  which is 1e-8 of its peak in places at these spread parameters: measured
  1.7e-9 and 1.7e-8), the sigmas to 1e-5.
* ``get_final_params`` and the sigma names: the JAX package's keys
  (``"{param}_{species}"``, ``"lineout pixel"``, the x-axis label), and each
  sigma named after the leaf in its column's place.  The JAX package's
  ``save_sigmas_params`` names the columns in ``get_fitted_params``' order
  (lam, amp1, amp2) while ``get_sigmas`` gives them in the ravel order (amp1,
  amp2, lam): its general.* sigma names are permuted; the port's are not.
* ``plotting.detailed_breakdown`` over two batches of two: each batch's
  component stacks and raw axes (the ion stack to 1e-8 of its peak: see
  ``tests/test_torch_detailed_spectrum.py``) and the instrument-only spectra
  as the JAX package files them; the angular arm on the small ARTS 2V deck
  (the window's fit, losses and squared deviations), and its Hessian skipped
  past the JAX package's budget of 2048 active parameters.
* ``interp.plain_forms()``: the lookups, the padded lookup, the chi tables'
  lookup and the PV tables give the same values with no ``autograd.Function``
  in their graph, and a second derivative (the spectrum tail's route is what
  the Hessian comparisons above hold); tensors off the CPU are refused there.

The refits and the sigmas' calibration are in ``tests/test_torch_refit_sigmas.py``.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import __graft_entry__ as ge
from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import combine, partition
from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
from tsadar_tpu.utils.process import postprocess as jpp
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import thomson_params_from_partitions
from tsadar_tpu_torch.utils import artifacts
from tsadar_tpu_torch.utils.process import postprocess as ppp

from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

H_TOL = 5e-8  # of the Hessian's largest |entry|
SIGMA_TOL = 1e-5  # relative


def _spread(cfg, B, seed=0):
    tp = JaxParams.create(cfg["parameters"], num_params=B, batch=True, activate=True)
    diff, static = partition(tp, jax_filter_spec(cfg["parameters"], tp))
    rng = np.random.default_rng(seed)
    diff = jax.tree.map(lambda x: x + 0.3 * jnp.asarray(rng.standard_normal(x.shape)), diff)
    return combine(diff, static), thomson_params_from_partitions(cfg["parameters"], diff, static, device="cpu")


def _all_data(n):
    b = ge._make_batch(n)
    return {"e_data": b["e_data"], "e_amps": b["e_amps"], "i_data": b["i_data"], "i_amps": b["i_amps"],
            "noiseE": b["noise_e"], "noiseI": b["noise_i"]}


@pytest.mark.parametrize("form", ["chunked", "dense"])
def test_batch_flat_hessian_and_sigmas_match_jax(form):
    B = 4
    cfg = ge._small_config(B)
    batch = ge._make_batch(B)
    jw, pw = _spread(cfg, B)
    dense = form == "dense"
    want = np.asarray(jpp.batch_flat_hessian(cfg, JaxLoss(cfg, jax_angles(cfg), batch), jw, batch, force_dense=dense))
    loss_fn = port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu")
    got = ppp.batch_flat_hessian(cfg, loss_fn, pw, batch, force_dense=dense)
    assert got.shape == want.shape == (6 * B, 6 * B)
    np.testing.assert_allclose(got, want, rtol=0, atol=H_TOL * np.abs(want).max())
    np.testing.assert_allclose(ppp.get_sigmas(got, B), jpp.get_sigmas(want, B), rtol=SIGMA_TOL)
    if not dense:  # the block form agrees with the port's own dense form, and no cross-lineout entry is filled
        full = ppp.batch_flat_hessian(cfg, loss_fn, pw, batch, force_dense=True)
        np.testing.assert_allclose(got, full, rtol=0, atol=1e-12 * np.abs(full).max())
        lineout = np.arange(6 * B) % B
        assert np.all(got[lineout[:, None] != lineout[None, :]] == 0.0)


def test_recalculate_with_chosen_weights_matches_jax():
    n, bs = 4, 2
    cfg = ge._small_config(bs)
    all_data = _all_data(n)
    weights = [_spread(cfg, bs, seed=s) for s in (5, 6)]
    jl = JaxLoss(cfg, jax_angles(cfg), jpp_batch := {k: v[:bs] for k, v in ge._make_batch(n).items()})
    pl = port.LossFunction(cfg, port.get_scattering_angles(cfg), jpp_batch, device="cpu")
    want = jpp.recalculate_with_chosen_weights(cfg, None, np.arange(n), all_data, jl, True, [w[0] for w in weights])
    record = {}
    got = ppp.recalculate_with_chosen_weights(cfg, None, np.arange(n), all_data, pl, True, [w[1] for w in weights], record)
    (w_losses, w_sqdevs, w_num, w_fits, w_sigmas, w_params), (g_losses, g_sqdevs, g_num, g_fits, g_sigmas, g_params) = want, got
    assert g_num == w_num == 6 and record["recalc_hessian_seconds"] > 0.0
    np.testing.assert_allclose(g_losses, w_losses, rtol=1e-7)  # errors over the theory itself, as sqdev
    for key in ("ele", "ion"):
        np.testing.assert_allclose(g_fits[key]["total_spec"], w_fits[key]["total_spec"], rtol=0,
                                   atol=1e-10 * np.abs(w_fits[key]["total_spec"]).max())
        np.testing.assert_allclose(g_sqdevs[key], w_sqdevs[key], rtol=1e-7, atol=1e-10 * np.abs(w_sqdevs[key]).max())
    assert np.all(np.abs(w_sigmas) > 0.0)
    np.testing.assert_allclose(g_sigmas, w_sigmas, rtol=SIGMA_TOL)
    for group, values in w_params.items():
        assert list(g_params[group]) == list(values)
        for name, v in values.items():
            np.testing.assert_allclose(g_params[group][name], np.asarray(v), rtol=1e-12, err_msg=f"{group}.{name}")

    # the final parameters: the JAX package's keys, lineout pixels and x axis first; sigma names by leaf
    cfg["data"] = {"lineouts": {"pixelE": [10, 11, 12, 13], "pixelI": [1, 2, 3, 4]}}
    axes = {"x_label": "Time (ps)", "epw_x": np.arange(20) * 2.0, "iaw_x": np.arange(20) * 3.0}
    final = artifacts.get_final_params(cfg, g_params, axes)  # the deck loads the ion spectrum: its pixels lead
    assert list(final)[:2] == ["lineout pixel", "Time (ps)"]
    np.testing.assert_array_equal(final["Time (ps)"], [3.0, 6.0, 9.0, 12.0])
    cfg["other"]["extraoptions"]["load_ion_spec"] = False
    np.testing.assert_array_equal(artifacts.get_final_params(cfg, g_params, axes)["lineout pixel"], [10, 11, 12, 13])
    assert sorted(list(final)[2:]) == sorted(f"{k}_{g}" for g, d in w_params.items() for k in d)
    names = ppp.sigma_names(cfg, weights[0][1])
    assert names == ["electron.Te", "electron.ne", "electron.m", "general.amp1", "general.amp2", "general.lam"]
    jax_names = [f"{g}.{k}" for g, d in w_params.items() for k, v in d.items() if np.asarray(v).ndim <= 1]
    assert jax_names != names and sorted(jax_names) == sorted(names)  # save_sigmas_params' permuted general.* names


def test_unported_options_raise_up_front():
    """What raised here until it was ported runs: ``plotting.detailed_breakdown`` (each batch's component stacks,
    instrument-only spectra and raw axes, as JAX files them) and the angular arm (the window's fit, losses and
    squared deviations against JAX's; the Hessian skipped past its budget of 2048 active parameters)."""
    n, bs = 4, 2
    cfg = ge._small_config(bs)
    cfg["plotting"] = {"detailed_breakdown": True}
    all_data = _all_data(n)
    weights = [_spread(cfg, bs, seed=s) for s in (5, 6)]
    batch = {k: v[:bs] for k, v in ge._make_batch(n).items()}
    want = jpp.recalculate_with_chosen_weights(cfg, None, np.arange(n), all_data, JaxLoss(cfg, jax_angles(cfg), batch), False,
                                               [w[0] for w in weights])[3]
    pl = port.LossFunction(cfg, port.get_scattering_angles(cfg), batch, device="cpu")
    got = ppp.recalculate_with_chosen_weights(cfg, None, np.arange(n), all_data, pl, False, [w[1] for w in weights])[3]
    for feature in ("ele", "ion"):
        assert list(got[feature]["spec_comps"]) == list(want[feature]["spec_comps"]) == [(0, 1), (2, 3)]
        for key in ("spec_comps", "detailed_axis"):
            for inds, w in want[feature][key].items():
                g = got[feature][key][inds]
                assert g.shape == w.shape and np.isfinite(g).all(), (feature, key)
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-8 * np.abs(w).max(), err_msg=f"{feature} {key}")
        np.testing.assert_allclose(got[feature]["IRF"], want[feature]["IRF"], rtol=0,
                                   atol=1e-10 * np.abs(want[feature]["IRF"]).max(), err_msg=feature)

    # the angular arm, which raised here until it was ported: the small ARTS 2V deck's window, against JAX's
    from .test_torch_arts_loss import UNIT, _all_data as arts_data, _config as arts_config

    cfg, sas = arts_config()
    lineouts = cfg["data"]["lineouts"]
    lineouts.update(start=int(lineouts["start"] / UNIT), end=int(lineouts["end"] / UNIT))
    cfg["optimizer"]["batch_size"] = 1
    all_data = arts_data(0)
    jw = JaxParams.create(cfg["parameters"], num_params=1, batch=False, activate=True)
    diff, static = partition(jw, jax_filter_spec(cfg["parameters"], jw))
    pw = thomson_params_from_partitions(cfg["parameters"], diff, static, activate=True, device="cpu")
    window = {"e_data": all_data["e_data"][lineouts["start"] : lineouts["end"]], "i_data": all_data["i_data"]}
    n = len(all_data["e_data"])
    want = jpp.recalculate_with_chosen_weights(cfg, sas, np.arange(n), all_data, JaxLoss(cfg, sas, window), False, [jw])
    record = {}
    got = ppp.recalculate_with_chosen_weights(cfg, sas, np.arange(n), all_data, port.LossFunction(cfg, sas, window, device="cpu"),
                                              False, [pw], record)
    losses, sqdevs, num_params, fits, sigmas, all_params = got
    assert fits["ele"].shape == (107, 128) and num_params == want[2]
    np.testing.assert_allclose(fits["ele"], want[3]["ele"], rtol=0, atol=1e-10 * np.abs(want[3]["ele"]).max())
    np.testing.assert_allclose(losses, want[0], rtol=1e-9)
    np.testing.assert_allclose(sqdevs["ele"], want[1]["ele"], rtol=0, atol=1e-9 * np.abs(want[1]["ele"]).max())
    assert all_params["electron"]["f"][0].shape == (32, 32)  # one unbatched set, not joined across batches
    # a 64 x 64 EDF's 4096 weights exceed the Hessian's budget of 2048: the sigmas are skipped with the JAX
    # package's message, as its postprocess does, before any Hessian work
    cfg["parameters"]["electron"]["fe"]["nvx"] = 64
    pw64 = port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu", batch=False)
    got = ppp.recalculate_with_chosen_weights(cfg, sas, np.arange(n), all_data, port.LossFunction(cfg, sas, window, device="cpu"),
                                              True, [pw64], record)
    assert record["sigma_error"] == "4096 active parameters exceed the hessian budget (2048)"
    assert not np.any(got[4])


def _graph_names(t):
    """The autograd node names of the graph behind ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo += [n for n, _ in node.next_functions]
    return {type(n).__name__ for n in seen}


def test_plain_forms_route_around_the_autograd_functions():
    """Inside ``interp.plain_forms()`` the kernel-backed functions give the same values through their plain forms
    with no ``autograd.Function`` in the graph (so a second derivative exists), and refuse tensors off the CPU."""
    from tsadar_tpu_torch.core.physics import interp, ratint

    rng = np.random.default_rng(7)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), requires_grad=True)  # noqa: E731
    q, table = torch.tensor(rng.uniform(-2.0, 2.0, (2, 50)), requires_grad=True), t(2, 9)
    meta = torch.tensor([[-2.0, 0.5, 9.0]] * 2, dtype=torch.float64)
    grid = torch.linspace(-2.0, 2.0, 9, dtype=torch.float64)
    T, beta = t(8, 3 * 5 - 2), torch.tensor(rng.uniform(0.0, 6.0, 30), requires_grad=True)
    f, coef = t(2, 7), ratint.pv_coefficients(5, torch.float64, "cpu")
    calls = {  # (the call, the autograd.Function whose node it makes outside plain_forms)
        "lin_lookup": (lambda: interp.lin_lookup(q, table, -2.0, 0.5), "LinLookupBackward"),
        "cubic_lookup": (lambda: interp.cubic_lookup(q, table, meta), "CubicLookupBackward"),
        "interp1d_linear_pallas": (lambda: interp.interp1d_linear_pallas(q, grid, table), "LinLookupPaddedBackward"),
        "chi_bilinear_lookup": (lambda: interp.chi_bilinear_lookup(T, beta, q[0, :30] * 2.0, -2.0, 1.0, -1.5, 1.0)[2],
                                "ChiBilinearBackward"),
        "pv_tables": (lambda: ratint.pv_tables(f**2, coef), "PvTablesBackward"),
    }
    for name, (call, node) in calls.items():
        want = call()
        assert node in _graph_names(want), name
        wrt = f if name == "pv_tables" else q
        with interp.plain_forms():
            got = call()
            (g,) = torch.autograd.grad(got.sum(), [wrt], create_graph=True)
            torch.autograd.grad(g.sum(), [wrt], allow_unused=True)  # a second derivative
        torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14, msg=name)
        assert node not in _graph_names(got), name
    with interp.plain_forms(), pytest.raises(ValueError, match="CPU"):
        interp.lin_lookup(q.detach().to("meta"), table.detach().to("meta"), -2.0, 0.5)
