"""The ARTS fit through the normal entry point against the JAX package's ``fitter.fit``, on the CPU in float64.

The ARTS 1V deck (``tests/configs/arts1v_test_{defaults,inputs}.yaml``: the
ATS image of shot 94475 with the background fitted from slice 94477, a DLM
EDF with Te, ne, m, amp1, amp2 and lam trainable) at a small size: one point
a pixel (npts 205 on the 103 x 205 image of resolution units), nvx 64, three
adam epochs at lr 5e-3, ``calc_sigmas``.  The port runs it as a user does,
``python -m tsadar_tpu_torch --cfg DIR --mode fit --device cpu`` (``cli.main``
in this process), with a checkpoint directory; the JAX package through
``fitter.fit`` inside a run of its tracker.  Both share one fit of the streak
background (``same_scipy_fits``):

* ``learned_parameters.csv``: the same columns, each to 1e-9 relative of the
  JAX package's final parameters;
* the angular Hessian (dense over the six unbatched parameters, on the CPU in
  float64) to ``HESSIAN_TOL`` of its largest entry, each package's at its own
  fitted parameters;
* ``binary/sigmas_fe.npz`` (the six sigmas of that Hessian): each within
  ``SPREAD_RATIO`` times the JAX package's own float64 spread of that sigma
  and at least ``SIGMA_FLOOR``.  The spread is the distance between the
  sigmas of JAX's two Hessian forms at its fitted parameters
  (``batch_flat_hessian``'s forward over reverse and ``jax.jacrev`` of the
  gradient); here it is ``JAX_SIGMA_SPREAD``, and, slow-marked (the second
  form compiles for a minute), it is computed and each sigma held to it
  directly.  ``SIGMA_TOL`` (1e-5,
  ``tests/test_torch_postprocess.py``) is out of reach on this deck in either
  package: the Hessian's condition number is ~2e6, and its (lam, lam) entry, a
  sum that cancels, comes out of float64 uncertain at ~1e-5 of itself (JAX's
  two forms part by 7.2e-6, the port's reverse over reverse by 1.7e-5 from
  JAX's); that entry moves every sigma by the same factor, so JAX's two forms
  part by 2.6e-5 (amp1) to 1.4e-2 (lam) on the sigmas, and the port by 2.6
  times that (ROADMAP.md §3);
* the run's angular files (``binary/angular_fit_and_data.npz`` and
  ``fit_and_data.nc``, ``sigma-fe.nc``, the EDF), the tracker's stage
  metrics with one ``epoch loss`` an epoch, and a checkpoint labelled with the
  last epoch.

Float32 loses the deck's gradients (lam's by ~20 times itself) in the JAX package as in the port
(``test_float32_loses_the_arts_1v_gradients_as_the_jax_packages_does``).  Slow-marked, the full-size twins of ``tests/test_inverse/test_angular_e2e.py``
(the deck as written with 8 adam epochs, a checkpoint every 4 and sigmas),
``test_angular_1v.py`` (a DLM reconstruction from a synthetic image) and
``test_angular_2v.py`` (arbitrary and spherical-harmonic 2D EDFs, the latter
at l = 1), each with the JAX test's own gate.
"""

import glob
import json
import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from tsadar_tpu.inverse import fitter as jax_fitter
from tsadar_tpu.utils import mlflow_shim as jax_mlflow
from tsadar_tpu.utils.plotting import plotters
from tsadar_tpu.utils.process import postprocess as jpp
import tsadar_tpu_torch as port
from tsadar_tpu_torch import cli
from tsadar_tpu_torch.core.params import get_filter_spec
from tsadar_tpu_torch.inverse import fitter
from tsadar_tpu_torch.inverse.optimizers import optimizer
from tsadar_tpu_torch.utils import mlflow_shim as mlflow
from tsadar_tpu_torch.utils.checkpoint import latest_epoch
from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges
from tsadar_tpu_torch.utils.process import postprocess

from .test_torch_data_pipeline import same_scipy_fits
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CONFIGS = Path(__file__).resolve().parent / "configs"
SPREAD_RATIO = 4.0  # the port's sigmas against JAX's, in units of JAX's own spread (measured 2.5-2.6)
HESSIAN_TOL = 1e-7  # of the largest entry: the port's angular Hessian against JAX's (measured 4.9e-8)
SIGMA_FLOOR = 1e-4  # relative: the least limit of a sigma
# each sigma's float64 spread in the JAX package, relative: the distance between the sigmas of its two Hessian forms
# at its fitted parameters, in the Hessian's order (``postprocess.sigma_names``); computed again, and these values
# held to it, by test_cli_arts_sigmas_within_the_jax_packages_own_spread
JAX_SIGMA_SPREAD = {"electron.Te": 1.78e-3, "electron.ne": 1.03e-2, "electron.m": 6.96e-4, "general.amp1": 2.62e-5,
                    "general.amp2": 2.71e-5, "general.lam": 1.36e-2}
ACTIVE = ("Te_electron", "ne_electron", "m_electron", "amp1_general", "amp2_general", "lam_general")


def _decks(epochs=3, small=True):
    defaults, inputs = (yaml.safe_load((CONFIGS / f"arts1v_test_{n}.yaml").read_text()) for n in ("defaults", "inputs"))
    inputs["optimizer"] = {"method": "adam", "num_epochs": epochs, "learning_rate": 5e-3}
    inputs["other"]["calc_sigmas"] = True
    if small:
        inputs["other"]["points_per_pixel"] = 1
        inputs["parameters"]["electron"]["fe"]["nvx"] = 64
    return defaults, inputs


def _write(directory, defaults, inputs):
    directory.mkdir(parents=True)
    for name, deck in (("defaults", defaults), ("inputs", inputs)):
        (directory / f"{name}.yaml").write_text(yaml.dump(deck))
    return directory


def _artifacts(runs):
    (run_json,) = Path(runs).rglob("run.json")
    return run_json.parent / "artifacts", json.loads(run_json.read_text())


def _jax_sigma_spread(stash):
    """|sigmas of ``jax.jacrev(jax.grad(loss))`` - sigmas of ``batch_flat_hessian``| at the JAX fit's parameters."""
    import jax
    from jax.flatten_util import ravel_pytree

    from tsadar_tpu.core.params import combine, get_filter_spec as jax_filter_spec, partition
    from tsadar_tpu.core.physics.interp import pallas_disabled
    from tsadar_tpu.inverse.loops import _angular_batch

    config, all_data, loss_fn, weights = stash["config"], stash["all_data"], stash["loss_fn"], stash["weights"]
    batch = _angular_batch(all_data, slice(config["data"]["lineouts"]["start"], config["data"]["lineouts"]["end"]))
    forward_over_reverse = jpp.get_sigmas(np.asarray(jpp.batch_flat_hessian(config, loss_fn, weights, batch)), 1)
    diff, static = partition(weights, jax_filter_spec(config["parameters"], weights))
    with pallas_disabled():
        x0, unravel = ravel_pytree(diff)
        hess = jax.jacrev(jax.grad(lambda x: loss_fn._loss_for_hess_fn_(combine(unravel(x), static), batch)))(x0)
    return np.abs(jpp.get_sigmas(np.asarray(hess), 1) - forward_over_reverse)


def _both_fits(tmp_path, monkeypatch):
    """The small deck through the port's command line and the JAX package's ``fitter.fit``, sharing one fit of the
    background: (the port's artifacts, its run record, the JAX run's artifacts, JAX's final parameters, what the
    JAX postprocess was given with each package's first Hessian under ``"hessians"``)."""
    for name in ("plot_data_angular", "plot_ang_lineouts", "plot_dist"):  # figures only: they cost seconds here
        monkeypatch.setattr(plotters, name, lambda *a, **k: {})
    stash, process = {"hessians": {}}, jpp.process_angular_data

    def keeping(module, key):
        hessian = module.batch_flat_hessian

        def first_kept(*args, **kwargs):
            h = hessian(*args, **kwargs)
            stash["hessians"].setdefault(key, np.asarray(h))
            return h

        monkeypatch.setattr(module, "batch_flat_hessian", first_kept)

    keeping(postprocess, "port")
    keeping(jpp, "jax")

    def keep(config, indices, all_data, all_axes, loss_fn, weights, *rest):  # the JAX fit's parameters, for the spread
        stash.update(config=config, all_data=all_data, loss_fn=loss_fn, weights=weights)
        return process(config, indices, all_data, all_axes, loss_fn, weights, *rest)

    monkeypatch.setattr(jpp, "process_angular_data", keep)
    defaults, inputs = _decks()
    inputs["optimizer"]["checkpoint_dir"] = str(tmp_path / "ckpt")
    cfg_dir = _write(tmp_path / "cfg", defaults, inputs)
    monkeypatch.chdir(tmp_path)  # the JAX loop writes state_weights.txt into the working directory
    with same_scipy_fits():
        monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "jax_runs"))
        jax_mlflow.set_experiment("arts-fit")
        with jax_mlflow.start_run(run_name="jax"):
            jax_deck = merge_configs(defaults, inputs)
            jax_deck["optimizer"].pop("checkpoint_dir")
            want, want_loss = jax_fitter.fit(jax_deck)
        monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
        cli.main(["--cfg", str(cfg_dir), "--mode", "fit", "--device", "cpu"])
    assert np.isfinite(want_loss)
    art, meta = _artifacts(tmp_path / "runs")
    return art, meta, _artifacts(tmp_path / "jax_runs")[0], want, stash


def _sigmas(*artifact_dirs):
    return [np.load(a / "binary" / "sigmas_fe.npz")["sigmas"] for a in artifact_dirs]


def test_cli_arts_fit_matches_the_jax_fitter(tmp_path, monkeypatch):
    art, meta, jax_art, want, stash = _both_fits(tmp_path, monkeypatch)
    table = pd.read_csv(art / "csv" / "learned_parameters.csv", index_col=0)
    assert set(ACTIVE) <= set(table.columns) and len(table) == 1
    for k in ACTIVE:
        np.testing.assert_allclose(table[k].to_numpy(), np.asarray(want[k]), rtol=1e-9, err_msg=k)
    hess, jax_hess = stash["hessians"]["port"], stash["hessians"]["jax"]
    assert hess.shape == jax_hess.shape == (6, 6)
    np.testing.assert_allclose(hess, jax_hess, rtol=0, atol=HESSIAN_TOL * np.abs(jax_hess).max())
    sig, jax_sig = _sigmas(art, jax_art)
    assert sig.shape == jax_sig.shape == (1, 6) and np.all(sig != 0)
    deck = merge_configs(*_decks())
    names = postprocess.sigma_names(deck, port.ThomsonParams.create(deck["parameters"], 1, activate=True, device="cpu",
                                                                     batch=False))
    assert names == list(JAX_SIGMA_SPREAD)
    # each sigma within its share of the float64 spread of either package's Hessian on this deck (module docstring)
    rtol = np.maximum(SPREAD_RATIO * np.array(list(JAX_SIGMA_SPREAD.values())), SIGMA_FLOOR)
    miss = np.abs(sig[0] - jax_sig[0]) / np.abs(jax_sig[0])
    assert np.all(miss <= rtol), dict(zip(names, miss / rtol))

    files = {str(p.relative_to(art)) for p in art.rglob("*") if p.is_file()}
    # no EDF file and no EDF figure: a DLM EDF gives the final parameters no "fe", and the JAX package plots none;
    # the image's figures, matplotlib being installed here (tests/test_torch_figures.py holds their pixels)
    assert files == {"defaults.yaml", "inputs.yaml", "binary/angular_fit_and_data.npz", "binary/fit_and_data.nc",
                     "binary/sigmas_fe.npz", "binary/sigma-fe.nc", "csv/learned_parameters.csv", "state_weights.txt",
                     "plots/angular_data_vs_fit.png", "plots/fit_and_data.png", "plots/angular_lineouts.png"}
    image = np.load(art / "binary" / "angular_fit_and_data.npz")
    assert image["data"].shape == (103, 205) and image["fit"].shape == (86, 205) and np.isfinite(image["fit"]).all()
    assert meta["tags"]["status"] == "completed"
    assert {"setup_time", "fit_lossfn_init_time", "fit_first_dispatch_time", "fit_time", "postprocessing time",
            "postprocess_time", "total_time"} <= set(meta["metrics"])
    assert [m["step"] for m in meta["metrics"]["epoch loss"]] == [0, 1, 2]
    assert latest_epoch(tmp_path / "ckpt") == 2


def test_float32_loses_the_arts_1v_gradients_as_the_jax_packages_does():
    """The ARTS 1V deck's first batch (the window of shot 94475's image) at the deck's start values: the gradient in
    float32 against float64, in both packages.  Float32 misses Te, ne and m by 0.1-0.8 of themselves and lam's by
    ~20-30 times itself (the deck's narrow resonance; its spectrum misses float64 by ~3e-2 of peak), in the JAX
    package as in the port.  The port's float32 miss of each is held to 1.5 times the JAX package's plus 2e-2, so
    that what the card misses can be put down to float32 (``chip_smoke.py``'s ``arts_1v_real_grad_check`` holds the
    card to twice the port's CPU float32 miss); the float64 gradients agree to 1e-8 of the largest (lam's, which
    cancels, to ~1e-7 of itself)."""
    import jax

    from tsadar_tpu.core.params import ThomsonParams as JaxParams, get_filter_spec as jax_filter_spec, partition
    from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
    from tsadar_tpu.inverse.loops import _angular_batch

    cfg = fitter._lineout_selection(merge_configs(*_decks(small=False)))
    all_data, sa, _ = fitter.load_data_for_fitting(cfg)
    cfg["optimizer"]["batch_size"] = 1
    lineouts, unit = cfg["data"]["lineouts"], cfg["other"]["ang_res_unit"]
    lineouts.update(start=int(lineouts["start"] / unit), end=int(lineouts["end"] / unit))
    batch = _angular_batch(all_data, slice(lineouts["start"], lineouts["end"]))

    def jax_grads(x64):
        with jax.enable_x64(x64):
            b = {k: np.asarray(v, np.float64 if x64 else np.float32) for k, v in batch.items()}
            loss_fn = JaxLoss(cfg, sa, b)
            jp = JaxParams.create(cfg["parameters"], num_params=1, batch=False, activate=True)
            diff, static = partition(jp, jax_filter_spec(cfg["parameters"], jp))
            grads = loss_fn._vg_func_(diff, static, b)[1]
            return {jax.tree_util.keystr(k): float(g) for k, g in jax.tree_util.tree_flatten_with_path(grads)[0]}

    def port_grads(dtype):
        loss_fn = port.LossFunction(cfg, sa, batch, device="cpu", dtype=dtype)
        params = port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu", dtype=dtype, batch=False)
        return {k: float(g) for k, g in loss_fn.value_and_grad(params, batch)[1].items()}

    j64, j32, p64, p32 = jax_grads(True), jax_grads(False), port_grads(torch.float64), port_grads(torch.float32)
    assert set(j64) == set(p64) and len(p64) == 6
    miss = lambda g: {k: abs(g[k] - j64[k]) / abs(j64[k]) for k in j64}  # noqa: E731
    jax_miss, port_miss = miss(j32), miss(p32)
    largest = max(abs(g) for g in j64.values())
    for k in j64:
        np.testing.assert_allclose(p64[k], j64[k], rtol=0, atol=1e-8 * largest, err_msg=k)
        assert port_miss[k] <= 1.5 * jax_miss[k] + 2e-2, (k, port_miss[k], jax_miss[k])
    lam = ".general.params.normed['lam']"
    assert jax_miss[lam] > 5.0 and port_miss[lam] > 5.0  # float32 loses lam's gradient in both


def _real_2v_deck(lr, epochs):
    """The ARTS 2V deck's 128 x 128 pointwise EDF (``bench_arts.py``'s: ``init_m`` 2.5, ``learn_log``) on the ARTS 1V
    deck's real data (shot 94475, background slice 94477): rmsprop at ``lr``, as ``chip_smoke.py``'s
    ``arts_2v_real_fit`` runs it."""
    cfg = merge_configs(*[yaml.safe_load((CONFIGS / n).read_text()) for n in ("arts2v_test_defaults.yaml", "arts2d_test_inputs.yaml")])
    cfg["parameters"]["electron"]["fe"].update(type="arbitrary", dim=2, nvx=128, params={"init_m": 2.5, "learn_log": True})
    cfg["data"].update(shotnum=94475, background={"type": "Fit", "slice": 94477}, launch_data_visualizer=False)
    cfg["optimizer"].update(num_epochs=epochs, learning_rate=lr, save_state=False)
    return cfg


@pytest.mark.parametrize("lr, epochs", [(1e-2, 8), (1e-3, 6)])
def test_real_2v_fit_follows_the_jax_loop_epoch_by_epoch(lr, epochs, tmp_path, monkeypatch):
    """``angular_optax`` of ``_real_2v_deck`` in both packages on the CPU in float64, each projecting by NUDFT as on an
    accelerator, from one fit of the background: every counted epoch's loss to 1e-5 relative (measured 1.9e-7).  At
    the deck's lr, 1e-2, the loss rises from the first step in both (0.879 -> 1.87 in 7 epochs, then the early
    stop); at 1e-3 it falls in both, which is why ``chip_smoke.py`` fits this image at 1e-3."""
    from tsadar_tpu.core.physics.form_factor import FormFactor as JaxFormFactor
    from tsadar_tpu.inverse import loops as jax_loops
    from tsadar_tpu_torch.core.physics.form_factor import FormFactor

    for cls in (JaxFormFactor, FormFactor):
        monkeypatch.setattr(cls, "_project_all_fourier", lambda self, vx, DF, betas: self._project_all_nudft(vx, DF))
    jax_losses, log_metrics = [], jax_loops.mlflow.log_metrics

    def keep(metrics, *args, **kwargs):
        if "epoch loss" in metrics:
            jax_losses.append(float(metrics["epoch loss"]))
        return log_metrics(metrics, *args, **kwargs)

    monkeypatch.setattr(jax_loops.mlflow, "log_metrics", keep)
    monkeypatch.chdir(tmp_path)
    with same_scipy_fits():
        jax_cfg = jax_fitter._lineout_selection(_real_2v_deck(lr, epochs))
        jax_data, jax_sa, _ = jax_fitter.load_data_for_fitting(jax_cfg)
        cfg = fitter._lineout_selection(_real_2v_deck(lr, epochs))
        all_data, sa, _ = fitter.load_data_for_fitting(cfg)
    np.testing.assert_array_equal(all_data["e_data"], jax_data["e_data"])
    record = {}
    port.angular_optax(cfg, all_data, sa, device="cpu", dtype=torch.float64, record=record)
    jax_loops.angular_optax(jax_cfg, jax_data, jax_sa)
    losses = record["losses"]
    assert len(losses) == len(jax_losses) >= 6
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    if lr > 5e-3:
        assert losses[-1] > 2 * losses[0] and jax_losses[-1] > 2 * jax_losses[0]
    else:
        assert losses[-1] < losses[0] and jax_losses[-1] < jax_losses[0]


@pytest.mark.slow
def test_cli_arts_sigmas_within_the_jax_packages_own_spread(tmp_path, monkeypatch):
    """The sigmas of ``test_cli_arts_fit_matches_the_jax_fitter`` against the JAX package's own float64 spread:
    each within SPREAD_RATIO times the distance between the sigmas of JAX's two Hessian forms."""
    art, _, jax_art, _, stash = _both_fits(tmp_path, monkeypatch)
    sig, jax_sig = _sigmas(art, jax_art)
    spread = _jax_sigma_spread(stash)
    assert np.all(spread < 0.05 * np.abs(jax_sig))  # JAX's own forms agree to a few percent at worst
    # the spreads that the tier-1 test takes as given (JAX_SIGMA_SPREAD, three digits)
    np.testing.assert_allclose(spread[0] / np.abs(jax_sig[0]), list(JAX_SIGMA_SPREAD.values()), rtol=5e-3)
    assert np.all(np.abs(sig - jax_sig) <= SPREAD_RATIO * spread), (np.abs(sig - jax_sig) / spread)


@pytest.mark.slow
def test_angular_fit_end_to_end(tmp_path, monkeypatch):
    """``tests/test_inverse/test_angular_e2e.py`` on the port: the deck as written (npts 410, nvx 256), 8 adam
    epochs, a checkpoint every 4, sigmas."""
    defaults, inputs = _decks(epochs=8, small=False)
    inputs["optimizer"].update(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_freq=4)
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    mlflow.set_experiment("arts-e2e")
    with mlflow.start_run(run_name="arts_e2e"):
        fit_results, loss = fitter.fit(merge_configs(defaults, inputs), device="cpu")
    assert np.isfinite(loss)
    assert any(k.endswith("_general") or k.endswith("_electron") for k in fit_results)
    assert latest_epoch(tmp_path / "ckpt") is not None
    sig_files = glob.glob(str(tmp_path / "**" / "sigmas_fe.npz"), recursive=True)
    assert sig_files, "angular sigma artifact missing"
    sig = np.load(sig_files[0])["sigmas"]
    assert np.all(np.isfinite(sig)) and np.any(np.abs(sig) > 0)


def _synthetic_setup(decks, npts=256, **fe):
    cfg = set_forward_ranges(merge_configs(*[yaml.safe_load((CONFIGS / n).read_text()) for n in decks]))
    cfg["other"].update(npts=npts, CCDsize=[npts, npts])
    cfg["parameters"]["electron"]["fe"].update(fe)
    sas = port.get_scattering_angles(cfg)
    sas["angAxis"] = port.get_calibrations(104000, cfg["other"]["extraoptions"]["spectype"], 0.0, cfg["other"]["CCDsize"])[0]
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    batch = {"i_data": np.ones((npts, npts)), "e_data": np.ones((npts, npts)), "noise_e": np.array([0.0]),
             "noise_i": np.array([0.0]), "e_amps": np.array([1.0]), "i_amps": np.array([1.0])}
    return cfg, sas, batch


def _adam_steps(cfg, diag, batch, target, lr, steps, stop=None):
    """Adam on mean((ThryE - target)^2) from the deck's parameters, as the JAX tests step: (losses, parameters)."""
    params = port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu", batch=False)
    leaves = list(get_filter_spec(cfg["parameters"], params).values())
    opt, losses = optimizer("adam", leaves, lr), []
    for _ in range(steps):
        loss = torch.mean(torch.square(diag(params, batch)[0] - target))
        grads = torch.autograd.grad(loss, leaves)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        losses.append(float(loss))
        if stop is not None and losses[-1] < stop:
            break
    return losses, params


@pytest.mark.slow
def test_angular_1v_inverse():
    """``tests/test_inverse/test_angular_1v.py`` on the port: m and Te of a DLM EDF from a synthetic image."""
    cfg, sas, batch = _synthetic_setup(("arts1v_test_defaults.yaml", "arts1v_test_inputs.yaml"), nvx=128)
    rng = np.random.default_rng(42)
    diag = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")
    cfg["parameters"]["electron"]["fe"]["params"]["m"]["val"] = float(rng.uniform(2.2, 3.2))
    cfg["parameters"]["electron"]["Te"]["val"] = float(rng.uniform(0.6, 1.0))
    truth = port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu", batch=False)
    with torch.no_grad():
        target, fe_truth = diag(truth, batch)[0], truth()["electron"]["fe"]
    cfg["parameters"]["electron"]["fe"]["params"]["m"]["val"] = 2.0
    cfg["parameters"]["electron"]["Te"]["val"] = 0.8
    start = port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu", batch=False)
    l2_start = float(torch.sqrt(torch.mean((start()["electron"]["fe"] - fe_truth) ** 2)))
    losses, fitted = _adam_steps(cfg, diag, batch, target, 5e-3, 60, stop=5e-3)
    assert losses[-1] < 5e-2, losses[-1]
    l2_fit = float(torch.sqrt(torch.mean((fitted()["electron"]["fe"] - fe_truth) ** 2)))
    assert l2_fit < l2_start, (l2_fit, l2_start)


@pytest.mark.slow
@pytest.mark.parametrize("dist_type", ["arbitrary", "sphericalharmonic"])
def test_angular_2v_inverse(dist_type):
    """``tests/test_inverse/test_angular_2v.py`` on the port: the loss falls by a tenth for both 2D EDFs (the
    spherical-harmonic one at l = 1)."""
    params = dict(init_m=2.5, learn_log=True) | (dict(nvr=32, Nl=1, flm_type="arbitrary") if "sph" in dist_type else {})
    cfg, sas, batch = _synthetic_setup(("arts2v_test_defaults.yaml", "arts2d_test_inputs.yaml"), type=dist_type, dim=2,
                                       nvx=32, params=params)
    diag = port.ThomsonScatteringDiagnostic(cfg, sas, device="cpu")
    cfg["parameters"]["electron"]["fe"]["params"]["init_m"] = 3.0
    with torch.no_grad():
        target = diag(port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu", batch=False), batch)[0]
    assert torch.isfinite(target).all()
    cfg["parameters"]["electron"]["fe"]["params"]["init_m"] = 2.0
    lr, steps = (2e-3, 20) if dist_type == "arbitrary" else (3e-2, 45)
    losses, _ = _adam_steps(cfg, diag, batch, target, lr, steps)
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]
