"""Postprocess of a fit: refits of bad lineouts, the sigma-Hessian, the final parameters, the run's files.

Counterpart of ``tsadar_tpu.utils.process.postprocess``:

* ``recalculate_with_chosen_weights``: the per-lineout loss, squared deviations
  and fitted spectra of every batch from its fitted parameters
  (``LossFunction.array_loss``, on the fit's device), optionally the sigmas,
  and with ``plotting.detailed_breakdown`` the breakdown of each batch
  (``ThomsonScatteringDiagnostic.spectrum_breakdown``: the component spectra,
  the instrument response alone and the model's own wavelength axes, in
  ``fits[feature]["spec_comps" | "IRF" | "detailed_axis"]``);
* ``batch_flat_hessian``: the Hessian of the sigma loss over the flat active
  parameters, in the JAX package's ``p * B + i`` layout.  The 1D loss is a sum
  over lineouts and every active leaf is per lineout, so the Hessian is block
  diagonal and one Hessian-vector product with the tangent e_p (x) 1_B gives
  row p of every lineout's block: n_active products, in chunks of 16 lineouts
  where the batch divides so; the dense form under ``force_dense`` or where a
  leaf is not [B].  It runs as the JAX package's does: on the CPU in float64,
  through the plain forms (``interp.plain_forms()``, the counterpart of
  ``pallas_disabled``), whichever device the fit ran on.  The kernels are
  float32 and their ``autograd.Function``s have no second derivative; the
  sigma loss weighs pixels by 1 / (|data| + 1e-10), whose products overflow
  float32.  The JAX package takes forward over reverse, the port reverse over
  reverse (``LossFunction.hvp_rows``): the same symmetric matrix;
* ``get_sigmas``: each lineout's block inverted, sigma = sign(diag) sqrt|diag|;
* ``refit_bad_fits``: lineouts whose loss exceeds ``other.refit_thresh`` are
  fitted again alone (batch size 1), warm-started from the previous lineout's
  fitted values, and a better refit is written into the lineout's own
  (batch, slot) -- the JAX package's correction of upstream's (i - 1) // bs;
* the angular (``angular_full``) arm of ``recalculate_with_chosen_weights``:
  the image's lineout window with the one set of fitted parameters, and with
  sigmas the dense Hessian of the unbatched parameters (on the CPU in
  float64, as above), skipped with the JAX package's log line where the
  active parameters exceed 2048 (a pointwise 2D EDF);
* ``process_angular_data``: the recalculation, the final parameters, and the
  angular files (the image and its fit, the sigmas of the fit as
  ``sigmas_fe``, the EDF); an angular fit has no refits;
* ``postprocess`` and ``process_data``: the refits, then the recalculation,
  the final parameters, and the run's files (``utils.artifacts``: the CSVs of
  the fitted parameters and the sigmas, the data and fits as ``.npz`` and
  ``.nc``; ``utils.plotting.plotters``: the figures, in ``plots/``), written
  in the JAX package's order into a temporary directory with ``plots/``,
  ``csv/`` and ``binary/`` and logged to the tracker (``utils.mlflow_shim``)
  with the JAX package's metric names and status tags: ``number of fits``,
  ``number of refits``, ``refitting time``, ``recalc_arrayloss_time``,
  ``recalc_hessian_time``, ``postprocessing time`` (refits and
  recalculation, the Hessian inside it), ``plotting time`` (the writing of
  the files and the figures) and the tags ``plotting`` and ``done plotting``.

The figures are drawn where ``utils.plotting.figures()`` says so: a run is
open and matplotlib imports (the card's machine has none; the run's tag
``figures`` then says why, and every other file is written as before).
Timings, and the fitted spectra with their breakdown, also go into an
optional ``record`` dict, unrounded.  Where the JAX package logs a breakdown
that fails and goes on, the port lets the failure stand; a figure that fails
raises, as in the JAX package.
"""

import copy
import os
import tempfile

import numpy as np
import torch

from ...core.params.ts_params import ThomsonParams, get_filter_spec, ravel_order
from ...core.physics.interp import plain_forms
from .. import artifacts
from .. import mlflow_shim as mlflow
from .. import plotting, trace
from ..config import flatten, unflatten
from ..console import log_info
from ..plotting import plotters
from .batches import angular_batch, to_numpy


def _rows(all_data, inds):
    """The loss's batch of the lineouts ``inds`` from the prepared data."""
    return {
        "e_data": all_data["e_data"][inds],
        "e_amps": all_data["e_amps"][inds],
        "i_data": all_data["i_data"][inds],
        "i_amps": all_data["i_amps"][inds],
        "noise_e": all_data["noiseE"][inds],
        "noise_i": all_data["noiseI"][inds],
    }


def _assign(dst, inds, val):
    """Place a batch's rows; unloaded species carry placeholder zeros whose shapes do not match the grid."""
    val = np.atleast_2d(to_numpy(val))
    tgt = dst[inds].shape
    if val.shape == (1, tgt[0]) and tgt[1] != tgt[0]:
        val = val.T
    if val.shape == tgt:
        dst[inds] = val
    elif val.shape[0] == tgt[0] and val.shape[1] >= tgt[1]:
        dst[inds] = val[:, : tgt[1]]
    else:
        dst[inds] = np.broadcast_to(val, tgt)


def recalculate_with_chosen_weights(config, sa, sample_indices, all_data, loss_fn, calc_sigma, fitted_weights, record=None):
    """(losses, sqdevs, num_params, fits, sigmas, all_params) of the fitted batches; sigmas when ``calc_sigma``.

    A Hessian that fails is logged and the sigmas are left at zero, as in the
    JAX package.  ``record`` gets ``recalc_arrayloss_seconds`` and
    ``recalc_hessian_seconds``, and the failure's message as ``sigma_error``.
    For ``angular_full``, ``fitted_weights`` is one unbatched set, ``fits["ele"]``
    and ``sqdevs["ele"]`` the window's arrays, and the parameters are not
    joined across batches (there is one), as in the JAX package.
    """
    angular = config["other"]["extraoptions"]["spectype"] == "angular_full"
    losses = np.zeros_like(sample_indices, dtype=np.float64)
    sample_indices.sort()
    batch_indices = np.reshape(sample_indices, (-1, config["optimizer"]["batch_size"]))

    all_params = {k: {} for k in config["parameters"]}
    num_params = 0
    for weights in fitted_weights:
        fitted, num_params = weights.get_fitted_params(config["parameters"])
        for group, values in fitted.items():
            for name, value in values.items():
                all_params[group].setdefault(name, []).append(to_numpy(value))
    for group in all_params:
        for name in all_params[group]:
            if not angular:
                all_params[group][name] = np.concatenate([np.atleast_1d(a) for a in all_params[group][name]])

    def grid_shape(arr):
        a = np.asarray(arr)
        return a.shape if a.ndim == 2 else (len(sample_indices), 1)

    e_shape, i_shape = grid_shape(all_data["e_data"]), grid_shape(all_data["i_data"])
    fits = {"ele": {"total_spec": np.zeros(e_shape)}, "ion": {"total_spec": np.zeros(i_shape)}}
    sqdevs = {"ion": np.zeros(i_shape), "ele": np.zeros(e_shape)}
    sigmas = np.zeros((len(sample_indices), max(num_params, 1)))

    arrayloss_s = hessian_s = 0.0

    def sigmas_of(weights, batch, n, max_params=None, what="Hessian"):
        """The sigmas of one batch, or None where the Hessian fails (logged, as in the JAX package)."""
        nonlocal hessian_s
        with trace.timed("postprocess.hessian") as hessian:
            try:
                return get_sigmas(batch_flat_hessian(config, loss_fn, weights, batch, max_params=max_params), n)
            except Exception as e:  # noqa: BLE001  the JAX package's behaviour: no sigmas, the fit stands
                log_info(f"Error calculating {what} ({e}); skipping uncertainties")
                if record is not None:
                    record["sigma_error"] = str(e)
                return None
            finally:
                hessian_s += hessian.seconds

    if angular:
        batch = angular_batch(all_data, slice(config["data"]["lineouts"]["start"], config["data"]["lineouts"]["end"]))
        with trace.timed("postprocess.arrayloss") as arrayloss:
            loss, sqds, ThryE, _, _ = loss_fn.array_loss(fitted_weights[0], batch)
            fits["ele"], sqdevs["ele"], losses = to_numpy(ThryE), to_numpy(sqds["ele"]), to_numpy(loss)
        arrayloss_s += arrayloss.seconds
        if calc_sigma:
            # a pointwise 2D EDF's nvx^2 weights exceed the budget: skipped, as in the JAX package
            angular_sigmas = sigmas_of(fitted_weights[0], batch, 1, max_params=2048, what="angular Hessian")
            sigmas = sigmas if angular_sigmas is None else angular_sigmas
    else:
        for i_batch, inds in enumerate(batch_indices):
            batch = _rows(all_data, inds)
            with trace.timed("postprocess.arrayloss") as arrayloss:
                loss, sqds, ThryE, ThryI, _ = loss_fn.array_loss(fitted_weights[i_batch], batch)
                losses[inds] = to_numpy(loss)
            arrayloss_s += arrayloss.seconds
            _assign(sqdevs["ele"], inds, sqds["ele"])
            _assign(sqdevs["ion"], inds, sqds["ion"])
            _assign(fits["ele"]["total_spec"], inds, ThryE)
            _assign(fits["ion"]["total_spec"], inds, ThryI)
            if config.get("plotting", {}).get("detailed_breakdown", False):
                _breakdown(fits, loss_fn.ts_diag.spectrum_breakdown(fitted_weights[i_batch], batch), inds, e_shape, i_shape)
            if calc_sigma:
                batch_sigmas = sigmas_of(fitted_weights[i_batch], batch, config["optimizer"]["batch_size"])
                if batch_sigmas is None:
                    calc_sigma = False
                else:
                    sigmas[inds] = batch_sigmas
    mlflow.log_metrics({"recalc_arrayloss_time": round(arrayloss_s, 2), "recalc_hessian_time": round(hessian_s, 2)})
    if record is not None:
        record["recalc_arrayloss_seconds"] = record.get("recalc_arrayloss_seconds", 0.0) + arrayloss_s
        record["recalc_hessian_seconds"] = record.get("recalc_hessian_seconds", 0.0) + hessian_s
    return losses, sqdevs, num_params, fits, sigmas, all_params


def _breakdown(fits, breakdown, inds, e_shape, i_shape):
    """File one batch's ``spectrum_breakdown`` into ``fits`` as the JAX package does: the component stacks and
    the raw axes by the batch's lineouts, the instrument-only spectra by row."""
    _, _, ThryE, ThryI, eIRF, iIRF, _, _, lamE_raw, lamI_raw = breakdown
    for feature, comps, irf, shape, axis in (("ele", ThryE, eIRF, e_shape, lamE_raw), ("ion", ThryI, iIRF, i_shape, lamI_raw)):
        fits[feature].setdefault("spec_comps", {})[tuple(inds)] = to_numpy(comps)
        _assign(fits[feature].setdefault("IRF", np.zeros(shape)), inds, irf)
        fits[feature].setdefault("detailed_axis", {})[tuple(inds)] = np.squeeze(to_numpy(axis))


def _lineout_slice(tree, sl, B):
    """Every entry whose leading axis is the lineout batch, cut to ``sl`` (the JAX package's shape-keyed rule)."""
    return {k: v[sl] if np.ndim(v) >= 1 and np.shape(v)[0] == B else v for k, v in tree.items()}


def _chunk_params(config, weights, sl, B):
    """The parameters of the lineouts ``sl`` as a ThomsonParams of their own (CPU, float64)."""
    chunk = ThomsonParams.create(config["parameters"], sl.stop - sl.start, activate=True, device="cpu", dtype=torch.float64)
    chunk.load_state_dict(_lineout_slice(weights.state_dict(), sl, B))
    return chunk


def batch_flat_hessian(config, loss_fn, weights, batch, max_params=None, force_dense=False):
    """[P, P] Hessian of the sigma loss over the flat active parameters, P = n_active x B, entry p * B + i.

    Runs on the CPU in float64 through the plain forms whatever the fit's
    device (module docstring).  Raises ValueError if ``max_params`` is given
    and P exceeds it.
    """
    weights64 = copy.deepcopy(weights).to(device="cpu", dtype=torch.float64)
    batch64 = {k: np.asarray(to_numpy(v), dtype=np.float64) for k, v in batch.items()}
    trainable = get_filter_spec(config["parameters"], weights64)
    leaves = [trainable[k] for k in ravel_order(trainable)]
    P = sum(p.numel() for p in leaves)
    if max_params is not None and P > max_params:
        raise ValueError(f"{P} active parameters exceed the hessian budget ({max_params})")
    host = loss_fn.host_f64()
    B = batch64["e_data"].shape[0] if batch64["e_data"].ndim > 1 else 1
    with plain_forms():
        if force_dense or B == 1 or any(tuple(p.shape) != (B,) for p in leaves):
            return host.h_loss_wrt_params(weights64, batch64)
        n_active = P // B
        CH = 16 if (B > 16 and B % 16 == 0) else B
        basis = np.zeros((n_active, n_active * CH))
        for p in range(n_active):
            basis[p, p * CH : (p + 1) * CH] = 1.0
        H = np.zeros((P, P))
        for s in range(B // CH):
            sl = slice(s * CH, (s + 1) * CH)
            chunk = weights64 if CH == B else _chunk_params(config, weights64, sl, B)
            rows = host.hvp_rows(chunk, _lineout_slice(batch64, sl, B), basis).cpu().numpy()
            # rows[p, q * CH + i] = d2 L / dx[p, i] dx[q, i]
            blocks = np.transpose(rows.reshape(n_active, n_active, CH), (2, 0, 1))
            for i in range(CH):
                idx = np.arange(n_active) * B + (s * CH + i)
                H[np.ix_(idx, idx)] = blocks[i]
        return H


def get_sigmas(hess, batch_size):
    """[B, P] sigmas: each lineout's P x P block (entries p * B + i) inverted, sign(diag) sqrt(|diag|); a
    negative sigma marks a point that is not a minimum."""
    P = hess.shape[0] // batch_size
    sigmas = np.zeros((batch_size, P))
    for i in range(batch_size):
        idx = np.arange(P) * batch_size + i
        inv = np.linalg.inv(hess[np.ix_(idx, idx)])
        sigmas[i, :] = np.sign(np.diag(inv)) * np.sqrt(np.abs(np.diag(inv)))
    return sigmas


def refit_bad_fits(config, sa, batch_indices, all_data, loss_fn, fitted_weights, record=None):
    """Fit again, alone, each lineout whose loss exceeds ``other.refit_thresh`` (but lineout 0), warm-started
    from the previous lineout's fitted values; a better refit goes into the lineout's own (batch, slot) of
    ``fitted_weights``.  Returns the losses before the refits.  ``record`` gets ``refits``: per refit, the
    lineout, its (batch, slot), the losses before and after and whether it was written."""
    from ...inverse import loops

    losses_init = recalculate_with_chosen_weights(config, sa, batch_indices, all_data, loss_fn, False, fitted_weights)[0]
    bs = config["optimizer"]["batch_size"]
    bad = batch_indices.flatten()[losses_init > config["other"]["refit_thresh"]]
    log_info(f"{len(batch_indices.flatten())} fits, {len(bad)} refits")
    mlflow.log_metrics({"number of fits": len(batch_indices.flatten())})
    mlflow.log_metrics({"number of refits": len(bad)})
    dev, dtype = loss_fn.ts_diag.device, loss_fn.ts_diag.dtype
    for i in bad:
        if i == 0:
            continue
        temp_cfg = copy.deepcopy(config)
        temp_cfg["optimizer"]["batch_size"] = 1
        j = (i - 1) % bs
        prev_vals = {}
        for group, values in fitted_weights[(i - 1) // bs].get_unnormed_params().items():
            prev_vals[group] = {}
            for name, v in values.items():
                if name in ("f", "fe", "flm"):
                    continue
                arr = to_numpy(v).reshape(-1)
                val = {"val": float(arr[j] if arr.size > 1 else arr[0])}
                if name == "m":
                    prev_vals[group]["fe"] = {"params": {"m": val}}
                else:
                    prev_vals[group][name] = val
        temp_params = flatten(temp_cfg["parameters"])
        temp_params.update(flatten(prev_vals))
        temp_cfg["parameters"] = unflatten(temp_params)

        new_weights, _, refit_loss_fn = loops.one_d_loop(temp_cfg, all_data, sa, np.array([i]), 1, device=dev, dtype=dtype,
                                                         record=record.setdefault("refit_scipy", {}) if record is not None else None)
        loss = float(to_numpy(refit_loss_fn.array_loss(new_weights[0], _rows(all_data, np.array([i])))[0]).sum())
        ib, slot = i // bs, i % bs
        written = loss < losses_init[i]
        if written:
            _write_slot(fitted_weights[ib], new_weights[0], slot, bs)
        if record is not None:
            record.setdefault("refits", []).append({"lineout": int(i), "batch": int(ib), "slot": int(slot),
                                                   "loss_before": float(losses_init[i]), "loss_after": loss, "written": bool(written)})
    return losses_init


def _write_slot(tgt, src, slot, bs):
    """Write a one-lineout fit ``src`` into lineout ``slot`` of the batch parameters ``tgt``: every state entry
    whose leading axis is the batch (the JAX package's shape-keyed rule)."""
    with torch.no_grad():
        for (name, x), y in zip(tgt.state_dict().items(), src.state_dict().values()):
            if x.dim() >= 1 and x.shape[0] == bs:
                x[slot].copy_(y.reshape(-1)[0] if x.dim() == 1 else y.reshape(x.shape[1:]))


def postprocess(config, sample_indices, all_data, all_axes, loss_fn, sa, fitted_weights, record=None):
    """The refits (``other.refit``), then ``process_data``: the final parameters
    (``utils.artifacts.get_final_params``), with the run's files and figures written into a temporary directory
    and logged as the run's artifacts; for ``angular_full`` no refits, and ``process_angular_data``.  Outside a run the
    tracker would drop them: no file is written."""
    angular = config["other"]["extraoptions"]["spectype"] == "angular_full"
    with trace.timed("postprocess.refit") as refit:
        init_losses = []
        if not angular and config["other"]["refit"]:
            init_losses = refit_bad_fits(config, sa, sample_indices, all_data, loss_fn, fitted_weights, record)
    mlflow.log_metrics({"refitting time": round(refit.seconds, 2)})
    if record is not None:
        record["refit_seconds"] = refit.seconds

    def process(td):
        if angular:
            return process_angular_data(config, sample_indices, all_data, all_axes, loss_fn, fitted_weights, sa,
                                        refit.seconds, td, record)
        return process_data(config, sample_indices, all_data, all_axes, loss_fn, fitted_weights, sa, init_losses,
                            refit.seconds, td, record)

    if mlflow.active_run() is None:
        files, final_params = process(None)
        writing_seconds = files.seconds
    else:
        with tempfile.TemporaryDirectory() as td:
            for dirname in ("plots", "binary", "csv") if plotting.figures() else ("binary", "csv"):
                os.makedirs(os.path.join(td, dirname), exist_ok=True)
            files, final_params = process(td)
            with trace.timed("files.log") as logged:
                mlflow.log_artifacts(td)
        writing_seconds = files.seconds + logged.seconds
    mlflow.log_metrics({"plotting time": round(writing_seconds, 2)})
    mlflow.set_tag("status", "done plotting")
    if record is not None:
        record["artifact_seconds"] = writing_seconds
    return final_params


def process_data(config, sample_indices, all_data, all_axes, loss_fn, fitted_weights, sa, losses_init, t1, td, record=None):
    """The recalculation with sigmas (``other.calc_sigmas``), the final parameters and, unless ``td`` is None,
    the files of ``utils.artifacts`` and the figures of ``utils.plotting.plotters`` (where
    ``utils.plotting.figures()`` says so) in ``td``: ``(the span of the files' writing, final parameters)``.  ``t1`` is
    the postprocess's seconds before this call (its refits'): ``postprocessing time`` counts them with the
    recalculation's.  ``record`` gets the losses before and after the refits, the fitted spectra (``fits``, with the
    breakdown when asked for) and the seconds of the recalculation."""
    with trace.timed("postprocess.recalculate") as recalc:
        losses, sqdevs, _, fits, sigmas, all_params = recalculate_with_chosen_weights(
            config, sa, sample_indices, all_data, loss_fn, config["other"]["calc_sigmas"], fitted_weights, record
        )
    if len(losses_init) == 0:
        losses_init = losses
    mlflow.log_metrics({"postprocessing time": round(t1 + recalc.seconds, 2)})
    mlflow.set_tag("status", "plotting")
    if record is not None:
        record.update(losses_init=np.asarray(losses_init), losses=losses, fits=fits,
                      postprocessing_seconds=recalc.seconds)
    with trace.timed("files") as files:
        names = sigma_names(config, fitted_weights[0])
        final_params = artifacts.get_final_params(config, all_params, all_axes, td)
        if td is not None:  # the files and figures in the JAX package's order
            draw = plotting.figures()
            red_losses = plotters.plot_loss_hist(config, losses_init, losses, 1.0, td) if draw else None
            artifacts.plot_ts_data(config, fits, all_data, all_axes, td)
            if draw:
                plotters.plot_ts_data(config, fits, all_data, all_axes, td)
                plotters.detailed_lineouts(config, all_data, all_axes, fits, losses, red_losses, sqdevs, td)
            sigma_ds = artifacts.save_sigmas_params(config, names, sigmas, all_axes, td)
            if draw:
                plotters.plot_final_params(config, all_params, sigma_ds, td)
        if config["other"]["calc_sigmas"]:
            final_params["sigmas"] = dict(zip(names, sigmas.T))
    return files, final_params


def process_angular_data(config, sample_indices, all_data, all_axes, loss_fn, fitted_weights, sa, t1, td, record=None):
    """``process_data`` of an ARTS fit (one unbatched set of parameters, ``fitted_weights``): the recalculation with
    sigmas (``other.calc_sigmas``), the final parameters and, unless ``td`` is None, the angular files of
    ``utils.artifacts`` (the image and its fit, the sigmas as ``sigmas_fe`` and the EDF) and their figures.  Returns ``(the span of
    the files' writing, final parameters)``; ``t1`` and ``record`` as in ``process_data``."""
    with trace.timed("postprocess.recalculate") as recalc:
        losses, sqdevs, num_params, fits, sigmas, all_params = recalculate_with_chosen_weights(
            config, sa, sample_indices, all_data, loss_fn, config["other"]["calc_sigmas"], [fitted_weights], record
        )
    mlflow.log_metrics({"postprocessing time": round(t1 + recalc.seconds, 2)})
    mlflow.set_tag("status", "plotting")
    if record is not None:
        record.update(losses=losses, fits=fits, sigmas=sigmas, postprocessing_seconds=recalc.seconds)
    with trace.timed("files") as files:
        final_params = artifacts.get_final_params(config, all_params, all_axes, td)
        if td is not None:  # the files and figures in the JAX package's order
            draw = plotting.figures()
            savedata = artifacts.plot_data_angular(config, fits, all_data, all_axes, td)
            if draw:
                plotters.plot_data_angular(config, fits, all_data, all_axes, td)
                plotters.plot_ang_lineouts(num_params, sqdevs, losses, all_params, all_axes, savedata, td)
            if config["other"]["calc_sigmas"]:
                artifacts.save_sigmas_fe(final_params, None, sigmas, td)
            artifacts.save_dist(final_params, td)
            if draw:
                plotters.plot_dist(config, "electron", final_params, None, td)
        if config["other"]["calc_sigmas"]:
            final_params["sigmas"] = dict(zip(sigma_names(config, fitted_weights), sigmas.T))
    return files, final_params


def sigma_names(config, weights):
    """The name of each sigma column, ``"{species}.{parameter}"`` as the JAX package's ``save_sigmas_params``
    writes them, taken from the active leaf in the column's place in the ravel order (the Hessian's)."""
    names = []
    for path in ravel_order(get_filter_spec(config["parameters"], weights)):
        parts = path.replace("[", ".").replace("]", "").replace("'", "").strip(".").split(".")
        group = f"ion-{int(parts[1]) + 1}" if parts[0] == "ions" else parts[0]
        names.append(f"{group}.{'m' if parts[-1] == 'normed_m' else parts[-1]}")
    return names
