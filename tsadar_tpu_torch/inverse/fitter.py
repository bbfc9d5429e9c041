"""Fit orchestration: the counterpart of ``tsadar_tpu.inverse.fitter``.

``_lineout_selection`` expands the deck's lineout range into pixels, trimmed
to whole batches; ``load_data_for_fitting`` runs the data pipeline
(``utils.process.prepare.prepare_data``) for the deck's shot; ``fit`` runs the
angular loop (``loops.angular_optax``) for an ARTS deck and the batched 1D
loop (``loops.one_d_loop``: adam, the device L-BFGS, or scipy's minimizer as
the main deck asks) for the others, then the postprocess (refits, sigmas,
final parameters; ``utils.process.postprocess``, which also writes the run's
files).  Stage seconds and status tags go to the tracker
(``utils.mlflow_shim``) under the JAX package's names.

A list ``data.shotnum`` (the multiplexed two-shot ARTS fit) fails in the JAX
package: its ``prepare_data(config, shotNum)`` loads ``data.shotnum``, not its
argument, so ``loadData`` is handed the list and finds no data.  The port's
``load_data_for_fitting`` raises at that same point, with that reason
(ROADMAP.md §3).  ``prepare_multiplexed`` gives the data that the list arm
means to give, each shot prepared on its own; ``loops.angular_optax`` fits it.

In a process group (``parallel.dist``) every rank calls ``fit``: rank 0 alone
prepares the data and hands it, with the config as the pipeline leaves it, to
the others (two processes can prepare different data: scipy's streak-background
fit ends in either of two mirror solutions); every rank fits (the loops share
the work), and rank 0 alone runs the postprocess and writes the run's files, as
the JAX package's postprocess runs unsharded.
"""

import numpy as np

from ..parallel import dist as par
from ..utils import mlflow_shim as mlflow
from ..utils import trace
from ..utils.console import log_info
from ..utils.process import postprocess, prepare
from .loops import angular_optax, one_d_loop

MULTIPLEX_FAULT = (
    "a multiplexed deck (a list data.shotnum) cannot be fitted through fitter.fit: the JAX package's "
    "prepare_data(config, shotNum) loads data.shotnum, not shotNum (tsadar_tpu/utils/process/prepare.py:167-170), "
    "so loadData is handed the list and finds no data, and the port keeps that code as it is (ROADMAP.md §3); "
    "prepare the shots with fitter.prepare_multiplexed and fit them with loops.angular_optax"
)


def _lineout_selection(config):
    """Expand start/end/skip into the pixel list ``data.lineouts.val``, trimmed to a whole number of batches."""
    sel = config["data"]["lineouts"]
    pixels = list(range(sel["start"], sel["end"], sel["skip"]))
    batch_size = config["optimizer"]["batch_size"]
    remainder = len(pixels) % batch_size
    if remainder:
        log_info(
            f"batch size {batch_size} does not divide the {len(pixels)} requested "
            f"lineouts; dropping the final {remainder}"
        )
        pixels = pixels[:-remainder]
    sel["val"] = pixels
    return config


def load_data_for_fitting(config):
    """(prepared data, scattering angles, axes) of the deck's shot.  A list of two shots is the JAX package's
    multiplexed arm: only for ``angular_full``, and it fails where the JAX package's does (``MULTIPLEX_FAULT``)."""
    shot = config["data"]["shotnum"]
    if not isinstance(shot, list):
        return prepare.prepare_data(config, shot)
    if config["other"]["extraoptions"]["spectype"] != "angular_full":
        raise NotImplementedError("Multiplexed data fitting is only available for angular data")
    raise NotImplementedError(MULTIPLEX_FAULT)


def prepare_multiplexed(config):
    """The data of a multiplexed deck as the JAX package's list arm means it: the first shot of ``data.shotnum``
    prepared with ``data.shotnum`` set to it, ``other.CCDsize`` put back, the second prepared the same way, and
    its electron channels added as ``e_data_rot``, ``e_amps_rot`` and ``noiseE_rot`` with ``rot_angle``
    (``data.shot_rot``).  ``config`` is changed as ``prepare_data`` changes it and keeps its list."""
    shots, ccd_size = config["data"]["shotnum"], config["other"]["CCDsize"]
    try:
        config["data"]["shotnum"] = shots[0]
        all_data, sa, all_axes = prepare.prepare_data(config, shots[0])
        config["other"]["CCDsize"] = ccd_size  # prepare_data sets it to the image's; the second shot starts anew
        config["data"]["shotnum"] = shots[1]
        second, _, _ = prepare.prepare_data(config, shots[1])
    finally:
        config["data"]["shotnum"] = shots
    all_data["e_data_rot"] = second["e_data"]
    all_data["e_amps_rot"] = second["e_amps"]
    all_data["noiseE_rot"] = second["noiseE"]
    all_data["rot_angle"] = config["data"]["shot_rot"]
    return all_data, sa, all_axes


def fit(config, device=None, record=None):
    """Fit the deck's lineouts of its shot, or its ARTS image: ``(final parameters, total loss)``.

    The fit runs on the card unless ``device="cpu"`` is given; the sigma-Hessian
    of the postprocess runs on the CPU in float64 either way.  The final
    parameters are ``utils.artifacts.get_final_params``'s dict of numpy arrays (with
    ``"sigmas"`` when ``other.calc_sigmas`` is on); on a rank other than 0 of a
    process group, which runs no postprocess, they are None.  The stage seconds go to
    the tracker (``setup_time``, ``fit_time``, ``postprocess_time``, rounded to
    0.01 s as the JAX package logs them, with ``overall loss`` and the status
    tags ``preprocessing``, ``minimizing``, ``postprocessing``) and, with
    ``record`` (a dict), unrounded into it (``setup_seconds``,
    ``fit_seconds``, ``postprocess_seconds``) beside the loop's own record
    (``scipy``: scipy's results per batch; ``lbfgs``: the device L-BFGS's
    values, evaluations and step sizes per step; ``adam``: the adam loop's
    losses and chunks; ``angular``: the angular
    loop's losses and chunks) and the postprocess's own entries.  ``config``
    is changed as the JAX package changes it (the lineout pixels, the
    quantities the data pipeline derives).
    """
    record = {} if record is None else record

    with trace.timed("stage.prepare") as stage:
        mlflow.set_tag("status", "preprocessing")
        config = _lineout_selection(config)
        all_data, sa, all_axes = _prepared(config)
        n_samples = max(len(all_data["e_data"]), len(all_data["i_data"]))
        sample_indices = np.arange(n_samples)
        num_batches = n_samples // config["optimizer"]["batch_size"] or 1
    record["setup_seconds"] = stage.seconds
    mlflow.log_metrics({"setup_time": round(record["setup_seconds"], 2)})
    log_info(f"setup: {record['setup_seconds']:.2f} s")

    with trace.timed("stage.fit") as stage:
        mlflow.set_tag("status", "minimizing")
        log_info("minimizing")
        if "angular" in config["other"]["extraoptions"]["spectype"]:
            fitted_weights, overall_loss, loss_fn = angular_optax(config, all_data, sa, device=device,
                                                                  record=record.setdefault("angular", {}))
        else:
            method = config["optimizer"]["method"]
            loop_record = record.setdefault(method if method in ("adam", "lbfgs") else "scipy", {})
            fitted_weights, overall_loss, loss_fn = one_d_loop(
                config, all_data, sa, sample_indices, num_batches, device=device, record=loop_record
            )
    record["fit_seconds"] = stage.seconds
    mlflow.log_metrics({"overall loss": float(overall_loss)})
    mlflow.log_metrics({"fit_time": round(record["fit_seconds"], 2)})
    log_info(f"fit: {record['fit_seconds']:.2f} s, overall loss {float(overall_loss):.6g}")

    if not mlflow.writer():  # the postprocess writes the run's files: rank 0's
        return None, float(overall_loss)
    with trace.timed("stage.postprocess") as stage:
        mlflow.set_tag("status", "postprocessing")
        log_info("postprocessing")
        with par.local():
            final_params = postprocess.postprocess(config, sample_indices, all_data, all_axes, loss_fn, sa, fitted_weights,
                                                   record)
    record["postprocess_seconds"] = stage.seconds
    mlflow.log_metrics({"postprocess_time": round(record["postprocess_seconds"], 2)})
    log_info(f"postprocess: {record['postprocess_seconds']:.2f} s")
    return final_params, float(overall_loss)


def _prepared(config):
    """``load_data_for_fitting(config)``; in a process group rank 0's, handed to every rank with the config as
    the pipeline changed it (``config`` is updated in place on every rank)."""
    if not par.initialized():
        return load_data_for_fitting(config)
    prepared = (config, load_data_for_fitting(config)) if par.rank() == 0 else None
    changed, prepared = par.broadcast_object(prepared)
    if par.rank() != 0:
        config.clear()
        config.update(changed)
    return prepared
