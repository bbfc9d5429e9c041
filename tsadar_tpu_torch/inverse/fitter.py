"""Fit orchestration: the counterpart of ``tsadar_tpu.inverse.fitter`` for the 1D spectypes.

``_lineout_selection`` expands the deck's lineout range into pixels, trimmed
to whole batches; ``load_data_for_fitting`` runs the data pipeline
(``utils.process.prepare.prepare_data``) for the deck's shot (a multiplexed
two-shot ARTS fit raises, as its loss does); ``fit`` runs the batched 1D loop
(``loops.one_d_loop``: adam, or scipy's minimizer as the main deck asks) and
the postprocess (refits, sigmas, final parameters;
``utils.process.postprocess``, which also writes the run's files).  Stage
seconds and status tags go to the tracker (``utils.mlflow_shim``) under the
JAX package's names.  The angular fit's postprocess is not ported yet
(ROADMAP.md §1 item 7), so ``fit`` takes the 1D spectypes only: for an ARTS
image use ``loops.angular_optax``.
"""

import time

import numpy as np

from ..utils import mlflow_shim as mlflow
from ..utils.console import log_info
from ..utils.process import postprocess, prepare
from .loops import one_d_loop


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
    """(prepared data, scattering angles, axes) of the deck's shot."""
    shot = config["data"]["shotnum"]
    if isinstance(shot, list):
        raise NotImplementedError("the multiplexed two-shot angular fit is not ported yet (ROADMAP.md §1 item 7)")
    return prepare.prepare_data(config, shot)


def fit(config, device=None, record=None):
    """Fit the deck's lineouts of its shot: ``(final parameters, total loss)``.

    The fit runs on the card unless ``device="cpu"`` is given; the sigma-Hessian
    of the postprocess runs on the CPU in float64 either way.  The final
    parameters are ``utils.artifacts.get_final_params``'s dict of numpy arrays (with
    ``"sigmas"`` when ``other.calc_sigmas`` is on).  The stage seconds go to
    the tracker (``setup_time``, ``fit_time``, ``postprocess_time``, rounded to
    0.01 s as the JAX package logs them, with ``overall loss`` and the status
    tags ``preprocessing``, ``minimizing``, ``postprocessing``) and, with
    ``record`` (a dict), unrounded into it (``setup_seconds``,
    ``fit_seconds``, ``postprocess_seconds``) beside the loop's own record
    (``scipy``: scipy's results per batch; ``lbfgs``: the device L-BFGS's
    values, evaluations and step sizes per step) and the postprocess's own
    entries.  ``config``
    is changed as the JAX package changes it (the lineout pixels, the
    quantities the data pipeline derives).
    """
    postprocess.refuse_unported(config)  # the angular spectypes
    record = {} if record is None else record

    stage_start = time.perf_counter()
    mlflow.set_tag("status", "preprocessing")
    config = _lineout_selection(config)
    all_data, sa, all_axes = load_data_for_fitting(config)
    n_samples = max(len(all_data["e_data"]), len(all_data["i_data"]))
    sample_indices = np.arange(n_samples)
    num_batches = n_samples // config["optimizer"]["batch_size"] or 1
    record["setup_seconds"] = time.perf_counter() - stage_start
    mlflow.log_metrics({"setup_time": round(record["setup_seconds"], 2)})
    log_info(f"setup: {record['setup_seconds']:.2f} s")

    stage_start = time.perf_counter()
    mlflow.set_tag("status", "minimizing")
    log_info("minimizing")
    loop_record = record.setdefault("lbfgs" if config["optimizer"]["method"] == "lbfgs" else "scipy", {})
    fitted_weights, overall_loss, loss_fn = one_d_loop(
        config, all_data, sa, sample_indices, num_batches, device=device, record=loop_record
    )
    record["fit_seconds"] = time.perf_counter() - stage_start
    mlflow.log_metrics({"overall loss": float(overall_loss)})
    mlflow.log_metrics({"fit_time": round(record["fit_seconds"], 2)})
    log_info(f"fit: {record['fit_seconds']:.2f} s, overall loss {float(overall_loss):.6g}")

    stage_start = time.perf_counter()
    mlflow.set_tag("status", "postprocessing")
    log_info("postprocessing")
    final_params = postprocess.postprocess(config, sample_indices, all_data, all_axes, loss_fn, sa, fitted_weights, record)
    record["postprocess_seconds"] = time.perf_counter() - stage_start
    mlflow.log_metrics({"postprocess_time": round(record["postprocess_seconds"], 2)})
    log_info(f"postprocess: {record['postprocess_seconds']:.2f} s")
    return final_params, float(overall_loss)
