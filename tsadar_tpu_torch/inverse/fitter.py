"""Fit set-up from a shot's data: the counterpart of ``tsadar_tpu.inverse.fitter``'s first stage.

``_lineout_selection`` expands the deck's lineout range into pixels, trimmed
to whole batches; ``load_data_for_fitting`` runs the data pipeline
(``utils.process.prepare.prepare_data``) for the deck's shot (a multiplexed
two-shot ARTS fit raises, as its loss does).  ``fit`` itself (the fit, then the sigma-Hessian
postprocess and the plots) is not ported yet (ROADMAP.md §1 items 10-11): a
1V fit is ``LossFunction`` + ``loops._1d_adam_loop_`` on the prepared batch.
"""

from ..utils.console import log_info
from ..utils.process import prepare


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
        raise NotImplementedError("the multiplexed two-shot angular fit is not ported yet (ROADMAP.md §1 item 12)")
    return prepare.prepare_data(config, shot)
