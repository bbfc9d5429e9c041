"""Data preparation orchestration: load -> calibrate -> correct -> lineouts.

A copy of ``tsadar_tpu.utils.process.prepare``: load the shot, calibrate axes,
throughput-correct, build the shot background, then either extract lineouts
(1D fits) or block-average the full ARTS image down to resolution units
(angular_full fits). Mutates ``config`` with the derived quantities the fit
stage reads back (IRF widths, wavelength ranges, npts, lineout pixels).

With ``feature_detector.estimate_lineouts_iaw`` and/or ``_epw`` the lineout
range and the fit windows come from the frames (``feature_detector``, which
reproduces the JAX package's OpenCV detector in numpy and scipy); otherwise
the lineout pixels come from ``data.lineouts.val``
(``inverse.fitter._lineout_selection``).  With ``data.launch_data_visualizer``
the raw frames are drawn with their fit windows and lineouts
(``utils.data_handling.data_visualizer``) after the lineouts, as the JAX
package draws them, where ``utils.plotting.figures()`` says so (a run is
open and matplotlib imports; else the run's ``figures`` tag says why).
"""

import os
from typing import Dict

import numpy as np

from ..data_handling.load_ts_data import loadData
from ..calibration import get_calibrations, get_scattering_angles
from .correct_throughput import correctThroughput
from .evaluate_background import get_shot_bg
from .lineouts import get_lineouts
from ..console import log_info

# CCD counts of 0 break log/variance-weighted losses downstream; offset all
# corrected images by a fraction of a count.
_ZERO_COUNT_OFFSET = 0.1


def _custom_data_dir(data_cfg):
    """Directory holding user-supplied shot files, if the deck names any.

    When both channels name files, the iaw entry's directory wins (upstream
    tsadar's sequential assignment — last writer wins); in practice
    run_for_app stages both files in the same artifacts directory.
    """
    names = data_cfg.get("filenames") or {}
    custom = None
    for channel in ("epw", "iaw"):
        if names.get(channel) is not None:
            custom = os.path.dirname(names[f"{channel}-local"])
    return custom


def _block_means_1d(vec, width):
    """Means of consecutive blocks (last block may be ragged)."""
    starts = np.arange(0, len(vec), width)
    counts = np.diff(np.append(starts, len(vec)))
    return np.add.reduceat(np.asarray(vec, float), starts) / counts


def _block_means_2d(image, row_width, col_width):
    """Block-average an image to resolution units: [n_row_blocks, n_col_blocks]."""
    image = np.asarray(image, float)
    row_starts = np.arange(0, image.shape[0], row_width)
    col_starts = np.arange(0, image.shape[1], col_width)
    row_counts = np.diff(np.append(row_starts, image.shape[0]))
    col_counts = np.diff(np.append(col_starts, image.shape[1]))
    summed = np.add.reduceat(np.add.reduceat(image, row_starts, axis=0), col_starts, axis=1)
    return summed / (row_counts[:, None] * col_counts[None, :])


def _axis_value(axis, index, what, buffer_key=None):
    """``axis[index]`` as numpy indexes it (a negative index counts from the end); an index outside the axis
    raises ``IndexError``, as the JAX package's indexing does, naming the detector's box (and ``buffer_key``'s
    buffer) as the cause."""
    if not -len(axis) <= index < len(axis):
        cause = (f"the box plus feature_detector.buffer.{buffer_key}" if buffer_key
                 else "the EPW box's start less the IAW box's")
        raise IndexError(f"the feature detector's {what} at pixel {index} ({cause}) runs past the "
                         f"{len(axis)}-pixel axis")
    return axis[index]


def _apply_feature_detector(config, elecData, ionData, all_axes):
    """The detector's lineout range and fit windows written into ``config`` as axis values, in the JAX package's
    three modes (IAW only, EPW only, both); returns the detected (start, end) pixels, or None with detection off."""
    fd = config.get("feature_detector", {"estimate_lineouts_iaw": False, "estimate_lineouts_epw": False})
    want_iaw, want_epw = fd["estimate_lineouts_iaw"], fd["estimate_lineouts_epw"]
    if not (want_iaw or want_epw):
        return None

    raise NotImplementedError("the reference copy has no feature detector: give the deck its lineouts and windows")
    fit_rng = config["data"]["fit_rng"]
    guess = None

    if want_iaw and want_epw:
        (end, start, iaw_cf_min, iaw_cf_max, iaw_max, iaw_min,
         ion_t0_shift, blue_min, blue_max, red_min, red_max) = guess
        config["data"]["ion_t0_shift"] = _axis_value(all_axes["iaw_x"], ion_t0_shift, "ion t0 shift")
        lineout_axis = all_axes["epw_x"]
    elif want_iaw:
        end, start, iaw_cf_min, iaw_cf_max, iaw_max, iaw_min = guess
        blue_min = blue_max = red_min = red_max = None
        lineout_axis = all_axes["iaw_x"]
    else:
        end, start, blue_min, blue_max, red_min, red_max = guess
        iaw_min = iaw_max = iaw_cf_min = iaw_cf_max = None
        lineout_axis = all_axes["epw_x"]

    config["data"]["lineouts"]["start"] = _axis_value(lineout_axis, start, "lineout start", "lineout_start")
    config["data"]["lineouts"]["end"] = _axis_value(lineout_axis, end, "lineout end", "lineout_end")
    if iaw_min is not None:
        iaw_y = all_axes["iaw_y"]
        fit_rng["iaw_min"] = _axis_value(iaw_y, iaw_min, "IAW window start", "spectral_start")
        fit_rng["iaw_max"] = _axis_value(iaw_y, iaw_max, "IAW window end", "spectral_end")
        fit_rng["iaw_cf_min"] = _axis_value(iaw_y, int(iaw_cf_min), "IAW central-feature start", "spectral_start")
        fit_rng["iaw_cf_max"] = _axis_value(iaw_y, int(iaw_cf_max), "IAW central-feature end", "spectral_end")
    if blue_min is not None:
        epw_y = all_axes["epw_y"]
        fit_rng["blue_min"] = _axis_value(epw_y, blue_min, "blue window start", "spectral_start")
        fit_rng["blue_max"] = _axis_value(epw_y, blue_max, "blue window end", "spectral_end")
        fit_rng["red_min"] = _axis_value(epw_y, red_min, "red window start", "spectral_start")
        fit_rng["red_max"] = _axis_value(epw_y, red_max, "red window end", "spectral_end")
    return int(start), int(end)


def _resolve_lineout_values(config, detected):
    """``lineouts.val`` from the detected pixels (``type: pixel``) or from the axis values the detector wrote
    (every other type), at the deck's skip."""
    lineouts = config["data"]["lineouts"]
    if detected is not None:
        if lineouts["type"] == "pixel":
            start, end = detected
        else:
            start, end = int(lineouts["start"]), int(lineouts["end"])
        lineouts["val"] = list(range(start, end, int(lineouts["skip"])))


def _trim_to_batch_multiple(config):
    """Drop trailing lineouts so the count divides the optimizer batch size."""
    values = config["data"]["lineouts"]["val"]
    remainder = len(values) % config["optimizer"]["batch_size"]
    if remainder:
        log_info(f"total slices: {len(values)}")
        log_info(
            f"batch size = {config['optimizer']['batch_size']} is not a round divisor of the number of lineouts"
        )
        log_info(f"final {remainder} lineouts have been removed")
        config["data"]["lineouts"]["val"] = values[:-remainder]


def _reduce_arts_image(config, elecData, BGele, axisxE, axisyE, sa, all_axes):
    """ARTS full-image fit: block-average data/background to resolution units."""
    config["other"]["extraoptions"]["spectype"] = "angular_full"
    sa["angAxis"] = axisxE

    n_lam = config["other"]["lam_res_unit"]
    n_ang = config["other"]["ang_res_unit"]
    bg = BGele if np.ndim(BGele) == 2 else np.zeros_like(elecData)

    # [n_lam_units, n_ang_units] -> transpose to [angle, wavelength] rows.
    data_units = _block_means_2d(elecData, n_lam, n_ang).T
    bg_units = _block_means_2d(bg, n_lam, n_ang).T

    all_axes["epw_y"] = _block_means_1d(axisyE, n_lam).reshape((-1, 1))
    all_axes["epw_x"] = _block_means_1d(axisxE, n_ang).reshape((-1, 1))

    all_data = {
        "e_data": data_units,
        "e_amps": data_units.max(axis=1, keepdims=True),
        "i_data": np.zeros(len(data_units)),
        "i_amps": np.zeros(len(data_units)),
        "noiseI": np.zeros(np.shape(bg_units)),
        "noiseE": config["data"]["bgscaleE"] * bg_units + _ZERO_COUNT_OFFSET,
    }
    config["other"]["CCDsize"] = np.shape(data_units)
    return all_data, all_axes["epw_y"].ravel()


def prepare_data(config: Dict, shotNum: int):
    """Returns (all_data, sa, all_axes); mutates config with derived quantities."""
    from .warpcorr import reset_fiducial_cache

    # fiducial-map reuse (signal frame -> tracerless background frame) is
    # scoped to THIS shot's loads; see warpcorr._FIDUCIAL_MAPS_CACHE
    reset_fiducial_cache()
    opts = config["other"]["extraoptions"]
    elecData, ionData, xlab, t0, opts["spectype"] = loadData(
        config["data"]["shotnum"], config["data"]["shotDay"], opts,
        custom_path=_custom_data_dir(config["data"]),
    )

    sa = get_scattering_angles(config)
    axisxE, axisxI, axisyE, axisyI, magE, stddev = get_calibrations(
        shotNum, opts["spectype"], t0, config["other"]["CCDsize"]
    )
    all_axes = {"epw_x": axisxE, "epw_y": axisyE, "iaw_x": axisxI, "iaw_y": axisyI, "x_label": xlab}

    # A channel that did not load cannot be fit.
    if not opts["load_ion_spec"]:
        opts["fit_IAW"] = 0
        log_info("IAW data not loaded, omitting IAW fit")
    if not opts["load_ele_spec"]:
        opts["fit_EPWb"] = 0
        opts["fit_EPWr"] = 0
        log_info("EPW data not loaded, omitting EPW fit")

    if opts["load_ele_spec"]:
        elecData = correctThroughput(elecData, opts["spectype"], axisyE, shotNum) + _ZERO_COUNT_OFFSET
    if opts["load_ion_spec"]:
        ionData = ionData + _ZERO_COUNT_OFFSET

    BGele, BGion = get_shot_bg(config, shotNum, axisyE, elecData)

    detected = _apply_feature_detector(config, elecData, ionData, all_axes)
    _resolve_lineout_values(config, detected)
    _trim_to_batch_multiple(config)

    if config["data"]["lineouts"]["type"] == "range" and opts["spectype"] == "angular":
        all_data, axisyE = _reduce_arts_image(config, elecData, BGele, axisxE, axisyE, sa, all_axes)
    else:
        all_data = get_lineouts(
            elecData, ionData, BGele, BGion, axisxE, axisxI, axisyE, axisyI,
            config["data"]["ele_t0"], config["data"]["ion_t0_shift"], xlab, sa, config,
        )


    config["other"]["PhysParams"]["widIRF"] = stddev
    config["other"]["lamrangE"] = [axisyE[0], axisyE[-1]]
    config["other"]["lamrangI"] = [axisyI[0], axisyI[-1]]
    config["other"]["npts"] = int(config["other"]["CCDsize"][1] * config["other"]["points_per_pixel"])

    return all_data, sa, all_axes
