"""Lineout extraction, smoothing, background assembly, amplitude metrics.

A copy of ``tsadar_tpu.utils.process.lineouts``: lineout locations (time/space/pixel units) map to pixel columns; each
lineout is the sum over a ±dpixel column band, box-smoothed along the spectral
axis; per-lineout noise comes from the background module; amplitudes are the
peak of the gain-normalized lineout inside the fit bands.
"""

from typing import Dict

import numpy as np
from scipy.ndimage import convolve1d

from .evaluate_background import get_lineout_bg


def _nearest_pixels(axis, locations):
    """Pixel index of the axis sample nearest each location (vectorized)."""
    locations = np.atleast_1d(np.asarray(locations, float))
    return np.abs(axis[None, :] - locations[:, None]).argmin(axis=1)


def _band_sums(image, centers, half_width):
    """Sum each [center-half, center+half) column band: [n_centers, n_rows].

    Columns falling outside the image contribute zero (bands at the detector
    edge are partial, matching slice-truncation semantics).
    """
    cols = np.asarray(centers, int)[:, None] + np.arange(-half_width, half_width)
    inside = (cols >= 0) & (cols < image.shape[1])
    return (image[:, np.clip(cols, 0, image.shape[1] - 1)] * inside).sum(axis=-1).T


def _box_smooth_rows(rows, span):
    """Zero-padded centered moving average (odd span) along the last axis."""
    return convolve1d(np.asarray(rows, float), np.full(span, 1.0 / span), axis=-1, mode="constant")


def _either_band_mask(axis, lo1, hi1, lo2, hi2):
    """Boolean mask for axis values strictly inside (lo1,hi1) or (lo2,hi2)."""
    return ((lo1 < axis) & (axis < hi1)) | ((lo2 < axis) & (axis < hi2))


def get_lineouts(
    elecData, ionData, BGele, BGion, axisxE, axisxI, axisyE, axisyI, shift_zero, IAWtime, xlab, sa, config
) -> Dict:
    """Extract, background-subtract-ready, and normalize lineouts.

    Returns a dict with e_data/i_data [n, 1024], e_amps/i_amps [n], and
    noiseE/noiseI profiles; channels that are not loaded get zeros. Mutates
    ``config`` with the resolved pixel locations and ``sa["weights"]`` with the
    per-lineout aperture weights.
    """
    data_cfg = config["data"]
    opts = config["other"]["extraoptions"]
    locations = data_cfg["lineouts"]["val"]

    # Resolve lineout locations to pixel columns on each detector.
    lo_units = data_cfg["lineouts"]["type"]
    if lo_units in ("ps", "um"):
        px_e = _nearest_pixels(axisxE, np.asarray(locations) + shift_zero)
        px_i = _nearest_pixels(axisxI, np.asarray(locations) + shift_zero)
        # IAWtime arrives in axis units; the ion detector shift is in pixels.
        IAWtime = IAWtime / (axisxI[1] - axisxI[0])
    elif lo_units == "pixel":
        px_e = np.asarray(locations)
        px_i = np.asarray(locations)
    else:
        raise NotImplementedError(f"lineout type {lo_units}")
    px_i = np.round(px_i - IAWtime).astype(int)
    data_cfg["lineouts"]["pixelE"] = px_e
    data_cfg["lineouts"]["pixelI"] = px_i

    # Resolve the background column.
    bg_units = data_cfg["background"]["type"]
    if bg_units in ("ps", "um"):
        background_px = int(_nearest_pixels(axisxE, data_cfg["background"]["slice"])[0])
    elif bg_units == "pixel":
        background_px = data_cfg["background"]["slice"]
    elif bg_units == "auto":
        background_px = px_e + 100
    else:
        background_px = []

    half = data_cfg["dpixel"]
    span = 2 * half + 1

    e_smooth = []
    if opts["load_ele_spec"]:
        e_smooth = _box_smooth_rows(_band_sums(elecData, px_e, half), span)
        if opts["spectype"] == "angular":
            # ARTS: aperture weights follow the same column bands as the data.
            # Edge lineouts get partial bands (slice-truncation semantics, like
            # _band_sums): average over the in-range rows only.
            windows = px_e[:, None] + np.arange(-half, half)
            inside = (windows >= 0) & (windows < sa["weights"].shape[0])
            rows = sa["weights"][np.clip(windows, 0, sa["weights"].shape[0] - 1), :]
            counts = np.maximum(inside.sum(axis=1), 1)[:, None]
            sa["weights"] = ((rows * inside[..., None]).sum(axis=1) / counts)[:, None, :]
        else:
            sa["weights"] = sa["weights"] * np.ones([len(px_e), len(sa["sa"])])

    i_smooth = None
    if opts["load_ion_spec"]:
        i_smooth = _box_smooth_rows(_band_sums(ionData, px_i, half), span)

    noiseE, noiseI = get_lineout_bg(
        config, elecData, ionData, BGele, BGion, e_smooth, background_px, px_e, px_i
    )

    # Gain-normalize and measure amplitudes inside the fit bands.
    gain = config["other"]["gain"]
    fr = data_cfg["fit_rng"]
    zeros = np.zeros(len(locations))
    out = {"noiseE": noiseE, "noiseI": noiseI, "e_data": zeros, "e_amps": zeros, "i_data": zeros, "i_amps": zeros}

    if opts["load_ion_spec"]:
        out["noiseI"] = noiseI / gain
        i_norm = i_smooth / gain
        iaw_band = _either_band_mask(axisyI, fr["iaw_min"], fr["iaw_cf_min"], fr["iaw_cf_max"], fr["iaw_max"])
        out["i_data"] = i_norm
        out["i_amps"] = i_norm[:, iaw_band].max(axis=1)

    if opts["load_ele_spec"]:
        out["noiseE"] = noiseE / gain
        e_norm = e_smooth / gain
        epw_band = _either_band_mask(axisyE, fr["blue_min"], fr["blue_max"], fr["red_min"], fr["red_max"])
        out["e_data"] = e_norm
        out["e_amps"] = e_norm[:, epw_band].max(axis=1)

    return out
