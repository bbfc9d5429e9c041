"""Shot- and lineout-level background models.

A copy of ``tsadar_tpu.utils.process.evaluate_background``. Two layers of
background exist:

* a *shot* background — a whole second CCD/streak image from a dedicated
  background shot, smoothed (and for ARTS optionally rescaled by a fitted
  quadratic-in-pixel gain model), and
* a *lineout* background — a per-lineout noise profile built either from an
  edge-region model fit ("Fit") or from a background pixel column ("Pixel"/
  "Shot"), with a double-exponential resmoothing + per-lineout L1 rescale for
  streaked data.

All pixel windows below are instrument facts from the reference (OMEGA streak
fiducial/notch locations, CCD gain-fit seeds) and are kept as named constants.
"""

from typing import Tuple

import numpy as np
import scipy.optimize as spopt
from scipy.ndimage import convolve1d, uniform_filter

from ..data_handling.load_ts_data import loadData
from .correct_throughput import correctThroughput
from ..console import log_info

# Streak-camera column windows (pixels). The fit window skips the timing
# fiducials (top/bottom combs) and the notch-filter shadow; the rescale window
# uses only the far spectral wings where signal is background-dominated.
STREAK_BG_FIT_COLS = np.r_[250:480, 540:900]
STREAK_BG_RESCALE_COLS = np.r_[250:300, 700:900]
# IAW backgrounds are nearly flat: average the smoothed background lineout over
# these signal-free columns and use the scalar everywhere.
IAW_BG_MEAN_COLS = np.r_[200:400, 700:850]

# ARTS "Fit" mode: gain mismatch between shot and background-shot images is
# modeled as quad(px) * background, fit on one high-signal row.
ARTS_GAIN_FIT_ROW = 1000
ARTS_GAIN_FIT_SEED = (0.1, 0.1, 1.15, 300.0)  # (curvature, slope, scale, pivot px)

# Double-exponential decay seed for the streak background resmoothing.
EXP2_DECAY_SEED = (200.0, 0.001, 200.0, 0.001)

_NPX = 1024


def _box1d(profile, span):
    """Zero-padded centered moving average (odd span), along the last axis."""
    kernel = np.full(span, 1.0 / span)
    return convolve1d(np.asarray(profile, float), kernel, axis=-1, mode="constant")


def _box2d(image, rows, cols):
    """Zero-padded 2D box smooth of an image."""
    return uniform_filter(np.asarray(image, float), size=(rows, cols), mode="constant")


def _column_band_mean(image, center, half_width):
    """Mean over the column band [center-half, center+half) — a raw lineout.

    An ARRAY of centers (background type 'auto': one column per lineout,
    lineouts.py) collapses to the mean over the per-lineout bands — one
    representative background profile, matching the single-column semantics
    of the other pixel-style types."""
    if np.ndim(center) > 0:
        return _window_means(image, center, half_width).mean(axis=0)
    center = int(center)
    return image[:, center - half_width : center + half_width].mean(axis=1)


def _window_means(image, centers, half_width):
    """Per-center column-band means, vectorized: returns [n_centers, n_rows].

    Columns outside the image are excluded (edge bands are partial)."""
    cols = np.asarray(centers, int)[:, None] + np.arange(-half_width, half_width)
    inside = (cols >= 0) & (cols < image.shape[1])
    sums = (image[:, np.clip(cols, 0, image.shape[1] - 1)] * inside).sum(axis=-1).T
    return sums / np.maximum(inside.sum(axis=-1), 1)[:, None]


# Edge-fit background models (selected by config data.background.bg_alg).
def _exp2(x, a, b, c, d):
    return a * np.exp(b * x) + c * np.exp(d * x)


def _exp2_decay(x, a, b, c, d):
    return a * np.exp(-b * x) + c * np.exp(-d * x)


def _power2(x, a, b, c):
    return a * x**b + c


def _rat21(x, a, b, c, d):
    return (a * x**2 + b * x + c) / (x + d)


def _rat11(x, a, b, c):
    return (a * x + b) / (x + c)


BG_MODELS = {"exp2": _exp2, "power2": _power2, "rat21": _rat21, "rat11": _rat11}


def _l1_scale(target, template):
    """argmin_a sum |target - a*template|, exactly (weighted median of ratios).

    The objective is piecewise-linear convex in a; its minimizer is the
    |template|-weighted median of target/template. (The reference reaches a
    nearby value with a Brent scalar search.)
    """
    t = np.asarray(template, float)
    y = np.asarray(target, float)
    keep = t != 0.0
    ratios = y[keep] / t[keep]
    weights = np.abs(t[keep])
    order = np.argsort(ratios)
    cdf = np.cumsum(weights[order])
    return ratios[order][np.searchsorted(cdf, 0.5 * cdf[-1])]


def get_shot_bg(config, shotNum, axisyE, elecData):
    """Whole-image backgrounds from a dedicated background shot.

    "Shot": load + throughput-correct + box-smooth both channels.
    "Fit" (ARTS only): additionally rescale by a fitted quadratic gain model.
    Anything else: zeros (no shot background).
    """
    bg_cfg = config["data"]["background"]
    opts = config["other"]["extraoptions"]
    spectype = opts["spectype"]
    is_arts = spectype == "angular"

    def _load_bg_image():
        # pass a COPY of the channel flags: loadData's failure path mutates
        # load_ion_spec/load_ele_spec in place, and a background shot missing
        # one channel must not silently disable the successfully loaded
        # SIGNAL channel (prepare's fit_IAW/fit_EPW gating already ran — the
        # fit would then run against all-zero data with no warning).  The
        # copy's flags describe what the BACKGROUND shot actually has.
        bg_opts = dict(opts)
        eimg, iimg, _, _, _ = loadData(bg_cfg["slice"], config["data"]["shotDay"], bg_opts)
        return eimg, iimg, bg_opts

    if bg_cfg["type"] == "Shot":
        raw_e, raw_i, bg_opts = _load_bg_image()
        bg_ion = _box2d(raw_i, 5, 3) if (opts["load_ion_spec"] and bg_opts["load_ion_spec"]) else 0
        if opts["load_ele_spec"] and bg_opts["load_ele_spec"]:
            corrected = correctThroughput(raw_e, spectype, axisyE, config["data"]["shotnum"])
            bg_ele = _box2d(corrected, 5, 5) if is_arts else _box2d(corrected, 5, 3)
        else:
            bg_ele = 0
        return bg_ele, bg_ion

    if is_arts and bg_cfg["type"] == "Fit":
        raw_e, _, _ = _load_bg_image()
        smoothed = _box2d(correctThroughput(raw_e, spectype, axisyE, shotNum), 5, 5)
        px = np.arange(_NPX)

        def quad_gain(coef):
            curv, slope, scale, pivot = coef
            return curv * (px - pivot) ** 2 + slope * (px - pivot) + scale

        row = ARTS_GAIN_FIT_ROW
        residual = lambda coef: np.sum((elecData[row, :] - quad_gain(coef) * smoothed[row, :]) ** 2)
        best = spopt.minimize(residual, list(ARTS_GAIN_FIT_SEED))
        log_info("Angular background corrected with polynomial model")
        return quad_gain(best.x) * smoothed, 0

    return 0, 0


def _edge_fit_backgrounds(config, smoothed_lineouts):
    """'Fit' mode (non-ARTS): fit bg_alg to each lineout's edge columns."""
    bg_cfg = config["data"]["background"]
    lo, hi, lo2, hi2 = bg_cfg["bg_alg_domain"]
    fit_cols = np.r_[lo:hi, lo2:hi2]
    model = BG_MODELS[bg_cfg["bg_alg"]]
    px = np.arange(_NPX)
    profiles = []
    for lineout in smoothed_lineouts:
        coef, _ = spopt.curve_fit(model, fit_cols, lineout[fit_cols], bg_cfg["bg_alg_params"])
        profiles.append(model(px, *coef))
    return profiles


def _pixel_backgrounds_ele(config, elecData, shot_bg, smoothed_lineouts, background_px):
    """'Pixel'/'Shot' mode: background lineout at background_px, smoothed; for
    streaked data, replaced by a fitted double-exponential rescaled per lineout."""
    dpx = config["data"]["dpixel"]
    profile = _box1d(_column_band_mean(elecData - shot_bg, background_px, dpx), 2 * dpx + 1)

    if config["other"]["extraoptions"]["spectype"] == "angular":
        return profile

    coef, _ = spopt.curve_fit(
        _exp2_decay, STREAK_BG_FIT_COLS, profile[STREAK_BG_FIT_COLS], p0=list(EXP2_DECAY_SEED)
    )
    template = config["data"]["bgscaleE"] * _exp2_decay(np.arange(_NPX), *coef)
    wing = STREAK_BG_RESCALE_COLS
    scales = np.array([_l1_scale(lo[wing], template[wing]) for lo in smoothed_lineouts])
    return scales[:, None] * template[None, :]


def get_lineout_bg(
    config, elecData, ionData, BGele, BGion, LineoutTSE_smooth, BackgroundPixel, LineoutPixelE, LineoutPixelI
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-lineout noise profiles: (noiseE, noiseI), each [n_lineouts, 1024]
    (or zeros when that channel is not loaded)."""
    bg_type = config["data"]["background"]["type"].casefold()
    # 'ps'/'um'/'auto' are documented ALIASES for 'pixel' whose background
    # column was already resolved by lineouts.py (time -> pixel for ps/um;
    # lineout+100 px for auto) — reference evaluate_background.py:99-100.
    # (The reference's own dispatch rejects them here, making the aliases
    # its validator and lineout resolver both accept dead on arrival.)
    if bg_type in ("ps", "um", "auto"):
        bg_type = "pixel"
    if bg_type not in ("fit", "shot", "pixel"):
        raise NotImplementedError("Background type must be: 'Fit', 'Shot', or 'Pixel'")

    opts = config["other"]["extraoptions"]
    dpx = config["data"]["dpixel"]
    n_lineouts = len(config["data"]["lineouts"]["val"])
    ccd_shape = tuple(config["other"]["CCDsize"])

    if opts["load_ele_spec"]:
        if bg_type == "fit" and opts["spectype"] == "angular":
            # per-lineout 'Fit' backgrounds only exist for streaked/imaging
            # data; angular 'Fit' is handled at the shot level (get_shot_bg)
            # with range-type lineouts.  This combination (angular + pixel
            # lineouts + 'Fit') is dead upstream too (the reference falls into
            # the pixel path with no background pixel and crashes); fail with
            # a name instead.
            raise ValueError(
                "background type 'Fit' with angular spectra requires lineout type "
                "'range' (shot-level background); per-lineout 'Fit' backgrounds "
                "are not defined for angular data"
            )
        if bg_type == "fit":
            lineout_bg = _edge_fit_backgrounds(config, LineoutTSE_smooth)
        else:
            lineout_bg = _pixel_backgrounds_ele(
                config, elecData, BGele, LineoutTSE_smooth, BackgroundPixel
            )
        if np.shape(BGele) == ccd_shape:
            noiseE = np.asarray(lineout_bg) + _window_means(BGele, LineoutPixelE, dpx)
        else:
            noiseE = np.asarray(lineout_bg) * np.ones((len(LineoutPixelE), 1))
        noiseE = noiseE + config["other"]["flatbg"]
    else:
        noiseE = np.zeros(n_lineouts)

    if opts["load_ion_spec"]:
        # IAW backgrounds are small and flat: one scalar from the smoothed
        # background lineout's signal-free columns, broadcast everywhere.
        # (In "fit" mode the electron path never used the slice column, so it
        # is consumed here.)
        ion_bg_px = config["data"]["background"]["slice"] if bg_type == "fit" else BackgroundPixel
        profile = _box1d(_column_band_mean(ionData - BGion, ion_bg_px, dpx), 2 * dpx + 1)
        flat = config["data"]["bgscaleI"] * profile[IAW_BG_MEAN_COLS].mean()
        noiseI = np.full(_NPX, flat)
        if np.shape(BGion) == ccd_shape:
            noiseI = noiseI[None, :] + _window_means(BGion, LineoutPixelI, dpx)
        else:
            noiseI = noiseI * np.ones((len(LineoutPixelI), 1))
    else:
        noiseI = np.zeros(n_lineouts)

    return noiseE, noiseI
