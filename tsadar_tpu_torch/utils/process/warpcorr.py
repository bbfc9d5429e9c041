"""Streak-camera dewarp via forward-splat bilinear remap.

A copy of ``tsadar_tpu.utils.process.warpcorr``: upstream tsadar's remap with the
per-pixel Python double loop replaced by a vectorized numpy scatter-add (same
splat weights).  The precomputed warp maps (``epwtestDW5img1x/y.npy``) are
absent from this repository, for the JAX package as for the port; when absent
the correction degrades to identity with a warning, preserving pipeline operability.

``reconstruct_warp_from_fiducials`` builds a LOW-ORDER approximation of the
missing maps from tracers inside each frame (opt-in via the
``other.extraoptions.fiducial_dewarp`` deck flag):

* **time axis** — the OMEGA timing-fiducial comb pips arrive every 548 ps
  (109.6 px at the 5 ps/px calibration); measured tooth spacing on shot
  101675 runs 109.4 px early -> 92.3 px late, i.e. the sweep runs ~17% fast
  by the end of the window.  The map pins each tooth back to the calibrated
  pip interval (anchored at the first tooth, so fiducial t0 is unchanged).
* **spectral axis** — the iaw notch filter's dark band is an in-frame
  wavelength reference; its measured center drifts ~12 px across the sweep.
  The half-depth band EDGES are biased inward relative to the filter's
  nominal wavelengths (finite OD slope), but the band CENTER is unbiased, so
  the map applies the per-column shift that pins the center to the
  calibration row of the notch wavelength, computed per shot by the loader
  (``load_ts_data._notch_target_row``); without a calibration it degrades to
  relative (straighten-only) anchoring.

What this cannot recover (quantified on shot 101675, see PARITY.md): any
warp component varying along the spectral axis between the comb band
(rows ~0-130) and the notch (rows ~470-540) — the in-frame tracers sample
the 2D warp on two nearly-horizontal curves only, so the reconstruction is
separable (rank-1) by construction, while the lost reference maps encode a
full calibration-grid measurement.
"""

import os

import numpy as np
from ..console import log_info

_EXTERNAL = os.path.join(os.path.dirname(__file__), "..", "..", "external")

# EPW 5 ns streak instrument constants for the fiducial reconstruction
EPW5_PIP_PX = 109.6  # 548 ps OMEGA fiducial pip interval / 5 ps-per-px sweep
EPW5_COMB_ROWS = slice(0, 100)  # row band carrying the timing comb (loader's band)
EPW5_NOTCH_BAND = (430, 580)  # row window containing the iaw notch dark band
_COMB_PROMINENCE = 1000
_COMB_WIDTH = 10
_NOTCH_MIN_LEVEL = 500.0  # counts: plateau level needed to trust an edge fit


def _load_warp_maps(instrument="EPW", sweepSpeed=5):
    xp = os.path.join(_EXTERNAL, "files", "epwtestDW5img1x.npy")
    yp = os.path.join(_EXTERNAL, "files", "epwtestDW5img1y.npy")
    if not (os.path.exists(xp) and os.path.exists(yp)):
        return None, None
    if sweepSpeed != 5:
        log_info("no specific data available for this sweep speed - using 5ns dewarp")
    return np.load(xp), np.load(yp)


def _forward_splat(val, typix, txpix):
    """Bilinear forward splat: counts at (row i, col j) land at (typix, txpix).

    Same splat weights and edge guards as the reference remap loop; counts are
    conserved for interior pixels, so a locally compressed axis raises the
    per-pixel density by the local Jacobian — the mechanism by which dewarp
    affects fitted amplitudes.
    """
    n0, n1 = val.shape
    xl = np.floor(txpix).astype(int)
    xh = np.ceil(txpix).astype(int)
    yl = np.floor(typix).astype(int)
    yh = np.ceil(typix).astype(int)
    xlf = 1.0 - (txpix - xl)
    ylf = 1.0 - (typix - yl)

    dep = np.zeros_like(val, dtype=float)
    valid = (yl > 0) & (xl > 0) & (yh < n0) & (xh < n1)

    def splat(yy, xx, w):
        np.add.at(dep, (yy[valid], xx[valid]), (val * w)[valid])

    splat(yl, xl, xlf * ylf)
    splat(yl, xh, (1 - xlf) * ylf)
    splat(yh, xl, xlf * (1 - ylf))
    splat(yh, xh, (1 - xlf) * (1 - ylf))
    return dep


def _comb_tooth_centers(img, comb_rows=EPW5_COMB_ROWS, pip_px=EPW5_PIP_PX):
    """Subpixel timing-comb tooth centers (half-height midpoints), or None.

    Detected peaks are filtered to the longest chain of pips spaced within
    40% of the nominal pip interval — the comb band can contain bright
    non-comb features (signal bleed, pre-pulse marks) whose spacing to the
    real teeth is not one pip, and anchoring the time map on one of those
    would shift the whole sweep.  The chain is the longest PATH over all
    in-window peak pairs (O(n^2) DP, n ~ 10-20), not the longest run of
    adjacent detections: a spur landing BETWEEN two teeth splits every
    adjacent-pair scan in half (each side of the spur is ~0.5 pip away),
    silently discarding half the comb and leaving the late sweep — exactly
    where the speed correction matters — to edge-slope extrapolation.  The
    DP simply bypasses the spur: the tooth-to-tooth edge across it is still
    ~1 pip.
    """
    from scipy.signal import find_peaks

    comb = img[comb_rows, :].sum(axis=0)
    _, props = find_peaks(comb, prominence=_COMB_PROMINENCE, width=_COMB_WIDTH)
    centers = 0.5 * (props["left_ips"] + props["right_ips"])
    if len(centers) < 3:
        return None
    n = len(centers)
    chain_len = np.ones(n, dtype=int)
    prev_idx = np.full(n, -1)
    for j in range(n):
        for i in range(j):
            d = centers[j] - centers[i]
            if 0.6 * pip_px <= d <= 1.4 * pip_px and chain_len[i] + 1 > chain_len[j]:
                chain_len[j] = chain_len[i] + 1
                prev_idx[j] = i
    end = int(np.argmax(chain_len))
    best = []
    while end >= 0:
        best.append(centers[end])
        end = prev_idx[end]
    best.reverse()
    return np.asarray(best) if len(best) >= 3 else None


def _notch_edges(prof, band=EPW5_NOTCH_BAND):
    """(top, bottom) half-depth edge rows of the notch dark band, or None.

    Returns None when the surrounding plateaus are too dim to give reliable
    edges (or the frame is too short to contain the band).  The two
    half-depth crossings are biased inward by the filter's finite OD slope,
    but symmetrically — their midpoint is unbiased.  Measured per-tracer
    noise on shot 101675 (quadratic-fit residual rms over 43 column blocks):
    top edge 1.3 px, bottom edge 8.5 px — the bottom plateau is contaminated
    by the time-varying blue EPW feature, so callers should trace the TOP
    edge per column and use the bottom only through a robust
    (median-half-width) center offset.
    """
    lo, hi = band
    hi = min(hi, len(prof))
    if hi - lo < 40:
        return None
    p = np.convolve(prof[lo:hi].astype(float), np.ones(5) / 5, mode="same")
    imin = int(np.argmin(p))
    if imin < 10 or imin > len(p) - 10:
        return None
    floor = p[imin]
    left_lvl = np.median(p[: imin - 5])
    right_lvl = np.median(p[imin + 5 :])
    if min(left_lvl, right_lvl) - floor < _NOTCH_MIN_LEVEL:
        return None
    edges = []
    for direction, lvl in ((-1, left_lvl), (1, right_lvl)):
        half = 0.5 * (lvl + floor)
        i = imin
        while 0 < i < len(p) - 1 and p[i] < half:
            i += direction
        if i <= 0 or i >= len(p) - 1:
            return None
        frac = (half - p[i - direction]) / (p[i] - p[i - direction] + 1e-12)
        edges.append(lo + i - direction + direction * frac)
    return edges[0], edges[1]


def reconstruct_warp_from_fiducials(
    img,
    pip_px=EPW5_PIP_PX,
    comb_rows=EPW5_COMB_ROWS,
    notch_band=EPW5_NOTCH_BAND,
    notch_target_row=None,
):
    """(typix, txpix) dewarp target maps from in-frame tracers, or None.

    Separable low-order model: columns move so the comb teeth sit at the
    calibrated pip interval (anchored at the first tooth — fiducial t0 is
    invariant); rows shift per column so the notch center tracks
    ``notch_target_row`` — the calibration row of the notch center wavelength,
    computed PER SHOT by the caller (528 nm sits at row 507.5 for shot 101675
    but 512.2 for 111411, so it cannot be a constant here).  The absolute
    registration matters: it aligns the per-lineout amplitude normalization
    windows with their dewarped-calibration positions (amp1 on the validated
    shot improves from 11% to 9% off with it vs relative-only anchoring).
    When None, the center is held at its first-tooth-column value instead
    (relative anchoring: straightens the drift, leaves global registration to
    the fitted probe wavelength).  See the module docstring for what this can
    and cannot recover.
    """
    n0, n1 = img.shape
    teeth = _comb_tooth_centers(img, comb_rows, pip_px=pip_px)
    if teeth is None:
        return None

    # time map: measured tooth k -> first_tooth + k * pip_px, piecewise-linear
    # in between, extended with the edge slopes outside the comb
    true_teeth = teeth[0] + pip_px * np.arange(len(teeth))
    cols = np.arange(n1, dtype=float)
    colp = np.interp(cols, teeth, true_teeth)
    left_slope = (true_teeth[1] - true_teeth[0]) / (teeth[1] - teeth[0])
    right_slope = (true_teeth[-1] - true_teeth[-2]) / (teeth[-1] - teeth[-2])
    colp = np.where(cols < teeth[0], true_teeth[0] + (cols - teeth[0]) * left_slope, colp)
    colp = np.where(cols > teeth[-1], true_teeth[-1] + (cols - teeth[-1]) * right_slope, colp)

    # spectral shift: notch TOP edge per 16-col block, quadratic fit over
    # valid blocks (needs enough of the sweep lit to constrain the
    # polynomial), re-centered by the robust half-width.  The top edge is the
    # clean tracer (1.3 px rms on 101675); the bottom plateau carries the
    # time-varying blue EPW signal (8.5 px rms), so it enters only through
    # the median band half-width — one robust constant instead of 43 noisy
    # per-column samples.
    tops, widths, ccols = [], [], []
    for c in range(8, n1 - 8, 16):
        e = _notch_edges(img[:, c - 8 : c + 8].sum(axis=1), notch_band)
        if e is not None:
            tops.append(e[0])
            widths.append(e[1] - e[0])
            ccols.append(c)
    if len(tops) < 8 or (max(ccols) - min(ccols)) < n1 / 4:
        return None
    coeff = np.polyfit(np.asarray(ccols, float), np.asarray(tops, float), 2)
    coeff[-1] += 0.5 * float(np.median(widths))  # top-edge quad -> band center
    anchor = notch_target_row if notch_target_row is not None else np.polyval(coeff, teeth[0])
    shift = anchor - np.polyval(coeff, cols)  # [n1]

    typix = np.arange(n0, dtype=float)[:, None] + shift[None, :]
    txpix = np.broadcast_to(colp[None, :], (n0, n1))
    return typix, txpix


# Last successful fiducial reconstruction, keyed by (instrument, frame shape)
# and stored WITH the spectral anchor it was built for.  Background-shot
# frames (null shots) carry the timing comb but no scattered light, so their
# notch tracer is absent; the reference applied the SAME static maps to
# signal and background frames, and reusing the signal frame's reconstruction
# (prepare loads the signal before the background) preserves that
# registration instead of leaving the background un-dewarped against a
# stretched signal.  Reuse REQUIRES a matching spectral anchor: a background
# shot sits in the same calibration range as its signal (same target row),
# while an unrelated later shot from a different range does not — it must get
# the identity fallback, not another shot's registration.
#
# The cache is SCOPED TO ONE prepare_data() invocation: prepare calls
# ``reset_fiducial_cache()`` before loading, so a long-lived process fitting
# several shots can never silently apply shot A's per-shot sweep correction
# to an unrelated shot B whose tracers fail detection (the anchor check alone
# cannot distinguish B from A's background when both share a calibration
# range).
_FIDUCIAL_MAPS_CACHE = {}


def reset_fiducial_cache():
    """Drop cached fiducial maps (call at the start of each shot's prepare)."""
    _FIDUCIAL_MAPS_CACHE.clear()


def _anchors_match(a, b):
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) < 1.0


def perform_warp_correction(
    warpedData,
    instrument="EPW",
    sweepSpeed=5,
    flatField=True,
    fiducial_fallback=False,
    notch_target_row=None,
):
    """Dewarp one streak frame.

    ``notch_target_row`` may be a value or a zero-arg callable (evaluated only
    when the fiducial reconstruction actually runs).  Any failure inside the
    fiducial path degrades to identity — it must never propagate into the
    loader's channel-level exception handling, which would silently drop the
    whole channel.  The fiducial reconstruction implements the EPW 5 ns
    streak geometry only and is skipped for other instruments.
    """
    warp1x, warp1y = _load_warp_maps(instrument, sweepSpeed)
    if warp1x is None:
        if fiducial_fallback and instrument == "EPW":
            key = (instrument, np.shape(warpedData))
            if callable(notch_target_row):
                try:
                    notch_target_row = notch_target_row()
                except Exception as e:
                    log_info(f"warpcorr: spectral anchor unavailable ({e}); relative anchoring")
                    notch_target_row = None
            try:
                maps = reconstruct_warp_from_fiducials(
                    np.asarray(warpedData), notch_target_row=notch_target_row
                )
            except Exception as e:
                log_info(f"warpcorr: fiducial reconstruction failed ({e}); continuing without it")
                maps = None
            if maps is not None:
                _FIDUCIAL_MAPS_CACHE[key] = (maps, notch_target_row)
                log_info("warpcorr: using fiducial-reconstructed warp (comb + notch tracers)")
                return _forward_splat(np.asarray(warpedData, dtype=float), *maps)
            cached = _FIDUCIAL_MAPS_CACHE.get(key)
            if cached is not None and _anchors_match(cached[1], notch_target_row):
                log_info(
                    "warpcorr: tracers not found in this frame (background shot?); "
                    "reusing the maps reconstructed from the signal frame"
                )
                return _forward_splat(np.asarray(warpedData, dtype=float), *cached[0])
            log_info("warpcorr: fiducial tracers not found; returning data without dewarp")
            return warpedData
        log_info(
            "warpcorr: warp maps unavailable (missing from reference snapshot); "
            "returning data without dewarp"
        )
        return warpedData

    n0, n1 = warpedData.shape
    jj, ii = np.meshgrid(np.arange(n1), np.arange(n0))  # (i=row, j=col) as in reference loops
    # reference: for (i, j): value at warpedData[j, i] lands at
    # (typix, txpix) = (j + warp1y[j, i], i + warp1x[j, i])
    typix = jj.T + warp1y  # indexed [j, i]
    txpix = ii.T + warp1x
    return _forward_splat(warpedData, typix, txpix)
