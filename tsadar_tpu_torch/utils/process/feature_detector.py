"""Automatic estimation of the lineout range and the fit windows from the CCD frames.

A copy of ``tsadar_tpu.utils.process.feature_detector`` in numpy and scipy, without OpenCV: normalise to uint8 ->
21 x 21 Gaussian blur -> notch split (EPW) -> three morphological openings -> Shi-Tomasi corners -> neighbour
filter -> bounding box plus the deck's buffers.  The detector's output is a handful of pixel indices, and a blur
that is off by one at some pixels moves them (by up to 5 pixels on shot 112059's EPW frame), so each image step
reproduces the OpenCV call of the JAX package bit for bit:

- ``_gaussian_blur_u8``: ``cv.GaussianBlur(img, (21, 21), 0)`` on uint8, OpenCV's fixed-point 8-bit path;
- ``_morphological_opening``: ``cv.erode`` then ``cv.dilate`` with square kernels of ones (default border);
- ``_good_features_to_track``: ``cv.goodFeaturesToTrack(img, 100, 0.1, 10)`` (``cornerMinEigenVal``, block 3,
  Sobel aperture 3, float32).

``tests/test_torch_feature_detector.py`` holds each step to the OpenCV call at every pixel (the corners as a list,
in order) on the repository's real frames and on seeded images; OpenCV is that test's oracle and nothing here
imports it.  Where the JAX package fails on a deck (an index past the axis, no corner with a neighbour, a deck
that loads no ion frame), this module raises the same exception type with a message that names the cause.
"""

import math

import numpy as np
from scipy import ndimage

# Pixels of the notch between the red and blue EPW halves (rows of the uncropped frame).
_NOTCH_ROWS = (516, 540)
# Corners with no other corner this close [pixels] are dropped before the bounding box.
_NEIGHBOUR_DISTANCE = 100
_f32 = np.float32


def _data_processing(data, config, wave_type):
    """The frame's detector rows and its first 1023 columns, scaled to 0..255 and truncated to uint8."""
    if not isinstance(data, np.ndarray) or data.ndim != 2:
        raise TypeError(f"the {wave_type} feature detector needs the {wave_type} frame, and this deck loads none "
                        f"(other.extraoptions.load_{'ion' if wave_type == 'IAW' else 'ele'}_spec)")
    if config["other"]["extraoptions"]["spectype"] == "temporal":
        a, b = (150, 850) if wave_type == "IAW" else (200, 900)
    else:
        a = 150 if wave_type == "EPW" else 0
        b = 1023
    data = data[a:b, 0:1023]
    lo, hi = data.min(), data.max()
    return (((data - lo) / (hi - lo)) * 255.0).astype(np.uint8)


def _gaussian_taps_u8(ksize):
    """OpenCV's 8-bit fixed-point Gaussian taps for ``ksize`` with sigma 0: integers summing to 256.

    The float taps are OpenCV's bit-exact kernel: sigma = 0.15 ksize + 0.35 (= 0.3 ((ksize - 1) 0.5 - 1) + 0.8),
    exp(-x^2 / (8 sigma^2)) at x = 1 - ksize, 3 - ksize, ... (half-pixel units), divided by their sum.  Each outer
    tap times 256 is rounded half to even after adding the rounding error carried from the tap before it (error
    diffusion from the edge inwards), the mirror tap takes the same value, and the centre tap takes what keeps the
    sum at 256.  Taps rounded one by one differ in four places, and the blur then misses ``cv.GaussianBlur`` at
    15 751 of shot 112059's 893 079 EPW pixels (``tests/test_torch_feature_detector.py``).
    """
    if ksize % 2 == 0 or ksize < 9:
        raise ValueError(f"ksize {ksize}: OpenCV builds kernels of at most 7 taps from tables, not by this rule")
    sigma = ksize * 0.15 + 0.35
    scale = -0.125 / (sigma * sigma)
    half = ksize // 2
    outer = [math.exp(float(x * x) * scale) for x in range(1 - ksize, 0, 2)]
    total = 0.0
    for v in outer:
        total += v
    inverse = 1.0 / (2.0 * total + 1.0)
    taps = np.zeros(ksize, np.int64)
    err = 0.0
    for i, v in enumerate(outer):
        adjusted = v * inverse * 256.0 + err
        taps[i] = taps[ksize - 1 - i] = int(np.rint(adjusted))
        err = adjusted - float(taps[i])
    taps[half] = 256 - 2 * int(taps[:half].sum())
    return taps


def _gaussian_blur_u8(img, ksize=21):
    """``cv.GaussianBlur(img, (ksize, ksize), 0)`` of a uint8 image, bit for bit.

    OpenCV's fixed-point path: the row pass sums taps x pixels as integers (8 fraction bits), the column pass sums
    taps x row sums (16 fraction bits), and the result is (sum + 2^15) >> 16; both passes reflect at the border
    without repeating the edge pixel (``BORDER_REFLECT_101``, scipy's "mirror").  Every partial sum is an integer
    below 2^25, so float64 correlations hold them exactly.
    """
    taps = _gaussian_taps_u8(ksize).astype(np.float64)
    rows = ndimage.correlate1d(img.astype(np.float64), taps, axis=1, mode="mirror")
    both = ndimage.correlate1d(rows, taps, axis=0, mode="mirror")
    return ((both.astype(np.int64) + (1 << 15)) >> 16).clip(0, 255).astype(np.uint8)


def _notch_filter(img, config):
    """The blurred EPW image split at the notch: (red part, blue part)."""
    blur = _gaussian_blur_u8(img, 21)
    start, end = _NOTCH_ROWS
    off = 200 if config["other"]["extraoptions"]["spectype"] == "temporal" else 150
    return blur[end - off:, :], blur[:start - off, :]


def _morphological_opening(img):
    """Erosion then dilation with square kernels of 3, 5 and 7 pixels in turn; the edge pixels repeat beyond the
    border (scipy's "nearest"), which is what ``cv.erode``/``cv.dilate`` do at their default border."""
    for k in (3, 5, 7):
        img = ndimage.grey_dilation(ndimage.grey_erosion(img, size=(k, k), mode="nearest"), size=(k, k),
                                    mode="nearest")
    return img


def _fma32(a, b, c):
    """float32 a * b + c with one rounding: the product of two float32 values is exact in float64, and at the
    Sobel pass's magnitudes (integers below 2^11 times 1/3060) so is the sum."""
    return (a.astype(np.float64) * np.float64(b) + c.astype(np.float64)).astype(_f32)


def _sobel_3(img):
    """OpenCV's float32 Sobel derivatives of a uint8 image with aperture 3 and ``cornerMinEigenVal``'s scale
    1 / (4 x 3 x 255): (d/dx, d/dy), ``BORDER_REFLECT_101``, in the order OpenCV evaluates them.

    d/dx: the row difference (exact), then the column smoothing as fma(above + below, s, 2 s x centre).  d/dy: the
    row smoothing, then the column difference (exact).  OpenCV's row smoothing runs a fused multiply-add chain
    (left, centre, right) over the whole 32-pixel blocks of a row and plain products and sums over the columns
    after them; each is reproduced where OpenCV runs it.
    """
    s = _f32(1.0 / (4 * 3 * 255.0))
    s2 = _f32(2) * s
    p = np.pad(img, 1, mode="reflect").astype(_f32)
    r = p[:, 2:] - p[:, :-2]
    dx = _fma32(r[:-2] + r[2:], s, s2 * r[1:-1])
    left, centre, right = p[:, :-2], p[:, 1:-1], p[:, 2:]
    q = (left * s + centre * s2) + right * s
    v = img.shape[1] // 32 * 32
    q[:, :v] = _fma32(right[:, :v], s, _fma32(centre[:, :v], s2, left[:, :v] * s))
    dy = q[2:] - q[:-2]
    return dx, dy


def _box_sums_3(plane):
    """OpenCV's unnormalised 3 x 3 box sums of a float32 plane (``BORDER_REFLECT_101``): each row's three sums in
    float64, then a running float64 column sum down the image that adds the row below and takes away the row above,
    rounded to float32 as it is written."""
    p = np.pad(plane, 1, mode="reflect").astype(np.float64)
    rows = (p[:, :-2] + p[:, 1:-1]) + p[:, 2:]
    out = np.empty(plane.shape, _f32)
    running = rows[0] + rows[1]
    for y in range(plane.shape[0]):
        total = running + rows[y + 2]
        out[y] = total
        running = total - rows[y]
    return out


def _min_eigenvalues(img):
    """``cv.cornerMinEigenVal(img, 3, 3)`` of a uint8 image, float32, bit for bit."""
    dx, dy = _sobel_3(img)
    a = _box_sums_3(dx * dx) * _f32(0.5)
    b = _box_sums_3(dx * dy)
    c = _box_sums_3(dy * dy) * _f32(0.5)
    t = a - c
    return (a + c) - np.sqrt(t * t + b * b)


def _good_features_to_track(img, max_corners=100, quality=0.1, min_distance=10):
    """``cv.goodFeaturesToTrack(img, max_corners, quality, min_distance)`` of a uint8 image: the corners as
    integer (x, y) rows [N, 2], in OpenCV's order, or None where OpenCV returns None (no corner at all).

    The smallest eigenvalue; values at or below float32(quality x max) set to 0; the non-zero pixels off the
    one-pixel border that equal the largest value of their 3 x 3 neighbourhood; those sorted by value, larger
    first, and among equal values the later in raster order first (OpenCV's tie rule: the larger address); then,
    in that order, each one kept unless a kept corner lies closer than ``min_distance``, up to ``max_corners``.
    """
    eig = _min_eigenvalues(img)
    eig[eig <= _f32(float(eig.max()) * quality)] = 0
    peak = ndimage.grey_dilation(eig, size=(3, 3), mode="nearest")
    inner = np.zeros(eig.shape, bool)
    inner[1:-1, 1:-1] = True
    ys, xs = np.nonzero(inner & (eig != 0) & (eig == peak))
    if len(ys) == 0:
        return None
    order = np.lexsort((ys * eig.shape[1] + xs, eig[ys, xs]))[::-1]
    kept = np.empty((0, 2), np.int64)
    for y, x in zip(ys[order], xs[order]):
        if len(kept) and ((kept[:, 0] - x) ** 2 + (kept[:, 1] - y) ** 2 < min_distance * min_distance).any():
            continue
        kept = np.vstack([kept, [[x, y]]])
        if len(kept) == max_corners:
            break
    return kept


def _data_analysis(img, config):
    """The bounding box of the corners that have a neighbour within ``_NEIGHBOUR_DISTANCE``, widened by the
    deck's buffers: (min x, max x, min y, max y) in pixels of ``img``."""
    corners = _good_features_to_track(img, 100, 0.1, 10)
    if corners is None:
        raise TypeError("the feature detector found no corner in the image (no local maximum of the smallest "
                        "eigenvalue above its quality threshold)")
    d2 = np.sum((corners[:, None, :] - corners[None, :, :]) ** 2, axis=-1).astype(float)
    np.fill_diagonal(d2, np.inf)
    filtered = corners[d2.min(axis=1) <= _NEIGHBOUR_DISTANCE**2]
    if len(filtered) == 0:
        raise ValueError(f"the feature detector found {len(corners)} corner(s), none with another within "
                         f"{_NEIGHBOUR_DISTANCE} pixels: there is no box to take")

    min_x, max_x = filtered[:, 0].min(), filtered[:, 0].max()
    min_y, max_y = filtered[:, 1].min(), filtered[:, 1].max()

    buf = config["feature_detector"]["buffer"]
    return (
        min_x - buf["lineout_start"],
        max_x + buf["lineout_end"],
        min_y - buf["spectral_start"],
        max_y + buf["spectral_end"],
    )


def first_guess(elecData, ionData, config):
    """The detected lineout range and fit windows in pixels, as the JAX package's ``first_guess`` returns them.

    IAW only: (lineout end, lineout start, iaw_cf_min, iaw_cf_max, iaw_max, iaw_min).  EPW only: (lineout end,
    lineout start, blue_min, blue_max, red_min, red_max).  Both: (EPW lineout end, EPW lineout start, iaw_cf_min,
    iaw_cf_max, iaw_max, iaw_min, ion_t0_shift, blue_min, blue_max, red_min, red_max).  A box with inverted bounds
    raises ``ValueError``.
    """
    temporal = config["other"]["extraoptions"]["spectype"] == "temporal"

    def iaw_detector():
        img = _morphological_opening(_data_processing(ionData, config, "IAW"))
        min_x, max_x, min_y, max_y = _data_analysis(img, config)
        lineout_start, lineout_end = min_x, max_x
        if temporal:
            iaw_max, iaw_min = max_y + 150, min_y + 150
        else:
            iaw_max, iaw_min = max_y, min_y
        iaw_cf = (iaw_max - iaw_min) * 0.2
        midpoint = (iaw_max + iaw_min) / 2
        return lineout_end, lineout_start, midpoint - iaw_cf, midpoint + iaw_cf, iaw_max, iaw_min

    def epw_detector():
        img = _data_processing(elecData, config, "EPW")
        red, blue = _notch_filter(img, config)
        rx0, rx1, ry0, ry1 = _data_analysis(_morphological_opening(red), config)
        bx0, bx1, by0, by1 = _data_analysis(_morphological_opening(blue), config)
        a = 200 if temporal else 150
        b = _NOTCH_ROWS[1]
        return rx1, rx0, by0 + b, by1 + b, ry0 + a, ry1 + a

    fd = config["feature_detector"]
    if fd["estimate_lineouts_iaw"] and not fd["estimate_lineouts_epw"]:
        out = iaw_detector()
        lineout_end, lineout_start, _, _, iaw_max, iaw_min = out
        if lineout_end < lineout_start or iaw_min > iaw_max:
            raise ValueError("IAW feature detector failed (inverted bounds)")
        return out

    if fd["estimate_lineouts_epw"] and not fd["estimate_lineouts_iaw"]:
        out = epw_detector()
        lineout_end, lineout_start, blue_min, blue_max, red_min, red_max = out
        if lineout_end < lineout_start or blue_min > blue_max or red_min > red_max:
            raise ValueError("EPW feature detector failed (inverted bounds)")
        return out

    if fd["estimate_lineouts_epw"] and fd["estimate_lineouts_iaw"]:
        iaw_end, iaw_start, iaw_cf_min, iaw_cf_max, iaw_max, iaw_min = iaw_detector()
        epw_end, epw_start, blue_min, blue_max, red_min, red_max = epw_detector()
        if epw_end < epw_start or blue_min > blue_max or red_min > red_max:
            raise ValueError("EPW feature detector failed (inverted bounds)")
        if iaw_start > iaw_end or iaw_min > iaw_max:
            raise ValueError("IAW feature detector failed (inverted bounds)")
        ion_t0_shift = 0 if iaw_start == epw_start else epw_start - iaw_start
        return (
            epw_end, epw_start, iaw_cf_min, iaw_cf_max, iaw_max, iaw_min,
            ion_t0_shift, blue_min, blue_max, red_min, red_max,
        )
