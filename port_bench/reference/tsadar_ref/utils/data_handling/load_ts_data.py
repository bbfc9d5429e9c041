"""OMEGA shot-data loader (HDF4 streak/CCD frames), a copy of ``tsadar_tpu.utils.data_handling.load_ts_data``.

Each shot file holds two stacked frames (signal, background); the
signal is the frame difference; each diagnostic gets an orientation fix; streaked
data optionally gets its t0 from the timing-fiducial comb; temporal EPW data is
dewarped. Uses the pure-Python HDF4 reader (pyhdf is not a dependency).
"""

import os
from os.path import join

import numpy as np
from scipy.signal import find_peaks

from .hdf4 import read_sds
from ..console import log_info
from ..process.warpcorr import (
    EPW5_COMB_ROWS,
    _COMB_PROMINENCE,
    _COMB_WIDTH,
    _comb_tooth_centers,
    perform_warp_correction,
)

# The OMEGA shot files are read where the repository keeps them, beside the JAX
# package (a data directory, not an import); ``data.filenames`` in a deck names
# another directory (``prepare._custom_data_dir``).
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), *[".."] * 5, "tsadar_tpu", "external", "data")

# Fiducial comb geometry (streak cameras): the comb lives in a fixed row band of
# the image, and t0 sits a fixed number of pixels left of the first comb tooth.
# The EPW constants are shared with warpcorr (single source of truth: the
# dewarp anchors its time map at the first chain tooth precisely so that this
# module's t0 detection on the dewarped frame is unchanged).
_FIDUCIAL = {
    "iaw": {"rows": slice(850, 950), "t0_offset_px": 164},
    "epw": {"rows": EPW5_COMB_ROWS, "t0_offset_px": 95},
}
_PEAK_PROMINENCE = _COMB_PROMINENCE
_PEAK_WIDTH = _COMB_WIDTH

# Diagnostic type is encoded in the filename: streaked instruments have no
# "ccd" tag; ATS files are the angular spectrometer.
_AXIS_LABELS = {
    "temporal": "Time (ps)",
    "imaging": r"Radius (\mum)",
    "angular": "Scattering angle (degrees)",
}


def _classify(filename):
    """Map a shot filename to (channel, spectype) or None if unrelated."""
    low = filename.casefold()
    if "ats" in low:
        return "epw", "angular"
    for channel in ("epw", "iaw"):
        if channel in low:
            return channel, ("imaging" if "ccd" in low else "temporal")
    return None


def _signal_frame(path):
    """Signal = frame 0 minus frame 1 (background exposure), as float."""
    frames = read_sds(path).astype(float)
    return frames[0] - frames[1]


def _fiducial_t0(image, channel):
    """Locate t0 from the timing-fiducial comb; returns a pixel offset.

    The comb is summed over its row band; the first tooth's mid-point (between
    its interpolated half-height edges) minus the per-channel offset is t0.

    EPW: anchors on the first CHAIN-FILTERED tooth (warpcorr's pip-spacing
    filter) rather than the raw first peak — the validated shot's comb band
    carries a bright non-pip feature 182 px (1.66 pip intervals) before the
    first real pip, which would shift t0 ~910 ps.  (Deliberate deviation from
    the reference, which takes the raw first peak; documented because the
    offset constants are shared.)  IAW keeps the raw first peak: its pip
    interval in pixels depends on the IAW camera's sweep calibration, which
    this module does not assume.
    """
    geo = _FIDUCIAL[channel]
    if channel == "epw":
        teeth = _comb_tooth_centers(image, comb_rows=geo["rows"])
        if teeth is not None:
            return round(float(teeth[0]) - geo["t0_offset_px"])
    comb = image[geo["rows"], :].sum(axis=0)
    _, props = find_peaks(comb, prominence=_PEAK_PROMINENCE, width=_PEAK_WIDTH)
    first_tooth = 0.5 * (props["left_ips"][0] + props["right_ips"][0])
    return round(first_tooth - geo["t0_offset_px"])


_NOTCH_LAMBDA = 528.0  # iaw notch filter center wavelength [nm] (instrument)


def _notch_target_row(sNum, shape):
    """Calibration row of the notch center wavelength for this shot's range.

    Gives the fiducial dewarp its ABSOLUTE spectral anchor (the row where the
    shot-ranged wavelength calibration expects the notch filter's center) —
    t0-independent, so it can be computed before the fiducial timing.
    Returns None (relative anchoring) if the calibration is unavailable.
    """
    try:
        from ..calibration import get_calibrations

        _, _, axisyE, _, _, _ = get_calibrations(int(sNum), "temporal", [0.0, 0.0], list(shape))
        return float(np.interp(_NOTCH_LAMBDA, np.asarray(axisyE).ravel(), np.arange(shape[0])))
    except Exception as e:
        log_info(f"notch target row unavailable ({e}); using relative spectral anchoring")
        return None


def loadData(sNum, sDay, loadspecs, custom_path=None):
    """Load electron/ion frames for a shot number; detect spectype from filenames.

    Returns ``(eDat, iDat, xlab, t0, specType)``. Channels that fail to load are
    returned as ``[]`` with their ``loadspecs`` flag cleared; if neither channel
    loads, raises LookupError.
    """
    folder = custom_path if custom_path else DATA_DIR
    paths = {}
    spec_type = None
    for name in os.listdir(folder):
        if str(sNum) not in name:
            continue
        tagged = _classify(name)
        if tagged is not None:
            channel, spec_type = tagged
            paths[channel] = join(folder, name)

    xlab = _AXIS_LABELS.get(spec_type)
    t0 = [0, 0]
    want_t0 = loadspecs.get("absolute_timing", False)

    iDat = []
    if loadspecs["load_ion_spec"]:
        try:
            iDat = np.flipud(_signal_frame(paths["iaw"]))
            if spec_type == "imaging":
                iDat = np.rot90(np.squeeze(iDat))
            elif want_t0:
                t0[0] = _fiducial_t0(iDat, "iaw")
        except Exception as e:
            log_info(f"Unable to find IAW ({e})")
            iDat = []
            loadspecs["load_ion_spec"] = False

    eDat = []
    if loadspecs["load_ele_spec"]:
        try:
            eDat = _signal_frame(paths["epw"])
            if spec_type == "angular":
                eDat = np.fliplr(eDat)
            elif spec_type == "temporal":
                # fiducial_dewarp (default on): when the reference's warp maps
                # are missing, reconstruct a low-order approximation from the
                # in-frame timing comb + notch tracers (warpcorr module doc) —
                # closer to the reference's dewarped-data behavior than the
                # identity fallback; falls back to identity if tracers are
                # absent.  Disable with extraoptions.fiducial_dewarp: false.
                shape = eDat.shape
                eDat = perform_warp_correction(
                    eDat,
                    fiducial_fallback=loadspecs.get("fiducial_dewarp", True),
                    # lazy: evaluated only if the reconstruction actually runs
                    notch_target_row=lambda: _notch_target_row(sNum, shape),
                )
            elif spec_type == "imaging":
                eDat = np.rot90(np.squeeze(eDat), 3)
            if spec_type == "temporal" and want_t0:
                try:
                    t0[1] = _fiducial_t0(eDat, "epw")
                except Exception:
                    log_info("Fiducial timing encountered an error, default timing is being used")
        except Exception as e:
            log_info(f"Unable to find EPW ({e})")
            eDat = []
            loadspecs["load_ele_spec"] = False

    if not loadspecs["load_ele_spec"] and not loadspecs["load_ion_spec"]:
        raise LookupError(f"No data found for shotnumber {sNum} in the data folder")

    return eDat, iDat, xlab, t0, spec_type
