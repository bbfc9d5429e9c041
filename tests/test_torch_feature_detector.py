"""The port's lineout feature detector (``tsadar_tpu_torch.utils.process.feature_detector``) against OpenCV and
against the JAX package's detector.

The port reproduces, in numpy and scipy, the OpenCV calls that the JAX package makes; here ``cv2`` is the oracle
(the port never imports it).  Each image step is compared exactly, pixel for pixel and corner for corner, on the
frames that the detector reads from the repository's shots -- 101675 and 111411 (the temporal streak, EPW and
IAW, from ``configs/1d``) and 112059 (the imaging CCD, EPW and IAW, from ``tests/configs/detector_inputs.yaml``) --
and on seeded images, one of them made of flat plateaus whose corners tie in their eigenvalues:

* ``cv.GaussianBlur(img, (21, 21), 0)`` (the EPW frames, before the notch split; the noise images);
* the three openings (``cv.erode`` then ``cv.dilate``) of every image that the detector opens;
* ``cv.cornerMinEigenVal`` and ``cv.goodFeaturesToTrack(img, 100, 0.1, 10)`` on every opened image.

Then ``first_guess`` in each mode against the JAX package's on the same frames, ``prepare_data`` with the detector
on against the JAX package's (``same_scipy_fits``), the decks on which the JAX detector fails (the port raises the
same exception type), the JAX test's known values, and ``runner.run`` on the detected-window deck of shot 112059.
"""

import copy
import functools
from pathlib import Path

import cv2 as cv
import numpy as np
import pandas as pd
import pytest
import yaml

import chip_smoke as cs
import tsadar_tpu.utils.process.feature_detector as jax_fd
from tsadar_tpu.utils.process.prepare import prepare_data as jax_prepare
from tsadar_tpu_torch import runner
from tsadar_tpu_torch.inverse.fitter import _lineout_selection
from tsadar_tpu_torch.utils.config import merge_configs
from tsadar_tpu_torch.utils.process import feature_detector as fd
from tsadar_tpu_torch.utils.process import prepare
from tsadar_tpu_torch.utils.process.prepare import prepare_data

from .test_torch_data_pipeline import same_scipy_fits
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "tests" / "configs"
SHOTS = ("101675", "111411", "112059")
MODES = {"iaw": (True, False), "epw": (False, True), "both": (True, True)}


def _buffers(value):
    return {k: value for k in ("lineout_start", "lineout_end", "spectral_start", "spectral_end")}


def temporal_deck(shot, iaw=True, epw=False, buffer=20):
    """``configs/1d`` (the temporal streak, both frames loaded) at ``shot``, the raw-data visualizer off."""
    cfg = merge_configs(*[yaml.safe_load((ROOT / "configs" / "1d" / f"{n}.yaml").read_text()) for n in ("defaults", "inputs")])
    cfg["data"]["launch_data_visualizer"] = False
    cfg["data"]["shotnum"] = int(shot)
    cfg["data"]["lineouts"].update({"start": 535, "end": 735, "skip": 100})
    cfg["feature_detector"].update(estimate_lineouts_iaw=iaw, estimate_lineouts_epw=epw, buffer=_buffers(buffer))
    return _lineout_selection(cfg)


def detector_inputs(iaw=True, epw=True):
    """``tests/configs/detector_inputs.yaml`` (shot 112059, the imaging CCD, both frames; buffers 0)."""
    cfg = yaml.safe_load((CONFIGS / "detector_inputs.yaml").read_text())
    cfg["feature_detector"].update(estimate_lineouts_iaw=iaw, estimate_lineouts_epw=epw)
    return cfg


def main_deck(shot, iaw=False, epw=True):
    """The main deck (``tests/configs/time_test_*``, buffers 20, no ion frame) at ``shot``; at 112059 with the
    imaging test's pixel lineouts and adam."""
    cfg = merge_configs(*[yaml.safe_load((CONFIGS / f"time_test_{n}.yaml").read_text()) for n in ("defaults", "inputs")])
    cfg["data"]["launch_data_visualizer"] = False
    cfg["data"]["shotnum"] = shot
    if shot == 112059:
        cfg["data"]["lineouts"].update({"type": "pixel", "start": 500, "end": 510, "skip": 5})
        cfg["optimizer"].update({"method": "adam", "num_epochs": 30, "batch_size": 2})
    cfg["feature_detector"].update(estimate_lineouts_iaw=iaw, estimate_lineouts_epw=epw)
    return _lineout_selection(cfg)


class _Frames(Exception):
    pass


@functools.lru_cache(maxsize=None)
def frames(shot):
    """(EPW frame, ion frame, deck) as the port's ``prepare_data`` hands them to the detector."""
    cfg = detector_inputs() if shot == "112059" else temporal_deck(shot)

    def stop(elecData, ionData, config):
        raise _Frames(elecData, ionData, copy.deepcopy(config))

    real = prepare.first_guess
    prepare.first_guess = stop
    try:
        prepare_data(cfg, cfg["data"]["shotnum"])
    except _Frames as caught:
        return caught.args
    finally:
        prepare.first_guess = real
    raise AssertionError("prepare_data did not reach the detector")


def seeded(kind):
    """A seeded uint8 image: uniform noise, or flat plateaus (blocks of four grey levels, whose corners tie)."""
    rng = np.random.default_rng(17)
    if kind == "noise":
        return rng.integers(0, 256, (211, 247)).astype(np.uint8)
    blocks = rng.integers(0, 4, (28, 21)) * 60
    return np.repeat(np.repeat(blocks, 9, axis=0), 11, axis=1)[:250, :229].astype(np.uint8)


@functools.lru_cache(maxsize=None)
def image(name):
    """An image by name: ``<shot>/<EPW|IAW>`` the detector's uint8 frame, ``<shot>/<red|blue>`` the blurred EPW
    halves, ``seed/<kind>`` a seeded image; ``:opened`` after the three openings, as the detector takes them."""
    if name.endswith(":opened"):
        return fd._morphological_opening(image(name[:-len(":opened")]))
    source, part = name.split("/")
    if source == "seed":
        return seeded(part)
    elecData, ionData, cfg = frames(source)
    if part in ("EPW", "IAW"):
        return fd._data_processing(elecData if part == "EPW" else ionData, cfg, part)
    red, blue = fd._notch_filter(image(f"{source}/EPW"), cfg)
    return red if part == "red" else blue


def cv_opening(img):
    for k in (3, 5, 7):
        kernel = np.ones((k, k), np.uint8)
        img = cv.dilate(cv.erode(img, kernel, iterations=1), kernel, iterations=1)
    return img


BLURRED = [f"{s}/{w}" for s in SHOTS for w in ("EPW", "IAW")] + ["seed/noise", "seed/plateaus"]
OPENED = [f"{s}/{w}" for s in SHOTS for w in ("IAW", "red", "blue")] + ["seed/noise", "seed/plateaus"]


@pytest.mark.parametrize("name", BLURRED)
def test_blur_is_opencvs(name):
    img = image(name)
    got, want = fd._gaussian_blur_u8(img, 21), cv.GaussianBlur(img, (21, 21), 0)
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} pixels differ"


def test_the_blur_rounds_as_opencv_and_not_otherwise(monkeypatch):
    """The fixed-point scheme is what matches.  On shot 112059's EPW frame (893 079 pixels) a float64 separable
    Gaussian rounded to uint8 misses OpenCV's blur at thousands of pixels, and so do the same integer passes with
    taps rounded one by one (no error diffusion: 15 751 pixels); the port's blur at none.  Those taps move the
    EPW detector's box: its lineout end from 622 to 627 and its red window's end from 263 to 260."""
    img = image("112059/EPW")
    want = cv.GaussianBlur(img, (21, 21), 0)
    x = np.arange(-10, 11)
    g = np.exp(-x**2 / (2 * 3.5**2))
    g /= g.sum()
    smooth = np.rint(fd.ndimage.correlate1d(fd.ndimage.correlate1d(img.astype(float), g, axis=1, mode="mirror"), g,
                                            axis=0, mode="mirror")).astype(np.uint8)
    assert int((smooth != want).sum()) > 1000
    alone = np.rint(g * 256).astype(np.int64)
    alone[10] = 256 - 2 * alone[:10].sum()
    taps = fd._gaussian_taps_u8(21)
    assert taps.sum() == 256 and np.array_equal(taps, taps[::-1]) and not np.array_equal(alone, taps)
    rows = fd.ndimage.correlate1d(img.astype(float), alone.astype(float), axis=1, mode="mirror")
    unrounded = fd.ndimage.correlate1d(rows, alone.astype(float), axis=0, mode="mirror").astype(np.int64)
    assert int((((unrounded + (1 << 15)) >> 16).astype(np.uint8) != want).sum()) == 15751
    assert np.array_equal(fd._gaussian_blur_u8(img), want)
    elecData, ionData, cfg = frames("112059")
    cfg = copy.deepcopy(cfg)
    cfg["feature_detector"]["estimate_lineouts_iaw"] = False
    assert [int(v) for v in fd.first_guess(elecData, ionData, cfg)] == [622, 360, 749, 782, 209, 263]
    monkeypatch.setattr(fd, "_gaussian_taps_u8", lambda ksize: alone)
    assert [int(v) for v in fd.first_guess(elecData, ionData, cfg)] == [627, 361, 749, 782, 210, 260]


@pytest.mark.parametrize("name", OPENED)
def test_opening_is_opencvs(name):
    img = image(name)
    assert np.array_equal(fd._morphological_opening(img), cv_opening(img))


@pytest.mark.parametrize("name", OPENED)
def test_min_eigenvalues_are_opencvs(name):
    img = image(name + ":opened")
    got, want = fd._min_eigenvalues(img), cv.cornerMinEigenVal(img, 3, 3)
    assert got.dtype == np.float32
    assert np.array_equal(got, want), f"{int((got != want).sum())} pixels differ"


@pytest.mark.parametrize("name", OPENED)
def test_corners_are_opencvs(name):
    img = image(name + ":opened")
    want = cv.goodFeaturesToTrack(img, 100, 0.1, 10)
    got = fd._good_features_to_track(img, 100, 0.1, 10)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, np.intp(want).reshape(-1, 2))


def test_plateau_corners_tie_and_keep_opencvs_order():
    """The plateau image's corner candidates tie in their eigenvalues (OpenCV breaks ties by the later pixel
    first), and its corner list is OpenCV's in order."""
    img = image("seed/plateaus:opened")
    eig = fd._min_eigenvalues(img)
    corners = fd._good_features_to_track(img, 100, 0.1, 10)
    values = eig[corners[:, 1], corners[:, 0]]
    assert len(np.unique(values)) < len(values) // 2
    np.testing.assert_array_equal(corners, np.intp(cv.goodFeaturesToTrack(img, 100, 0.1, 10)).reshape(-1, 2))


def test_no_corner_at_all_raises_as_the_jax_package():
    flat = np.full((64, 64), 7, np.uint8)
    assert cv.goodFeaturesToTrack(flat, 100, 0.1, 10) is None and fd._good_features_to_track(flat) is None
    cfg = detector_inputs()
    with pytest.raises(TypeError):
        jax_fd._data_analysis(flat, cfg)
    with pytest.raises(TypeError, match="no corner"):
        fd._data_analysis(flat, cfg)


def _same_outcome(run_jax, run_port):
    """Both calls' results, equal value for value, or both raising the same exception type."""
    try:
        want = run_jax()
    except Exception as e:  # noqa: BLE001 -- the JAX package's failure is the expectation
        with pytest.raises(type(e)):
            run_port()
        return None
    got = run_port()
    assert [type(g) for g in got] == [type(w) for w in want]
    assert [float(g) for g in got] == [float(w) for w in want]
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shot", SHOTS)
def test_first_guess_is_jaxs(shot, mode):
    elecData, ionData, cfg = frames(shot)
    cfg = copy.deepcopy(cfg)
    cfg["feature_detector"]["estimate_lineouts_iaw"], cfg["feature_detector"]["estimate_lineouts_epw"] = MODES[mode]
    _same_outcome(lambda: jax_fd.first_guess(elecData, ionData, cfg), lambda: fd.first_guess(elecData, ionData, cfg))


def test_first_guess_fails_where_the_jax_package_fails():
    """Shot 101675's ion frame has one corner and no pair: the JAX package's reduction over no corners raises
    ``ValueError``, the port's names the cause."""
    elecData, ionData, cfg = frames("101675")
    with pytest.raises(ValueError):
        jax_fd.first_guess(elecData, ionData, cfg)
    with pytest.raises(ValueError, match="none with another within 100 pixels"):
        fd.first_guess(elecData, ionData, cfg)


def _detected(cfg):
    lo = cfg["data"]["lineouts"]
    return {"start": lo["start"], "end": lo["end"], "val": list(lo["val"]), "fit_rng": dict(cfg["data"]["fit_rng"]),
            "ion_t0_shift": cfg["data"]["ion_t0_shift"]}


PREPARED = {"detector_inputs": lambda: detector_inputs(), "main_112059_epw": lambda: main_deck(112059),
            "temporal_111411_both_b0": lambda: temporal_deck("111411", iaw=True, epw=True, buffer=0)}


@pytest.mark.parametrize("deck", PREPARED)
def test_prepare_data_is_jaxs(deck):
    cfg = PREPARED[deck]()
    jax_cfg, port_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    with same_scipy_fits():
        want = jax_prepare(jax_cfg, jax_cfg["data"]["shotnum"])[0]
        got = prepare_data(port_cfg, port_cfg["data"]["shotnum"])[0]
    assert _detected(port_cfg) == _detected(jax_cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_prepare_data_detects_the_112059_windows():
    """The detected-window deck of shot 112059 (``chip_smoke.detector_decks``): the windows and pixels that
    ``chip_smoke.py``'s ``detector_112059_fit`` pins on the card's machine (DETECTOR_WINDOWS, DETECTOR_PIXELS: 61
    detected lineouts at skip 5, trimmed to 60 for batches of 20) are the JAX package's, and the port's."""
    cfg = detector_deck(num_epochs=1)
    jax_cfg, port_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    with same_scipy_fits():
        jax_prepare(jax_cfg, jax_cfg["data"]["shotnum"])
        prepare_data(port_cfg, port_cfg["data"]["shotnum"])
    for got in (jax_cfg, port_cfg):
        lo, rng = got["data"]["lineouts"], got["data"]["fit_rng"]
        detected = {"start": lo["start"], "end": lo["end"], **{k: rng[k] for k in ("blue_min", "blue_max", "red_min", "red_max")}}
        assert sorted(detected) == sorted(cs.DETECTOR_WINDOWS)
        for k, v in cs.DETECTOR_WINDOWS.items():
            assert abs(detected[k] - v) <= cs.DETECTOR_WINDOW_TOL, k
        assert lo["val"] == cs.DETECTOR_PIXELS


FAILING = {  # the deck, and the exception type of the JAX package's prepare_data on it
    "main_101675_epw": (lambda: main_deck(101675), IndexError),  # the box plus 20 ends at pixel 1029
    "main_111411_epw": (lambda: main_deck(111411), IndexError),  # ... at pixel 1028
    "temporal_101675_iaw": (lambda: temporal_deck("101675"), ValueError),  # no corner has a neighbour
    "main_112059_iaw": (lambda: main_deck(112059, iaw=True, epw=False), TypeError),  # no ion frame loaded
}


@pytest.mark.parametrize("deck", FAILING)
def test_prepare_data_fails_where_the_jax_package_fails(deck):
    make, error = FAILING[deck]
    cfg = make()
    with same_scipy_fits():
        with pytest.raises(error):
            jax_prepare(copy.deepcopy(cfg), cfg["data"]["shotnum"])
        with pytest.raises(error, match="feature detector"):
            prepare_data(copy.deepcopy(cfg), cfg["data"]["shotnum"])


def test_feature_detector_known_values():
    """``tests/test_data_pipeline/test_pipeline.py::test_feature_detector`` on the port."""
    cfg = detector_inputs()
    prepare_data(cfg, cfg["data"]["shotnum"])
    known_values = {"lineout_start": -900, "lineout_end": 402, "iaw_min": 526.23, "iaw_max": 526.58, "iaw_cf_min": 526.33,
                    "iaw_cf_max": 526.47, "blue_min": 588, "blue_max": 598, "red_min": 454, "red_max": 439}
    np.testing.assert_allclose(cfg["data"]["lineouts"]["start"], known_values["lineout_start"], rtol=1e-1)
    np.testing.assert_allclose(cfg["data"]["lineouts"]["end"], known_values["lineout_end"], rtol=1e-1)
    for k in ("iaw_min", "iaw_max", "iaw_cf_min", "iaw_cf_max", "blue_min", "blue_max", "red_min", "red_max"):
        np.testing.assert_allclose(cfg["data"]["fit_rng"][k], known_values[k], rtol=1e-1)


def detector_decks(num_epochs):
    """(defaults, inputs) of ``chip_smoke.py``'s detected-window deck with ``num_epochs`` adam epochs."""
    defaults, inputs = cs.detector_decks()
    inputs["optimizer"]["num_epochs"] = num_epochs
    return defaults, inputs


def detector_deck(num_epochs):
    return _lineout_selection(merge_configs(*detector_decks(num_epochs)))


def test_runner_fits_the_detected_windows(tmp_path, monkeypatch):
    """``runner.run`` of the detected-window deck cut to one epoch, on the CPU: 60 rows of
    ``learned_parameters.csv`` at the detected pixels, every fitted value finite."""
    deck = tmp_path / "deck"
    deck.mkdir()
    for name, d in zip(("defaults", "inputs"), detector_decks(num_epochs=1)):
        (deck / f"{name}.yaml").write_text(yaml.safe_dump(d))
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    run_id = runner.run(str(deck), "fit", device="cpu")
    (run_dir,) = [p.parent for p in (tmp_path / "runs").rglob("run.json") if p.parent.name.endswith(run_id)]
    table = pd.read_csv(run_dir / "artifacts" / "csv" / "learned_parameters.csv", index_col=0)
    assert len(table) == 60
    np.testing.assert_array_equal(table["lineout pixel"].to_numpy(), cs.DETECTOR_PIXELS)
    assert np.isfinite(table.select_dtypes("number").to_numpy()).all()
