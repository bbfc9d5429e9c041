"""Calibrations of the OMEGA Thomson diagnostic: a copy of ``tsadar_tpu.utils.data_handling.calibration``.

The probe-beam scattering angles and aperture weights (instrument facts, kept
verbatim), the angular (ARTS) geometry -- the fine scattering angles, the
[camera angle, fine angle] weight matrix and the camera's angle axis, from the
port's own copy of ``arts_angular.npz`` -- and the shot-ranged spectral and
time/space calibrations of the angular, temporal and imaging instruments.
"""

import os
from typing import Dict

import numpy as np

# (sa_start, sa_end, weights) per OMEGA probe beam
_BEAMS = {
    "P9": (
        53.637560,
        66.1191,
        [0.00702671050853565, 0.0391423809738300, 0.0917976667717670, 0.150308544660150,
         0.189541011666141, 0.195351560740507, 0.164271879645061, 0.106526733030044,
         0.0474753389486960, 0.00855817305526778],
    ),
    "B12": (
        71.0195, 83.3160,
        [0.007702, 0.0404, 0.09193, 0.1479, 0.1860, 0.1918, 0.1652, 0.1083, 0.05063, 0.01004],
    ),
    "B15": (
        12.0404, 24.0132,
        [0.0093239, 0.04189, 0.0912121, 0.145579, 0.182019, 0.188055, 0.163506, 0.1104,
         0.0546822, 0.0133327],
    ),
    "B23": (
        72.281, 84.3307,
        [0.00945903, 0.0430611, 0.0925634, 0.146705, 0.182694, 0.1881, 0.162876, 0.109319,
         0.0530607, 0.0121616],
    ),
    "B26": (
        55.5636, 68.1058,
        [0.00648619, 0.0386019, 0.0913923, 0.150489, 0.190622, 0.195171, 0.166389, 0.105671,
         0.0470249, 0.00815279],
    ),
    "B35": (
        32.3804, 44.6341,
        [0.00851313, 0.0417549, 0.0926084, 0.149182, 0.187019, 0.191523, 0.16265, 0.106842,
         0.049187, 0.0107202],
    ),
    "B42": (
        155.667, 167.744,
        [0.00490969, 0.0257646, 0.0601324, 0.106076, 0.155308, 0.187604, 0.19328, 0.15702,
         0.0886447, 0.0212603],
    ),
    "B46": (
        56.5615, 69.1863,
        [0.00608081, 0.0374307, 0.0906716, 0.140714, 0.191253, 0.197333, 0.166164, 0.106121,
         0.0464844, 0.0077474],
    ),
    "B58": (
        119.093, 131.666,
        [0.00549525, 0.0337372, 0.0819783, 0.140084, 0.186388, 0.19855, 0.174136, 0.117517,
         0.0527003, 0.00941399],
    ),
    "B62": (
        147.818, 160.129,
        [0.0049997747, 0.0280167560, 0.0686455565, 0.1195892076, 0.1689113103, 0.1943155713,
         0.1876041619, 0.1412098554, 0.0715283095, 0.0151794964],
    ),
}


def sa_lookup(beam: str) -> Dict:
    """Scattering angles (10, degrees) and aperture weights of an OMEGA probe beam."""
    if beam not in _BEAMS:
        raise NotImplementedError("Other probe geometries are not yet supported")
    lo, hi, weights = _BEAMS[beam]
    return dict(sa=np.linspace(lo, hi, 10), weights=np.array(weights))


_EXTERNAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "external")


def _arts_assets():
    d = np.load(os.path.join(_EXTERNAL, "arts_angular.npz"))
    return d["angsFRED"], d["weightMatrix"]


def get_scattering_angles(config: Dict) -> Dict:
    """Scattering-angle dict from the deck: the probe beam's, or for spectype "angular" the ARTS
    geometry (241 fine angles and the [1024, 241] weight matrix)."""
    if config["other"]["extraoptions"]["spectype"] != "angular":
        return sa_lookup(config["data"]["probe_beam"])
    _, weights = _arts_assets()
    return dict(sa=np.arange(19, 139.5, 0.5), weights=weights)


def get_calibrations(shotNum, tstype, t0, CCDsize):
    """Shot-ranged dispersions, offsets, IRF widths, and axis scales of the OMEGA instruments.

    Returns (axisxE, axisxI, axisyE, axisyI, magE, stddev) for spectype
    "angular" (ARTS: the camera's angle axis as axisxE), "temporal" (streaked:
    time axes from t0 and the sweep magnification) and "imaging" (space axes
    about the target-chamber centre); the numbers are instrument facts, kept
    verbatim from ``tsadar_tpu.utils.data_handling.calibration``.
    """
    stddev = {}
    if tstype == "angular":
        if shotNum < 95000:
            EPWDisp, EPWoff = 0.214116, 449.5272
        else:  # calibrations from 7-26-22 pending upstream, same for >=105000
            EPWDisp, EPWoff = 0.2129, 439.8
        IAWDisp, IAWoff = 1, 1  # ARTS does not measure ion spectra
        stddev["spect_stddev_ion"] = 1
        magE = 1
        stddev["spect_FWHM_ele"] = 0.9  # ~0.8-0.9 for H2
        stddev["spect_stddev_ele"] = stddev["spect_FWHM_ele"] / 2.3548
        stddev["ang_FWHM_ele"] = 1  # ~1-1.2

    elif tstype == "temporal":
        if 98610 < shotNum < 98620:
            EPWDisp, IAWDisp = 0.4104, 0.00678
            EPWoff, IAWoff = 319.3, 522.894
            stddev["spect_stddev_ion"] = 0.0238
            stddev["spect_stddev_ele"] = 1.4294
            magI = magE = 5
        elif shotNum < 105000:
            EPWDisp, IAWDisp = 0.4104, 0.00678
            EPWoff, IAWoff = 319.3, 523.1
            stddev["spect_stddev_ion"] = 0.02262
            stddev["spect_stddev_ele"] = 1.4294
            magI = magE = 5
        elif shotNum < 108950:  # shot 108135 calibrations
            EPWDisp, IAWDisp = 0.4104, 0.005749
            EPWoff, IAWoff = 319.3, 523.3438
            stddev["spect_stddev_ion"] = 0.0153
            stddev["spect_stddev_ele"] = 1.4294
            magI = magE = 5
        elif shotNum < 108990:  # shots 108964-
            EPWDisp, IAWDisp = 0.4104, 0.00959
            EPWoff, IAWoff = 135.0, 346.09
            stddev["spect_stddev_ion"] = 0.0153
            stddev["spect_stddev_ele"] = 1.4294
            magI = magE = 5
        elif 111410 < shotNum < 111435:
            EPWDisp, IAWDisp = 0.4104, 0.00678
            EPWoff, IAWoff = 317.4, 522.92
            stddev["spect_stddev_ion"] = 0.0153
            stddev["spect_stddev_ele"] = 0.668  # from Hg lamp data
            magI, magE = 5.23, 5.35
        elif 114907 < shotNum < 115920:  # 3w CBET study
            EPWDisp, IAWDisp = 0.4153, 0.00366
            EPWoff, IAWoff = 135.74, 349.10
            stddev["spect_stddev_ion"] = 0.0153
            stddev["spect_stddev_ele"] = 0.668
            magI, magE = 5.23, 5.35
        else:
            EPWDisp, IAWDisp = 0.4104, 0.00678
            EPWoff, IAWoff = 319.3, 522.90
            stddev["spect_stddev_ion"] = 0.02262
            stddev["spect_stddev_ele"] = 1.4294
            magI = magE = 5

    else:  # imaging
        if shotNum < 104000:
            EPWDisp, IAWDisp = 0.27093, 0.00438
            EPWoff, IAWoff = 396.256, 524.275
            stddev["spect_stddev_ion"] = 0.028
            stddev["spect_stddev_ele"] = 1.4365
            magI, magE = 2.87, 5.10
            EPWtcc = 1024 - 456.1
            IAWtcc = 1024 - 519
        elif 106303 <= shotNum <= 106321:  # refractive telescope 11/8/22
            EPWDisp, IAWDisp = 0.27594, 0.00437
            EPWoff, IAWoff = 388.256, 524.345
            stddev["spect_stddev_ion"] = 0.028
            stddev["spect_stddev_ele"] = 1.1024
            magI = 2.89 / 0.3746 * 1.118
            magE = 5.13 / 0.36175 * 1.118
            EPWtcc = 1024 - 503
            IAWtcc = 1024 - 568
        elif 107620 <= shotNum <= 107633:  # refractive telescope 3/9/23
            EPWDisp, IAWDisp = 0.27594, 0.005701
            EPWoff, IAWoff = 388.256, 524.345
            stddev["spect_stddev_ion"] = 0.028
            stddev["spect_stddev_ele"] = 1.1024
            magI = 2.89 / 0.3746 * 1.118
            magE = 5.13 / 0.36175 * 1.118
            EPWtcc = 1024 - 503
            IAWtcc = 1024 - 568
        elif shotNum == 112059:
            EPWDisp, IAWDisp = 0.277, 0.00448
            EPWoff, IAWoff = 381.141905, 524.1416133146356
            stddev["spect_stddev_ion"] = 0.007838851799629626
            stddev["spect_stddev_ele"] = 0.5348962893498197
            magI, magE = 2.88, 5.13
            EPWtcc = 544.6141
            IAWtcc = 526.4255994117018
        else:
            EPWDisp, IAWDisp = 0.27093, 0.00437
            EPWoff, IAWoff = 396.256, 524.275
            stddev["spect_stddev_ion"] = 0.028
            stddev["spect_stddev_ele"] = 1.4365
            magI = 2.89 * 1.079
            magE = 5.13 * 1.079
            EPWtcc = 1024 - 516
            IAWtcc = 1024 - 450

    axisy = np.arange(1, CCDsize[0] + 1)
    axisyE = axisy * EPWDisp + EPWoff  # nm
    axisyI = axisy * IAWDisp + IAWoff  # nm

    if tstype != "angular":
        axisx = np.arange(1, CCDsize[1] + 1)
        axisxE = (axisx - t0[1]) * magE  # ps or um
        axisxI = (axisx - t0[0]) * magI
        if tstype == "imaging":
            axisxE = axisxE - EPWtcc * magE
            axisxI = axisxI - IAWtcc * magI
    else:
        axisxE, _ = _arts_assets()
        axisxI = np.arange(1, CCDsize[1] + 1)

    return axisxE, axisxI, axisyE, axisyI, magE, stddev
