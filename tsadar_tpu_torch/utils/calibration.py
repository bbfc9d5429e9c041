"""Probe-beam scattering angles and aperture weights of the OMEGA Thomson diagnostic.

A copy of the beam table of ``tsadar_tpu.utils.data_handling.calibration``
(instrument facts, kept verbatim).  The ARTS (angular) geometry is not ported
yet.
"""

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


def get_scattering_angles(config: Dict) -> Dict:
    """Scattering-angle dict of the deck's probe beam (non-angular spectypes)."""
    if config["other"]["extraoptions"]["spectype"] == "angular":
        raise NotImplementedError("the ARTS angular geometry is not ported yet (ROADMAP.md §1 item 12)")
    return sa_lookup(config["data"]["probe_beam"])
