"""Spectral throughput (optics transmission) correction.

A copy of ``tsadar_tpu.utils.process.correct_throughput``, reading the port's own
copies of the throughput tables (``tsadar_tpu_torch/external/*.npz``).
"""

import os

import numpy as np
import scipy.interpolate as sp

_EXTERNAL = os.path.join(os.path.dirname(__file__), "..", "..", "external")


def correctThroughput(data, tstype, axisy, shotNum):
    if tstype == "angular":
        speccal = np.load(os.path.join(_EXTERNAL, "throughput.npz"))["speccal"]
        if shotNum < 95000:
            vq1 = 1.0 / speccal
        else:
            specax = np.arange(0, 1024) * 0.214116 + 449.5272
            interp = sp.interp1d(specax, speccal, "linear", bounds_error=False, fill_value=speccal[0])
            vq1 = 1.0 / interp(axisy)
    elif tstype == "temporal":
        sens = np.load(os.path.join(_EXTERNAL, "throughput_temporal.npz"))["sens"].copy()
        sens[:, 1] = 1.0 / sens[:, 1]
        sens[0:17, 1] = sens[18, 1]  # sensitivity ~0 there; unusable
        interp = sp.interp1d(sens[:, 0], sens[:, 1], "linear", bounds_error=False, fill_value=sens[0, 1])
        vq1 = interp(axisy)
    else:
        sens = np.load(os.path.join(_EXTERNAL, "throughput.npz"))["sens"].copy()
        sens[:, 1] = 1.0 / sens[:, 1]
        sens[0:17, 1] = sens[18, 1]
        interp = sp.interp1d(sens[:, 0], sens[:, 1], "linear", bounds_error=False, fill_value=sens[0, 1])
        vq1 = interp(axisy)

    C = np.tile(np.asarray(vq1).reshape(-1, 1), (1, data.shape[1]))
    C[np.isnan(C)] = 0
    return data * C
