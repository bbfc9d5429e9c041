"""What the fit loops and the postprocess share: the loss's batches from prepared data, and tensors back as numpy.

* ``angular_batch``: the ARTS batch of a resolution-unit window, the
  counterpart of ``tsadar_tpu.inverse.loops._angular_batch``;
* ``to_numpy``: a tensor, a dict of them or an array-like as numpy, on the host.
"""

import numpy as np
import torch


def angular_batch(all_data, sl, rot=False):
    """ARTS batch for the resolution-unit window ``sl``: the electron channels are windowed (from the second
    shot's ``*_rot`` channels with ``rot``), the ion channels stay whole except the noise window."""
    return {
        "e_data": all_data["e_data_rot" if rot else "e_data"][sl, :],
        "e_amps": all_data["e_amps_rot" if rot else "e_amps"][sl, :],
        "noise_e": all_data["noiseE_rot" if rot else "noiseE"][sl, :],
        "i_data": all_data["i_data"],
        "i_amps": all_data["i_amps"],
        "noise_i": all_data["noiseI"][sl, :],
    }


def to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: to_numpy(x) for k, x in v.items()}
    return np.asarray(v)
