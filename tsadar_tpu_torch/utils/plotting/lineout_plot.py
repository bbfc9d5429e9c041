"""Data, fit and squared deviation of a few lineouts: ``tsadar_tpu.utils.plotting.lineout_plot``'s figure."""

import os

import numpy as np

from . import subplots


def lineout_plot(sorted_data, sorted_fits, sorted_sqdev, yaxis, sorted_x, xlabel, s_ind, e_ind, td, tag):
    """A column a lineout, each cut to ``[s_ind[i], e_ind[i])`` of ``yaxis``: data and fit above, the squared
    deviation below; ``td/lineouts_{tag}.png``."""
    num = len(sorted_data)
    fig, ax = subplots(2, num, figsize=(4 * num, 6), tight_layout=True, squeeze=False, sharex=True)
    for i in range(num):
        cut = slice(s_ind[i], e_ind[i])
        ax[0][i].plot(yaxis[cut], np.squeeze(sorted_data[i][cut]), label="Data")
        ax[0][i].plot(yaxis[cut], np.squeeze(sorted_fits[i][cut]), label="Fit")
        ax[0][i].set_title(f"{xlabel} = {sorted_x[i]}")
        ax[0][i].legend()
        ax[0][i].grid()
        ax[1][i].plot(yaxis[cut], np.squeeze(sorted_sqdev[i][cut]))
        ax[1][i].set_ylabel("Square deviation")
        ax[1][i].grid()
    fig.savefig(os.path.join(td, f"lineouts_{tag}.png"), bbox_inches="tight")
