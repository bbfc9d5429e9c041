"""The raw frames with the fit windows and the lineouts drawn on them: ``tsadar_tpu.utils.data_handling.data_visualizer``."""

import os
import tempfile

import numpy as np

from .. import mlflow_shim as mlflow
from ..plotting import subplots


def launch_data_visualizer(elecData, ionData, all_axes, config):
    """``electron_raw_data.png`` and ``ion_raw_data.png`` (each frame that is an image) logged as the run's
    artifacts: the frame to its 99th percentile on its calibrated axes, the fit range's edges
    (``data.fit_rng``: blue and red for the electron frame, iaw for the ion frame) as red dashed lines, and up to
    about 20 of the lineouts (``data.lineouts.val``) as white dotted ones."""
    with tempfile.TemporaryDirectory() as td:
        for name, data, xax, yax, windows in (
            ("electron", elecData, all_axes["epw_x"], all_axes["epw_y"], [("blue_min", "blue_max"), ("red_min", "red_max")]),
            ("ion", ionData, all_axes["iaw_x"], all_axes["iaw_y"], [("iaw_min", "iaw_max")]),
        ):
            if np.ndim(data) != 2:
                continue
            fig, ax = subplots(figsize=(7, 6), tight_layout=True)
            im = ax.imshow(data, aspect="auto", vmin=0, vmax=np.percentile(data, 99),
                           extent=[xax[0], xax[-1], yax[-1], yax[0]])
            fig.colorbar(im, ax=ax)
            for lo_key, hi_key in windows:
                fr = config["data"]["fit_rng"]
                if lo_key in fr and hi_key in fr:  # a deck may give one window only
                    ax.axhline(fr[lo_key], color="r", ls="--", lw=0.8)
                    ax.axhline(fr[hi_key], color="r", ls="--", lw=0.8)
            locs = np.atleast_1d(config["data"]["lineouts"].get("val", []))
            for loc in locs[:: max(1, locs.size // 20)]:
                if config["data"]["lineouts"]["type"] == "pixel":
                    ax.axvline(xax[int(loc)], color="w", ls=":", lw=0.5)
                else:
                    ax.axvline(loc, color="w", ls=":", lw=0.5)
            ax.set_title(f"{name} raw data")
            ax.set_xlabel(all_axes.get("x_label", ""))
            ax.set_ylabel("Wavelength (nm)")
            fig.savefig(os.path.join(td, f"{name}_raw_data.png"), bbox_inches="tight")
        mlflow.log_artifacts(td)
