"""Forward and series modes: synthetic spectra of the deck's parameters, or of a sweep of them.

Counterpart of ``tsadar_tpu.forward.calc_series``.  ``forward_pass`` changes
the deck as the JAX function does (batch size 1, ``lamrangE``/``lamrangI``
from the forward ranges, ``npts``, and the spectype ``angular_full`` for
ARTS) and runs the diagnostic once per entry of ``series.vals1`` (once with
no ``series``), each entry setting ``series.param1`` to ``param4`` by
``_set_series_param``:

* the 1D arm: one ``ThomsonScatteringDiagnostic``, a batched
  ``ThomsonParams`` of one lineout per entry; writes
  ``binary/{electron,ion}_data.npz`` and ``.nc`` for each loaded feature,
  and the figure ``plots/simulated_data.png``: each loaded feature's spectra
  overplotted, with the series values as the legend;
* the angular arm: the ARTS image in table mode (the chi tables' layout
  step, then K7), with the camera's angle axis from
  ``get_calibrations(104000, ...)`` and unbatched parameters; writes
  ``utils.artifacts.plot_data_angular``'s files and the EDF
  (``utils.artifacts.save_dist``), and their figures
  (``utils.plotting.plotters.plot_data_angular`` and ``plot_dist``).

The files are logged as the run's artifacts, and ``spectrum_calc_time`` (the
seconds of every entry's forward, read back) as a metric.  The figures are
drawn where ``utils.plotting.figures()`` says so (a run is open and
matplotlib imports).  The JAX function compiles once and loops; the port
loops eagerly over one diagnostic, whose tables depend on the deck's grids
and ranges but on no parameter that a series sets.
"""

import os
import tempfile

import numpy as np
import torch

from ..core.diagnostic import ThomsonScatteringDiagnostic
from ..core.params import ThomsonParams
from ..utils import artifacts
from ..utils import mlflow_shim as mlflow
from ..utils import plotting, trace
from ..utils.calibration import get_calibrations, get_scattering_angles
from ..utils.ncwriter import write_dataset
from ..utils.plotting import plotters


def _write_series_nc(path, sim, series_vals, lam_axis):
    """Simulated spectra as a netCDF over (series, Wavelength).  Series values that are not one number an
    entry (a multi-species sweep sets a list an entry) give an index coordinate."""
    sim = np.atleast_2d(np.squeeze(np.asarray(sim)))
    try:
        coord = np.asarray(series_vals, float)
        if coord.ndim != 1 or coord.size != sim.shape[0]:
            raise ValueError
    except (TypeError, ValueError):
        coord = np.arange(sim.shape[0], dtype=float)
    write_dataset(path, {"Sim": sim}, [("series", coord), ("Wavelength", np.squeeze(lam_axis))])


def _plot_feature(axis, sim, lam_axis, series_vals):
    """One feature's spectra overplotted on ``axis``, with the series values (None: no series) as the legend."""
    axis.plot(lam_axis.squeeze().transpose(), sim.squeeze().transpose())
    axis.set_title("Simulated Data", fontsize=14)
    axis.set_ylabel("Amp (arb. units)")
    axis.set_xlabel("Wavelength (nm)")
    axis.grid()
    if series_vals is not None:
        axis.legend([str(v) for v in series_vals])


def _set_series_param(parameters, name, value):
    """Set one series value; a list value is spread over the ion species in order (``Z: [Z_ion1, Z_ion2]``)."""
    ion_keys = sorted(k for k in parameters if "ion" in k)
    if isinstance(value, (list, tuple)) and ion_keys and name in parameters[ion_keys[0]]:
        for k, v in zip(ion_keys, value):
            parameters[k][name]["val"] = v
        return
    for species in ("electron", "general", *ion_keys):
        if species in parameters and name in parameters[species]:
            parameters[species][name]["val"] = value
            return
    raise KeyError(f"series parameter {name} not found in any species")


def forward_pass(config, device=None, record=None, dtype=None):
    """The deck's spectra, or its series', written as the run's artifacts: ``(ThryE, ThryI, lamAxisE,
    lamAxisI)``, one row an entry, as the JAX function stacks them before it writes them.

    Runs on the card unless ``device="cpu"`` is given (float64 plain forms
    there; ``dtype`` another working dtype).  ``config`` is changed as the
    JAX function changes it.
    ``record`` (a dict), if given, gets ``entry_seconds``: each entry's
    forward with its read-back.
    """
    is_angular = "angular" in config["other"]["extraoptions"]["spectype"]
    config["optimizer"]["batch_size"] = 1
    fit_rng = config["data"]["fit_rng"]
    config["other"]["lamrangE"] = [fit_rng["forward_epw_start"], fit_rng["forward_epw_end"]]
    config["other"]["lamrangI"] = [fit_rng["forward_iaw_start"], fit_rng["forward_iaw_end"]]
    config["other"]["npts"] = int(config["other"]["CCDsize"][1] * config["other"]["points_per_pixel"])

    sas = get_scattering_angles(config)
    dummy_batch = {"i_data": np.array([1]), "e_data": np.array([1]), "noise_e": np.array([0]), "noise_i": np.array([0]),
                   "e_amps": np.array([1]), "i_amps": np.array([1])}
    if is_angular:
        spectype = config["other"]["extraoptions"]["spectype"]
        axisxE, _, _, _, _, _ = get_calibrations(104000, spectype, 0.0, config["other"]["CCDsize"])
        config["other"]["extraoptions"]["spectype"] = "angular_full"
        sas["angAxis"] = axisxE
        dummy_batch["i_data"] = np.ones(tuple(config["other"]["CCDsize"]))
        dummy_batch["e_data"] = np.ones(tuple(config["other"]["CCDsize"]))

    serieslen = len(config["series"]["vals1"]) if "series" in config else 1
    ThryE, ThryI, lamAxisE, lamAxisI = ([None] * serieslen for _ in range(4))
    entry_seconds = []
    ts_diag = ts_params = None
    with trace.timed("series") as series, torch.no_grad():
        for i in range(serieslen):
            with trace.timed("series.entry") as entry:
                if "series" in config:
                    for p in (1, 2, 3, 4):
                        if f"param{p}" in config["series"]:
                            _set_series_param(config["parameters"], config["series"][f"param{p}"],
                                              config["series"][f"vals{p}"][i])
                if ts_diag is None:
                    ts_diag = ThomsonScatteringDiagnostic(config, sas, device=device, dtype=dtype)
                ts_params = ThomsonParams.create(config["parameters"], 1, device=ts_diag.device, dtype=ts_diag.dtype,
                                                 batch=not is_angular)
                out = ts_diag(ts_params, dummy_batch)
                ThryE[i], ThryI[i], lamAxisE[i], lamAxisI[i] = (t.detach().cpu().numpy() for t in out)
            entry_seconds.append(entry.seconds)
    spectime = series.seconds
    ThryE, ThryI, lamAxisE, lamAxisI = (np.array(a) for a in (ThryE, ThryI, lamAxisE, lamAxisI))

    draw = plotting.figures()
    with tempfile.TemporaryDirectory() as td:
        for d in ("plots", "binary", "csv") if draw else ("binary", "csv"):
            os.makedirs(os.path.join(td, d), exist_ok=True)
        series_vals = config["series"]["vals1"] if "series" in config else [0]
        if is_angular:
            with torch.no_grad():
                fe = ts_params()["electron"]["fe"].detach().cpu().numpy()
            fits, data = {"ele": np.squeeze(ThryE)}, {"e_data": np.zeros(tuple(config["other"]["CCDsize"]))}
            axes = {"epw_x": sas["angAxis"], "epw_y": lamAxisE}
            artifacts.plot_data_angular(config, fits, data, axes, td)
            artifacts.save_dist({"fe": np.squeeze(fe)}, td)
            if draw:
                plotters.plot_data_angular(config, fits, data, axes, td)
                plotters.plot_dist(config, "electron", {"fe": np.squeeze(fe)}, None, td)
        else:
            opts = config["other"]["extraoptions"]
            fig, ax = plotting.subplots(1, 2, figsize=(12, 6), tight_layout=True) if draw else (None, (None, None))
            for loaded, axis, sim, lam_axis, name in ((opts["load_ele_spec"], ax[0], ThryE, lamAxisE, "electron"),
                                                      (opts["load_ion_spec"], ax[1], ThryI, lamAxisI, "ion")):
                if not loaded:
                    continue
                if draw:
                    _plot_feature(axis, sim, lam_axis, series_vals if "series" in config else None)
                np.savez(os.path.join(td, "binary", f"{name}_data.npz"), Sim=sim,
                         series=np.asarray(series_vals, dtype=object), Wavelength=lam_axis[0])
                _write_series_nc(os.path.join(td, "binary", f"{name}_data.nc"), sim, series_vals, lam_axis[0])
            if draw:  # no extension, as the JAX package names it: matplotlib writes simulated_data.png
                fig.savefig(os.path.join(td, "plots", "simulated_data"), bbox_inches="tight")
        mlflow.log_artifacts(td)
        mlflow.log_metrics({"spectrum_calc_time": spectime})
    if record is not None:
        record["entry_seconds"] = entry_seconds
    return ThryE, ThryI, lamAxisE, lamAxisI
