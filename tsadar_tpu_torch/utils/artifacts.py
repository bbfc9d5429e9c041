"""The files a run writes: the fitted parameters, data and fits, sigmas, simulated spectra.

Counterpart of the parts of ``tsadar_tpu.utils.plotting.plotters`` that are
not figures.  Each function writes the files its JAX counterpart writes, at
the same paths relative to the run's artifact directory (``td``, which holds
``csv/`` and ``binary/``):

* ``get_final_params`` (``plotters.get_final_params``): ``csv/learned_parameters.csv``
  led by the ``lineout pixel`` and x-axis columns, and ``csv/learned_dist.csv``
  for a pointwise EDF;
* ``plot_ts_data`` (``plotters.plot_ts_data``): ``binary/{ele,ion}_fit_and_data.npz``
  and, where the calibrated axes fit, ``.nc``;
* ``save_sigmas_params`` (``plotters.save_sigmas_params``): ``binary/sigmas.npz``,
  ``csv/sigmas.csv`` and ``sigmas.nc`` at the artifact root;
* ``plot_data_angular`` (``plotters.plot_data_angular``):
  ``binary/angular_fit_and_data.npz`` and ``binary/fit_and_data.nc``;
* ``save_sigmas_fe`` (``plotters.save_sigmas_fe``): ``binary/sigmas_fe.npz``
  and ``binary/sigma-fe.nc``;
* ``save_dist``: ``binary/distribution_function.npz``, the EDF that
  ``plotters.plot_dist`` draws into ``plots/distribution_function.png`` (a
  file of the port's own).

The figures these JAX functions draw are drawn by ``utils.plotting.plotters``,
where matplotlib imports (the card's machine has none).  That machine has
no pandas either: the CSVs are written with the ``csv`` module in the
layout of pandas' ``to_csv``: a leading index column with an empty header,
every value as numpy prints it (``repr`` of a float), an empty cell for a
missing one, so a reader of the JAX package's CSVs reads these unchanged.

Two departures, both recorded in ROADMAP.md §3: the sigma columns are named
after the leaf in their place (``postprocess.sigma_names``), where the JAX
package permutes the ``general.*`` names; and ``get_final_params`` returns the
``lineout pixel`` and x-axis columns in its dict as well as in its CSV.
"""

import csv
import os

import numpy as np

from .ncwriter import write_dataset


def write_csv(path, columns):
    """``columns`` (name -> 1-D values) as pandas' ``DataFrame(columns).to_csv(path)`` writes it."""
    columns = {str(k): np.asarray(v).reshape(-1) for k, v in columns.items()}
    n = max((len(v) for v in columns.values()), default=0)

    def cell(v, i):
        if i >= len(v) or (np.issubdtype(v.dtype, np.floating) and np.isnan(v[i])):
            return ""
        return str(v[i])

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(columns))
        for i in range(n):
            w.writerow([i] + [cell(v, i) for v in columns.values()])


def get_final_params(config, all_params, all_axes, td=None):
    """The fitted parameters by lineout as numpy arrays, ``"{param}_{species}"``, led by ``"lineout pixel"`` and
    the data's x-axis label, a pointwise EDF as ``"fe"``, a harmonic one's profiles as ``"flm{l}{m}"``; with ``td``, also ``csv/learned_parameters.csv`` (the
    scalar columns) and, for a pointwise EDF, ``csv/learned_dist.csv``."""
    params, dist = {}, {}
    for species, values in all_params.items():
        for k, v in values.items():
            if k in ("fe", "f"):
                dist["fe"] = np.squeeze(np.asarray(v))
            elif k == "flm":  # a harmonic EDF: its coefficient profiles as "flm{l}{m}", as the JAX package keys them
                flm = v[0] if isinstance(v, list) else v
                for l, sub in flm.items():
                    for m, fv in sub.items() if isinstance(sub, dict) else ():
                        dist["fe" if m == "fvxvy" else "v" if m == "v" else f"flm{l}{m}"] = np.squeeze(np.asarray(fv))
            else:
                params[k + "_" + species] = np.asarray(v).reshape(-1)
    lead = {}
    try:
        opts = config["other"]["extraoptions"]
        if opts["load_ion_spec"]:
            pixels = config["data"]["lineouts"]["pixelI"]
            lead = {"lineout pixel": np.asarray(pixels), all_axes["x_label"]: np.asarray(all_axes["iaw_x"][pixels])}
        elif opts["spectype"] != "angular_full":
            pixels = config["data"]["lineouts"]["pixelE"]
            lead = {"lineout pixel": np.asarray(pixels), all_axes["x_label"]: np.asarray(all_axes["epw_x"][pixels])}
    except (KeyError, IndexError, TypeError):
        lead = {}
    if td is not None:
        write_csv(os.path.join(td, "csv", "learned_parameters.csv"), lead | params)
        fe = dist.get("fe")
        if fe is not None and fe.ndim == 1:
            write_csv(os.path.join(td, "csv", "learned_dist.csv"), {"fe": fe})
        elif fe is not None and fe.ndim == 2:
            write_csv(os.path.join(td, "csv", "learned_dist.csv"), {i: fe[:, i] for i in range(fe.shape[1])})
    return lead | params | dist


FEATURES = (("ele", "e_data", "epw", "pixelE"), ("ion", "i_data", "iaw", "pixelI"))


def feature_data(fits, all_data, species, dkey):
    """(data, fit) of a feature as 2-D arrays, or None where it holds no data (not loaded: zeros)."""
    data = np.atleast_2d(np.asarray(all_data[dkey]))
    fit = fits[species]["total_spec"] if isinstance(fits[species], dict) else np.asarray(fits[species])
    if data.size <= 1 or np.all(data == 0):
        return None
    return data, np.atleast_2d(np.asarray(fit))


def calibrated_axes(config, all_axes, axis, pixkey, shape):
    """(the lineouts' x values, the wavelengths) of a feature where the calibrated axes fit data of ``shape``, else
    None (synthetic data that never went through prepare_data has none)."""
    try:
        pix = np.asarray(config["data"]["lineouts"][pixkey], int)
        xvals = np.squeeze(np.asarray(all_axes[f"{axis}_x"]))[pix]
        yvals = np.squeeze(np.asarray(all_axes[f"{axis}_y"]))
    except (KeyError, IndexError, TypeError):
        return None
    return (xvals, yvals) if shape == (xvals.size, yvals.size) else None


def window_axes(config, all_axes, data, fit):
    """(the window's angles, the wavelengths, the image's window) of an ARTS image where they fit ``fit``, else
    None."""
    sl = slice(config["data"]["lineouts"]["start"], config["data"]["lineouts"]["end"])
    try:
        xvals = np.squeeze(np.asarray(all_axes["epw_x"]))[sl]
        yvals = np.squeeze(np.asarray(all_axes["epw_y"]))
        windowed = data[sl]
    except (KeyError, IndexError, TypeError):
        return None
    return (xvals, yvals, windowed) if windowed.shape == fit.shape == (xvals.size, yvals.size) else None


def plot_ts_data(config, fits, all_data, all_axes, td):
    """Data and fit of each loaded feature: ``binary/{ele,ion}_fit_and_data.npz``, and the ``.nc`` over the
    lineouts' x values and the wavelengths where the calibrated axes fit the data.  Returns
    ``{feature: {"data", "fit"}}``."""
    savedata = {}
    for species, dkey, axis, pixkey in FEATURES:
        both = feature_data(fits, all_data, species, dkey)
        if both is None:
            continue
        data, fit = both
        savedata[species] = {"data": data, "fit": fit}
        np.savez(os.path.join(td, "binary", f"{species}_fit_and_data.npz"), data=data, fit=fit)
        axes = calibrated_axes(config, all_axes, axis, pixkey, data.shape)
        if axes is not None:
            write_dataset(os.path.join(td, "binary", f"{species}_fit_and_data.nc"), {"fit": fit, "data": data},
                          [(all_axes.get("x_label", "lineout"), axes[0]), ("Wavelength", axes[1])])
    return savedata


def save_sigmas_params(config, names, sigmas, all_axes, td):
    """The sigmas [lineouts, parameters] with their column ``names``: ``binary/sigmas.npz``, ``csv/sigmas.csv``
    (columns past the names as ``p{i}``) and ``sigmas.nc`` at the artifact root, one variable a parameter
    over the lineouts' x values.  Returns ``{"sigmas", "names"}``."""
    sigmas = np.asarray(sigmas)
    names = list(names)[: sigmas.shape[1]]
    np.savez(os.path.join(td, "binary", "sigmas.npz"), sigmas=sigmas, names=np.array(names, dtype=object))
    columns = names + [f"p{i}" for i in range(sigmas.shape[1] - len(names))]
    write_csv(os.path.join(td, "csv", "sigmas.csv"), {c: sigmas[:, i] for i, c in enumerate(columns)})
    try:
        pix = np.asarray(config["data"]["lineouts"]["pixelE"], int)
        xvals = np.squeeze(np.asarray(all_axes["epw_x"]))[pix]
    except (KeyError, IndexError, TypeError):
        xvals = np.arange(sigmas.shape[0], dtype=float)
    if sigmas.shape[0] == xvals.size:
        write_dataset(os.path.join(td, "sigmas.nc"), {name.replace(".", "_"): sigmas[:, i] for i, name in enumerate(names)},
                      [(all_axes.get("x_label", "lineout"), xvals)])
    return {"sigmas": sigmas, "names": names}


def plot_data_angular(config, fits, all_data, all_axes, td):
    """An ARTS image and its fit: ``binary/angular_fit_and_data.npz``, and ``binary/fit_and_data.nc`` over the
    angles of the lineout window and the wavelengths where the shapes line up.  Returns ``{"data", "fit"}``."""
    data = np.atleast_2d(np.asarray(all_data["e_data"]))
    fit = np.atleast_2d(np.asarray(fits["ele"]))
    np.savez(os.path.join(td, "binary", "angular_fit_and_data.npz"), data=data, fit=fit)
    window = window_axes(config, all_axes, data, fit)
    if window is not None:
        xvals, yvals, windowed = window
        write_dataset(os.path.join(td, "binary", "fit_and_data.nc"), {"fit": fit, "data": windowed},
                      [(all_axes.get("x_label", "Scattering angle (degrees)"), xvals), ("Wavelength", yvals)])
    return {"data": data, "fit": fit}


def save_sigmas_fe(final_params, best_weights_std, sigmas, td):
    """The EDF's sigmas: ``binary/sigmas_fe.npz`` and ``binary/sigma-fe.nc`` over a normalized velocity."""
    sigmas = np.asarray(sigmas)
    np.savez(os.path.join(td, "binary", "sigmas_fe.npz"), sigmas=sigmas)
    fe_sigma = np.ravel(sigmas)
    write_dataset(os.path.join(td, "binary", "sigma-fe.nc"), {"sigma_fe": fe_sigma},
                  [("v", np.linspace(-7, 7, fe_sigma.size))])
    return sigmas


def save_dist(final_params, td):
    """The EDF that the JAX package plots (``plotters.plot_dist``: ``fe``, ``f`` or ``fvxvy``, the first found),
    as ``binary/distribution_function.npz`` (``fe``); nothing when there is none."""
    for key in ("fe", "f", "fvxvy"):
        if key in final_params:
            fe = np.squeeze(np.asarray(final_params[key]))
            np.savez(os.path.join(td, "binary", "distribution_function.npz"), fe=fe)
            return fe
    return None
