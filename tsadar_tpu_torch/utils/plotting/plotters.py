"""The figures of a fit and of the forward modes: the figure halves of ``tsadar_tpu.utils.plotting.plotters``.

Each function draws the PNGs its JAX counterpart draws, under the same names
in ``td/plots`` (``td`` holds ``plots/``), with the same pixels; the files
the JAX functions also write (CSV, ``.npz``, ``.nc``) are written by
``utils.artifacts``.  The figures are drawn on ``Figure`` objects
(``plotting.subplots``): the JAX package's use pyplot, whose figures render
the same.

* ``TScmap``, ``_spectrum_cmap``: the white-footed colormaps;
* ``plot_2D_data_vs_fit``: fit and data side by side on the calibrated axes,
  with color limits from ``plotting.data_cbar_l`` / ``data_cbar_u``;
* ``plot_loss_hist``: ``loss_histograms.png``, and the losses it returns,
  divided by the number of points, for the lineout figures;
* ``plot_ts_data``: ``{ele,ion}_data_vs_fit.png`` and, where the calibrated
  axes fit the data, ``fit_and_data_{ele,ion}.png``;
* ``model_v_actual``: ``{best,worst}_{ele,ion}_lineouts.png``;
* ``detailed_lineouts``: those, and with the breakdown
  (``plotting.detailed_breakdown``) ``breakdown_{ele,ion}_lineout{n}.png``
  for the two best and two worst lineouts;
* ``plot_final_params``: ``{species}_{parameter}.png`` for each scalar
  parameter, with its sigma band where the sigmas name it;
* ``plot_data_angular``, ``plot_ang_lineouts``: ``angular_data_vs_fit.png``,
  ``fit_and_data.png`` and ``angular_lineouts.png`` of an ARTS image;
* ``plot_dist``: ``distribution_function.png``, the 1V EDF's curve or the 2V
  EDF's image with its two projections.
"""

import os

import numpy as np

from ..artifacts import FEATURES, calibrated_axes, feature_data, window_axes
from ..console import log_info
from . import mpl, subplots


def _white_ramp(to_rgb, n):
    """n RGBA rows blending white into ``to_rgb``."""
    ramp = np.ones((n, 4))
    ramp[:, :3] = np.linspace([1.0, 1.0, 1.0], np.asarray(to_rgb)[:3], n)
    return ramp


def TScmap():
    """jet with a foot of 16 entries ramped from white."""
    upper = mpl().colormaps["jet"](np.arange(256))
    return mpl().colors.ListedColormap(np.vstack([_white_ramp(upper[0], 256 // 16), upper]), name="TScmap")


def _spectrum_cmap(foot=20):
    """gist_ncar with its lowest ``foot`` entries ramped from white."""
    colors = mpl().colormaps["gist_ncar"](np.linspace(0, 1, 256))
    colors[:foot] = _white_ramp(colors[foot], foot)
    return mpl().colors.ListedColormap(colors)


def _save(fig, td, name):
    fig.savefig(os.path.join(td, "plots", name), bbox_inches="tight")


def plot_2D_data_vs_fit(config, x, y, data, fit, td, xlabel="Time (ps)", ylabel="Wavelength (nm)", name="fit_and_data.png"):
    """Fit and data as two pcolormesh images on one color scale, ``config["plotting"]["data_cbar_l"/"data_cbar_u"]``
    ("data": the data's own limit)."""
    plotting_cfg = config.get("plotting", {})
    lo = plotting_cfg.get("data_cbar_l", "data")
    hi = plotting_cfg.get("data_cbar_u", "data")
    vmin = np.amin(data) if lo == "data" else lo
    vmax = np.amax(data) if hi == "data" else hi

    cmap = _spectrum_cmap()
    fig, ax = subplots(1, 2, figsize=(12, 5), tight_layout=True)
    pc = ax[0].pcolormesh(x, y, fit, shading="nearest", cmap=cmap, vmin=vmin, vmax=vmax)
    ax[1].pcolormesh(x, y, data, shading="nearest", cmap=cmap, vmin=vmin, vmax=vmax)
    ax[0].set_title("fit")
    ax[1].set_title("data")
    for a in ax:
        a.set_xlabel(xlabel)
        a.set_ylabel(ylabel)
    fig.colorbar(pc)
    _save(fig, td, name)


def plot_loss_hist(config, losses_init, losses, reduced_points, td):
    """Histograms of the losses before the refits and after: ``loss_histograms.png``.  Returns the final losses
    over ``reduced_points``."""
    red_losses = np.asarray(losses) / reduced_points
    fig, ax = subplots(1, 2, figsize=(10, 4), tight_layout=True)
    ax[0].hist(np.asarray(losses_init), 32)
    ax[0].set_title("initial losses")
    ax[1].hist(red_losses, 32)
    ax[1].set_title("final losses")
    for a in ax:
        a.set_xlabel("loss")
        a.grid()
    _save(fig, td, "loss_histograms.png")
    return red_losses


def plot_ts_data(config, fits, all_data, all_axes, td):
    """Data, fit and residual of each loaded feature, ``{ele,ion}_data_vs_fit.png``, and where the calibrated
    axes fit the data the two-panel ``fit_and_data_{ele,ion}.png`` over the lineouts' x values."""
    for species, dkey, axis, pixkey in FEATURES:
        both = feature_data(fits, all_data, species, dkey)
        if both is None:
            continue
        data, fit = both
        fig, ax = subplots(1, 3, figsize=(14, 4), tight_layout=True)
        vmax = np.percentile(data, 99)
        ax[0].imshow(data, aspect="auto", vmin=0, vmax=vmax)
        ax[0].set_title(f"{species} data")
        ax[1].imshow(fit, aspect="auto", vmin=0, vmax=vmax)
        ax[1].set_title("fit")
        ax[2].imshow(data - fit, aspect="auto")
        ax[2].set_title("residual")
        _save(fig, td, f"{species}_data_vs_fit.png")
        axes = calibrated_axes(config, all_axes, axis, pixkey, data.shape)
        if axes is None:
            continue
        x_grid, y_grid = np.meshgrid(*axes)
        plot_2D_data_vs_fit(config, x_grid, y_grid, data.T, fit.T, td, xlabel=all_axes.get("x_label", "lineout"),
                            name=f"fit_and_data_{species}.png")


def model_v_actual(config, all_data, all_axes, fits, losses, red_losses, sqdevs, td):
    """Data and fit of the (up to) four best and four worst lineouts: ``{best,worst}_{ele,ion}_lineouts.png``."""
    losses = np.asarray(losses)
    num = min(4, len(losses))
    order = np.argsort(losses)
    picks = {"best": order[:num], "worst": order[-num:]}
    for species, dkey, _, _ in FEATURES:
        both = feature_data(fits, all_data, species, dkey)
        if both is None:
            continue
        data, fit = both
        for which, inds in picks.items():
            fig, axs = subplots(1, num, figsize=(4 * num, 3), tight_layout=True, squeeze=False)
            for a, i in zip(axs[0], inds):
                a.plot(data[i], label="data")
                a.plot(fit[i], label="fit")
                a.set_title(f"lineout {i}, loss={losses[i]:.2e}")
                a.legend()
                a.grid()
            _save(fig, td, f"{which}_{species}_lineouts.png")


def _component_slices(comps_by_batch, lineout):
    """The component stack [G, L, A] of a lineout (its global index) from the stacks filed by batch."""
    for inds, stack in comps_by_batch.items():
        if lineout in inds:
            return np.asarray(stack)[list(inds).index(lineout)]
    return None


def _axis_for_lineout(axis_store, lineout):
    """The model's own wavelength axis of a lineout (its global index), or None where the store has none.

    ``detailed_axis`` is filed by batch, as the component stacks are; an
    entry with a row a lineout (lam fitted per lineout) gives the lineout's
    row.  A single array (no producer writes one) is indexed by the global
    index, and one without that row gives None: the overlay is skipped.
    """
    if axis_store is None:
        return None
    if isinstance(axis_store, dict):
        for inds, ax in axis_store.items():
            if lineout in inds:
                ax = np.asarray(ax)
                if ax.ndim > 1:
                    return ax.reshape(-1, ax.shape[-1])[list(inds).index(lineout)]
                return ax
        return None
    ax = np.asarray(axis_store)
    if ax.ndim > 1:
        rows = ax.reshape(-1, ax.shape[-1])
        if lineout >= rows.shape[0]:
            log_info(f"detailed_axis legacy array has {rows.shape[0]} rows, no row for "
                     f"global lineout {lineout}; skipping the raw-axis overlay")
            return None
        return rows[lineout]
    return ax


def detailed_lineouts(config, all_data, all_axes, fits, losses, red_losses, sqdevs, td):
    """``model_v_actual``'s figures and, where the breakdown ran, for the two best and two worst lineouts the data,
    the fit, the first and last components on the model's own axis, the instrument-only spectrum and the
    squared deviations: ``breakdown_{ele,ion}_lineout{n}.png``."""
    model_v_actual(config, all_data, all_axes, fits, losses, red_losses, sqdevs, td)

    losses = np.asarray(losses).ravel()
    order = np.argsort(losses)
    picks = list(dict.fromkeys(np.concatenate([order[:2], order[-2:]])))
    for species, dkey in (("ele", "e_data"), ("ion", "i_data")):
        comps = fits[species].get("spec_comps")
        if not comps:
            continue
        data = np.atleast_2d(np.asarray(all_data[dkey]))
        total = np.atleast_2d(np.asarray(fits[species]["total_spec"]))
        axis_store = fits[species].get("detailed_axis")
        for lineout in picks:
            stack = _component_slices(comps, int(lineout))
            raw_axis = _axis_for_lineout(axis_store, int(lineout))
            if stack is None or data.size <= 1 or data.shape[0] <= lineout:
                continue
            fig, (ax_top, ax_res) = subplots(2, 1, figsize=(8, 6), tight_layout=True, sharex=False, height_ratios=[3, 1])
            ax_top.plot(data[lineout], label="data", color="k", lw=1)
            ax_top.plot(total[lineout], label="total fit")
            if raw_axis is not None and stack.ndim == 3 and stack.shape[1] == raw_axis.size:
                ax_comp = ax_top.twiny()  # the components are on the model's axis, before the instrument response
                ax_comp.plot(raw_axis, stack[0, :, 0], ls="--", alpha=0.7, label="first grad/angle")
                ax_comp.plot(raw_axis, stack[-1, :, 0], ls="--", alpha=0.7, label="last grad")
                ax_comp.plot(raw_axis, stack[0, :, -1], ls="--", alpha=0.7, label="last angle")
                ax_comp.set_xlabel("Wavelength (nm)")
                ax_comp.legend(loc="upper left", fontsize=8)
            irf = fits[species].get("IRF")
            if irf is not None:
                ax_top.plot(np.atleast_2d(irf)[lineout], label="IRF", alpha=0.7)
            ax_top.set_title(f"{species} lineout {lineout}, loss={losses[lineout]:.2e}")
            ax_top.set_ylabel("Amp (arb. units)")
            ax_top.legend(loc="upper right", fontsize=8)
            ax_top.grid()
            ax_res.plot(np.atleast_2d(np.asarray(sqdevs[species]))[lineout])
            ax_res.set_ylabel(r"$\chi_i^2$")
            ax_res.set_xlabel("pixel")
            _save(fig, td, f"breakdown_{species}_lineout{lineout}.png")


def plot_final_params(config, all_params, sigma_ds, td):
    """Each scalar parameter over the lineouts, ``{species}_{parameter}.png``, with its sigma band where
    ``sigma_ds["names"]`` names it and the sigmas have a row a lineout."""
    sigmas = np.asarray(sigma_ds["sigmas"])
    names = sigma_ds["names"]
    for species, params in all_params.items():
        for key, val in params.items():
            arr = np.asarray(val)
            if arr.ndim > 1:
                continue
            fig, ax = subplots(figsize=(6, 3), tight_layout=True)
            x = np.arange(len(arr.reshape(-1)))
            y = arr.reshape(-1)
            ax.plot(x, y, "o-")
            if f"{species}.{key}" in names:
                i = names.index(f"{species}.{key}")
                if sigmas.shape[0] == len(y):
                    s = np.abs(sigmas[:, i])
                    ax.fill_between(x, y - s, y + s, alpha=0.3)
            ax.set_xlabel("lineout")
            ax.set_ylabel(key)
            ax.grid()
            _save(fig, td, f"{species}_{key}.png")


def plot_data_angular(config, fits, all_data, all_axes, td):
    """An ARTS image, its fit over the lineout window and their residual, ``angular_data_vs_fit.png``, and where
    the calibrated axes fit the window the two-panel ``fit_and_data.png`` over the angles."""
    data = np.atleast_2d(np.asarray(all_data["e_data"]))
    fit = np.atleast_2d(np.asarray(fits["ele"]))
    fig, ax = subplots(1, 3, figsize=(14, 4), tight_layout=True)
    vmax = np.percentile(data, 99)
    ax[0].imshow(data, aspect="auto", vmin=0, vmax=vmax)
    ax[0].set_title("ARTS data")
    sl = slice(config["data"]["lineouts"]["start"], config["data"]["lineouts"]["end"])
    ax[1].imshow(fit, aspect="auto", vmin=0, vmax=vmax)
    ax[1].set_title("fit")
    ax[2].imshow(data[sl] - fit, aspect="auto")
    ax[2].set_title("residual (fit window)")
    _save(fig, td, "angular_data_vs_fit.png")
    window = window_axes(config, all_axes, data, fit)
    if window is not None:
        xvals, yvals, windowed = window
        x_grid, y_grid = np.meshgrid(xvals, yvals)
        plot_2D_data_vs_fit(config, x_grid, y_grid, windowed.T, fit.T, td, xlabel="Angle (degrees)")


def plot_ang_lineouts(used_points, sqdevs, losses, all_params, all_axes, savedata, td):
    """Up to four rows of the ARTS fit, evenly spaced: ``angular_lineouts.png``."""
    fit = savedata["fit"]
    num = min(4, fit.shape[0])
    fig, axs = subplots(1, num, figsize=(4 * num, 3), tight_layout=True, squeeze=False)
    for k, a in enumerate(axs[0]):
        i = k * max(1, fit.shape[0] // num)
        a.plot(fit[i], label="fit")
        a.set_title(f"res unit {i}")
        a.legend()
        a.grid()
    _save(fig, td, "angular_lineouts.png")


def plot_dist(config, elec_species, final_params, sigma_fe, td):
    """The EDF (``fe``, ``f`` or ``fvxvy`` of ``final_params``, the first found), ``distribution_function.png``: a
    square 2D one as log10 f(vx, vy) beside its two projections, else its curve on a log axis; nothing where
    there is none."""
    fe = None
    for key in ("fe", "f", "fvxvy"):
        if key in final_params:
            fe = np.asarray(final_params[key])
            break
    if fe is None:
        return
    fe = np.squeeze(fe)
    fig, ax = subplots(1, 2 if fe.ndim == 2 else 1, figsize=(9, 4), tight_layout=True, squeeze=False)
    if fe.ndim == 2 and fe.shape[0] == fe.shape[1]:
        im = ax[0][0].imshow(np.log10(np.maximum(fe, 1e-30)), aspect="auto")
        fig.colorbar(im, ax=ax[0][0])
        ax[0][0].set_title("log10 f(vx, vy)")
        ax[0][1].plot(np.log10(np.maximum(fe.sum(0), 1e-30)), label="proj vy")
        ax[0][1].plot(np.log10(np.maximum(fe.sum(1), 1e-30)), label="proj vx")
        ax[0][1].legend()
        ax[0][1].grid()
    else:
        ax[0][0].semilogy(np.atleast_2d(fe).T)
        ax[0][0].set_title("f(v)")
        ax[0][0].grid()
    _save(fig, td, "distribution_function.png")
