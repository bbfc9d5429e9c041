"""Validation of the merged two-deck config, a copy of ``tsadar_tpu.utils.schema``.

A merged config is checked up front against a hand-written schema, and a
failure names the deck path, e.g.::

    ConfigError: parameters.electron.fe.type: 'dlmm' is not one of
    ('dlm', 'mx', 'arbitrary') (did you mean 'dlm'?)

Extra keys pass (decks carry facility-specific extras); the keys the code
dispatches on are held strictly: enum values, numeric types, the order of
bounds, and the sections each mode needs.

One departure: the JAX package accepts any callable that ``optax`` has as an
optimizer name (its ARTS loop takes one by name).  The port cannot import
optax: it accepts the 1D loops' names and every optimizer of optax's aliases
(``inverse.optimizers.METHODS``, and ``UNRUNNABLE``, which fail in the loop as
in the JAX package); any other name fails with a message that lists them
(ROADMAP.md §3).
"""

import difflib
import numbers

from ..inverse.optimizers import METHODS, UNRUNNABLE

_NUM = numbers.Real  # YAML ints and floats; bool excluded explicitly below
_MISSING = object()


class ConfigError(ValueError):
    """A deck failed validation; the message names the offending key path."""


def _is_num(v):
    return isinstance(v, _NUM) and not isinstance(v, bool)


def _is_bool(v):
    # decks use both true/false and 0/1 for flags
    return isinstance(v, bool) or v in (0, 1)


def _fmt(path):
    return ".".join(str(p) for p in path)


def _fail(path, msg):
    raise ConfigError(f"{_fmt(path)}: {msg}")


def _suggest(value, options):
    close = difflib.get_close_matches(str(value), [str(o) for o in options], n=1)
    return f" (did you mean '{close[0]}'?)" if close else ""


def _get(cfg, path, default=_MISSING):
    cur = cfg
    for key in path:
        if not isinstance(cur, dict) or key not in cur:
            return default
        cur = cur[key]
    return cur


def _require(cfg, path, kind="dict"):
    v = _get(cfg, path)
    if v is _MISSING:
        _fail(path, "required key is missing")
    if kind == "dict" and not isinstance(v, dict):
        _fail(path, f"expected a mapping, got {type(v).__name__}")
    return v


def _check_enum(cfg, path, options, required=False, casefold=False):
    v = _get(cfg, path)
    if v is _MISSING:
        if required:
            _fail(path, "required key is missing")
        return
    key = str(v).casefold() if casefold else v
    opts = tuple(str(o).casefold() for o in options) if casefold else tuple(options)
    if key not in opts:
        _fail(path, f"{v!r} is not one of {tuple(options)}{_suggest(v, options)}")


def _check_num(cfg, path, required=False, positive=False, integer=False):
    v = _get(cfg, path)
    if v is _MISSING:
        if required:
            _fail(path, "required key is missing")
        return
    if not _is_num(v):
        _fail(path, f"expected a number, got {type(v).__name__} ({v!r})")
    if positive and v <= 0:
        _fail(path, f"must be positive, got {v!r}")
    if integer and int(v) != v:
        _fail(path, f"expected an integer, got {v!r}")


def _check_bool(cfg, path, required=False):
    v = _get(cfg, path)
    if v is _MISSING:
        if required:
            _fail(path, "required key is missing")
        return
    if not _is_bool(v):
        _fail(path, f"expected a boolean (or 0/1), got {type(v).__name__} ({v!r})")


def _check_param(species_cfg, path):
    """A fittable scalar: {val, active?, lb?, ub?, ...}."""
    p = _get(species_cfg, path)
    if p is _MISSING:
        return
    if not isinstance(p, dict):
        _fail(path, f"expected a mapping with 'val', got {type(p).__name__}")
    _check_num(species_cfg, path + ("val",), required=True)
    _check_bool(species_cfg, path + ("active",))
    _check_num(species_cfg, path + ("lb",))
    _check_num(species_cfg, path + ("ub",))
    # bounds order matters only when the parameter is trainable (inactive
    # reference decks carry degenerate lb == ub placeholders)
    if _get(species_cfg, path + ("active",)) in (True, 1):
        lb, ub = _get(species_cfg, path + ("lb",)), _get(species_cfg, path + ("ub",))
        if _is_num(lb) and _is_num(ub) and lb >= ub:
            _fail(path, f"lb ({lb!r}) must be < ub ({ub!r}) for an active parameter")


_FE_TYPES_1V = ("dlm", "mx", "arbitrary")
_FE_TYPES_2V = ("arbitrary", "sphericalharmonic", "sph_harm")
_SPECTYPES = ("1d", "temporal", "imaging", "angular", "angular_full")
_LINEOUT_TYPES = ("pixel", "ps", "um", "range")
_BACKGROUND_TYPES = ("pixel", "ps", "um", "Shot", "Fit", "auto")
_LOSS_METHODS = ("l1", "l2", "log-cosh", "poisson")
_GRAD_METHODS = ("AD", "FD")
_BUILTIN_METHODS = ("adam", "lbfgs", "l-bfgs-b")
_ANGULAR_METHODS = METHODS + tuple(m for m in UNRUNNABLE if m not in _BUILTIN_METHODS)  # optax's optimizers
PORTED_OPTAX = f"; the port takes these optax optimizers: {_ANGULAR_METHODS}"  # the message's end, after the JAX package's


def _check_parameters(cfg):
    params = _require(cfg, ("parameters",))
    electron = _require(cfg, ("parameters", "electron"))
    for name in ("Te", "ne"):
        _check_param(cfg, ("parameters", "electron", name))

    fe = _get(cfg, ("parameters", "electron", "fe"))
    if isinstance(fe, dict):
        fe_path = ("parameters", "electron", "fe")
        _check_num(cfg, fe_path + ("dim",), integer=True)
        dim = _get(cfg, fe_path + ("dim",), 1)
        if dim not in (1, 2, _MISSING):
            _fail(fe_path + ("dim",), f"must be 1 or 2, got {dim!r}")
        # typo protection only: the union of 1V and 2V names (corpus decks
        # carry dim-inconsistent types on inactive EDFs that never dispatch)
        _check_enum(
            cfg, fe_path + ("type",), tuple(dict.fromkeys(_FE_TYPES_1V + _FE_TYPES_2V)),
            required=True, casefold=True,
        )
        _check_num(cfg, fe_path + ("nvx",), positive=True, integer=True)
        _check_bool(cfg, fe_path + ("active",))

    for species, spec_cfg in params.items():
        if not species.startswith("ion-"):
            continue
        if not isinstance(spec_cfg, dict):
            _fail(("parameters", species), "expected a mapping of ion parameters")
        for name in ("Ti", "Z", "A", "fract"):
            _check_param(cfg, ("parameters", species, name))

    general = _get(cfg, ("parameters", "general"))
    if isinstance(general, dict):
        for name in ("amp1", "amp2", "amp3", "lam", "Te_gradient", "ne_gradient", "ud", "Va"):
            _check_param(cfg, ("parameters", "general", name))


def _check_other(cfg):
    other = _require(cfg, ("other",))
    _check_enum(cfg, ("other", "extraoptions", "spectype"), _SPECTYPES, casefold=True)
    for flag in ("load_ion_spec", "load_ele_spec", "fit_IAW", "fit_EPWb", "fit_EPWr", "fiducial_dewarp"):
        _check_bool(cfg, ("other", "extraoptions", flag))
    ccd = _get(cfg, ("other", "CCDsize"))
    if ccd is not _MISSING and (not isinstance(ccd, (list, tuple)) or len(ccd) != 2):
        _fail(("other", "CCDsize"), f"expected a 2-list [ny, nx], got {ccd!r}")
    _check_num(cfg, ("other", "points_per_pixel",), positive=True, integer=True)
    _check_num(cfg, ("other", "gain"), positive=True)
    _check_bool(cfg, ("other", "shard_2v_points"))
    iawf = _get(cfg, ("other", "iawfilter"))
    if iawf is not _MISSING and (not isinstance(iawf, (list, tuple)) or len(iawf) != 4):
        _fail(("other", "iawfilter"), f"expected [on, OD, width_nm, center_nm], got {iawf!r}")


def _check_data(cfg, required):
    data = _get(cfg, ("data",))
    if data is _MISSING:
        if required:
            _fail(("data",), "required section is missing (fit mode)")
        return
    _check_enum(cfg, ("data", "lineouts", "type"), _LINEOUT_TYPES, casefold=True)
    _check_enum(cfg, ("data", "background", "type"), _BACKGROUND_TYPES, casefold=True)
    _check_num(cfg, ("data", "dpixel"), positive=True, integer=True)
    for name in ("bgscaleE", "bgscaleI", "ele_t0", "ion_t0_shift", "ele_lam_shift", "ion_loss_scale"):
        _check_num(cfg, ("data", name))
    fit_rng = _get(cfg, ("data", "fit_rng"))
    if isinstance(fit_rng, dict):
        for k, v in fit_rng.items():
            if not _is_num(v):
                _fail(("data", "fit_rng", k), f"expected a number, got {type(v).__name__} ({v!r})")


def _check_optimizer(cfg, required):
    opt = _get(cfg, ("optimizer",))
    if opt is _MISSING:
        if required:
            _fail(("optimizer",), "required section is missing (fit mode)")
        return

    method = _get(cfg, ("optimizer", "method"))
    if method is not _MISSING and method not in _BUILTIN_METHODS and method not in _ANGULAR_METHODS:
        _fail(
            ("optimizer", "method"),
            f"{method!r} is not one of {_BUILTIN_METHODS} or an optax optimizer"
            f"{_suggest(method, _BUILTIN_METHODS)}{PORTED_OPTAX}",
        )

    _check_enum(cfg, ("optimizer", "loss_method"), _LOSS_METHODS, casefold=True)
    _check_enum(cfg, ("optimizer", "grad_method"), _GRAD_METHODS)
    _check_num(cfg, ("optimizer", "batch_size"), positive=True, integer=True)
    _check_num(cfg, ("optimizer", "num_epochs"), positive=True, integer=True)
    _check_num(cfg, ("optimizer", "learning_rate"), positive=True)
    _check_bool(cfg, ("optimizer", "x_norm"))
    _check_bool(cfg, ("optimizer", "y_norm"))
    _check_bool(cfg, ("optimizer", "parallel"))
    _check_bool(cfg, ("optimizer", "pallas_sharded"))
    _check_enum(cfg, ("optimizer", "track_best"), ("overall", "per_lineout"))


def validate_config(cfg, mode=None):
    """Validate a merged config; raises ConfigError naming the deck path.

    ``mode`` ("fit" | "forward" | "series" | None) controls which sections are
    required; all present sections are checked regardless.
    """
    if not isinstance(cfg, dict):
        raise ConfigError(f"config must be a mapping, got {type(cfg).__name__}")
    needs_fit_sections = str(mode).casefold() == "fit"
    _check_parameters(cfg)
    _check_other(cfg)
    _check_data(cfg, required=needs_fit_sections)
    _check_optimizer(cfg, required=needs_fit_sections)
    return cfg
