"""Thomson-scattering parameters as ``nn.Module``s over a batch of lineouts.

Counterpart of ``tsadar_tpu.core.params.ts_params``: each scalar parameter is
stored normalized, ``normed = inv_act((val - lb) / (ub - lb))``, as one
``nn.Parameter`` entry per lineout ([B]), or as a 0-d tensor with
``batch=False`` (the angular fit: one plasma, one 2D EDF); calling the module
returns the physical values.  Module and attribute names follow the JAX
pytree, so a JAX leaf path names the same tensor here (see
``tsadar_tpu_torch.convert``).
"""

import re

import torch
from torch import nn

from ...device import resolve_device, working_dtype
from .distributions import DLM1V, Arbitrary1V, Arbitrary2V, Maxwellian1V, act, inv_act
from .spherical import SphericalHarmonics


class ParamGroup(nn.Module):
    """Normalized scalar parameters with their static scale/shift/activation."""

    def __init__(self, cfg, names, num_params, activate, batch=True):
        super().__init__()
        shape = (num_params,) if batch else ()
        self.normed = nn.ParameterDict()
        self.scales, self.shifts, self.activated = {}, {}, {}
        for name in names:
            c = cfg[name]
            scale = float(c["ub"] - c["lb"]) if "ub" in c and "lb" in c else 1.0
            if scale == 0.0:  # degenerate bounds (lb == ub): pin, don't divide by zero
                scale = 1.0
            shift = float(c["lb"]) if "lb" in c else 0.0
            is_act = bool(c.get("active", False) and activate)
            val = inv_act((float(c["val"]) - shift) / scale, is_act)
            self.normed[name] = nn.Parameter(torch.full(shape, float(val), dtype=torch.float64))
            self.scales[name], self.shifts[name], self.activated[name] = scale, shift, is_act

    def forward(self):
        return {
            name: act(v, self.activated[name]) * self.scales[name] + self.shifts[name] for name, v in self.normed.items()
        }


_DIST_1V = {"dlm": DLM1V, "mx": Maxwellian1V, "arbitrary": Arbitrary1V}


def _make_distribution(fe_cfg, num_params, batch, activate):
    dim, kind = fe_cfg["dim"], fe_cfg["type"].casefold()
    if dim == 1:
        if kind not in _DIST_1V:
            raise NotImplementedError(f"Unknown 1D distribution type: {fe_cfg['type']}")
        return _DIST_1V[kind](fe_cfg, num_params, activate, batch)
    if dim == 2:
        if batch:
            raise NotImplementedError("Batch mode not implemented for 2D distributions")
        if "sph" in kind:
            return SphericalHarmonics(fe_cfg, num_params, activate)
        if kind == "arbitrary":
            return Arbitrary2V(fe_cfg, num_params, activate)
        raise NotImplementedError(f"Unknown 2D distribution type: {fe_cfg['type']}")
    raise NotImplementedError(f"Not implemented distribution dimension: {dim}")


class ElectronParams(nn.Module):
    def __init__(self, cfg, num_params, activate, batch=True):
        super().__init__()
        self.params = ParamGroup(cfg, ("Te", "ne"), num_params, activate, batch)
        self.distribution_functions = _make_distribution(cfg["fe"], num_params, batch, activate)

    def get_unnormed_params(self):
        return self.params() | self.distribution_functions.get_unnormed_params()

    def forward(self):
        return self.params() | {"fe": self.distribution_functions(), "v": self.distribution_functions.vx}


class IonParams(nn.Module):
    def __init__(self, cfg, num_params, activate, batch=True):
        super().__init__()
        self.params = ParamGroup(cfg, ("Ti", "Z", "fract"), num_params, activate, batch)
        self.register_buffer("A", torch.full((num_params,) if batch else (), float(cfg["A"]["val"]), dtype=torch.float64))

    def forward(self):
        return {"A": self.A} | self.params()


_GENERAL_NAMES = ("lam", "amp1", "amp2", "amp3", "ne_gradient", "Te_gradient", "ud", "Va")


class GeneralParams(nn.Module):
    def __init__(self, cfg, num_params, activate, batch=True):
        super().__init__()
        self.params = ParamGroup(cfg, _GENERAL_NAMES, num_params, activate, batch)

    def forward(self):
        return self.params()


class ThomsonParams(nn.Module):
    """Electron, per-species ion and general parameters of ``num_params`` lineouts
    (``batch=False``: of one plasma, every scalar a 0-d tensor, as a 2D EDF needs)."""

    def __init__(self, param_cfg, num_params, activate=False, batch=True):
        super().__init__()
        self.electron = ElectronParams(param_cfg["electron"], num_params, activate, batch)
        ion_keys = sorted(k for k in param_cfg.keys() if "ion" in k)
        if not ion_keys:
            raise ValueError("No ion species found in input deck")
        self.ions = nn.ModuleList(IonParams(param_cfg[k], num_params, activate, batch) for k in ion_keys)
        self.ti_same = tuple(bool(param_cfg[k]["Ti"].get("same", False)) if i else False for i, k in enumerate(ion_keys))
        self.general = GeneralParams(param_cfg["general"], num_params, activate, batch)

    @classmethod
    def create(cls, param_cfg, num_params, activate=False, device=None, dtype=None, batch=True):
        """Parameters of ``num_params`` lineouts on ``device`` (the GPU unless told otherwise)."""
        device = resolve_device(device)
        return cls(param_cfg, num_params, activate, batch).to(device=device, dtype=dtype or working_dtype(device))

    def renormalize_ions(self, tmp_dict):
        """Tie Ti where configured and normalize the ion fractions to sum 1."""
        fract_sum = 0.0
        for i in range(len(self.ions)):
            if i > 0 and self.ti_same[i]:
                tmp_dict[f"ion-{i+1}"]["Ti"] = tmp_dict["ion-1"]["Ti"]
            fract_sum = fract_sum + tmp_dict[f"ion-{i+1}"]["fract"]
        for i in range(len(self.ions)):
            tmp_dict[f"ion-{i+1}"]["fract"] = tmp_dict[f"ion-{i+1}"]["fract"] / fract_sum
        return tmp_dict

    def forward(self):
        tmp = {"electron": self.electron(), "general": self.general()} | {
            f"ion-{i+1}": ion() for i, ion in enumerate(self.ions)
        }
        return self.renormalize_ions(tmp)

    def get_unnormed_params(self):
        """Physical scalar parameters per group (the EDF as its shape parameters, not its values)."""
        tmp = {"electron": self.electron.get_unnormed_params(), "general": self.general()} | {
            f"ion-{i+1}": ion() for i, ion in enumerate(self.ions)
        }
        return self.renormalize_ions(tmp)

    def get_fitted_params(self, param_cfg):
        """({group: {name: value}} of the active parameters, their number), for reporting."""
        param_dict = self.get_unnormed_params()
        fitted, num_params = {}, 0
        for group, values in param_dict.items():
            fitted[group] = {}
            for name, value in values.items():
                if name in ("f", "fe", "flm"):  # a pointwise or harmonic EDF is reported whole and not counted
                    fitted[group][name] = value
                    if name == "flm":
                        out = self()
                        fitted[group][name]["fvxvy"] = out["electron"]["fe"]
                        fitted[group][name]["v"] = out["electron"]["v"]
                    continue
                active = param_cfg[group]["fe"]["active"] if name == "m" else param_cfg[group].get(name, {}).get("active", False)
                if active:
                    fitted[group][name] = value
                    num_params += 1
        return fitted, num_params


def jax_path(name: str) -> str:
    """The JAX ``keystr`` leaf path of one of the port's parameter names
    (``ions.0.params.normed.Ti`` -> ``.ions[0].params.normed['Ti']``); the inverse of ``convert.state_key``."""
    parts = name.split(".")
    out = ""
    for prev, part in zip([""] + parts, parts):
        out += f"[{part}]" if part.isdigit() else f"['{part}']" if prev == "normed" else f".{part}"
    return out


def _is_active(cfg_params, name):
    parts = name.split(".")
    if parts[0] == "electron" and parts[1] == "distribution_functions":
        fe_cfg = cfg_params["electron"]["fe"]
        if not fe_cfg.get("active", False):
            return False
        kind, tail = fe_cfg["type"].casefold(), parts[2:]
        if kind == "dlm":
            return tail == ["normed_m"]
        if kind == "arbitrary":
            return tail == ["fval"]
        if "sph" in kind:
            if tail == ["normed_m"]:
                return True
            if len(tail) >= 2 and tail[0] == "flm":
                flm_type = str(fe_cfg.get("params", {}).get("flm_type", "")).casefold()
                if flm_type == "arbitrary":
                    return tail[-1] in ("flm_mag", "flm_sign")
                if flm_type == "mora-yahi":
                    return tail[-1] == "log_10_LT"
                if flm_type == "nn":
                    return "weights" in tail
        return False
    group = f"ion-{int(parts[1]) + 1}" if parts[0] == "ions" else parts[0]
    if parts[-2] != "normed":
        return False
    return bool(cfg_params[group][parts[-1]]["active"])


def get_filter_spec(cfg_params, ts_params):
    """Mark exactly the deck's active leaves trainable and return them by JAX leaf path.

    The counterpart of ``tsadar_tpu.core.params.get_filter_spec``:
    ``requires_grad`` is set on a parameter if
    and only if the deck says ``active``, and the returned
    ``{JAX keystr path: nn.Parameter}`` holds those, in the module's order.
    """
    trainable = {}
    for name, p in ts_params.named_parameters():
        active = _is_active(cfg_params, name)
        p.requires_grad_(active)
        if active:
            trainable[jax_path(name)] = p
    return trainable


_DICT_KEY = re.compile(r"^(.*)\['([^']*)'\]$")


def ravel_order(trainable):
    """The JAX leaf paths of ``trainable`` in the order of JAX's ``ravel_pytree`` over the same leaves.

    JAX flattens the dataclass fields in their order, which the modules here
    follow, and a dict by its sorted keys: a ``ParamGroup``'s names come sorted
    (``Te``, ``ne``; ``amp1``, ``amp2``, ``lam``), not in the order the group
    registered them.  The flat vector of the scipy loop, the Hessian's
    ``p * B + i`` layout and the sigmas' columns all follow this order.
    """
    groups = {}
    for path in trainable:
        m = _DICT_KEY.match(path)
        head, key = (m.group(1), m.group(2)) if m else (path, "")
        groups.setdefault(head, []).append((key, path))
    return [path for members in groups.values() for _, path in sorted(members)]
