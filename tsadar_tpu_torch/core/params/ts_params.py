"""Thomson-scattering parameters as ``nn.Module``s over a batch of lineouts.

Counterpart of ``tsadar_tpu.core.params.ts_params``: each scalar parameter is
stored normalized, ``normed = inv_act((val - lb) / (ub - lb))``, as one
``nn.Parameter`` entry per lineout ([B]); calling the module returns the
physical values.  Module and attribute names follow the JAX pytree, so a JAX
leaf path names the same tensor here (see ``tsadar_tpu_torch.convert``).
"""

import torch
from torch import nn

from ...device import resolve_device, working_dtype
from .distributions import DLM1V, Maxwellian1V, act, inv_act


class ParamGroup(nn.Module):
    """Normalized scalar parameters with their static scale/shift/activation."""

    def __init__(self, cfg, names, num_params, activate):
        super().__init__()
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
            self.normed[name] = nn.Parameter(torch.full((num_params,), float(val), dtype=torch.float64))
            self.scales[name], self.shifts[name], self.activated[name] = scale, shift, is_act

    def forward(self):
        return {
            name: act(v, self.activated[name]) * self.scales[name] + self.shifts[name] for name, v in self.normed.items()
        }


_DIST_1V = {"dlm": DLM1V, "mx": Maxwellian1V}


class ElectronParams(nn.Module):
    def __init__(self, cfg, num_params, activate):
        super().__init__()
        self.params = ParamGroup(cfg, ("Te", "ne"), num_params, activate)
        fe_cfg = cfg["fe"]
        kind = fe_cfg["type"].casefold()
        if fe_cfg["dim"] != 1 or kind not in _DIST_1V:
            raise NotImplementedError(
                f"{fe_cfg['dim']}V '{fe_cfg['type']}' distributions are not ported yet (ROADMAP.md §1 items 5, 12)"
            )
        self.distribution_functions = _DIST_1V[kind](fe_cfg, num_params, activate)

    def get_unnormed_params(self):
        return self.params() | self.distribution_functions.get_unnormed_params()

    def forward(self):
        return self.params() | {"fe": self.distribution_functions(), "v": self.distribution_functions.vx}


class IonParams(nn.Module):
    def __init__(self, cfg, num_params, activate):
        super().__init__()
        self.params = ParamGroup(cfg, ("Ti", "Z", "fract"), num_params, activate)
        self.register_buffer("A", torch.full((num_params,), float(cfg["A"]["val"]), dtype=torch.float64))

    def forward(self):
        return {"A": self.A} | self.params()


_GENERAL_NAMES = ("lam", "amp1", "amp2", "amp3", "ne_gradient", "Te_gradient", "ud", "Va")


class GeneralParams(nn.Module):
    def __init__(self, cfg, num_params, activate):
        super().__init__()
        self.params = ParamGroup(cfg, _GENERAL_NAMES, num_params, activate)

    def forward(self):
        return self.params()


class ThomsonParams(nn.Module):
    """Electron, per-species ion and general parameters of ``num_params`` lineouts."""

    def __init__(self, param_cfg, num_params, activate=False):
        super().__init__()
        self.electron = ElectronParams(param_cfg["electron"], num_params, activate)
        ion_keys = sorted(k for k in param_cfg.keys() if "ion" in k)
        if not ion_keys:
            raise ValueError("No ion species found in input deck")
        self.ions = nn.ModuleList(IonParams(param_cfg[k], num_params, activate) for k in ion_keys)
        self.ti_same = tuple(bool(param_cfg[k]["Ti"].get("same", False)) if i else False for i, k in enumerate(ion_keys))
        self.general = GeneralParams(param_cfg["general"], num_params, activate)

    @classmethod
    def create(cls, param_cfg, num_params, activate=False, device=None, dtype=None):
        """Parameters of ``num_params`` lineouts on ``device`` (the GPU unless told otherwise)."""
        device = resolve_device(device)
        return cls(param_cfg, num_params, activate).to(device=device, dtype=dtype or working_dtype(device))

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
        return bool(fe_cfg.get("active", False)) and fe_cfg["type"].casefold() == "dlm" and parts[2:] == ["normed_m"]
    group = f"ion-{int(parts[1]) + 1}" if parts[0] == "ions" else parts[0]
    if parts[-2] != "normed":
        return False
    return bool(cfg_params[group][parts[-1]]["active"])


def get_filter_spec(cfg_params, ts_params):
    """Mark exactly the deck's active leaves trainable and return them by JAX leaf path.

    The counterpart of ``tsadar_tpu.core.params.get_filter_spec`` for the
    scalar groups and the DLM EDF: ``requires_grad`` is set on a parameter if
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
