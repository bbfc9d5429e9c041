"""Carry JAX ``ThomsonParams`` states, partitions and gradients into the port, and back.

The port's modules mirror the JAX pytree, so each JAX leaf path names one
tensor of the port's ``state_dict``: ``.electron.params.normed['Te']`` is
``electron.params.normed.Te`` and ``.ions[0].A`` is ``ions.0.A``.  The leaves
arrive as numpy arrays (e.g. from ``jax.tree_util.tree_flatten_with_path``
and ``jax.tree_util.keystr`` in a test), so this module needs no JAX.

``leaves_by_path`` walks a JAX-side pytree itself -- the parameter modules are
plain dataclasses over dicts and tuples -- and names every array leaf as
``keystr`` would, skipping the ``None`` holes of a partition: it serves whole
parameter trees, their (diff, static) halves and gradient pytrees alike, so a
test compares gradients leaf by leaf.  ``leaves_of`` names the port's own
tensors the same way.
"""

import dataclasses
import re

import numpy as np
import torch

from .core.params.ts_params import ThomsonParams, jax_path
from .device import resolve_device, working_dtype

_INDEX = re.compile(r"\[(\d+)\]")
_KEY = re.compile(r"\['([^']*)'\]")


def state_key(jax_path: str) -> str:
    """The port's ``state_dict`` key of a JAX ``keystr`` leaf path."""
    return _INDEX.sub(r".\1", _KEY.sub(r".\1", jax_path)).lstrip(".")


def thomson_params_from_jax(param_cfg, leaves, activate=False, device=None, dtype=None):
    """The port's ``ThomsonParams`` holding the same state as a JAX ``ThomsonParams``.

    Args:
      param_cfg: the deck's ``parameters`` section the JAX parameters were made from.
      leaves: mapping of JAX ``keystr`` leaf path -> numpy array, every leaf.
      activate: the ``activate`` flag the JAX parameters were made with.

    Every leaf crosses by its path, the 2V distributions' too (``fval``,
    ``normed_m``, the flm modules' ``log_10_LT``, ``flm_sign``/``flm_mag`` and
    the MLPs' ``weights[i][j]``): JAX's seeded MLP draws replace the port's own.
    """
    state = {state_key(path): torch.tensor(np.asarray(v)) for path, v in leaves.items()}
    Te = state["electron.params.normed.Te"]
    batch = Te.dim() > 0  # unbatched JAX parameters (the angular fit's) hold 0-d scalars
    params = ThomsonParams(param_cfg, Te.shape[0] if batch else 1, activate, batch)
    params.load_state_dict(state, strict=True)
    device = resolve_device(device)
    return params.to(device=device, dtype=dtype or working_dtype(device))


def leaves_by_path(tree, prefix=""):
    """{``keystr`` leaf path: numpy array} of a pytree of dataclasses, dicts, tuples and lists.

    Dataclass fields marked static (pytree metadata) and ``None`` holes are
    skipped; dict keys come sorted, as JAX flattens them.
    """
    if tree is None:
        return {}
    if dataclasses.is_dataclass(tree):
        children = [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)
                    if not f.metadata.get("static", False)]
    elif isinstance(tree, dict):
        children = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        children = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for key, child in children:
        out |= leaves_by_path(child, prefix + key)
    return out


def thomson_params_from_partitions(param_cfg, diff, static, activate=True, device=None, dtype=None):
    """The port's ``ThomsonParams`` from a JAX ``partition(ts_params, filter_spec)`` pair."""
    leaves = leaves_by_path(diff) | leaves_by_path(static)
    return thomson_params_from_jax(param_cfg, leaves, activate=activate, device=device, dtype=dtype)


def leaves_of(ts_params):
    """{JAX ``keystr`` leaf path: numpy array} of the port's parameters and buffers."""
    return {jax_path(k): v.detach().cpu().numpy() for k, v in ts_params.state_dict().items()}
