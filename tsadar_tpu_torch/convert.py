"""Carry a JAX ``ThomsonParams`` state into the port's ``ThomsonParams``.

The port's modules mirror the JAX pytree, so each JAX leaf path names one
tensor of the port's ``state_dict``: ``.electron.params.normed['Te']`` is
``electron.params.normed.Te`` and ``.ions[0].A`` is ``ions.0.A``.  The leaves
arrive as numpy arrays (e.g. from ``jax.tree_util.tree_flatten_with_path``
and ``jax.tree_util.keystr`` in a test), so this module needs no JAX.
"""

import re

import numpy as np
import torch

from .core.params.ts_params import ThomsonParams
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
    """
    state = {state_key(path): torch.tensor(np.asarray(v)) for path, v in leaves.items()}
    num_params = state["electron.params.normed.Te"].shape[0]
    params = ThomsonParams(param_cfg, num_params, activate)
    params.load_state_dict(state, strict=True)
    device = resolve_device(device)
    return params.to(device=device, dtype=dtype or working_dtype(device))
