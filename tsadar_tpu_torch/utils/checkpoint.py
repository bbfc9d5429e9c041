"""Checkpoints of a long fit, to resume it where it stopped.

Counterpart of ``tsadar_tpu.utils.checkpoint``: ``save_checkpoint`` writes the
trainable leaves, the optimizer's state and the epoch into
``<path>/epoch_{n}.pt`` (``torch.save``) and the epoch into ``<path>/LATEST``;
``latest_epoch`` reads that marker; ``restore_checkpoint`` loads the newest
checkpoint into the caller's leaves and optimizer, on their device and in
their dtype.  The port neither reads nor writes the JAX package's orbax
directories or pickle files: a fit resumes from a checkpoint of its own
package.
"""

import os

import torch


def save_checkpoint(path, leaves, optimizer, epoch):
    """Write ``leaves`` ({leaf path: tensor}), ``optimizer.state_dict()`` and ``epoch``; mark ``epoch`` the latest."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {"leaves": {k: v.detach().cpu() for k, v in leaves.items()}, "optimizer": optimizer.state_dict(),
               "epoch": int(epoch)}
    torch.save(payload, os.path.join(path, f"epoch_{epoch}.pt"))
    with open(os.path.join(path, "LATEST"), "w") as fh:
        fh.write(str(epoch))


def latest_epoch(path):
    """The epoch of the newest checkpoint in ``path``, or None."""
    marker = os.path.join(os.path.abspath(path), "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as fh:
        return int(fh.read().strip())


def restore_checkpoint(path, leaves, optimizer):
    """Load the newest checkpoint of ``path`` into ``leaves`` ({leaf path: tensor}, in place) and ``optimizer``:
    its epoch, or 0 (nothing changed) when there is none."""
    epoch = latest_epoch(path)
    if epoch is None:
        return 0
    payload = torch.load(os.path.join(os.path.abspath(path), f"epoch_{epoch}.pt"), weights_only=True)
    if set(payload["leaves"]) != set(leaves):
        raise ValueError(f"checkpoint {epoch} of {path} holds the leaves {sorted(payload['leaves'])}, not {sorted(leaves)}")
    with torch.no_grad():
        for k, p in leaves.items():
            p.copy_(payload["leaves"][k].to(device=p.device, dtype=p.dtype))
    optimizer.load_state_dict(payload["optimizer"])  # moves the state to each parameter's device and dtype
    return payload["epoch"]
