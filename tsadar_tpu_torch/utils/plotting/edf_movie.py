"""A GIF of the EDF through a fit, from the snapshots of ``state_weights.txt``: ``tsadar_tpu.utils.plotting.edf_movie``.

The angular loop (``inverse.loops.angular_optax`` with ``optimizer.save_state``)
pickles ``{epoch: the parameters' physical values}`` into the run's
``state_weights.txt``; each snapshot's EDF (``electron.fe`` or ``f``, or a
harmonic EDF's f00) is a frame: its curve on a log axis, or a 2D EDF's
log10 image.  From the repository root::

    python -m tsadar_tpu_torch.utils.plotting.edf_movie state_weights.txt edf_evolution.gif
"""

import pickle

import numpy as np

from . import mpl, subplots


def _extract_fe(snapshot):
    """The EDF of one snapshot as numpy, or None where it has none."""
    elec = snapshot.get("electron", {})
    for key in ("fe", "f"):
        if key in elec:
            return np.squeeze(np.asarray(elec[key]))
    if "flm" in elec and isinstance(elec["flm"], dict):
        f00 = elec["flm"].get(0, {}).get(0)
        if f00 is not None:
            return np.squeeze(np.asarray(f00))
    return None


def make_edf_movie(state_weights_path="state_weights.txt", out_path="edf_evolution.gif", fps=5):
    """The snapshots' EDFs in epoch order as a GIF at ``out_path``, ``fps`` frames a second: the path.  Raises
    ValueError where no snapshot holds an EDF."""
    with open(state_weights_path, "rb") as fh:
        state_weights = pickle.loads(fh.read())

    epochs = sorted(state_weights.keys())
    frames = [(e, _extract_fe(state_weights[e])) for e in epochs]
    frames = [(e, f) for e, f in frames if f is not None]
    if not frames:
        raise ValueError("no distribution snapshots found in state_weights")

    fig, ax = subplots(figsize=(6, 4), tight_layout=True)
    is_2d = frames[0][1].ndim == 2

    def draw(i):
        ax.clear()
        e, fe = frames[i]
        if is_2d:
            ax.imshow(np.log10(np.maximum(fe, 1e-30)), aspect="auto")
            ax.set_title(f"log10 f(vx, vy), epoch {e}")
        else:
            ax.semilogy(np.maximum(fe, 1e-30))
            ax.set_title(f"f(v), epoch {e}")
            ax.grid()

    animation = mpl().animation
    ani = animation.FuncAnimation(fig, draw, frames=len(frames))
    ani.save(out_path, writer=animation.PillowWriter(fps=fps))
    return out_path


if __name__ == "__main__":
    import sys

    make_edf_movie(*sys.argv[1:])
