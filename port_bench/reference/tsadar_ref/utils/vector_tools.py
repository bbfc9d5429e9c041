"""Two-vector helpers (tuples of tensors) and the rotation of a 2D EDF.

Counterpart of ``tsadar_tpu.utils.vector_tools``: ``vsub``, ``vadd``,
``vdot`` and ``vdiv`` act on tuples component by component (a tuple and a
scalar or tensor scale every component); ``rotate_edf`` turns a 2D EDF about
the origin, as the multiplexed two-shot angular loss does for its second shot.
"""

import math

import torch

from ..core.physics.interp import interp2d_cubic


def vsub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def vadd(a, b):
    return tuple(x + y for x, y in zip(a, b))


def vdot(a, b):
    if isinstance(a, tuple) and isinstance(b, tuple):
        return sum(x * y for x, y in zip(a, b))
    if isinstance(a, tuple):
        return tuple(x * b for x in a)
    return tuple(a * y for y in b)


def vdiv(a, b):
    if isinstance(a, tuple) and isinstance(b, tuple):
        return tuple(x / y for x, y in zip(a, b))
    if isinstance(a, tuple):
        return tuple(x / b for x in a)
    return tuple(a / y for y in b)


def rotate_edf(f, vx, angle_rad):
    """The EDF f [N, N] on the square grid vx [N] turned counter-clockwise by ``angle_rad`` (bicubic resample,
    edge polynomials extrapolated).  The array convention of the EDF modules: f[i, j] = f(vx[j], vy = vx[i])."""
    X, Y = torch.meshgrid(vx, vx, indexing="xy")  # X[i, j] = vx[j], Y[i, j] = vx[i]
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    # the turned function at (x, y) is f at R(-angle) (x, y)
    xq = c * X + s * Y
    yq = -s * X + c * Y
    return interp2d_cubic(yq.reshape(-1), xq.reshape(-1), vx, vx, f, extrap=True).reshape(f.shape)
