"""The plain forms of the port's kernels that the copied physics calls (frozen with it).

``plain_meta`` is K10's (a linear lookup on each row's first n entries),
``pv_plain`` K9's (two matmuls with the dense principal-value matrices,
interleaved), ``chi_plain_fwd`` K7's (rows mixed, then the columns of each
of the three stacked segments).
"""

import torch

from .core.physics.interp import col_cell, lin_lookup_plain, rowmix_indices
from .core.physics.ratint import pv_dense, pv_tables_matmul


def plain_meta(q, table, meta):
    x0, dx, n = meta[0], meta[1], int(meta[2])
    return lin_lookup_plain(q, table[:, :n], x0, dx)


def pv_plain(f, coef):
    mid, node = pv_tables_matmul(f, *pv_dense(coef.shape[1] // 4, coef.dtype, coef.device))
    out = torch.empty(f.shape[:-1] + (mid.shape[-1] + node.shape[-1],), dtype=mid.dtype, device=mid.device)
    out[..., 0::2], out[..., 1::2] = mid, node
    return out


def _segments(nvx, meta):
    v0x, dvx, v0p, dvp = meta.unbind(0)
    return (0, nvx, v0x, dvx), (nvx, nvx, v0x, dvx), (2 * nvx, nvx - 2, v0p, dvp)


def chi_plain_fwd(bq, xq, T, meta):
    ib0, ib1, wb = rowmix_indices(T.shape[0], bq)
    vals, ders = [], []
    for c0, ns, v0, dv in _segments((T.shape[1] + 2) // 3, meta):
        iv0, wv, inside = col_cell(xq, v0, dv, ns)
        f0 = (1.0 - wb) * T[ib0, c0 + iv0] + wb * T[ib1, c0 + iv0]
        f1 = (1.0 - wb) * T[ib0, c0 + iv0 + 1] + wb * T[ib1, c0 + iv0 + 1]
        vals.append(f0 * (1.0 - wv) + f1 * wv)
        ders.append((f1 - f0) / dv * inside)
    return torch.stack(vals + ders)
