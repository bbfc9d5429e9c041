"""Principal-value pole tables of the electron susceptibility, as two matmuls.

The midpoint and node PV tables are linear in the integrand, so the
finite-difference stencils and the Toeplitz contraction collapse into one
host-built float64 matrix each (same construction as
``tsadar_tpu.core.physics.ratint.pv_combined_kernel_np``).  The tables are
then one [B, N] @ [N, M] product each -- a plain matmul, left to
``torch.matmul`` as the JAX package leaves it to XLA.
"""

import numpy as np
import torch


def pv_combined_kernel_np(n_intervals, delta):
    """Fully precombined PV-table matrix K [N, M] (host f64): table = f @ K.

    ``delta`` 0.0 gives the midpoint-pole table, 0.5 the node-pole table.
    """
    if delta not in (0.0, 0.5):
        raise ValueError(f"delta must be 0.0 (midpoint poles) or 0.5 (node poles), got {delta}")
    m = n_intervals
    d = np.arange(m)[None, :] - np.arange(m)[:, None]
    if delta == 0.0:
        T = np.log(np.abs(d + 0.5)) - np.log(np.abs(d - 0.5))
    else:
        dn = d - 1
        with np.errstate(divide="ignore"):
            T = np.log(np.abs(dn + 1.0)) - np.log(np.abs(dn).clip(min=1e-300))
        T[(dn == 0) | (dn == -1)] = 0.0
    p = np.arange(m, dtype=np.float64)[:, None]
    i = np.arange(m, dtype=np.float64)[None, :]
    W = 1.0 + (p + delta - i) * T
    K = np.zeros((m + 2, m))
    K[:m] += 0.5 * T.T - W.T  # node j as the left end of interval i = j
    K[1 : m + 1] += 0.5 * T.T + W.T  # node j as the right end of interval i = j - 1
    return K


def pv_combined_kernels(n_intervals, dtype, device):
    """(K_mid [N, M], K_node [N, M]) for ``pv_tables_matmul``."""
    return tuple(
        torch.as_tensor(pv_combined_kernel_np(n_intervals, delta), dtype=dtype, device=device)
        for delta in (0.0, 0.5)
    )


def pv_tables_matmul(f, kmid, knode):
    """Midpoint + node PV tables: f [..., N] -> ([..., M], [..., M-1])."""
    return f @ kmid, (f @ knode)[..., : kmid.shape[1] - 1]
