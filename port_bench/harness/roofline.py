"""The least time of each of the port's kernel operations, from the cell's own shapes.

A launch's least time is the larger of its bytes at the card's memory bandwidth
and its operations at its type's peak (NVIDIA's H100 SXM data sheet, dense).
Each input byte is read once and each output byte written once; the
operations are counted from the kernel's arithmetic per point (the counts of
``chip_smoke.py`` and PERF.md's kernel table, copied here as functions of the
shapes).  A count depends on the shapes alone, not on which kernel does the
work.
"""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


def least_s(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)


def lin_lookup_fwd(B, Q, n):  # K1: value and slope of per-row tables [B, n] at queries [B, Q]
    return least_s(4 * B * Q + 4 * B * n + 8 * B * Q, 10 * B * Q)


def lin_lookup_bwd(B, Q, n):  # K2: the table cotangent
    return least_s(8 * B * Q + 4 * B * n, 8 * B * Q)


def cubic_lookup_fwd(B, Q, n):  # K3: cubic Hermite value and slope, per-row grids
    return least_s(4 * B * Q + 4 * B * n + 12 * B + 8 * B * Q, 50 * B * Q)


def cubic_lookup_bwd(B, Q, n):  # K4: the table cotangent
    return least_s(8 * B * Q + 12 * B + 4 * B * n, 40 * B * Q)


def spectrum_tail_fwd(B, G, L, NA, S):  # K5: ~100 operations a point, ~130 more an ion species
    nops = B * G * L * NA * (100 + 130 * S)
    return least_s(8 * B * G * L * NA + 4 * B * L + 4 * (2 * B * G + 3 * B + 4 * B * S + 2 * NA + L), nops)


def spectrum_tail_bwd(B, G, L, NA, S):  # K6: the forward again and about as much for the chain rule
    nops = 2 * B * G * L * NA * (100 + 130 * S)
    return least_s(16 * B * G * L * NA + 4 * B * L + 4 * (4 * B * G + 6 * B + 7 * B * S + 2 * NA + L), nops)


def pv_tables(B, N):  # K9 and K9T: two [N, N - 2] tables, three TF32 products a term (float32 accuracy)
    m = N - 2
    return least_s(4 * (B * N + B * (2 * m - 1) + 8 * m), 3 * 2 * 2 * B * N * m, TF32_OPS_PER_S)


OPERATIONS = {
    "K1": lin_lookup_fwd, "K2": lin_lookup_bwd, "K3": cubic_lookup_fwd, "K4": cubic_lookup_bwd,
    "K5": spectrum_tail_fwd, "K6": spectrum_tail_bwd, "K9": pv_tables, "K9T": pv_tables,
}


def least_seconds(kernels, B, steps, units):
    """The least seconds of the work that ``kernels`` (the configuration's ``kernels``: each operation's shapes,
    launches a step and launches a unit besides) takes over ``steps`` steps and ``units`` units at batch ``B``."""
    return sum(OPERATIONS[op](B=B, **k["shape"]) * (k["per_step"] * steps + k["per_unit"] * units)
               for op, k in kernels.items())
