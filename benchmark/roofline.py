"""Operations, bytes and least time of the fused ADMM iteration, and the
published peaks they are held against.

A frozen copy of the arithmetic that `chip_smoke.py` uses for its kernel
table (`iteration_flops`, `bound`), so that the yardstick cannot move with
the program. The count depends on the problem's shapes and on how many
iterations run, never on how the program splits them into kernel calls.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): float32
# on the CUDA cores and HBM3 bandwidth.
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12
F32_BYTES = 4


def iteration_flops(M, K, n, n_fc):
    """Float32 operations one ADMM iteration needs (a multiply-add counts
    two, a compare one): (those of the two G-sweeps, all others)."""
    F, nv, ns = M * K, n + 2, n_fc + 2 + n
    sweeps = 2 * (2 * F * n)
    # sample rows: w (2), eGy w / eGt w sums (4), zt (4), relax/clip/dual
    # update (10); per sample: Cbar^T g and Cbar v (4 nv) and ~40 scalar
    # ops; the Schur matvec, the final rows and the small-row updates
    other = 20 * F + M * (4 * nv + 40) + 2 * nv * nv + 4 * n_fc * n + 12 * ns
    return sweeps, other


def qp_bytes(M, K, n, n_fc):
    """Bytes one QP's fused iterations must move at the least: the scaled
    problem (G, the sample-row and per-sample arrays, the small rows, F, the
    Schur inverse, the coupling block and the scalars) read once, and the
    iterate read once and written once, all float32."""
    F, nv, ns = M * K, n + 2, n_fc + 2 + n
    problem = (F * n + 5 * F + 8 * M + 3 * ns + n_fc * n + 2 * n + nv * nv
               + M * nv + 10)
    state = n + 2 + 3 * M + 2 * F + 2 * ns
    return F32_BYTES * (problem + 2 * state)


def least_seconds(M, K, n, n_fc, iterations):
    """Least time of `iterations` ADMM iterations of one QP, and what sets
    it ("operations" or "bytes"): the operations at the float32 peak
    against the QP's bytes once at the HBM rate."""
    sweeps, other = iteration_flops(M, K, n, n_fc)
    t_ops = iterations * (sweeps + other) / PEAK_F32
    t_bytes = qp_bytes(M, K, n, n_fc) / HBM_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
