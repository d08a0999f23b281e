#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (riskaversetrajopt_torch) on one GPU.

Phases (each prints its seconds; any failure exits non-zero). The main
process runs phases 0, 1, 4, 6 and 7's kernel checks alone on the card, so
that the kernels are timed on a quiet card; then three phase groups that
reach neither kernel run beside it, each in a process of its own (this
script run as `--group NAME`): "golden" (phase 2, then 12(a) from its
plan), "ipm" (phase 9) and "ds" (phase 10), while the main process runs
phases 3, 5, 7's SCPs, 8, 11 and 12(b-d). Each group's log is printed when
it ends; a group that fails, or outlives GROUP_TIMEOUT, fails the script.
  0. card name and power limit, torch/CUDA versions; TF32 off; build the
     hand-written kernels csrc/saa_admm.cu (B1) and csrc/saa_admm_f.cu (B2)
     for sm_90a, one nvcc each, both at once.
  1. kernel B1 against its plain PyTorch version (one_iter_ref) on the
     M=1000 scaled problem of a real define phase at scp_iter=3, 100
     iterations each, both on the card; time both, the cuBLAS sweeps and
     the dependency-chain floor (three grid barriers per iteration on B1's
     grid); then B1 against one_iter_ref at M=2000 (sampled omegas), where
     the G slab no longer fits in shared memory: 25 iterations, timed.
     Each kernel's launch shape (grid, samples per block, shared memory,
     residency) is printed.
  2. the float64 'admm' SCP at M=1000, 15 iterations, golden SCP config, on
     the committed omegas fixture; held to the committed golden trajectory.
  3. the float32 '_admm-pallas' SCP at M=1000, 15 iterations, through
     kernel B1; every iterate finite and the out-of-sample Monte-Carlo safe
     fraction >= 1 - alpha on 10000 fresh samples.
  4. kernel B2 against its plain version (one_iter_ref_f) on phase 1's
     problem, 25 and 100 iterations, at each sweep precision; two runs agree
     bit for bit; its sweeps hold at their own precision's arithmetic and
     fail at the others'; B2 "highest" against B1; time each precision.
  5. the float32 '_admm-pallas-f' SCP at M=1000, 15 iterations, through
     kernel B2, held as phase 3.
  6. the float32 Schur block, compensated and plain, against float64; one
     polished float32 QP per fused solver at M=1000, scp_iter=3,
     SolverConfig() (polish on: the compensated factorization on the card).
  7. the car at the reference's size (CarScenario(): M=50, K=S=20, n=40,
     n_fc=4, alpha=0.1, omegas of the port's sampler, seed 0): B1 and B2
     (three precisions) against their plain versions on its scaled
     structure at scp_iter 0 (gated, the cancellation-free KKT form) and 3,
     timed; the car SCP (15 iterations) through f64 'admm', f32
     '_admm-pallas', f32 '_admm-pallas-f' and f32 'admm', each held to
     tests/test_scp_car.py's contract (the final L2 only for f64), with MC
     on 10000 fresh samples. Each kernel's count is set to 0 just before
     its car solve and read just after: the "launches" of the kernels line.
     The free-row form of B1 and B2 ("highest", "high") at scp_iter 0 and,
     forced, at 3: one kernel iteration from built states against the
     float64 plain iteration on the CVaR row (kernel_checks.free_row_errs,
     <= FREE_ROW_TOL), the check that sees the branch's beta c2 terms.
  8. the entry points: solve_instrumented on the drone at M=1000 through
     '_admm-pallas' (define/solve split, MC check); at M=50 a checkpoint at
     iteration 4 resumed to 15 against the uninterrupted run, and
     solve_many over 2 instances against per-instance solve; the
     drone_risk (alpha 0.1) and driving CLIs (M=50, 1 repeat, 15 SCP
     iterations) into a temporary directory: the reference file layout,
     median final L2 < 1e-2, SAA safer than the baseline.
  9. the interior-point family, which reaches neither kernel (both counts
     held to 0 around each solve): the IPM on phase 1's M=1000 QP in
     float64 (certified, its KKT residuals, its objective against f64
     'admm''s at eps 1e-6 warm-started at its point) and float32; avar_qp
     against avar on the golden's 10000 MC constraint values; the drone
     SCP at M=1000 through f64 'ipm', f32 'hybrid' and f32 'admm-ir' (the
     JAX bench's parity config) with MC beside the golden's, 'hybrid' and
     'admm-ir' held to MC safe >= 1 - alpha; '_hybrid-prox' at M=50, its
     QPs certified reported.
 10. the double-single ADMM and the Gaussian car baseline, which reach
     neither kernel (both counts held to 0 around each run): (a) on phase
     1's M=1000 QP, from one start and with the same float32 Ruiz scaling,
     DS_ITERS ADMM iterations at fixed rho of float64 and float32
     admm_solve and of solve_saa_qp_ds; the ds iterate must lie within a
     tenth of the float32 one's distance from the float64 one; ds ms and
     kernels per iteration (torch.profiler); (b) the 'admm-ds' SCP at
     M=1000 with the JAX bench's ds config, cut to DS_SCP_ITERS SCP
     iterations: QPs certified, L2 to the golden (MC safe >= 1 - alpha
     once the depth reaches 15); (c) the Gaussian car at CarScenario():
     float64 'ipm' at alpha 0.1, 25 SCP iterations, held to
     tests/test_gaussian.py:47-62; float32 'admm-ir' at alpha 0.05,
     GAUSS_PAIR_ITERS iterations, every QP certified and within 1e-3
     relative L2 of float64 'ipm' at the same depth;
     the Gaussian plan's MC safe fraction and cost on the car's 10000
     samples; (d) in phase 8, the driving_gaussian CLI writes its result
     into the car CLI's results directory first, and the driving CLI's
     Monte-Carlo report reads it.
 11. the NLP family (ops/nlp_ipm.py), which reaches neither kernel (both
     counts held to 0 around each run): (a) the hopper CLI at
     HopperScenario() (M=30, 400 variables, a 1945^2 KKT matrix), float64,
     alpha 0.3 (its figure where matplotlib is installed): the damped
     cold baseline solved at jump > 0.9, the warm SAA phase solved at
     jump > 0.3, both files in the JAX layout, MC on 10000 fresh fields
     (safe fractions and the SAA plan's AVaR reported); ms (eager and
     replayed from CUDA graphs) and kernels per barrier iteration; (b) the
     hopper in float32 with three Ruiz sweeps: the cold damped baseline
     within 0.11 of jump 1.053, the SAA phase warm-started from
     tests/fixtures/hopper_base_Z.npy solved at jump > 0.3; (c) in phase
     8, after the drone_risk CLI and into its directory, the
     drone_gaussian CLI at alpha 0.1, float64, tol 1e-6, cap 1500: solved,
     dual <= 1e-5, sum of the risk allocations <= alpha + 1e-6; (d) the
     terrains_gaussian CLI's fields (and its figure where matplotlib is
     installed).
 12. Anderson acceleration, the sample-sharded solve, the native QP oracle
     and torch_entry.py, which reach neither kernel (both counts held to 0
     around each run): (a) the float64 'admm' QP of phase 2's scp_iter 3
     at depth 0 and AA_DEPTH (iterations, ms, residuals, objective gap);
     (b) the sharded float64 'admm' drone SCP at M=1000 on a one-rank NCCL
     group against the unsharded one (bit for bit expected), and phase 1's
     QP on two ranks sharing the card (gloo with CUDA tensors, this script
     run as `--shard-worker`), 500 samples each, against the unsharded
     solve to 1e-8; collectives per ADMM iteration; (c) the native oracle
     (g++-built native/qp_admm.cpp) against solve_dense_qp on one dense QP;
     (d) torch_entry.entry() and dryrun_multichip over the host's cards.
 13. the other backends sample-sharded, which reach neither kernel (both
     counts held to 0 around each run; (a)-(c) in the "ipm" group after
     phase 9, (d) in the "ds" group after phase 10): (a) the drone SCP at
     M=1000 through float64 'ipm', float32 'hybrid' and float32 'admm-ir'
     (the parity config) on a one-rank NCCL group, cut as 12(b)'s, each
     bit for bit its unsharded run; collectives per QP iteration; (b)
     phase 1's QP through the IPM on two ranks sharing the card, held to
     phase 9(a)'s bounds on the unsharded operator and its objective, u
     reported beside the unsharded solve of the samples in reverse order;
     (c) a one-rank sharded 'admm' SCP at M=50 checkpointed and resumed:
     the file the unsharded one, the resumed run the uninterrupted one,
     bit for bit; (d) float32 'admm-ds' (phase 10(b)'s run) and float64
     '_hybrid-prox' (M=50, phase 9(d)'s config) as (a).
Then one JSON line describing each kernel (with its launches on every path
above), the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

Run from the repository root with no arguments: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures"
M, ALPHA, SCP_ITERS, CHUNK, CHUNK_F = 1000, 0.2, 15, 100, 25
M_STREAM = 2000  # beyond shared-memory residency of the G slab
CAR_M, CAR_ALPHA = 50, 0.1  # the car CLI's defaults (CarScenario().M)
GAUSS_ITERS = 25  # the Gaussian car's SCP depth (tests/test_gaussian.py:48)
PRECISIONS = ("highest", "high", "default")
# phase 10: ADMM iterations of the ds-vs-float64 tracking check (cut from
# 200 to make room for phase 12: the ds iterate lay 8.8e-3 of the float32
# one's distance from float64 there, against the 0.1 limit), and the SCP
# depth of the 'admm-ds' drone solve (cut from 15: the third QP runs to the
# 45000 cap in the JAX bench's ds leg, at several ms per ds iteration)
DS_ITERS, DS_SCP_ITERS = 150, 2
# depth cut in phase 9 to keep the script near 700 s once phase 10 came in:
# the '_hybrid-prox' SCP's iterations (3 before)
HYBRID_PROX_ITERS = 2
# the drone_risk CLI's alpha in phase 8, which the drone_gaussian CLI (phase
# 11(c)) warm-starts from: 0.1, the alpha of tests/test_gaussian.py:124-152.
# At 0.2 the Gaussian NLP does not certify within its 1500-iteration cap
# from such a plan, in the JAX package either (prim ~4e-4, dual ~6)
DRONE_CLI_ALPHA = 0.1
# depth cut in phase 10(c) to make room for phases 11 and 12: the SCP
# iterations of the alpha 0.05 Gaussian car pair, float32 'admm-ir' against
# float64 'ipm' (20 at first, then 12). The two plans' gap falls
# with the depth: 3.6e-3 at 8 (past the 1e-3 check, on the card and on the
# host alike), 5.2e-4 at 10, 1.4e-4 at 11, 3.7e-5 at 12, 1.1e-6 at 20 (host
# runs)
GAUSS_PAIR_ITERS = 11
# Kernel vs plain after 100 iterations, |a - b| <= TOL * (1 + |b|) per
# element: both run float32 with sums taken in different orders (blocked
# partials in the kernel, cuBLAS/ATen reductions in the plain version), and
# the 1e3 rho of the equality rows amplifies those ulp-level differences in
# the dual update (tests/test_pallas_admm.py:108-114 uses the same 2e-2).
# At sweep precision "default" (bf16 operands) the iteration amplifies a
# change of summation order into O(1e-1..1) after 25-100 iterations, for two
# plain versions as much as for kernel and plain, so there each kernel
# iteration is held to one plain iteration from the kernel's own state
# (kernel_checks.step_err_f). This measure cannot tell the sweep precisions
# apart; kernel_checks.check_sweeps_f does.
KERNEL_TOL = 2e-2
# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): float32
# on the CUDA cores, bf16 on the tensor cores, HBM bandwidth.
PEAK_F32, PEAK_BF16, HBM_BYTES_S = 67e12, 989e12, 3.35e12


def log(msg):
    print(msg, flush=True)


def phase0(torch):
    from riskaversetrajopt_torch.ops.cuda import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("saa_admm", "saa_admm_f")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(build.build, names))
    for path, secs, out in builds:
        log(f"built {path.name} in {secs:.2f} s")
        for line in out.splitlines():
            if any(k in line for k in ("registers", "Compiling entry", "spill")):
                log("  ptxas: " + line.strip())
    return smi


def load_omegas(torch, dtype, device):
    import numpy as np

    from riskaversetrajopt_torch.models.drone import DroneOmega

    f = np.load(FIXTURES / "omegas_drone_m1000_seed0.npz")
    return DroneOmega(*(torch.from_numpy(f[k]).to(device, dtype)
                        for k in DroneOmega._fields))


def golden_scp_config():
    from riskaversetrajopt_torch.core.config import SCPConfig

    # tests/test_reference_parity.py:224-227
    return SCPConfig(num_iters=SCP_ITERS, gate_iters=2, gate_row_scale=1e-7,
                     gate_bound_l=-0.1, gate_bound_u=0.1)


def fused_config():
    """Phase 3's solver config of the float32 fused backends."""
    from riskaversetrajopt_torch.core.config import SolverConfig

    return SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=20000,
                        polish=False, rho_warm_start=True)


def cuda_time(torch, fn, reps):
    """Mean seconds per call of fn on the current stream (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


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


def bound(inputs, outputs, dims, chunk, precision="highest"):
    """Least time of one wrapper call of `chunk` iterations, in ms, and what
    sets it: each input read once and each output written once, over the
    HBM rate; the operations, the sweeps at their operand type's peak (bf16
    tensor cores below "highest") and the rest at the float32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    sweeps, other = iteration_flops(dims.M, dims.K, dims.n, dims.n_fc)
    if precision == "high":
        sweeps *= 3  # three bf16 products per term
    peak = PEAK_F32 if precision == "highest" else PEAK_BF16
    t_ops = chunk * (sweeps / peak + other / PEAK_F32)
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def scaled_problem(torch, dev, m, om):
    """The float32 scaled structure of a real define phase at the initial
    guess (scp_iter=3, SolverConfig()) for omegas `om` of `m` samples."""
    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    # no device given: the port runs on the card by default
    opt = SAATrajOpt(DroneModel(DroneScenario(M=m)), scp_cfg=golden_scp_config())
    return scaled_of(torch, dev, opt, om(opt), ALPHA, 3)


def scaled_of(torch, dev, opt, om, alpha, scp_iter):
    """The float32 scaled structure (SolverConfig()) of the define phase of
    `opt` at its model's initial guess, at `scp_iter`."""
    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.ops import admm
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective,
    )

    m = om[0].shape[0]
    data = opt._define(opt.model.initial_guess(), om, alpha)
    data32 = type(data)(*(x.to(torch.float32) for x in data))
    st, cfg = opt._static_for(m), SolverConfig()
    ops = SAAQPOps(st, data32, scp_iter)
    _, q = build_objective(st, data32)
    l, u = build_bounds(st, data32, scp_iter)
    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=5)
    p, _ = sk.scaled_structure(st, data32, scp_iter, scaling,
                               torch.tensor(cfg.rho, device=dev), cfg)
    return p, sk.kernel_dims(st), st, data32


def shape_fields(shape):
    """The launch-shape keys of the kernels line."""
    return {"grid_blocks": shape.grid_blocks,
            "samples_per_block": shape.samples_per_block,
            "smem_bytes_per_block": shape.smem_bytes_per_block,
            "resident": shape.resident}


def log_shape(name, d, shape):
    log(f"{name} launch at M={d.M}: {shape.grid_blocks} blocks x "
        f"{shape.samples_per_block} samples, {shape.smem_bytes_per_block} B "
        f"shared memory per block, G slab resident {shape.resident}, rows "
        f"resident {shape.rows_resident}")


def kernel_vs_plain(torch, run, plain, s0, iters, what, epigraph=False):
    """`iters` iterations of the kernel (`run`, twice) and of its plain
    version from s0: every field finite, state_err <= KERNEL_TOL, the two
    kernel runs bit for bit equal; with `epigraph` (the car) also
    epigraph_err <= EPIGRAPH_TOL. Returns (state_err, max abs err, out,
    epigraph_err)."""
    from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc

    ref = s0
    for _ in range(iters):
        ref = plain(ref)
    out = run(s0, iters)
    again = run(s0, iters)
    torch.cuda.synchronize()
    rel, abs_ = kc.state_err(out, ref)
    epi = kc.epigraph_err(out, ref)
    log(f"{what}, {iters} iterations: max |kernel - plain| / (1 + |plain|) "
        f"{rel:.3e}; s, t, y each against its own scale {epi:.3e}")
    if rel > KERNEL_TOL:
        raise AssertionError(f"{what} disagrees with its plain version: {rel:.3e}")
    if epigraph and epi > kc.EPIGRAPH_TOL:
        raise AssertionError(f"{what}: s, t, y {epi:.3e} from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"two {what} runs from one state differ")
    log(f"{what} repeat run: bitwise identical")
    return rel, abs_, out, epi


def phase1(torch, dev):
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk

    p, d, st, data32 = scaled_problem(
        torch, dev, M, lambda opt: load_omegas(torch, torch.float64, dev))
    s0 = sk.init_scaled_state(p)
    shape = sk.launch_shape(d, dev)
    log_shape("B1", d, shape)

    def plain(s):
        return sk.one_iter_ref(p, s, d)

    before = sk.admm_chunk.launches
    max_rel, max_abs, out, _ = kernel_vs_plain(
        torch, lambda s, k: sk.admm_chunk(p, s, d, k), plain, s0, CHUNK, "B1")
    if sk.admm_chunk.launches != before + 2:
        raise AssertionError("admm_chunk did not count its launches")

    reps = 10
    sk.admm_chunk(p, s0, d, CHUNK)  # warm
    t_k = cuda_time(torch, lambda: sk.admm_chunk(p, s0, d, CHUNK), reps)

    def plain_chunk():
        s = s0
        for _ in range(CHUNK):
            s = plain(s)

    t_p = cuda_time(torch, plain_chunk, 3)
    # yardstick, never on the kernel's path: the two cuBLAS G-sweeps an
    # iteration needs, Gs^T w and Gs u
    G2d = p.Gs.view(-1, d.n)
    w, uv = s0.z_G.reshape(-1) + 1.0, p.q_hat_u

    def sweeps():
        for _ in range(CHUNK):
            G2d.T @ w
            G2d @ uv

    sweeps()
    t_l = cuda_time(torch, sweeps, reps)
    # the dependency chain alone: three grid barriers per iteration
    sk.sync_floor(d, dev, CHUNK)  # warm
    t_f = cuda_time(torch, lambda: sk.sync_floor(d, dev, CHUNK), reps)
    b_ms, b_by = bound((*p, *s0), out, d, CHUNK)
    log(f"kernel {t_k * 1e6 / CHUNK:.2f} us/iter, plain one_iter_ref "
        f"{t_p * 1e6 / CHUNK:.2f} us/iter, cuBLAS sweeps "
        f"{t_l * 1e6 / CHUNK:.2f} us/iter, three grid barriers "
        f"{t_f * 1e6 / CHUNK:.2f} us/iter, bound {b_ms * 1e3 / CHUNK:.3f} "
        f"us/iter ({b_by}) (M={M}, chunk={CHUNK})")
    kernel = {
        "max_abs_err": max_abs,
        "ms": t_k * 1e3, "plain_ms": t_p * 1e3, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": t_l * 1e3,
        "iterations_per_call": CHUNK, "max_rel_err": max_rel,
        "us_per_iter": t_k * 1e6 / CHUNK, "plain_us_per_iter": t_p * 1e6 / CHUNK,
        "library_us_per_iter": t_l * 1e6 / CHUNK,
        "bound_us_per_iter": b_ms * 1e3 / CHUNK,
        "barrier_floor_us_per_iter": t_f * 1e6 / CHUNK,
        **shape_fields(shape),
        "streaming": phase1_stream(torch, dev),
    }
    return kernel, (p, d, s0, out, st, data32)


def phase1_stream(torch, dev):
    """B1 at M=2000 (omegas of the port's own sampler, seed 0), where each
    block's G slab does not fit in shared memory and each sweep reads it
    from global memory: against one_iter_ref over CHUNK_F iterations, timed."""
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk

    p, d, _, _ = scaled_problem(
        torch, dev, M_STREAM,
        lambda opt: opt.sample(torch.Generator().manual_seed(0), M_STREAM))
    s0 = sk.init_scaled_state(p)
    shape = sk.launch_shape(d, dev)
    log_shape("B1", d, shape)
    if shape.resident:
        raise AssertionError(f"B1 at M={M_STREAM} was meant to stream G")
    rel, abs_, _, _ = kernel_vs_plain(
        torch, lambda s, k: sk.admm_chunk(p, s, d, k),
        lambda s: sk.one_iter_ref(p, s, d), s0, CHUNK_F,
        f"B1 at M={M_STREAM}")
    t_k = cuda_time(torch, lambda: sk.admm_chunk(p, s0, d, CHUNK_F), 10)
    log(f"B1 at M={M_STREAM}: {t_k * 1e6 / CHUNK_F:.2f} us/iter "
        f"(chunk {CHUNK_F})")
    return {"M": M_STREAM, "us_per_iter": t_k * 1e6 / CHUNK_F,
            "max_rel_err": rel, "max_abs_err": abs_, **shape_fields(shape)}


def drone64():
    """The float64 'admm' drone at M=1000 with the golden SCP config."""
    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    return SAATrajOpt(DroneModel(DroneScenario(M=M)), scp_cfg=golden_scp_config())


def load_gold(torch, dev):
    import numpy as np

    return torch.from_numpy(
        np.load(FIXTURES / f"gold_drone_m{M}_a{ALPHA}_seed0_iters{SCP_ITERS}.npy")
    ).to(dev)


def phase2(torch, dev):
    from riskaversetrajopt_torch.scp.driver import l2_error_us

    opt = drone64()
    om = load_omegas(torch, torch.float64, dev)
    t0 = time.perf_counter()
    res = opt.solve(om, alpha=ALPHA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gold = load_gold(torch, dev)
    err = float(l2_error_us(gold, res.us))  # denominator: the golden
    log(f"f64 admm: {wall:.2f} s, relative L2 vs golden {err:.3e}, "
        f"qp_iters {res.qp_iters.tolist()}, qp_solved {res.qp_solved.tolist()}")
    if not err <= 1e-3:
        raise AssertionError(f"f64 'admm' lands {err:.3e} from the golden")
    return opt, gold, res


def fused_scp(torch, dev, opt64, gold, backend, counter):
    """The float32 SCP through one fused backend at M=1000, 15 iterations,
    golden SCP config, phase 3's solver config; every iterate finite, the
    kernel launched, MC safe fraction >= 1 - alpha on 10000 fresh samples.
    Returns the kernel calls of the run."""
    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    opt = SAATrajOpt(DroneModel(DroneScenario(M=M)), scp_cfg=golden_scp_config(),
                     qp_backend=backend, admm_cfg=fused_config(),
                     dtype=torch.float32)
    om = load_omegas(torch, torch.float32, dev)
    counter.launches = 0
    t0 = time.perf_counter()
    res = opt.solve(om, alpha=ALPHA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    if launches == 0:
        raise AssertionError(f"{backend!r} did not launch its kernel")
    for name in ("us", "xs", "l2_errors", "us_history"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise AssertionError(f"{backend!r} {name} is not finite")
    mc_om = opt64.sample(torch.Generator().manual_seed(99), 10000)
    mc = opt64.monte_carlo(res.us.to(torch.float64), mc_om, ALPHA)
    mc_gold = opt64.monte_carlo(gold, mc_om, ALPHA)
    safe = float(mc["safe_frac"])
    iters = res.qp_iters.tolist()
    log(f"f32 {backend}: {wall:.2f} s, {launches} kernel calls, "
        f"{sum(iters)} ADMM iterations, qp_iters {iters}, qp_solved "
        f"{res.qp_solved.tolist()}")
    log(f"  MC (10000 samples, seed 99): safe {safe:.4f}, AVaR "
        f"{float(mc['avar']):.4f}, cost {float(mc['cost']):.4f} "
        f"(golden: safe {float(mc_gold['safe_frac']):.4f}, cost "
        f"{float(mc_gold['cost']):.4f})")
    if not safe >= 1 - ALPHA:
        raise AssertionError(f"MC safe fraction {safe:.4f} < {1 - ALPHA}")
    return launches


def phase3(torch, dev, opt64, gold):
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk

    return fused_scp(torch, dev, opt64, gold, "_admm-pallas", sk.admm_chunk)


def phase4(torch, problem):
    """Kernel B2 against one_iter_ref_f at each sweep precision."""
    from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f as fk

    p, d, s0_nat, b1_out, _, _ = problem
    pf = fk.to_f(p, d)
    s0 = fk.state_to_f(s0_nat, d)
    before = fk.admm_chunk_f.launches
    by_prec = {}
    for prec in PRECISIONS:
        shape = fk.launch_shape_f(d, pf.G2.device, prec)
        log_shape(f"B2 {prec}", d, shape)
        errs, ends = {}, [s0]
        for iters in (CHUNK_F, CHUNK):
            out = fk.admm_chunk_f(pf, s0, d, iters, prec)
            again = fk.admm_chunk_f(pf, s0, d, iters, prec)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, again)):
                raise AssertionError(f"two B2 runs ({prec}) from one state differ")
            ends.append(out)
            if prec != "default":
                ref = s0
                for _ in range(iters):
                    ref = fk.one_iter_ref_f(pf, ref, d, prec)
                rel, abs_ = kc.state_err(out, ref)
                how = ""
            else:
                # each iteration against one plain iteration from its state
                rel = abs_ = 0.0
                s = s0
                for _ in range(iters):
                    step = fk.admm_step_f(pf, s, d, prec)
                    r1, a1 = kc.step_err_f(pf, s, step, d, prec)
                    rel, abs_, s = max(rel, r1), max(abs_, a1), step.state
                how = ", each iteration from the kernel's state"
            errs[iters] = (rel, abs_)
            log(f"B2 {prec}, {iters} iterations: max |kernel - plain| / "
                f"(1 + |plain|) {rel:.3e}{how}")
            if rel > KERNEL_TOL:
                raise AssertionError(
                    f"B2 ({prec}) disagrees with one_iter_ref_f: {rel:.3e}")
        # the sweeps of one iteration from the start and from each chunk's
        # end, against every precision's arithmetic on their own operands:
        # they must hold at theirs and fail at the others'
        worst = {q: [0.0, 0.0] for q in PRECISIONS}
        for s in ends:
            step = fk.admm_step_f(pf, s, d, prec)
            sweep_errs = kc.sweep_errs_f(pf, s, step, d)
            log(f"B2 {prec} sweeps (1 / 2) against each precision's "
                "arithmetic: " + ", ".join(
                    f"{q} {e1:.2e} / {e2:.2e}"
                    for q, (e1, e2) in sweep_errs.items()))
            kc.check_sweeps_f(sweep_errs, prec)
            for q, e in sweep_errs.items():
                worst[q] = [max(a, b) for a, b in zip(worst[q], e)]
        reps = 10
        fk.admm_chunk_f(pf, s0, d, CHUNK_F, prec)  # warm
        t_k = cuda_time(torch, lambda: fk.admm_chunk_f(pf, s0, d, CHUNK_F, prec), reps)

        def plain():
            s = s0
            for _ in range(CHUNK_F):
                s = fk.one_iter_ref_f(pf, s, d, prec)

        plain()
        t_p = cuda_time(torch, plain, 3)
        # G counted once: G2T holds G2's numbers again, a cost of the
        # layout, not of the work
        b_ms, b_by = bound((pf.G2, *pf[2:], *s0), s0, d, CHUNK_F, prec)
        by_prec[prec] = {
            "ms": t_k * 1e3, "plain_ms": t_p * 1e3, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": errs[CHUNK_F][1],
            "max_rel_err": max(e[0] for e in errs.values()),
            "sweep_errs": worst,
            "us_per_iter": t_k * 1e6 / CHUNK_F,
            "plain_us_per_iter": t_p * 1e6 / CHUNK_F,
            "bound_us_per_iter": b_ms * 1e3 / CHUNK_F,
            **shape_fields(shape),
        }
        log(f"B2 {prec}: kernel {t_k * 1e6 / CHUNK_F:.2f} us/iter, plain "
            f"{t_p * 1e6 / CHUNK_F:.2f} us/iter, bound "
            f"{b_ms * 1e3 / CHUNK_F:.3f} us/iter ({b_by}) (chunk {CHUNK_F})")
    if fk.admm_chunk_f.launches == before:
        raise AssertionError("admm_chunk_f did not count its launches")
    # B2 "highest" against B1, 100 iterations from one state
    b2 = fk.f_to_state(fk.admm_chunk_f(pf, s0, d, CHUNK), d)
    rel, _ = kc.state_err(b2, b1_out)
    log(f"B2 highest vs B1 after {CHUNK} iterations: {rel:.3e}")
    if rel > KERNEL_TOL:
        raise AssertionError(f"B2 disagrees with B1: {rel:.3e}")
    # yardstick, never on the kernel's path: the two cuBLAS sweeps in the F
    # layout, w_f G2 and u G2T
    w, uv = s0.zG_f + 1.0, p.q_hat_u

    def sweeps():
        for _ in range(CHUNK_F):
            w @ pf.G2
            uv @ pf.G2T

    sweeps()
    t_l = cuda_time(torch, sweeps, 10)
    log(f"cuBLAS sweeps, F layout: {t_l * 1e6 / CHUNK_F:.2f} us/iter")
    main = by_prec["highest"]
    return {
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": t_l * 1e3,
        "iterations_per_call": CHUNK_F, "sweep_precision": "highest",
        "us_per_iter": main["us_per_iter"],
        "plain_us_per_iter": main["plain_us_per_iter"],
        "bound_us_per_iter": main["bound_us_per_iter"],
        "library_us_per_iter": t_l * 1e6 / CHUNK_F,
        **shape_fields(fk.launch_shape_f(d, pf.G2.device)),
        "max_rel_err_vs_b1": rel, "by_precision": by_prec,
    }


def phase5(torch, dev, opt64, gold):
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f as fk

    return fused_scp(torch, dev, opt64, gold, "_admm-pallas-f", fk.admm_chunk_f)


def phase6(torch, problem):
    """One polished float32 QP per fused solver (SolverConfig(), polish on:
    the compensated float32 factorization runs on the card). The polish is
    accepted only if it lowers both residuals; the solution says whether it
    was."""
    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.ops import admm
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f as fk
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective,
    )

    *_, st, data32 = problem
    cfg = SolverConfig()
    ops = SAAQPOps(st, data32, 3)
    _, q = build_objective(st, data32)
    amax = lambda v: float(torch.max(torch.abs(v)))  # noqa: E731

    # the float32 Schur block S = L L^T, compensated and plain, against the
    # float64 one of the same data (the float32 factor adds a 1e-7 trace
    # jitter, the float64 one none)
    l, u = build_bounds(st, data32, 3)
    rv = admm.rho_vector(l, u, cfg.rho)
    sg = torch.full_like(q, cfg.sigma)

    def schur(ops_, rv_, sg_):
        L = ops_.factorize(rv_, sg_)[0].double()
        return L @ L.T

    data64 = type(data32)(*(x.double() for x in data32))
    S64 = schur(SAAQPOps(st, data64, 3), rv.double(), sg.double())
    for comp in (True, False):
        S32 = schur(SAAQPOps(st, data32, 3, factorize_compensated=comp), rv, sg)
        if not bool(torch.isfinite(S32).all()):
            raise AssertionError("float32 Schur factor is not finite")
        log(f"float32 Schur block, {'compensated' if comp else 'plain'} "
            f"sums over M: max |S32 - S64| / max |S64| "
            f"{amax(S32 - S64) / amax(S64):.3e}")
    for name, solve in (("_admm-pallas", sk.solve_saa_qp_pallas),
                        ("_admm-pallas-f", fk.solve_saa_qp_pallas_f)):
        t0 = time.perf_counter()
        sol = solve(st, data32, 3, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for f in ("x", "y", "z"):
            if not bool(torch.isfinite(getattr(sol, f)).all()):
                raise AssertionError(f"polished {name} {f} is not finite")
        prim = amax(ops.matvec_A(sol.x) - sol.z)
        dual = amax(ops.matvec_P(sol.x) + q + ops.rmatvec_A(sol.y))
        log(f"polished f32 QP, {name}: {wall:.2f} s, {sol.iters} iterations, "
            f"prim_res {float(sol.prim_res):.3e}, dual_res "
            f"{float(sol.dual_res):.3e}, solved {sol.solved}; after polish "
            f"prim {prim:.3e}, dual {dual:.3e}, polish "
            + ("accepted" if sol.polished
               else "rejected (it did not lower both residuals)"))


def car_opt(torch, **kw):
    """The car at the reference's size, CarScenario() defaults (M=50, S=20,
    K=20, n=40, n_fc=4; its SCP config: 15 iterations, scp_iter 0 gated),
    on the card."""
    from riskaversetrajopt_torch.core.config import CarScenario
    from riskaversetrajopt_torch.models.car import CarModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    return SAATrajOpt(CarModel(CarScenario()), **kw)


def b2_default_steps(torch, pf, s0, d, iters, what):
    """B2 at "default" over `iters` iterations, each held to one plain
    iteration from the kernel's own state (kernel_checks.step_err_f), and a
    chunk of `iters` bit for bit equal on repeat. Returns (rel, abs)."""
    from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f as fk

    rel = abs_ = 0.0
    s = s0
    for _ in range(iters):
        step = fk.admm_step_f(pf, s, d, "default")
        r1, a1 = kc.step_err_f(pf, s, step, d, "default")
        rel, abs_, s = max(rel, r1), max(abs_, a1), step.state
    out = fk.admm_chunk_f(pf, s0, d, iters, "default")
    again = fk.admm_chunk_f(pf, s0, d, iters, "default")
    torch.cuda.synchronize()
    log(f"{what}, {iters} iterations: max |kernel - plain| / (1 + |plain|) "
        f"{rel:.3e}, each iteration from the kernel's state")
    if rel > KERNEL_TOL:
        raise AssertionError(f"{what} disagrees with its plain version: {rel:.3e}")
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"two {what} runs from one state differ")
    log(f"{what} repeat run: bitwise identical")
    return rel, abs_


def free_row_check(torch, p, d, what):
    """The free-row form of B1 and of B2 ("highest", "high") on p with
    sm_free set: kernel_checks.free_row_errs (one kernel iteration from each
    built state against the float64 plain iteration, on the CVaR row) at
    most FREE_ROW_TOL. Returns the readings."""
    from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f as fk

    p = p._replace(sm_free=torch.tensor(1.0))
    pf = fk.to_f(p, d)
    steps = {"b1": lambda s: sk.admm_chunk(p, s, d, 1)}
    for prec in ("highest", "high"):
        steps[f"b2_{prec}"] = lambda s, prec=prec: fk.f_to_state(
            fk.admm_chunk_f(pf, fk.state_to_f(s, d), d, 1, prec), d)
    out = {}
    for name, step in steps.items():
        out[name] = kc.free_row_errs(p, d, step)
        log(f"{what}, {name} free-row form: CVaR row against float64 "
            f"{out[name]:.3e} (limit {kc.FREE_ROW_TOL:.0e})")
        if out[name] > kc.FREE_ROW_TOL:
            raise AssertionError(f"{what}: {name}'s free-row form reads "
                                 f"{out[name]:.3e}")
    return out


def phase7_kernels(torch, dev):
    """B1, and B2 at each precision, against their plain versions on the
    car's scaled structure at scp_iter 0 (gated: the y of the samples past
    the third meet the CVaR row alone, sm_free) and 3, in chunks of the
    solver's sizes; bit for bit on repeat; timed at the car's shape; the
    free-row form (free_row_check) at scp_iter 0 and, forced, at 3."""
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f as fk

    opt = car_opt(torch)
    om = opt.sample(torch.Generator().manual_seed(0), CAR_M)
    out = {"b1": {}, "b2": {}, "free_row": {}}
    for scp_iter in (0, 3):
        p, d, _, _ = scaled_of(torch, dev, opt, om, CAR_ALPHA, scp_iter)
        if bool(p.sm_free) != (scp_iter == 0):
            raise AssertionError(f"car scp_iter {scp_iter}: sm_free {p.sm_free}")
        out["free_row"][f"scp_iter_{scp_iter}"] = free_row_check(
            torch, p, d, f"car scp_iter {scp_iter}")
        s0 = sk.init_scaled_state(p)
        shape = sk.launch_shape(d, dev)
        what = f"B1 car scp_iter {scp_iter}"
        log_shape(what, d, shape)
        rel, abs_, end, epi = kernel_vs_plain(
            torch, lambda s, k: sk.admm_chunk(p, s, d, k),
            lambda s: sk.one_iter_ref(p, s, d), s0, CHUNK, what, epigraph=True)
        t_k = cuda_time(torch, lambda: sk.admm_chunk(p, s0, d, CHUNK), 10)
        b_ms, b_by = bound((*p, *s0), end, d, CHUNK)
        log(f"{what}: {t_k * 1e6 / CHUNK:.2f} us/iter, bound "
            f"{b_ms * 1e3 / CHUNK:.3f} us/iter ({b_by}) (chunk {CHUNK})")
        out["b1"][f"scp_iter_{scp_iter}"] = {
            "M": d.M, "K": d.K, "n": d.n, "n_fc": d.n_fc,
            "us_per_iter": t_k * 1e6 / CHUNK, "bound_us_per_iter": b_ms * 1e3 / CHUNK,
            "bound_by": b_by, "max_rel_err": rel, "max_abs_err": abs_,
            "epigraph_err": epi, **shape_fields(shape)}
        pf, sf0 = fk.to_f(p, d), fk.state_to_f(s0, d)
        for prec in PRECISIONS:
            shape = fk.launch_shape_f(d, dev, prec)
            what = f"B2 {prec} car scp_iter {scp_iter}"
            log_shape(what, d, shape)
            epi = None  # "default" runs the free-row code of the others
            if prec == "default":
                rel, abs_ = b2_default_steps(torch, pf, sf0, d, CHUNK_F, what)
            else:
                rel, abs_, _, epi = kernel_vs_plain(
                    torch, lambda s, k: fk.admm_chunk_f(pf, s, d, k, prec),
                    lambda s: fk.one_iter_ref_f(pf, s, d, prec), sf0, CHUNK_F,
                    what, epigraph=True)
            t_k = cuda_time(
                torch, lambda: fk.admm_chunk_f(pf, sf0, d, CHUNK_F, prec), 10)
            b_ms, b_by = bound((pf.G2, *pf[2:], *sf0), sf0, d, CHUNK_F, prec)
            log(f"{what}: {t_k * 1e6 / CHUNK_F:.2f} us/iter, bound "
                f"{b_ms * 1e3 / CHUNK_F:.3f} us/iter ({b_by}) (chunk {CHUNK_F})")
            out["b2"].setdefault(f"scp_iter_{scp_iter}", {})[prec] = {
                "us_per_iter": t_k * 1e6 / CHUNK_F,
                "bound_us_per_iter": b_ms * 1e3 / CHUNK_F, "bound_by": b_by,
                "max_rel_err": rel, "max_abs_err": abs_, "epigraph_err": epi,
                **shape_fields(shape)}
    return out


def car_checks(model, res, omegas, alpha):
    """tests/test_scp_car.py's contract but the L2 line: every iterate
    finite, the sample-mean ego final state within 2e-2 of the goal, the
    training-sample AVaR of the worst separation violation <= 5e-2, and
    |u| <= u_max + 1e-6. Returns (final-state error, AVaR, max |u|)."""
    import torch

    from riskaversetrajopt_torch.ops.cvar import avar

    for name in ("us", "xs", "l2_errors", "us_history"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise AssertionError(f"car {name} is not finite")
    goal = torch.cat([model.scn.position_ego_goal,
                      model.scn.velocity_ego_goal]).to(res.xs)
    final = float(torch.max(torch.abs(res.xs[:, -1, :4].mean(0) - goal)))
    worst = torch.amax(model.ineq_constraints(res.xs, omegas), dim=1)
    risk = float(avar(worst, alpha))
    umax = float(torch.max(torch.abs(res.us)))
    if not (final <= 2e-2 and risk <= 5e-2 and umax <= model.scn.u_max + 1e-6):
        raise AssertionError(f"car contract: final-state error {final:.3e}, "
                             f"AVaR {risk:.3e}, max |u| {umax:.3f}")
    return final, risk, umax


def phase7_scp(torch, dev):
    """The car SCP through float64 'admm' (the driver's default solver
    config) and the float32 '_admm-pallas', '_admm-pallas-f' and 'admm'
    (phase 3's solver config; float32 'admm' runs the Sherman-Morrison
    repair of the car's gated QP, SAAQPOps.free_y), each held to
    car_checks, f64 'admm' also to final L2 < 2e-2; Monte Carlo on 10000
    fresh samples for each beside f64 'admm''s on the same samples. Returns
    each fused kernel's launches."""
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f as fk

    opt64 = car_opt(torch)
    om = opt64.sample(torch.Generator().manual_seed(0), CAR_M)
    mc_om = opt64.sample(torch.Generator().manual_seed(99), 10000)
    launches = {}
    runs = (("admm", None, torch.float64), ("_admm-pallas", sk.admm_chunk,
                                            torch.float32),
            ("_admm-pallas-f", fk.admm_chunk_f, torch.float32),
            ("admm", None, torch.float32))
    for backend, counter, dtype in runs:
        opt = opt64 if dtype == torch.float64 else car_opt(
            torch, qp_backend=backend, admm_cfg=fused_config(), dtype=dtype)
        sk.admm_chunk.launches = fk.admm_chunk_f.launches = 0
        t0 = time.perf_counter()
        res = opt.solve(om, alpha=CAR_ALPHA)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = sk.admm_chunk.launches, fk.admm_chunk_f.launches
        final, risk, umax = car_checks(opt.model, res,
                                       opt._cast_omegas(om), CAR_ALPHA)
        l2 = float(res.l2_errors[-1])
        if dtype == torch.float64 and not l2 < 2e-2:
            raise AssertionError(f"car f64 'admm' final L2 {l2:.3e}")
        if counter is not None:
            launches[backend] = counter.launches
            if counter.launches == 0:
                raise AssertionError(f"car {backend!r} did not launch its kernel")
        elif any(counts):
            raise AssertionError("car 'admm' launched a fused kernel")
        mc = opt64.monte_carlo(res.us.to(torch.float64), mc_om, CAR_ALPHA)
        iters = res.qp_iters.tolist()
        log(f"car {'f64' if dtype == torch.float64 else 'f32'} {backend}: {wall:.2f} s, "
            f"kernel calls B1 {counts[0]} B2 {counts[1]}, {sum(iters)} ADMM "
            f"iterations, qp_iters {iters}, QPs certified "
            f"{int(res.qp_solved.sum())} of {len(iters)}, final L2 {l2:.3e}, "
            f"mean final-state error {final:.3e}, training AVaR {risk:.3e}, "
            f"max |u| {umax:.3f}")
        log(f"  MC (10000 samples, seed 99): safe {float(mc['safe_frac']):.4f}, "
            f"AVaR {float(mc['avar']):.4f}, cost {float(mc['cost']):.4f}")
    return launches


def phase8_instrumented(torch, dev, opt64):
    """solve_instrumented on the drone at M=1000 (the fixture omegas, the
    golden SCP config, phase 3's solver config) through '_admm-pallas': the
    median define and solve ms per SCP iteration; every iterate finite and
    phase 3's MC check. Returns kernel B1's launches in the run (the
    warm-up pass included)."""
    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    opt = SAATrajOpt(DroneModel(DroneScenario(M=M)), scp_cfg=golden_scp_config(),
                     qp_backend="_admm-pallas", admm_cfg=fused_config(),
                     dtype=torch.float32)
    om = load_omegas(torch, torch.float32, dev)
    sk.admm_chunk.launches = 0
    t0 = time.perf_counter()
    out = opt.solve_instrumented(om, ALPHA)
    wall = time.perf_counter() - t0
    launches = sk.admm_chunk.launches
    import numpy as np

    if launches == 0:
        raise AssertionError("solve_instrumented did not launch kernel B1")
    if not (bool(torch.isfinite(out["us"]).all())
            and bool(torch.isfinite(out["xs"]).all())):
        raise AssertionError("solve_instrumented iterate is not finite")
    d_ms, s_ms = (float(np.median(out[k])) * 1e3
                  for k in ("define_times", "solve_times"))
    per_it = {k: [round(float(x) * 1e3, 2) for x in out[k]]
              for k in ("define_times", "solve_times")}
    mc = opt64.monte_carlo(out["us"].to(torch.float64),
                           opt64.sample(torch.Generator().manual_seed(99), 10000),
                           ALPHA)
    safe = float(mc["safe_frac"])
    log(f"solve_instrumented M={M} '_admm-pallas': {wall:.2f} s with the warm-up "
        f"pass, {launches} kernel calls; per SCP iteration median define "
        f"{d_ms:.2f} ms, median solve {s_ms:.2f} ms; define ms "
        f"{per_it['define_times']}, solve ms {per_it['solve_times']}; final L2 "
        f"{out['l2_errors'][-1]:.3e}; MC safe {safe:.4f}")
    if not safe >= 1 - ALPHA:
        raise AssertionError(f"MC safe fraction {safe:.4f} < {1 - ALPHA}")
    return launches, {"define_ms_median": d_ms, "solve_ms_median": s_ms,
                      "define_ms": per_it["define_times"],
                      "solve_ms": per_it["solve_times"]}


def phase8_resume_and_many(torch, dev):
    """The drone at M=50 through '_admm-pallas' (the kernel is
    deterministic): a checkpoint written at iteration 4 and resumed to 15
    reaches the uninterrupted run's controls within 1e-5 relative, and
    solve_many over B=2 instances equals per-instance solve bit for bit.
    Returns kernel B1's launches in the resumed solve and in solve_many,
    each counted from 0 just before its call and read just after."""
    import tempfile
    from dataclasses import replace

    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt
    from riskaversetrajopt_torch.utils import checkpoint as ckpt

    def drone(iters):
        return SAATrajOpt(DroneModel(DroneScenario(M=50)),
                          scp_cfg=replace(golden_scp_config(), num_iters=iters),
                          qp_backend="_admm-pallas", admm_cfg=fused_config(),
                          dtype=torch.float32)

    opt = drone(SCP_ITERS)
    oms = [opt.sample(torch.Generator().manual_seed(s), 50) for s in (0, 1)]
    launches = {}
    full = opt.solve(oms[0], ALPHA)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/scp.npz"
        drone(4).solve(oms[0], ALPHA, checkpoint_path=path)
        if ckpt.load(path).scp_iter != 4:
            raise AssertionError("the checkpoint was not written at iteration 4")
        sk.admm_chunk.launches = 0
        resumed = opt.solve(oms[0], ALPHA, checkpoint_path=path)
        launches["drone M=50 resumed solve (phase 8)"] = sk.admm_chunk.launches
    rel = float(torch.linalg.norm(resumed.us - full.us) / torch.linalg.norm(full.us))
    log(f"checkpoint at 4 resumed to {SCP_ITERS}: {resumed.qp_iters.numel()} "
        f"iterations run, final controls {rel:.3e} relative from the "
        f"uninterrupted run")
    if not rel <= 1e-5:
        raise AssertionError(f"resumed controls {rel:.3e} from the uninterrupted run")
    alphas = [ALPHA, 0.1]
    sk.admm_chunk.launches = 0
    many = opt.solve_many(type(oms[0])(*(torch.stack(f) for f in zip(*oms))),
                          alphas)
    launches["drone M=50 solve_many B=2 (phase 8)"] = sk.admm_chunk.launches
    for i, om in enumerate(oms):
        one = opt.solve(om, alphas[i])
        for name, a, b in zip(one._fields, many, one):
            if not torch.equal(a[i].cpu(), b.cpu()):
                raise AssertionError(f"solve_many instance {i} {name} differs "
                                     "from its solve")
    log("solve_many over B=2 (alphas 0.2, 0.1): bit for bit each instance's "
        f"solve; B1 launches {launches}")
    for path, n in launches.items():
        if n == 0:
            raise AssertionError(f"{path}: kernel B1 was not launched")
    return launches


def run_cli(main, argv, dev):
    """main(argv, device=dev) with its standard output captured and echoed:
    returns the output and the wall seconds."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv, device=dev)
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log("  | " + line)
    return buf.getvalue(), wall


def phase8_clis(torch, dev):
    """drone_risk.main and driving.main into a temporary directory at M=50
    (their default), with --repeats 1 and 15 SCP iterations (alpha 0.1
    each): the reference file layout, median final L2 < 1e-2, and the
    drone SAA safe(mean) above the baseline's safe fraction. Between them,
    phase 11(c): the drone_gaussian CLI from the drone_risk CLI's SAA
    plan; returns its stats."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        drone_cli(dev, f"{tmp}/drone")
        t = time.perf_counter()
        drone_gauss = phase11_drone_gaussian_cli(torch, dev, f"{tmp}/drone")
        log(f"[phase 11(c), in phase 8] {time.perf_counter() - t:.2f} s")
        car_cli(dev, f"{tmp}/car")
    return drone_gauss


def drone_cli(dev, rdir):
    import re

    from riskaversetrajopt_torch.experiments import common, drone_risk

    out, wall = run_cli(drone_risk.main, [
        "--repeats", "1", "--alphas", str(DRONE_CLI_ALPHA), "--scp-iters",
        str(SCP_ITERS), "--results", rdir], dev)
    files = sorted(p.name for p in Path(rdir).iterdir())
    want = [f"drone_alpha={DRONE_CLI_ALPHA}_repeat=0.npy", "drone_baseline.npy"]
    l2 = float(re.search(r"final L2 \(median over sweep\): (\S+)", out)[1])
    saa = float(re.search(rf"alpha={DRONE_CLI_ALPHA}: safe\(mean\)=(\S+)",
                          out)[1])
    base = float(re.search(r"baseline: safe=(\S+)", out)[1])
    stages = re.findall(r"stage wall time (\S+) s", out)
    log(f"drone_risk CLI: {wall:.2f} s (stages SAA / baseline / MC "
        f"{' / '.join(stages)} s), files {files}, median final L2 "
        f"{l2:.3e}, SAA safe(mean) {saa:.4f}, baseline safe {base:.4f}")
    if files != want or not l2 < 1e-2 or not saa > base:
        raise AssertionError("drone_risk CLI: wrong files, L2 or safety")
    for f in want:
        us, xs = common.load_traj(f"{rdir}/{f}")
        if us.shape != (20, 3) or xs.shape != (50, 21, 6):
            raise AssertionError(f"{f}: shapes {us.shape}, {xs.shape}")


def car_cli(dev, rdir):
    """The driving_gaussian CLI (alpha 0.1, 25 SCP iterations, phase 10(d))
    and then the driving CLI into one results directory: the driving CLI's
    Monte-Carlo report reads the Gaussian baseline's file."""
    import re

    import numpy as np
    import torch

    from riskaversetrajopt_torch.experiments import (
        common,
        driving,
        driving_gaussian,
    )

    (_, g_wall), _, _ = no_kernel_run(
        torch, dev, lambda: run_cli(driving_gaussian.main, [
            "--alphas", str(CAR_ALPHA), "--scp-iters", str(GAUSS_ITERS),
            "--results", rdir], dev), "driving_gaussian CLI")
    gfile = f"driving_gaussian_alpha={CAR_ALPHA}.npy"
    us, xs = common.load_traj(f"{rdir}/{gfile}")
    log(f"driving_gaussian CLI: {g_wall:.2f} s, {gfile}: us {us.shape}, "
        f"xs {xs.shape}")
    if us.shape != (20, 2) or xs.shape != (21, 8) or not np.isfinite(xs).all():
        raise AssertionError(f"driving_gaussian CLI: {us.shape}, {xs.shape}")
    out, wall = run_cli(driving.main, [
        "--repeats", "1", "--alphas", str(CAR_ALPHA), "--scp-iters",
        str(SCP_ITERS), "--results", rdir], dev)
    files = sorted(p.name for p in Path(rdir).iterdir())
    want = ["driving_alpha=0.1_repeat=0.npy", "driving_baseline.npy",
            "driving_computation_times.npy", gfile]
    alphas, d_t, s_t, c_t, l2s = common.load_timing(
        f"{rdir}/driving_computation_times.npy")
    l2 = float(np.median(l2s[:, :, -1]))
    stages = re.findall(r"stage wall time (\S+) s", out)
    log(f"driving CLI: {wall:.2f} s (stages SAA / baseline / MC "
        f"{' / '.join(stages)} s), files {files}, median final L2 {l2:.3e}, "
        f"define/solve ms per SCP iteration (median) "
        f"{np.median(d_t) * 1e3:.2f} / {np.median(s_t) * 1e3:.2f}")
    if files != want or not l2 < 1e-2 or d_t.shape != (1, 1, SCP_ITERS):
        raise AssertionError("driving CLI: wrong files, L2 or timing shape")
    gauss = re.search(rf"alpha={CAR_ALPHA}: safe=(\S+) cost=(\S+)", out)
    if "run the driving_gaussian experiment first" in out or gauss is None:
        raise AssertionError("driving CLI: no Gaussian-baseline comparison")
    log(f"driving CLI, Gaussian baseline: MC safe {gauss[1]}, cost {gauss[2]}")


def parity_config():
    """'admm-ir''s solver and refinement config in phase 9: the JAX bench's
    parity mode (bench.py:747-761): eps_abs 1e-4, eps_rel 1e-5, the base
    solve at that target capped at 20000 iterations, polish off, no rho
    warm start, the "factored" KKT refinement, the explicit Schur inverse."""
    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.ops.qp_refine import IRConfig

    return (SolverConfig(eps_abs=1e-4, eps_rel=1e-5, max_iter=20000,
                         polish=False, rho_warm_start=False,
                         kkt_refine_mode="factored", kkt_chol_inverse=True),
            IRConfig(base_eps_abs=1e-4, base_eps_rel=1e-5,
                     base_max_iter=20000))


def drone_opt(torch, dev, m, scp_cfg, **kw):
    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    return SAATrajOpt(DroneModel(DroneScenario(M=m), device=dev),
                      scp_cfg=scp_cfg, device=dev, **kw)


def first_omegas(torch, dtype, dev, m):
    """The first m omegas of the committed M=1000 fixture."""
    om = load_omegas(torch, dtype, dev)
    return type(om)(*(x[:m] for x in om))


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def kernel_counters():
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f as fk

    return sk.admm_chunk, fk.admm_chunk_f


def no_kernel_run(torch, dev, fn, what):
    """fn() with both kernels' counts set to 0 just before and read just
    after: the interior-point family reaches neither kernel, so both must
    read 0. Returns (fn's result, wall seconds, the two counts)."""
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = tuple(c.launches for c in counters)
    if any(counts):
        raise AssertionError(f"{what} launched a fused kernel: {counts}")
    return out, wall, counts


def kkt_stats(torch, st, data, x, y):
    """The primal violation, dual residual, its scale max(|A^T y|, |q|) and
    objective of (x, y) on the whole QP of (st, data) at scp_iter 3
    (tests/test_ipm.py:101-135's measures)."""
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective,
    )

    ops = SAAQPOps(st, data, 3)
    p_diag, q = build_objective(st, data)
    l, u = build_bounds(st, data, 3)
    amax = lambda v: float(torch.max(torch.abs(v)))  # noqa: E731
    Ax = ops.matvec_A(x)
    Aty = ops.rmatvec_A(y)
    prim = max(float(torch.max(Ax - u)), float(torch.max(l - Ax)), 0.0)
    return (prim, amax(p_diag * x + q + Aty), max(amax(Aty), amax(q)),
            float(0.5 * torch.sum(p_diag * x * x) + q @ x))


def phase9_ipm_qp(torch, dev, opt64, m=M):
    """(a) The IPM on phase 1's QP (a real define phase at the initial
    guess, scp_iter 3, the fixture omegas): in float64 at tol 1e-5
    certified within IPMConfig's cap raised to 100 iterations (it takes 73
    at M=1000; the JAX package and the port both take 23, 28 and 49 at
    M=100, 300 and 500 on the CPU), its unscaled KKT residuals held as
    tests/test_ipm.py:101-135 holds them (primal <= 1e-6, dual / d_scale
    < 1e-4), and its objective within 1e-4 relative of float64 'admm''s at
    eps 1e-6 on the same QP (the driver's solver config, warm-started at
    the IPM point as 'hybrid' does; on this QP it may stop at the 20000
    cap, from a cold start it did at M=16, so whether it certified is
    reported); in float32 at IPMConfig(tol=1e-4, max_iter=30)
    (__graft_entry__.py:37) reported."""
    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.ops.ipm import IPMConfig, solve_qp_ipm
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective, solve_saa_qp,
    )

    om = first_omegas(torch, torch.float64, dev, m)
    alpha = torch.tensor(ALPHA, dtype=torch.float64, device=dev)
    data64 = opt64._define(opt64.model.initial_guess(), om, alpha)
    data32 = type(data64)(*(x.to(torch.float32) for x in data64))
    st = opt64._static_for(m)
    stats, sols = {}, {}
    for name, data, cfg in (("f64", data64, IPMConfig(tol=1e-5, max_iter=100)),
                            ("f32", data32, IPMConfig(tol=1e-4, max_iter=30))):
        ops = SAAQPOps(st, data, 3)
        _, q = build_objective(st, data)
        l, u = build_bounds(st, data, 3)
        sol, wall, _ = no_kernel_run(
            torch, dev, lambda: solve_qp_ipm(ops, q, l, u, n_eq=st.n_fc,
                                             cfg=cfg), f"{name} IPM")
        prim, dual, d_scale, obj = kkt_stats(torch, st, data, sol.x, sol.y)
        finite = all(bool(torch.isfinite(v).all()) for v in (sol.x, sol.y))
        sols[name] = sol
        stats[name] = {"iters": sol.iters, "solved": sol.solved,
                       "ms": wall * 1e3, "prim": prim,
                       "dual_over_scale": dual / d_scale, "objective": obj}
        log(f"IPM {name} on the M={m} drone QP (scp_iter 3): {sol.iters} "
            f"iterations, {wall * 1e3:.1f} ms, solved {sol.solved}, primal "
            f"violation {prim:.3e}, dual {dual:.3e} (/ d_scale {d_scale:.3e}"
            f" = {dual / d_scale:.3e}), objective {obj:.10e}, finite {finite}")
        if not finite:
            raise AssertionError(f"{name} IPM iterate is not finite")
    f64 = stats["f64"]
    if not (f64["solved"] and f64["prim"] <= 1e-6
            and f64["dual_over_scale"] < 1e-4):
        raise AssertionError(f"f64 IPM QP checks: {f64}")
    p_diag, q = build_objective(st, data64)
    cfg = SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000,
                       polish=False, kkt_refine_iters=1)
    sol, wall, _ = no_kernel_run(
        torch, dev, lambda: solve_saa_qp(st, data64, 3, cfg, x0=sols["f64"].x,
                                         y0=sols["f64"].y), "f64 admm QP")
    obj = float(0.5 * torch.sum(p_diag * sol.x * sol.x) + q @ sol.x)
    rel = abs(f64["objective"] - obj) / abs(obj)
    stats["admm_f64"] = {"iters": sol.iters, "solved": sol.solved,
                         "ms": wall * 1e3, "objective": obj,
                         "ipm_objective_rel_diff": rel}
    log(f"f64 'admm' on the same QP at eps 1e-6, warm-started at the IPM "
        f"point: {sol.iters} iterations, {wall * 1e3:.1f} ms, solved "
        f"{sol.solved}, objective {obj:.10e}; the IPM's objective {rel:.3e} "
        f"relative from it")
    if not rel <= 1e-4:
        raise AssertionError(f"IPM objective {rel:.3e} from 'admm''s")
    return stats


def phase9_avar(torch, dev, opt64, gold, mc_om):
    """(b) avar_qp (the IPM on AVaRQPOps) against the sort-based avar in
    float64 on the golden's max-constraint values of phase 3's Monte Carlo
    (10000 samples, seed 99): atol 1e-4 (tests/test_cvar.py:52-61)."""
    from riskaversetrajopt_torch.ops.cvar import avar, avar_qp

    Z = opt64.monte_carlo(gold, mc_om, ALPHA)["max_constraints"]
    v_qp, wall, _ = no_kernel_run(torch, dev, lambda: avar_qp(Z, ALPHA),
                                  "avar_qp")
    v_qp, v = float(v_qp), float(avar(Z, ALPHA))
    log(f"avar_qp over {Z.shape[0]} samples: {v_qp:.10f} in {wall * 1e3:.1f}"
        f" ms; avar {v:.10f}; |difference| {abs(v_qp - v):.3e}")
    if not abs(v_qp - v) <= 1e-4:
        raise AssertionError(f"avar_qp {v_qp} vs avar {v}")
    return {"avar_qp": v_qp, "avar": v, "ms": wall * 1e3}


def phase9_scp(torch, dev, opt64, gold, mc_om, m=M):
    """(c) Three drone SCPs at M=1000 on the fixture omegas, alpha 0.2,
    phase 2's SCP config, each with MC on phase 3's 10000 samples beside
    the golden's: float64 'ipm' (finite iterates; L2 and MC reported only:
    the JAX driver warns that raw IPM solutions can make the SCP oscillate,
    driver.py:71-76), float32 'hybrid' (phase 3's solver config, the
    driver's IPMConfig(tol=1e-5, max_iter=40)) and float32 'admm-ir'
    (parity_config); the last two with finite iterates and MC safe
    fraction >= 1 - alpha. Returns the stats of each."""
    from riskaversetrajopt_torch.scp.driver import l2_error_us

    adm, ir = parity_config()
    runs = (("ipm", torch.float64, {}),
            ("hybrid", torch.float32, dict(admm_cfg=fused_config())),
            ("admm-ir", torch.float32, dict(admm_cfg=adm, ir_cfg=ir)))
    mc_gold = opt64.monte_carlo(gold, mc_om, ALPHA) if gold is not None else None
    stats = {}
    for backend, dtype, kw in runs:
        opt = drone_opt(torch, dev, m, golden_scp_config(), qp_backend=backend,
                        dtype=dtype, **kw)
        om = first_omegas(torch, dtype, dev, m)
        res, wall, counts = no_kernel_run(torch, dev,
                                          lambda: opt.solve(om, ALPHA),
                                          f"{backend!r} SCP")
        for name in ("us", "xs", "l2_errors", "us_history"):
            if not bool(torch.isfinite(getattr(res, name)).all()):
                raise AssertionError(f"{backend!r} {name} is not finite")
        mc = opt64.monte_carlo(res.us.to(torch.float64), mc_om, ALPHA)
        iters = res.qp_iters.tolist()
        st = {"dtype": str(dtype).split(".")[-1], "wall_s": wall,
              "qp_iters": iters, "qp_iters_total": sum(iters),
              "qps_certified": int(res.qp_solved.sum()),
              "mc_safe": float(mc["safe_frac"]),
              "mc_avar": float(mc["avar"]), "mc_cost": float(mc["cost"]),
              "kernel_launches": counts}
        if gold is not None:
            st["l2_vs_golden"] = float(l2_error_us(gold, res.us.to(gold)))
            st["golden_mc_safe"] = float(mc_gold["safe_frac"])
            st["golden_mc_cost"] = float(mc_gold["cost"])
        stats[backend] = st
        log(f"{st['dtype']} {backend!r} SCP M={m}: {wall:.2f} s, QP iterations "
            f"{iters} ({sum(iters)} in all), QPs certified "
            f"{st['qps_certified']} of {len(iters)}, relative L2 vs golden "
            f"{st.get('l2_vs_golden', float('nan')):.3e}; MC safe "
            f"{st['mc_safe']:.4f}, AVaR {st['mc_avar']:.4f}, cost "
            f"{st['mc_cost']:.4f} (golden: safe "
            f"{st.get('golden_mc_safe', float('nan')):.4f}, cost "
            f"{st.get('golden_mc_cost', float('nan')):.4f}); kernel calls "
            f"B1 {counts[0]} B2 {counts[1]}")
        if backend != "ipm" and not st["mc_safe"] >= 1 - ALPHA:
            raise AssertionError(f"{backend!r} MC safe {st['mc_safe']:.4f}")
    return stats


def phase9_hybrid_prox(torch, dev, m=50):
    """(d) '_hybrid-prox' (validated in JAX at small M only) on the drone at
    M=50, float64, with tests/test_scp_drone.py:238-261's SCP config
    (gate_iters 1) cut from 3 iterations to HYBRID_PROX_ITERS, omegas of the
    port's sampler, seed 0: every iterate finite; the QPs certified are
    reported. On these numbers the third QP stops uncertified after 6021
    ADMM iterations in the JAX package as in the port (the same counts on
    the CPU; 13 s of the 27 s on the card); on JAX's PRNGKey(0) sample
    both certify all three."""
    from riskaversetrajopt_torch.core.config import SCPConfig

    scp = SCPConfig(num_iters=HYBRID_PROX_ITERS, gate_iters=1,
                    gate_row_scale=1e-7, gate_bound_l=-0.1, gate_bound_u=0.1)
    opt = drone_opt(torch, dev, m, scp, qp_backend="_hybrid-prox")
    om = opt.sample(torch.Generator().manual_seed(0), m)
    res, wall, _ = no_kernel_run(torch, dev, lambda: opt.solve(om, ALPHA),
                                 "'_hybrid-prox' SCP")
    log(f"f64 '_hybrid-prox' SCP M={m}, {HYBRID_PROX_ITERS} iterations: "
        f"{wall:.2f} s, QP iterations {res.qp_iters.tolist()}, certified "
        f"{res.qp_solved.tolist()}")
    for name in ("us", "xs", "l2_errors"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise AssertionError(f"'_hybrid-prox' {name} is not finite")
    return {"wall_s": wall, "qp_iters": res.qp_iters.tolist(),
            "qp_solved": res.qp_solved.tolist()}


def phase9(torch, dev, opt64, gold):
    """Phase 9: the interior-point family on the card."""
    mc_om = opt64.sample(torch.Generator().manual_seed(99), 10000)
    out = {"ipm_qp_m1000": phase9_ipm_qp(torch, dev, opt64)}
    out["avar_qp_m10000"] = phase9_avar(torch, dev, opt64, gold, mc_om)
    out["scp_m1000"] = phase9_scp(torch, dev, opt64, gold, mc_om)
    out["hybrid_prox_m50"] = phase9_hybrid_prox(torch, dev)
    log("phase 9 summary " + json.dumps(out))
    return out


def launches_per_call(torch, fn):
    """fn() under torch.profiler: (the kernels it launched, counted by the
    runtime's launch calls, and those the device trace shows; None where
    the profiler recorded none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    api = sum(e.count for e in events
              if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                           "cuLaunchKernel", "cudaLaunchCooperativeKernel"))
    dev = sum(e.count for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return api, (dev or None)


def tracking_runs(torch, st, data32, iters, scp_iter=3):
    """`iters` ADMM iterations on one QP from the same cold start at fixed
    rho (adaptive rho off, eps 0: no termination, no refactorization): float64
    and float32 admm_solve, both with the float32 Ruiz scaling that
    solve_saa_qp_ds computes for itself, and solve_saa_qp_ds on the float32
    data. Returns {name: (solution, wall seconds)}."""
    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.ops import admm
    from riskaversetrajopt_torch.ops.admm_ds import solve_saa_qp_ds
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective,
    )

    cfg = SolverConfig(eps_abs=0.0, eps_rel=0.0, max_iter=iters,
                       adaptive_rho=False, polish=False, kkt_refine_iters=1)
    data64 = type(data32)(*(x.double() for x in data32))
    qps = {}
    for name, data in (("f32", data32), ("f64", data64)):
        _, q = build_objective(st, data)
        qps[name] = (SAAQPOps(st, data, scp_iter), q,
                     *build_bounds(st, data, scp_iter))
    sc32 = admm.ruiz_equilibrate(*qps["f32"], iters=5)
    scalings = {"f32": sc32, "f64": admm.Scaling(*(v.double() for v in sc32))}
    dev = data32.G.device
    out = {}
    for name in ("f64", "f32"):
        sol, wall = timed(torch, dev, lambda: admm.admm_solve(
            *qps[name], cfg, scaling=scalings[name]))
        out[name] = (sol, wall)
    out["ds"] = timed(torch, dev,
                      lambda: solve_saa_qp_ds(st, data32, scp_iter, cfg))
    for name, (sol, _) in out.items():
        if sol.iters != iters:
            raise AssertionError(f"{name}: {sol.iters} iterations, not {iters}")
    return out


def timed(torch, dev, fn):
    sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, time.perf_counter() - t0


def phase10_track(torch, dev, st, data32):
    """(a) The ds iterate tracks the float64 one: DS_ITERS iterations on
    phase 1's QP (tracking_runs), ||x_ds - x_64|| <= 0.1 ||x_32 - x_64||;
    ds ms per iteration (the DS_ITERS run, set-up included) and kernels per
    iteration beside float64 admm_solve's: the launches of a 5-iteration
    run (one termination check, check_every 5) less those of a 0-iteration
    run (the set-up), over 5. The profiler's own cost grows with the
    events, so the window is short; with the production check_every of
    25 the check's share per iteration is a fifth of this one's."""
    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.ops import admm
    from riskaversetrajopt_torch.ops.admm_ds import solve_saa_qp_ds
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective,
    )

    runs, _, _ = no_kernel_run(
        torch, dev, lambda: tracking_runs(torch, st, data32, DS_ITERS),
        "the ds tracking runs")
    x64 = runs["f64"][0].x
    norm = lambda v: float(torch.linalg.norm(v.double() - x64))  # noqa: E731
    e32, eds = norm(runs["f32"][0].x), norm(runs["ds"][0].x)
    scale = float(torch.linalg.norm(x64))
    ms = {k: w * 1e3 / DS_ITERS for k, (_, w) in runs.items()}
    data64 = type(data32)(*(x.double() for x in data32))
    _, q64 = build_objective(st, data64)
    ops64 = SAAQPOps(st, data64, 3)
    l64, u64 = build_bounds(st, data64, 3)
    sc64 = admm.ruiz_equilibrate(ops64, q64, l64, u64)
    solvers = {
        "ds": lambda cfg: solve_saa_qp_ds(st, data32, 3, cfg),
        "f64": lambda cfg: admm.admm_solve(ops64, q64, l64, u64, cfg,
                                           scaling=sc64),
    }
    per_it = {}
    for name, solve in solvers.items():
        counts = [launches_per_call(torch, lambda: solve(SolverConfig(
            eps_abs=0.0, eps_rel=0.0, max_iter=n, check_every=5,
            adaptive_rho=False, polish=False))) for n in (0, 5)]
        per_it[name] = {
            "launch_calls": (counts[1][0] - counts[0][0]) / 5,
            "device_kernels": (None if None in (counts[0][1], counts[1][1])
                               else (counts[1][1] - counts[0][1]) / 5)}
    log(f"ds tracking, M={st.M} QP (scp_iter 3), {DS_ITERS} iterations at "
        f"fixed rho from one start: ||x_32 - x_64|| {e32:.3e}, ||x_ds - "
        f"x_64|| {eds:.3e} (||x_64|| {scale:.3e}); ratio {eds / e32:.3e}")
    log(f"  ms per iteration: ds {ms['ds']:.3f}, f32 {ms['f32']:.3f}, f64 "
        f"{ms['f64']:.3f}; kernels per iteration with one check per 5 "
        f"(launch calls / device trace): ds {per_it['ds']}, f64 "
        f"{per_it['f64']}")
    if not eds <= 0.1 * e32:
        raise AssertionError(f"the ds iterate is {eds:.3e} from float64, the "
                             f"float32 one {e32:.3e}")
    return {"iters": DS_ITERS, "err_f32": e32, "err_ds": eds, "x64_norm": scale,
            "ms_per_iter": ms, "kernels_per_iter_check_every_5": per_it}


def ds_config():
    """The JAX bench's ds leg (bench.py:625-626 through make, bench.py:
    57-100, its environment defaults): eps 1e-6, cap 45000, polish off, no
    rho warm start, no explicit Schur inverse, the "factored" KKT
    refinement, rho_update_factor 1.5."""
    from riskaversetrajopt_torch.core.config import SolverConfig

    return SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=45000,
                        polish=False, kkt_refine_iters=1,
                        kkt_refine_mode="factored", rho_update_factor=1.5,
                        rho_warm_start=False, kkt_chol_inverse=False)


def phase10_ds_scp(torch, dev, opt64, gold, mc_om):
    """(b) The float32 'admm-ds' drone SCP at M=1000 on the fixture omegas,
    the bench's ds config, the golden SCP config cut to DS_SCP_ITERS
    iterations: every iterate finite; QPs certified and the L2 to the
    golden reported; MC on phase 9's samples, held to >= 1 - alpha once the
    depth reaches 15."""
    from dataclasses import replace

    from riskaversetrajopt_torch.scp.driver import l2_error_us

    scp = replace(golden_scp_config(), num_iters=DS_SCP_ITERS)
    opt = drone_opt(torch, dev, M, scp, qp_backend="admm-ds",
                    admm_cfg=ds_config(), dtype=torch.float32)
    om = load_omegas(torch, torch.float32, dev)
    res, wall, counts = no_kernel_run(torch, dev, lambda: opt.solve(om, ALPHA),
                                      "'admm-ds' SCP")
    for name in ("us", "xs", "l2_errors", "us_history"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise AssertionError(f"'admm-ds' {name} is not finite")
    mc = opt64.monte_carlo(res.us.to(torch.float64), mc_om, ALPHA)
    iters = res.qp_iters.tolist()
    st = {"scp_iters": DS_SCP_ITERS, "wall_s": wall, "qp_iters": iters,
          "qps_certified": int(res.qp_solved.sum()),
          "l2_vs_golden": float(l2_error_us(gold, res.us.to(gold))),
          "mc_safe": float(mc["safe_frac"]), "mc_cost": float(mc["cost"]),
          "kernel_launches": counts}
    log(f"f32 'admm-ds' SCP M={M}, {DS_SCP_ITERS} SCP iterations: {wall:.2f} "
        f"s, QP iterations {iters}, QPs certified {st['qps_certified']} of "
        f"{len(iters)}, relative L2 vs the 15-iteration golden "
        f"{st['l2_vs_golden']:.3e}; MC safe {st['mc_safe']:.4f}, cost "
        f"{st['mc_cost']:.4f}; kernel calls B1 {counts[0]} B2 {counts[1]}")
    if DS_SCP_ITERS >= SCP_ITERS and not st["mc_safe"] >= 1 - ALPHA:
        raise AssertionError(f"'admm-ds' MC safe {st['mc_safe']:.4f}")
    return st


def phase10_gaussian(torch, dev):
    """(c) The Gaussian car at CarScenario(): float64 'ipm', alpha 0.1,
    GAUSS_ITERS SCP iterations, held to tests/test_gaussian.py:47-62 (every
    QP converged, last L2 < 1e-4, the risk budget and floor, padded
    separation <= 1e-6, mean final state at the goal within 1e-5); float32
    'admm-ir', alpha 0.05, GAUSS_PAIR_ITERS iterations, every QP
    certified, within 1e-3 relative L2 of float64 'ipm''s at alpha 0.05 and
    the same depth
    (tests/test_f32_gaussian.py:92-117); both plans' MC safe fraction and
    cost on phase 7's 10000 car samples (seed 99), reported."""
    from riskaversetrajopt_torch.core.config import CarScenario
    from riskaversetrajopt_torch.models.car_gaussian import GaussianCarPlanner

    car = car_opt(torch)
    mc_om = car.sample(torch.Generator().manual_seed(99), 10000)
    out = {}
    runs = (("f64_ipm_a0.1", 0.1, GAUSS_ITERS, torch.float64),
            ("f64_ipm_a0.05", 0.05, GAUSS_PAIR_ITERS, torch.float64),
            ("f32_admm-ir_a0.05", 0.05, GAUSS_PAIR_ITERS, torch.float32))
    res = {}
    for name, alpha, iters, dtype in runs:
        p = GaussianCarPlanner(CarScenario(), alpha=alpha, num_scp_iters=iters,
                               dtype=dtype)
        r, wall, _ = no_kernel_run(torch, dev, p.solve, f"Gaussian car {name}")
        res[name] = (p, r)
        mc = car.monte_carlo(r.us.to(torch.float64), mc_om, alpha)
        st = {"wall_s": wall, "qps_certified": int(r.qp_solved.sum()),
              "scp_iters": iters, "l2_last": float(r.l2_errors[-1]),
              "sum_alphas": float(torch.sum(r.alphas_risk)),
              "mc_safe": float(mc["safe_frac"]), "mc_cost": float(mc["cost"])}
        out[name] = st
        log(f"Gaussian car {name}: {wall:.2f} s, {iters} SCP iterations, "
            f"QPs certified {st['qps_certified']}, last L2 {st['l2_last']:.3e},"
            f" sum(alphas_risk) {st['sum_alphas']:.6f}; MC (10000 car "
            f"samples, seed 99) safe {st['mc_safe']:.4f}, cost "
            f"{st['mc_cost']:.4f}")
        if not bool(torch.isfinite(r.us).all()) or not all(r.qp_solved.tolist()):
            raise AssertionError(f"Gaussian car {name}: {r.qp_solved.tolist()}")
    p, r = res["f64_ipm_a0.1"]
    sep = float(torch.max(p.separation_constraints(r.us, r.alphas_risk)))
    goal = torch.cat([p.scn.position_ego_goal, p.scn.velocity_ego_goal]).to(r.xs)
    final = float(torch.max(torch.abs(r.xs[-1, :4] - goal)))
    a = r.alphas_risk
    if not (out["f64_ipm_a0.1"]["l2_last"] < 1e-4
            and float(a.sum()) <= 0.1 + 1e-6
            and float(a.min()) >= 100 * p.OSQP_TOL - 1e-12
            and sep <= 1e-6 and final <= 1e-5):
        raise AssertionError(f"Gaussian car f64 contract: padded separation "
                             f"{sep:.3e}, final state {final:.3e}, "
                             f"{out['f64_ipm_a0.1']}")
    us32, us64 = (res[k][1].us.double() for k in ("f32_admm-ir_a0.05",
                                                   "f64_ipm_a0.05"))
    rel = float(torch.linalg.norm(us32 - us64) / torch.linalg.norm(us64))
    out["f32_vs_f64_rel_l2"] = rel
    log(f"Gaussian car: f64 padded separation max {sep:.3e}, final-state "
        f"error {final:.3e}; f32 'admm-ir' vs f64 'ipm' at alpha 0.05: "
        f"relative L2 {rel:.3e}")
    if not rel <= 1e-3:
        raise AssertionError(f"Gaussian car f32 vs f64: {rel:.3e}")
    return out


def phase10(torch, dev, problem, opt64, gold):
    """Phase 10: the double-single ADMM and the Gaussian car on the card."""
    _, _, _, _, st, data32 = problem
    mc_om = opt64.sample(torch.Generator().manual_seed(99), 10000)
    out = {"ds_tracking_m1000": phase10_track(torch, dev, st, data32)}
    out["ds_scp_m1000"] = phase10_ds_scp(torch, dev, opt64, gold, mc_om)
    out["gaussian_car"] = phase10_gaussian(torch, dev)
    log("phase 10 summary " + json.dumps(out))
    return out


HOPPER_MC_M = 10000  # the hopper CLI's default Monte-Carlo fields
HOPPER_ALPHA = 0.3


def nlp_per_iteration(torch, dev, solve, profile_iters, eager_iters=5,
                      graph_iters=100):
    """The barrier iteration's cost, from runs of solve(n, graphs) with n
    iterations, each less an n = 0 run (the set-up): kernels per iteration
    (eager, profile_iters iterations under torch.profiler; none with
    profile_iters 0), ms per iteration eager (eager_iters) and replayed
    from CUDA graphs (graph_iters), and the seconds the graphs' capture
    adds to the set-up."""
    out = {}
    if profile_iters:
        counts = [launches_per_call(torch, lambda: solve(n, False))
                  for n in (0, profile_iters)]
        out["launch_calls"] = (counts[1][0] - counts[0][0]) / profile_iters
        out["device_kernels"] = (
            None if None in (counts[0][1], counts[1][1])
            else (counts[1][1] - counts[0][1]) / profile_iters)
    setup = {}
    for graphs, iters in ((False, eager_iters), (True, graph_iters)):
        walls = [timed(torch, dev, lambda: solve(n, graphs))[1]
                 for n in (0, iters)]
        setup[graphs] = walls[0]
        out["ms_graphs" if graphs else "ms_eager"] = (
            (walls[1] - walls[0]) * 1e3 / iters)
    out["capture_s"] = setup[True] - setup[False]
    return out


def in_dir(path, fn):
    """fn() with the working directory set to path (the CLIs write their
    figures under ./figures)."""
    import os

    old = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(old)


def phase11_hopper_cli(torch, dev, tmp):
    """(a) The hopper CLI at HopperScenario() (M=30, S=30, 400 variables, a
    1945^2 KKT matrix), float64, --alphas 0.3, with the figure where this
    host has matplotlib: the damped cold baseline solved at jump > 0.9, the
    warm SAA phase solved at jump > 0.3, both files in the JAX layout, both
    MC lines from HOPPER_MC_M fresh fields with finite values; iterations,
    ms and kernels per barrier iteration."""
    import re

    import numpy as np

    from riskaversetrajopt_torch.experiments import hopper
    from riskaversetrajopt_torch.models.hopper import HopperModel
    from riskaversetrajopt_torch.ops.nlp_ipm import NLPConfig, solve_nlp

    rdir = f"{tmp}/hopper"
    plot = ["--plot"] if have_matplotlib() else []
    (out, wall), _, _ = no_kernel_run(torch, dev, lambda: in_dir(
        tmp, lambda: run_cli(hopper.main, [
            "--alphas", str(HOPPER_ALPHA), "--mc-M", str(HOPPER_MC_M),
            "--results", rdir] + plot, dev)), "hopper CLI")
    solves = re.findall(r"iters=(\d+) solved=(\w+) prim=(\S+) dual=(\S+) "
                        r"jumped=(\S+)", out)
    stages = [float(v) for v in re.findall(r"stage wall time (\S+) s", out)]
    mc_b = re.search(r"baseline: jumped=\S+ safe=(\S+)", out)
    mc_s = re.search(rf"alpha={HOPPER_ALPHA}: jumped=\S+ safe=(\S+) "
                     r"avar=(\S+)", out)
    if len(solves) != 2 or len(stages) != 3 or not (mc_b and mc_s):
        raise AssertionError("hopper CLI: missing solve, stage or MC lines")
    st = {}
    for name, (iters, solved, prim, dual, jump), secs in zip(
            ("baseline", "saa"), solves, stages):
        st[name] = {"iters": int(iters), "solved": solved == "True",
                    "prim": float(prim), "dual": float(dual),
                    "jump": float(jump), "wall_s": secs,
                    "ms_per_iter": secs * 1e3 / max(int(iters), 1)}
    st["mc_wall_s"] = stages[2]
    st["mc_safe_baseline"] = float(mc_b[1])
    st["mc_safe_saa"], st["mc_avar_saa"] = float(mc_s[1]), float(mc_s[2])
    for f in ("hopper_base_results.npy",
              f"hopper_saa_alpha={HOPPER_ALPHA}_results.npy"):
        xs, us = hopper.load_xs_us(f"{rdir}/{f}")
        if xs.shape != (31, 8) or us.shape != (30, 4) or not (
                np.isfinite(xs).all() and np.isfinite(us).all()):
            raise AssertionError(f"{f}: {xs.shape}, {us.shape}")
    if plot and not Path(tmp, "figures", "hopper_trajectories.png").is_file():
        raise AssertionError("hopper CLI: no figure")

    # the barrier iteration: the warm SAA solve from the baseline
    model = HopperModel(device=dev)
    xs, us = hopper.load_xs_us(f"{rdir}/hopper_base_results.npy")
    Z0 = torch.zeros(model.num_vars, dtype=torch.float64, device=dev)
    Z0[: xs.size] = torch.as_tensor(xs.reshape(-1))
    Z0[xs.size : xs.size + us.size] = torch.as_tensor(us.reshape(-1))
    field = model.sample_friction(torch.Generator().manual_seed(1), model.M)
    nlp = model.make_nlp(field, "saa", HOPPER_ALPHA)
    st["per_iter"] = nlp_per_iteration(torch, dev, lambda n, graphs: (
        solve_nlp(*nlp, Z0, NLPConfig(tol=1e-3, max_iter=n),
                  cuda_graphs=graphs)), 3, eager_iters=10)
    log(f"hopper CLI (f64, alpha {HOPPER_ALPHA}): {wall:.2f} s; baseline "
        f"{st['baseline']}; SAA {st['saa']}; MC ({HOPPER_MC_M} fields, "
        f"{stages[2]:.2f} s) safe baseline {st['mc_safe_baseline']:.4f}, "
        f"SAA {st['mc_safe_saa']:.4f}, SAA AVaR {st['mc_avar_saa']:.5f}; "
        f"the SAA barrier iteration {st['per_iter']}")
    b, a = st["baseline"], st["saa"]
    if not (b["solved"] and b["jump"] > 0.9 and a["solved"]
            and a["jump"] > 0.3 and np.isfinite(st["mc_avar_saa"])):
        raise AssertionError(f"hopper CLI: {st}")
    return st


def phase11_hopper_f32(torch, dev):
    """(b) The hopper in float32 through the model API with three Ruiz
    sweeps: the cold damped baseline (50 / 0.1, tol 1e-4, cap 120) solved
    within 0.11 of the float64 basin's jump 1.053
    (tests/test_hopper.py:185-211); the SAA phase at alpha 0.3 warm-started
    from tests/fixtures/hopper_base_Z.npy (tol 1e-3, cap 100) solved at
    jump > 0.3 (tests/test_hopper.py:214-241)."""
    import numpy as np

    from riskaversetrajopt_torch.models.hopper import HopperModel
    from riskaversetrajopt_torch.ops.nlp_ipm import NLPConfig, solve_nlp

    model = HopperModel(device=dev)
    f32 = torch.float32
    runs = {
        "baseline": (model.sample_friction(torch.Generator().manual_seed(1),
                                           model.M, "baseline"),
                     "baseline", 0.1, model.initial_guess(model.M, f32),
                     NLPConfig(tol=1e-4, max_iter=120, kkt_ruiz_iters=3,
                               damp_iters=50, damp_max=0.1)),
        "saa": (model.sample_friction(torch.Generator().manual_seed(0),
                                      model.M),
                "saa", HOPPER_ALPHA,
                torch.as_tensor(np.load(FIXTURES / "hopper_base_Z.npy"),
                                dtype=f32, device=dev),
                NLPConfig(tol=1e-3, max_iter=100, kkt_ruiz_iters=3)),
    }
    st = {}
    for name, (field, method, alpha, Z0, cfg) in runs.items():
        f, g, gL, gU, n_eq, xL, xU = model.make_nlp(field, method, alpha)
        res, wall, _ = no_kernel_run(torch, dev, lambda: solve_nlp(
            f, g, gL, gU, n_eq, xL, xU, Z0, cfg), f"f32 hopper {name}")
        xs = model.split_z(res.Z)[0]
        st[name] = {"iters": res.iters, "solved": res.solved,
                    "prim": float(res.prim_res), "dual": float(res.dual_res),
                    "jump": float(xs[-1, 0]), "wall_s": wall,
                    "ms_per_iter": wall * 1e3 / max(res.iters, 1),
                    "finite": bool(torch.isfinite(res.Z).all())}
        log(f"f32 hopper {name}: {st[name]}")
    b, a = st["baseline"], st["saa"]
    if not (b["solved"] and abs(b["jump"] - 1.053) < 0.11 and a["solved"]
            and a["jump"] > 0.3 and b["finite"] and a["finite"]):
        raise AssertionError(f"f32 hopper: {st}")
    return st


def phase11_drone_gaussian_cli(torch, dev, rdir):
    """(c) The drone_gaussian CLI at alpha DRONE_CLI_ALPHA, float64, tol
    1e-6, cap 1500, warm-started from the drone_risk CLI's SAA file in
    rdir: solved, dual <= 1e-5, sum of the risk allocations <= alpha +
    1e-6 (tests/test_gaussian.py:124-152); its file read back; iterations,
    wall time, ms per barrier iteration eager and replayed (its ~5000
    kernels per eager iteration are not profiled here: the profiler's
    trace of them took ~40 s of the script)."""
    import re

    import numpy as np

    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.experiments import common, drone_gaussian
    from riskaversetrajopt_torch.models.drone_gaussian import (
        GaussianDronePlanner,
    )
    from riskaversetrajopt_torch.ops.nlp_ipm import NLPConfig, solve_nlp

    (out, wall), _, _ = no_kernel_run(torch, dev, lambda: run_cli(
        drone_gaussian.main, ["--alphas", str(DRONE_CLI_ALPHA), "--tol", "1e-6",
                              "--max-iter", "1500", "--results", rdir], dev),
        "drone_gaussian CLI")
    m = re.search(r"iters=(\d+) solved=(\w+) prim=(\S+) dual=(\S+) "
                  r"sum\(alphas\)=(\S+)", out)
    if m is None:
        raise AssertionError("drone_gaussian CLI: no result line")
    st = {"iters": int(m[1]), "solved": m[2] == "True", "prim": float(m[3]),
          "dual": float(m[4]), "sum_alphas": float(m[5]), "wall_s": wall,
          "ms_per_iter": wall * 1e3 / max(int(m[1]), 1)}
    a = DRONE_CLI_ALPHA
    us, xs = common.load_traj(f"{rdir}/drone_gaussian_alpha={a}.npy")
    us_init, _ = common.load_traj(f"{rdir}/drone_alpha={a}_repeat=0.npy")
    p = GaussianDronePlanner(DroneScenario(), alpha=DRONE_CLI_ALPHA, device=dev)
    Z0 = p.initial_guess(torch.as_tensor(us_init))
    st["per_iter"] = nlp_per_iteration(torch, dev, lambda n, graphs: (
        solve_nlp(p.f, p.g, *p.bounds(), Z0, NLPConfig(tol=1e-6, max_iter=n),
                  cuda_graphs=graphs)), 0)
    log(f"drone_gaussian CLI (f64, alpha {DRONE_CLI_ALPHA}): {st}")
    if not (st["solved"] and st["dual"] <= 1e-5
            and st["sum_alphas"] <= DRONE_CLI_ALPHA + 1e-6
            and us.shape == (20, 3) and xs.shape == (21, 6)
            and np.isfinite(xs).all()):
        raise AssertionError(f"drone_gaussian CLI: {st}")
    return st


def have_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def phase11_terrains(torch, dev, tmp):
    """(d) The terrains_gaussian CLI: its ten fields at 400 positions,
    finite and within the feature bound of mu_nom; its figure where this
    host has matplotlib (the CLI draws it with matplotlib, which the card's
    host may lack: then only the fields are computed and held)."""
    import math

    from riskaversetrajopt_torch.experiments import terrains_gaussian
    from riskaversetrajopt_torch.models.hopper import HopperModel

    model = HopperModel(device=dev)
    s = model.scn
    (pxs, mus), wall, _ = no_kernel_run(
        torch, dev, lambda: terrains_gaussian.friction_fields(model, 10, 1),
        "terrains_gaussian fields")
    bound = s.num_mu_features * s.mu_intensity_scale * math.sqrt(
        2.0 / s.num_mu_features)
    dev_max = float(torch.amax(torch.abs(mus - s.mu_nom)))
    st = {"fields_wall_s": wall, "max_abs_mu_minus_nom": dev_max,
          "figure": have_matplotlib()}
    if not (mus.shape == (10, 400) and bool(torch.isfinite(mus).all())
            and dev_max <= bound):
        raise AssertionError(f"terrains_gaussian fields: {st}")
    if st["figure"]:
        (_, st["cli_wall_s"]), _, _ = no_kernel_run(torch, dev, lambda: in_dir(
            tmp, lambda: run_cli(terrains_gaussian.main, [], dev)),
            "terrains_gaussian CLI")
        if not Path(tmp, "figures", "hopper_friction_fields.png").is_file():
            raise AssertionError("terrains_gaussian CLI: no figure")
    log(f"terrains_gaussian: {st} (figure drawn only where matplotlib is "
        f"installed)")
    return st


def phase11(torch, dev, drone_gauss):
    """Phase 11: the NLP family on the card; (c) ran inside phase 8's drone
    directory and its stats come in as drone_gauss."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["hopper_cli"] = phase11_hopper_cli(torch, dev, tmp)
        out["hopper_f32"] = phase11_hopper_f32(torch, dev)
        out["drone_gaussian_cli"] = drone_gauss
        out["terrains_cli"] = phase11_terrains(torch, dev, tmp)
    log("phase 11 summary " + json.dumps(out))
    return out

# phase 12: ADMM iterations of the two-rank QP (a fixed count: phase 1's QP
# does not certify from a cold start within it); the depth of the one-rank
# sharded SCP (its two gated iterations and the first past them) and the
# ADMM cap of its QPs, cut from the driver's 20000 (the third QP runs to
# that cap, 131 s sharded); the Anderson depth held against the plain
# iteration and the cap of both runs, cut from 20000 (at 20000 both
# certify, in 18325 and 8625 iterations, 76 s together on an H100, PERF.md)
SHARD_QP_ITERS, SHARD_SCP_ITERS, SHARD_SCP_CAP = 200, 3, 1000
AA_DEPTH, AA_CAP = 5, 3000
# phase 13(c), (d): the sample count of the one-rank sharded checkpoint and
# of '_hybrid-prox' (phase 9(d)'s)
SHARD_CKPT_M = 50


def phase12_anderson(torch, dev, opt64, res64, cap=AA_CAP):
    """(a) Anderson acceleration on the float64 'admm' QP of scp_iter 3 of
    phase 2's SCP (the first post-gating transition: its define phase at
    phase 2's controls after scp_iter 2, the fixture omegas), from a cold
    start with the driver's solver config, its cap cut to `cap`, at depth 0
    and AA_DEPTH: iterations, ms, solved, the residuals reached, the
    objective gap, ms per iteration."""
    import dataclasses

    from riskaversetrajopt_torch.ops.saa_qp import build_objective, solve_saa_qp

    om = load_omegas(torch, torch.float64, dev)
    alpha = torch.tensor(ALPHA, dtype=torch.float64, device=dev)
    data = opt64._define(res64.us_history[2], om, alpha)
    st = opt64._static_for(M)
    p_diag, q = build_objective(st, data)
    out = {}
    for depth in (0, AA_DEPTH):
        cfg = dataclasses.replace(opt64.admm_cfg, anderson_depth=depth,
                                  max_iter=cap)
        sol, wall, _ = no_kernel_run(
            torch, dev, lambda: solve_saa_qp(st, data, 3, cfg),
            f"'admm' QP at Anderson depth {depth}")
        if not bool(torch.isfinite(sol.x).all()):
            raise AssertionError(f"Anderson depth {depth}: x is not finite")
        obj = float(0.5 * torch.sum(p_diag * sol.x * sol.x) + q @ sol.x)
        out[f"depth_{depth}"] = {
            "iters": sol.iters, "ms": wall * 1e3, "solved": sol.solved,
            "prim_res": float(sol.prim_res), "dual_res": float(sol.dual_res),
            "objective": obj, "ms_per_iter": wall * 1e3 / max(sol.iters, 1)}
    o0, o5 = out["depth_0"]["objective"], out[f"depth_{AA_DEPTH}"]["objective"]
    out["objective_gap"] = abs(o5 - o0) / abs(o0)
    for k in ("depth_0", f"depth_{AA_DEPTH}"):
        r = out[k]
        log(f"f64 'admm' QP of scp_iter 3 (M={M}, cap {cap}), Anderson "
            f"{k}: {r['iters']} iterations, {r['ms']:.1f} ms "
            f"({r['ms_per_iter']:.3f} ms each), solved {r['solved']}, prim "
            f"{r['prim_res']:.3e}, dual {r['dual_res']:.3e}, objective "
            f"{r['objective']:.10e}")
    log(f"  objective gap depth {AA_DEPTH} vs 0: {out['objective_gap']:.3e}")
    return out


def bitwise_scp(torch, a, b):
    """Whether two SCP results have the same controls, iteration counts
    and flags, bit for bit."""
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in (
        (a.us_history, b.us_history), (a.qp_iters, b.qp_iters),
        (a.qp_solved, b.qp_solved)))


def phase12_shard_scp(torch, dev, cap=SHARD_SCP_CAP):
    """(b1) The sample-sharded float64 'admm' drone SCP on a one-rank NCCL
    group (M=1000, the fixture omegas, the golden config cut to
    SHARD_SCP_ITERS iterations, the driver's solver config with its cap
    cut to `cap`) against the unsharded run of the same config; the
    collectives per ADMM iteration."""
    import dataclasses

    import torch.distributed as dist

    from riskaversetrajopt_torch.core.config import DroneScenario, SolverConfig
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.parallel import distributed as pd
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    scp = dataclasses.replace(golden_scp_config(), num_iters=SHARD_SCP_ITERS)

    # the driver's default solver config (scp/driver.py), its cap cut
    admm_cfg = SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=cap,
                            polish=False, kkt_refine_iters=1)

    def make(group=None):
        return SAATrajOpt(DroneModel(DroneScenario(M=M)), scp_cfg=scp,
                          admm_cfg=admm_cfg, group=group)

    om = load_omegas(torch, torch.float64, dev)
    ref, t_ref, _ = no_kernel_run(
        torch, dev, lambda: make().solve(om, alpha=ALPHA), "unsharded SCP")
    pd.initialize(f"tcp://localhost:{free_port()}", 1, 0, device=dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        opt = make(dist.group.WORLD)
        with pd.audit() as calls:
            res, wall, _ = no_kernel_run(
                torch, dev, lambda: opt.solve(om, alpha=ALPHA),
                "sharded 'admm' SCP")
    finally:
        pd.shutdown()
    bitwise = bitwise_scp(torch, res, ref)
    diff = float(torch.max(torch.abs(res.us_history - ref.us_history)))
    iters = int(res.qp_iters.sum())
    st = pd.collective_summary(calls, iters)
    log(f"sharded f64 'admm' SCP, one NCCL rank, M={M}, {SHARD_SCP_ITERS} SCP "
        f"iterations, ADMM cap {cap}: {wall:.2f} s (unsharded {t_ref:.2f} s), "
        f"qp_iters {res.qp_iters.tolist()} (unsharded "
        f"{ref.qp_iters.tolist()}), controls bit for bit the unsharded "
        f"run's {bitwise} (max |diff| {diff:.3e}); collectives "
        f"{st['calls']} ({st['calls_per_iter']:.2f} and "
        f"{st['bytes_per_iter']:.0f} B per ADMM iteration, largest "
        f"{st['max_elements']} elements)")
    if diff > 1e-8 * max(1.0, float(torch.max(torch.abs(ref.us_history)))):
        raise AssertionError(f"sharded SCP {diff:.3e} from the unsharded one")
    return {"s": wall, "unsharded_s": t_ref, "qp_iters": res.qp_iters.tolist(),
            "bitwise": bitwise, "max_abs_diff": diff, "collectives": st}


def free_port():
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def shard_qp(torch, dev, shard=None, group=None, backend="admm",
             reverse=False):
    """Phase 1's QP (a define phase at the initial guess, scp_iter 3, the
    fixture omegas, in reverse order with `reverse`; under `shard` this
    process's samples) solved by float64 'admm' for SHARD_QP_ITERS
    iterations (eps 1e-14, polish off, the driver's KKT config), or with
    `backend` "ipm" by the IPM of phase 9(a) (tol 1e-5, cap 100). Returns
    (solution, wall seconds, static, data)."""
    from riskaversetrajopt_torch.core.config import DroneScenario, SolverConfig
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.ops.ipm import IPMConfig, solve_qp_ipm
    from riskaversetrajopt_torch.parallel.distributed import shard_samples_global
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective, solve_saa_qp,
    )
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    opt = SAATrajOpt(DroneModel(DroneScenario(M=M), device=dev),
                     scp_cfg=golden_scp_config(), device=dev, group=group)
    om = first_omegas(torch, torch.float64, dev, M)
    if reverse:
        om = type(om)(*(x.flip(0) for x in om))
    if shard is not None:
        om = shard_samples_global(om, M, group)
    alpha = torch.tensor(ALPHA, dtype=torch.float64, device=dev)
    data = opt._define(opt.model.initial_guess(), om, alpha, shard)
    st = opt._static_for(M)
    cfg = SolverConfig(eps_abs=1e-14, eps_rel=1e-14, max_iter=SHARD_QP_ITERS,
                       polish=False, kkt_refine_iters=1)
    _, q = build_objective(st, data)
    l, u = build_bounds(st, data, 3, shard)
    sync(torch, dev)
    t0 = time.perf_counter()
    if backend == "ipm":
        sol = solve_qp_ipm(SAAQPOps(st, data, 3, shard=shard), q, l, u,
                           n_eq=st.n_fc, cfg=IPMConfig(tol=1e-5, max_iter=100))
    else:
        sol = solve_saa_qp(st, data, 3, cfg, shard=shard)
    sync(torch, dev)
    return sol, time.perf_counter() - t0, st, data


def shard_worker(argv):
    """One of the two ranks of phase 12(b2) or 13(b) on the card (gloo,
    CUDA tensors): its half of phase 1's QP (`--backend` admm or ipm);
    prints the global x and y (gathered after the solve), iterations,
    solved, time, the solve's collectives and both kernels' counts as one
    JSON line."""
    import torch

    sys.path.insert(0, str(REPO))
    from riskaversetrajopt_torch.ops.saa_qp import gather_warm
    from riskaversetrajopt_torch.parallel import distributed as pd

    init, rank = argv[argv.index("--init") + 1], int(argv[argv.index("--rank") + 1])
    backend = argv[argv.index("--backend") + 1]
    dev = torch.device(argv[argv.index("--device") + 1])
    pd.initialize(init, 2, rank, backend="gloo", device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    shard = pd.SampleShard(M, dist.group.WORLD)
    with pd.audit() as calls:
        sol, wall, st, _ = shard_qp(torch, dev, shard, dist.group.WORLD,
                                    backend)
    x, y = gather_warm(st, shard, sol.x, sol.y)
    counts = [c.launches for c in kernel_counters()]
    print("SHARD_OK " + json.dumps({
        "rank": rank, "x": x.cpu().tolist(), "y": y.cpu().tolist(),
        "iters": sol.iters, "solved": sol.solved, "s": wall,
        "collectives": pd.collective_summary(calls, sol.iters),
        "kernel_launches": counts}), flush=True)
    pd.shutdown()
    return 0


def two_rank_qp(torch, dev, backend):
    """Phase 1's QP at M=1000 through `backend` on two ranks sharing the
    card (gloo with CUDA tensors, 500 samples each, this script run as
    `--shard-worker`) against the unsharded solve, both ranks bit for bit
    alike; collectives per iteration. "admm" (SHARD_QP_ITERS iterations, a
    contraction): the state within 1e-8 of (1 + |x|). "ipm": the IPM on
    this QP moves u by ~1e-2 under any change of the order of its sums
    (the unsharded solve of the samples in reverse order too: a nearly
    flat objective in u at tol 1e-5), so the gathered (x, y) is held to
    phase 9(a)'s bounds on the unsharded operator (certified, primal <=
    1e-6, dual / d_scale < 1e-4, the objective within 1e-4 relative of the
    unsharded solve's); u's distance and the objective's from the unsharded
    solve are reported beside the reversed-order solve's."""
    init = f"tcp://localhost:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--shard-worker",
         "--init", init, "--rank", str(r), "--backend", backend,
         "--device", str(dev)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines() if ln.startswith("SHARD_OK ")]
        if p.returncode != 0 or not line:
            raise AssertionError(f"rank {r} failed:\n{out[-3000:]}")
        res.append(json.loads(line[-1][len("SHARD_OK "):]))
    if res[0]["x"] != res[1]["x"] or res[0]["y"] != res[1]["y"]:
        raise AssertionError("the two ranks hold different solutions")
    if any(any(r["kernel_launches"]) for r in res):
        raise AssertionError("a rank launched a fused kernel")
    sol, wall, _ = no_kernel_run(
        torch, dev, lambda: shard_qp(torch, dev, backend=backend),
        f"unsharded {backend} QP")
    x = sol[0].x
    xs = torch.tensor(res[0]["x"], dtype=torch.float64, device=dev)

    def rel(a, b):
        return float(torch.max(torch.abs(a - b) / (1 + torch.abs(b))))

    st = res[0]["collectives"]
    out = {"ms": res[0]["s"] * 1e3, "unsharded_ms": sol[1] * 1e3,
           "iters": res[0]["iters"], "unsharded_iters": sol[0].iters,
           "max_rel_err": rel(xs, x), "collectives": st,
           "kernel_launches": [sum(r["kernel_launches"][k] for r in res)
                               for k in range(2)]}
    log(f"phase 1's QP through {backend!r} on two ranks sharing the card "
        f"(gloo, {M // 2} samples each), {res[0]['iters']} iterations "
        f"(unsharded {sol[0].iters}): {res[0]['s'] * 1e3:.1f} ms (unsharded "
        f"{sol[1] * 1e3:.1f} ms), ranks bit for bit alike, max |x - "
        f"x_unsharded| / (1 + |x|) {out['max_rel_err']:.3e}; collectives "
        f"{st['calls_per_iter']:.2f} and {st['bytes_per_iter']:.0f} B per "
        f"iteration, largest {st['max_elements']} elements")
    if backend == "admm":
        if out["max_rel_err"] > 1e-8:
            raise AssertionError(f"two-rank QP {out['max_rel_err']:.3e} "
                                 "from the unsharded one")
        return out
    n = sol[2].n
    ys = torch.tensor(res[0]["y"], dtype=torch.float64, device=dev)
    prim, dual, d_scale, obj = kkt_stats(torch, sol[2], sol[3], xs, ys)
    *_, obj_u = kkt_stats(torch, sol[2], sol[3], x, sol[0].y)
    rev, _, st_r, data_r = shard_qp(torch, dev, backend=backend,
                                    reverse=True)
    *_, obj_r = kkt_stats(torch, st_r, data_r, rev.x, rev.y)
    out.update(prim=prim, dual_over_scale=dual / d_scale,
               objective_rel_diff=abs(obj - obj_u) / abs(obj_u),
               objective_rel_diff_reversed_order=abs(obj_r - obj_u) / abs(obj_u),
               u_rel_err=rel(xs[:n], x[:n]),
               u_rel_err_reversed_order=rel(rev.x[:n], x[:n]))
    log(f"  two ranks: solved {res[0]['solved']}, primal violation "
        f"{prim:.3e}, dual / d_scale {dual / d_scale:.3e}; from the "
        f"unsharded solve: objective {out['objective_rel_diff']:.3e} "
        f"relative, u {out['u_rel_err']:.3e}; the unsharded solve of the "
        f"samples in reverse order ({rev.iters} iterations): objective "
        f"{out['objective_rel_diff_reversed_order']:.3e}, u "
        f"{out['u_rel_err_reversed_order']:.3e}")
    if not (res[0]["solved"] and prim <= 1e-6 and dual / d_scale < 1e-4
            and out["objective_rel_diff"] <= 1e-4):
        raise AssertionError(f"two-rank IPM QP checks: {out}")
    return out


def phase12_two_ranks(torch, dev):
    """(b2) Phase 1's QP through 'admm' on two ranks sharing the card."""
    return two_rank_qp(torch, dev, "admm")


def shard_scp_runs(torch, group):
    """(backend, dtype, samples, SCP config, SAATrajOpt keywords) of the
    one-rank sharded SCPs of phase 13 in the phase `group`. "ipm", (a):
    float64 'ipm', float32 'hybrid' (phase 3's solver config) and float32
    'admm-ir' (parity_config) at M=1000, the golden config cut to
    SHARD_SCP_ITERS, every ADMM leg capped at SHARD_SCP_CAP. "ds", (d):
    float32 'admm-ds' as phase 10(b) runs it, and float64 '_hybrid-prox'
    at M=50 with phase 9(d)'s SCP config, its ADMM legs capped at
    SHARD_SCP_CAP."""
    import dataclasses

    from riskaversetrajopt_torch.core.config import SCPConfig

    def golden(iters):
        return dataclasses.replace(golden_scp_config(), num_iters=iters)

    if group == "ds":
        prox = SCPConfig(num_iters=HYBRID_PROX_ITERS, gate_iters=1,
                         gate_row_scale=1e-7, gate_bound_l=-0.1,
                         gate_bound_u=0.1)
        return (("admm-ds", torch.float32, M, golden(DS_SCP_ITERS),
                 dict(admm_cfg=ds_config())),
                ("_hybrid-prox", torch.float64, SHARD_CKPT_M, prox,
                 dict(hybrid_cap=SHARD_SCP_CAP)))
    adm, ir = parity_config()
    scp = golden(SHARD_SCP_ITERS)
    return (("ipm", torch.float64, M, scp, {}),
            ("hybrid", torch.float32, M, scp, dict(admm_cfg=dataclasses.replace(
                fused_config(), max_iter=SHARD_SCP_CAP))),
            ("admm-ir", torch.float32, M, scp, dict(
                admm_cfg=dataclasses.replace(adm, max_iter=SHARD_SCP_CAP),
                ir_cfg=ir._replace(base_max_iter=SHARD_SCP_CAP))))


def phase13_shard_scps(torch, dev, group, runs):
    """(a), (d) The drone SCP (the first m fixture omegas) through each
    run of shard_scp_runs on the one-rank NCCL `group` against its
    unsharded run: bit for bit (controls, iteration counts, flags); the
    collectives per QP iteration (Mehrotra iterations for 'ipm'; for
    'hybrid' its ADMM iterations, the IPM legs' collectives counted in;
    for 'admm-ir' and '_hybrid-prox' every leg's ADMM iterations)."""
    from riskaversetrajopt_torch.parallel import distributed as pd

    out = {}
    for backend, dtype, m, scp, kw in runs:
        om = first_omegas(torch, dtype, dev, m)

        def make(group=None):
            return drone_opt(torch, dev, m, scp, qp_backend=backend,
                             dtype=dtype, group=group, **kw)

        ref, t_ref, _ = no_kernel_run(torch, dev,
                                      lambda: make().solve(om, ALPHA),
                                      f"unsharded {backend!r} SCP")
        opt = make(group)
        with pd.audit() as calls:
            res, wall, counts = no_kernel_run(
                torch, dev, lambda: opt.solve(om, ALPHA),
                f"sharded {backend!r} SCP")
        bitwise = bitwise_scp(torch, res, ref)
        diff = float(torch.max(torch.abs(res.us_history - ref.us_history)))
        st = pd.collective_summary(calls, int(res.qp_iters.sum()))
        out[backend] = {
            "dtype": str(dtype).split(".")[-1], "s": wall,
            "unsharded_s": t_ref, "qp_iters": res.qp_iters.tolist(),
            "qp_solved": res.qp_solved.tolist(), "bitwise": bitwise,
            "max_abs_diff": diff, "collectives": st,
            "kernel_launches": counts}
        log(f"sharded {out[backend]['dtype']} {backend!r} SCP, one NCCL "
            f"rank, M={m}, {scp.num_iters} SCP iterations: {wall:.2f} s "
            f"(unsharded "
            f"{t_ref:.2f} s), qp_iters {res.qp_iters.tolist()} (unsharded "
            f"{ref.qp_iters.tolist()}), solved {res.qp_solved.tolist()}, bit "
            f"for bit the unsharded run {bitwise} (max |diff| {diff:.3e}); "
            f"collectives {st['calls']} ({st['calls_per_iter']:.2f} and "
            f"{st['bytes_per_iter']:.0f} B per QP iteration, largest "
            f"{st['max_elements']} elements)")
        if not bitwise:
            raise AssertionError(f"sharded {backend!r} SCP is not the "
                                 f"unsharded run bit for bit ({diff:.3e})")
    return out


def phase13_checkpoint(torch, dev, group, m=SHARD_CKPT_M):
    """(c) The float64 'admm' drone SCP at M=m (the first m fixture omegas,
    the golden config cut to SHARD_SCP_ITERS iterations, phase 12(b1)'s
    solver config) on the one-rank NCCL `group`, checkpointed one iteration
    short of the end and resumed: the file bit for bit the unsharded
    solve's file at that iteration (the unsharded layout), the resumed run
    bit for bit the uninterrupted sharded run, and an unsharded solve
    resumed from the sharded file within 1e-10 of the uninterrupted
    unsharded run."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.utils import checkpoint as ckpt

    cfg = SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=SHARD_SCP_CAP,
                       polish=False, kkt_refine_iters=1)
    om = first_omegas(torch, torch.float64, dev, m)

    def make(iters, group=None):
        scp = dataclasses.replace(golden_scp_config(), num_iters=iters)
        return drone_opt(torch, dev, m, scp, admm_cfg=cfg, group=group)

    n = SHARD_SCP_ITERS
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: f"{tmp}/{k}.npz" for k in ("u", "s", "u_from_s")}

        def run():
            full_u = make(n).solve(om, ALPHA)
            make(n - 1).solve(om, ALPHA, checkpoint_path=paths["u"])
            full_s = make(n, group).solve(om, ALPHA)
            make(n - 1, group).solve(om, ALPHA, checkpoint_path=paths["s"])
            shutil.copy(paths["s"], paths["u_from_s"])
            files = [ckpt.load(paths[k]) for k in ("u", "s")]
            res_s = make(n, group).solve(om, ALPHA, checkpoint_path=paths["s"])
            res_u = make(n).solve(om, ALPHA, checkpoint_path=paths["u_from_s"])
            return full_u, full_s, files, res_s, res_u

        (full_u, full_s, files, res_s, res_u), wall, counts = no_kernel_run(
            torch, dev, run, "sharded checkpoint and resume")
    same_file = all(np.array_equal(a, b) for a, b in zip(*files))
    resumed_bitwise = (
        torch.equal(res_s.us_history, full_s.us_history[-1:])
        and res_s.qp_iters.tolist() == full_s.qp_iters[-1:].tolist())
    diff = float(torch.max(torch.abs(res_u.us - full_u.us)))
    log(f"one-rank sharded f64 'admm' SCP at M={m}, checkpointed at {n - 1} "
        f"and resumed to {n} ({wall:.2f} s for the five solves, qp_iters "
        f"{full_s.qp_iters.tolist()}): the file bit for bit the unsharded "
        f"one {same_file}; resumed run bit for bit the uninterrupted sharded "
        f"run {resumed_bitwise}; an unsharded solve resumed from the sharded "
        f"file {diff:.3e} from the uninterrupted unsharded run")
    if not (same_file and resumed_bitwise and diff <= 1e-10):
        raise AssertionError("sharded checkpoint/resume checks failed")
    return {"s": wall, "same_file": same_file,
            "resumed_bitwise": resumed_bitwise, "unsharded_resume_diff": diff,
            "kernel_launches": counts}


def one_nccl_rank(dev, fn):
    """fn(group) on a one-rank NCCL group of this process, left after."""
    import torch.distributed as dist

    from riskaversetrajopt_torch.parallel import distributed as pd

    pd.initialize(f"tcp://localhost:{free_port()}", 1, 0, device=dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        return fn(dist.group.WORLD)
    finally:
        pd.shutdown()


def phase13(torch, dev):
    """Phase 13 in the "ipm" group, sample-sharded, no kernel: (a) and (c)
    on a one-rank NCCL group, (b) on two gloo ranks sharing the card."""
    def one_rank(group):
        return {"scp_1rank": timed_phase("13a", lambda: phase13_shard_scps(
                    torch, dev, group, shard_scp_runs(torch, "ipm"))),
                "checkpoint_1rank": timed_phase("13c", lambda: (
                    phase13_checkpoint(torch, dev, group)))}

    out = one_nccl_rank(dev, one_rank)
    out["ipm_qp_2ranks"] = timed_phase("13b", lambda: two_rank_qp(
        torch, dev, "ipm"))
    return out


def phase13_ds(torch, dev):
    """Phase 13(d) in the "ds" group: 'admm-ds' and '_hybrid-prox' on a
    one-rank NCCL group."""
    return {"scp_1rank": timed_phase("13d", lambda: one_nccl_rank(
        dev, lambda group: phase13_shard_scps(
            torch, dev, group, shard_scp_runs(torch, "ds"))))}


def phase12_native(torch, dev):
    """(c) The native QP oracle (native/qp_admm.cpp, built here with g++)
    on one dense random QP (n=60, m=120, seed 0) against the port's
    solve_dense_qp in float64 on the card, both at eps 1e-9."""
    import numpy as np

    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.native import qp as native_qp
    from riskaversetrajopt_torch.ops.admm import solve_dense_qp

    rng = np.random.default_rng(0)
    n, m = 60, 120
    L = rng.standard_normal((n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    x_feas = rng.standard_normal(n) * 0.1
    l = A @ x_feas - rng.uniform(0.1, 2.0, m)
    u = A @ x_feas + rng.uniform(0.1, 2.0, m)
    t = [torch.tensor(a, device=dev) for a in (P, q, A, l, u)]
    t0 = time.perf_counter()
    native_qp.build()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = native_qp.solve_qp_native(*t, eps_abs=1e-9, eps_rel=1e-9)
    t_nat = time.perf_counter() - t0
    dense, t_dense, _ = no_kernel_run(
        torch, dev, lambda: solve_dense_qp(
            *t, SolverConfig(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000)),
        "dense QP")
    diff = float(torch.max(torch.abs(nat.x - dense.x)))
    log(f"native QP oracle (n={n}, m={m}): built with g++ in {t_build:.2f} "
        f"s; {nat.iters} iterations, {t_nat * 1e3:.1f} ms on the host, solved "
        f"{nat.solved}; solve_dense_qp on the card {dense.iters} iterations, "
        f"{t_dense * 1e3:.1f} ms, solved {dense.solved}; max |dx| {diff:.3e}")
    if not (nat.solved and dense.solved and diff <= 1e-6):
        raise AssertionError(f"native QP vs solve_dense_qp: {diff:.3e}")
    return {"native_ms": t_nat * 1e3, "native_iters": nat.iters,
            "native_build_s": t_build,
            "dense_ms": t_dense * 1e3, "dense_iters": dense.iters,
            "max_abs_diff": diff}


def phase12_entry(torch, dev):
    """(d) torch_entry.entry() (one SCP step at M=64 on the card) and
    dryrun_multichip over the host's cards."""
    sys.path.insert(0, str(REPO))
    import torch_entry

    def step():
        fn, args = torch_entry.entry()
        return fn(*args)

    us, t_entry, _ = no_kernel_run(torch, dev, step, "torch_entry.entry")
    n = torch.cuda.device_count()
    us_all, t_dry, _ = no_kernel_run(
        torch, dev, lambda: torch_entry.dryrun_multichip(n), "dry run")
    ok = bool(torch.isfinite(us).all()) and bool(torch.isfinite(us_all).all())
    log(f"torch_entry.entry(): controls {tuple(us.shape)} in {t_entry:.2f} s; "
        f"dryrun_multichip({n}): {tuple(us_all.shape)} in {t_dry:.2f} s; "
        f"finite {ok}")
    if not ok:
        raise AssertionError("entry controls are not finite")
    return {"entry_s": t_entry, "dryrun_s": t_dry, "cards": n}


def phase12(torch, dev):
    """Phase 12 in the main process: the sample-sharded solve, the native
    QP oracle and the entry file (Anderson runs in the "golden" group);
    none reaches a fused kernel."""
    out = {}
    for name, fn in (("shard_scp_1rank", lambda: phase12_shard_scp(torch, dev)),
                     ("shard_qp_2ranks", lambda: phase12_two_ranks(torch, dev)),
                     ("native_qp", lambda: phase12_native(torch, dev)),
                     ("entry", lambda: phase12_entry(torch, dev))):
        t = time.perf_counter()
        out[name] = fn()
        log(f"[phase 12 {name}] {time.perf_counter() - t:.2f} s")
    return out


def timed_phase(name, fn):
    t = time.perf_counter()
    out = fn()
    log(f"[phase {name}] {time.perf_counter() - t:.2f} s")
    return out


def group_golden(torch, dev):
    """Phase 2, then phase 12(a) from its plan."""
    opt64, _, res64 = timed_phase("2", lambda: phase2(torch, dev))
    return {"anderson": timed_phase("12 anderson", lambda: phase12_anderson(
        torch, dev, opt64, res64))}


def group_ipm(torch, dev):
    """Phase 9, then phase 13."""
    out = timed_phase("9", lambda: phase9(torch, dev, drone64(),
                                          load_gold(torch, dev)))
    out["sharded"] = timed_phase("13", lambda: phase13(torch, dev))
    return out


def group_ds(torch, dev):
    _, _, st, data32 = scaled_problem(
        torch, dev, M, lambda opt: load_omegas(torch, torch.float64, dev))
    problem = (None, None, None, None, st, data32)
    out = timed_phase("10", lambda: phase10(torch, dev, problem, drone64(),
                                            load_gold(torch, dev)))
    out["sharded"] = phase13_ds(torch, dev)
    return out


# Phases that reach neither kernel and run for minutes on the host's clock
# (the plain solvers are bound by their launches): each group runs in a
# process of its own beside the main one, started once the kernels are built
# and timed on a quiet card. Their wall times are taken beside each other's.
GROUPS = {"golden": group_golden, "ipm": group_ipm, "ds": group_ds}
GROUP_TIMEOUT = 1000  # seconds from the start of the groups


def group_worker(argv):
    """`--group NAME --out FILE`: run one phase group on the card and write
    its results to FILE as JSON."""
    import torch

    sys.path.insert(0, str(REPO))
    name, out = argv[argv.index("--group") + 1], argv[argv.index("--out") + 1]
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Path(out).write_text(json.dumps(GROUPS[name](torch, dev)))
    return 0


def start_groups(tmp):
    procs = {}
    for name in GROUPS:
        log_file = open(tmp / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--group", name,
             "--out", str(tmp / f"{name}.json")],
            stdout=log_file, stderr=subprocess.STDOUT, cwd=REPO), log_file)
    return procs


def stop_groups(procs):
    for p, log_file in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        log_file.close()


def join_groups(procs, tmp, deadline):
    """Wait for each group (killed at the deadline), print its log, and
    return its results; a group that failed fails the script."""
    out = {}
    for name, (p, log_file) in procs.items():
        try:
            rc = p.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        log_file.close()
        log(f"--- phase group {name!r} (its own process), exit {rc}:")
        for line in (tmp / f"{name}.log").read_text().splitlines():
            log("  " + line)
        if rc != 0:
            raise AssertionError(f"phase group {name!r} exited {rc}")
        out[name] = json.loads((tmp / f"{name}.json").read_text())
    return out


def main():
    if not (REPO / "riskaversetrajopt_torch").is_dir():
        print("chip_smoke.py: riskaversetrajopt_torch/ not found next to "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda:0")

    smi = timed_phase("0", lambda: phase0(torch))
    b1 = {"name": "saa_admm_chunk", "route": "cuda",
          "source": "riskaversetrajopt_torch/csrc/saa_admm.cu",
          "replaces": "riskaversetrajopt_tpu/ops/pallas/experimental/"
                      "saa_admm.py:793"}
    b2 = {"name": "saa_admm_f_chunk", "route": "cuda",
          "source": "riskaversetrajopt_torch/csrc/saa_admm_f.cu",
          "replaces": "riskaversetrajopt_tpu/ops/pallas/experimental/"
                      "saa_admm_f.py:425"}
    # the kernels against their plain versions, timed while no other
    # process uses the card
    stats, problem = timed_phase("1", lambda: phase1(torch, dev))
    b1.update(stats)
    b2.update(timed_phase("4", lambda: phase4(torch, problem)))
    timed_phase("6", lambda: phase6(torch, problem))
    car = timed_phase("7 kernels", lambda: phase7_kernels(torch, dev))
    b1["car"], b2["car"] = car["b1"], car["b2"]
    for name, k in (("b1", b1), ("b2_highest", b2), ("b2_high", b2)):
        k.setdefault("car_free_row_err", {})[name] = {
            it: r[name] for it, r in car["free_row"].items()}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        deadline = time.perf_counter() + GROUP_TIMEOUT
        procs = start_groups(tmp)
        try:
            opt64, gold = drone64(), load_gold(torch, dev)
            paths1, paths2 = {}, {}
            paths1["drone M=1000 solve (phase 3)"] = timed_phase(
                "3", lambda: phase3(torch, dev, opt64, gold))
            paths2["drone M=1000 solve (phase 5)"] = timed_phase(
                "5", lambda: phase5(torch, dev, opt64, gold))
            car_launches = timed_phase("7 scp", lambda: phase7_scp(torch, dev))
            # this slice's main path: the car's SCP through each kernel
            b1["launches"] = paths1["car M=50 solve (phase 7)"] = \
                car_launches["_admm-pallas"]
            b2["launches"] = paths2["car M=50 solve (phase 7)"] = \
                car_launches["_admm-pallas-f"]
            t = time.perf_counter()
            n_instr, split = phase8_instrumented(torch, dev, opt64)
            paths1["drone M=1000 solve_instrumented (phase 8)"] = n_instr
            b1["define_solve_split_m1000"] = split
            paths1.update(phase8_resume_and_many(torch, dev))
            drone_gauss = phase8_clis(torch, dev)
            log(f"[phase 8] {time.perf_counter() - t:.2f} s")
            timed_phase("11", lambda: phase11(torch, dev, drone_gauss))
            # nor do this slice's (no_kernel_run holds them to 0)
            for where in ("hopper CLI (phase 11)", "f32 hopper (phase 11)",
                          "drone_gaussian CLI (phase 11)"):
                paths1[where] = paths2[where] = 0
            p12 = timed_phase("12", lambda: phase12(torch, dev))
            groups = join_groups(procs, tmp, deadline)
        finally:
            stop_groups(procs)
    # the groups' paths reach neither kernel (no_kernel_run holds each to 0
    # in its process)
    for backend, st in groups["ipm"]["scp_m1000"].items():
        where = f"drone M=1000 {backend!r} solve (phase 9)"
        paths1[where], paths2[where] = st["kernel_launches"]
    sharded = groups["ipm"]["sharded"]
    for g in ("ipm", "ds"):
        for backend, st in groups[g]["sharded"]["scp_1rank"].items():
            where = f"sharded {backend!r} SCP, one NCCL rank (phase 13)"
            paths1[where], paths2[where] = st["kernel_launches"]
    for key, where in (("ipm_qp_2ranks", "sharded IPM QP M=1000, two ranks "
                                         "(phase 13)"),
                       ("checkpoint_1rank", "sharded checkpoint and resume "
                                            "M=50, one NCCL rank (phase 13)")):
        paths1[where], paths2[where] = sharded[key]["kernel_launches"]
    where = "drone M=1000 'admm-ds' solve (phase 10)"
    paths1[where], paths2[where] = \
        groups["ds"]["ds_scp_m1000"]["kernel_launches"]
    # nor do phase 12's (no_kernel_run holds them to 0; the two-rank
    # workers report their counts)
    for where in ("Anderson 'admm' QP M=1000 (phase 12)",
                  "sharded 'admm' SCP, one NCCL rank (phase 12)",
                  "sharded 'admm' QP, two ranks (phase 12)",
                  "dense QP vs native oracle (phase 12)",
                  "torch_entry entry and dry run (phase 12)"):
        paths1[where] = paths2[where] = 0
    log("phase 12 summary " + json.dumps(
        {"anderson": groups["golden"]["anderson"], **p12}))
    log("phase 13 summary " + json.dumps(
        {**sharded, "scp_1rank_ds": groups["ds"]["sharded"]["scp_1rank"]}))
    b1["launches_by_path"], b2["launches_by_path"] = paths1, paths2
    for k in (b1, b2):
        k["card"] = smi
    print(json.dumps({"kernels": [b1, b2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--shard-worker" in sys.argv:
        sys.exit(shard_worker(sys.argv[1:]))
    if "--group" in sys.argv:
        sys.exit(group_worker(sys.argv[1:]))
    sys.exit(main())
