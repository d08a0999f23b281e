#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (riskaversetrajopt_torch) on one GPU.

Phases, in order (each prints its seconds; any failure exits non-zero):
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
Then one JSON line describing each kernel, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.

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
PRECISIONS = ("highest", "high", "default")
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
    from riskaversetrajopt_torch.core.config import DroneScenario, SolverConfig
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.ops import admm
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective,
    )
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    # no device given: the port runs on the card by default
    opt = SAATrajOpt(DroneModel(DroneScenario(M=m)), scp_cfg=golden_scp_config())
    data = opt._define(opt.model.initial_guess(), om(opt), ALPHA)
    data32 = type(data)(*(x.to(torch.float32) for x in data))
    st, scp_iter, cfg = opt._static_for(m), 3, SolverConfig()
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


def kernel_vs_plain(torch, run, plain, s0, iters, what):
    """`iters` iterations of the kernel (`run`, twice) and of its plain
    version from s0: every field finite, state_err <= KERNEL_TOL, the two
    kernel runs bit for bit equal. Returns (state_err, max abs err, out)."""
    from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc

    ref = s0
    for _ in range(iters):
        ref = plain(ref)
    out = run(s0, iters)
    again = run(s0, iters)
    torch.cuda.synchronize()
    rel, abs_ = kc.state_err(out, ref)
    log(f"{what}, {iters} iterations: max |kernel - plain| / (1 + |plain|) "
        f"{rel:.3e}")
    if rel > KERNEL_TOL:
        raise AssertionError(f"{what} disagrees with its plain version: {rel:.3e}")
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"two {what} runs from one state differ")
    log(f"{what} repeat run: bitwise identical")
    return rel, abs_, out


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
    max_rel, max_abs, out = kernel_vs_plain(
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
    rel, abs_, _ = kernel_vs_plain(
        torch, lambda s, k: sk.admm_chunk(p, s, d, k),
        lambda s: sk.one_iter_ref(p, s, d), s0, CHUNK_F,
        f"B1 at M={M_STREAM}")
    t_k = cuda_time(torch, lambda: sk.admm_chunk(p, s0, d, CHUNK_F), 10)
    log(f"B1 at M={M_STREAM}: {t_k * 1e6 / CHUNK_F:.2f} us/iter "
        f"(chunk {CHUNK_F})")
    return {"M": M_STREAM, "us_per_iter": t_k * 1e6 / CHUNK_F,
            "max_rel_err": rel, "max_abs_err": abs_, **shape_fields(shape)}


def phase2(torch, dev):
    import numpy as np

    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt, l2_error_us

    opt = SAATrajOpt(DroneModel(DroneScenario(M=M)), scp_cfg=golden_scp_config())
    om = load_omegas(torch, torch.float64, dev)
    t0 = time.perf_counter()
    res = opt.solve(om, alpha=ALPHA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gold = torch.from_numpy(
        np.load(FIXTURES / f"gold_drone_m{M}_a{ALPHA}_seed0_iters{SCP_ITERS}.npy")
    ).to(dev)
    err = float(l2_error_us(gold, res.us))  # denominator: the golden
    log(f"f64 admm: {wall:.2f} s, relative L2 vs golden {err:.3e}, "
        f"qp_iters {res.qp_iters.tolist()}, qp_solved {res.qp_solved.tolist()}")
    if not err <= 1e-3:
        raise AssertionError(f"f64 'admm' lands {err:.3e} from the golden")
    return opt, gold


def fused_scp(torch, dev, opt64, gold, backend, counter):
    """The float32 SCP through one fused backend at M=1000, 15 iterations,
    golden SCP config, phase 3's solver config; every iterate finite, the
    kernel launched, MC safe fraction >= 1 - alpha on 10000 fresh samples.
    Returns the kernel calls of the run."""
    from riskaversetrajopt_torch.core.config import DroneScenario, SolverConfig
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    cfg = SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=20000,
                       polish=False, rho_warm_start=True)
    opt = SAATrajOpt(DroneModel(DroneScenario(M=M)), scp_cfg=golden_scp_config(),
                     qp_backend=backend, admm_cfg=cfg, dtype=torch.float32)
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


def main():
    if not (REPO / "riskaversetrajopt_torch").is_dir():
        print("chip_smoke.py: riskaversetrajopt_torch/ not found next to "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda:0")

    t = time.perf_counter()
    smi = phase0(torch)
    log(f"[phase 0] {time.perf_counter() - t:.2f} s")
    b1 = {"name": "saa_admm_chunk", "route": "cuda",
          "source": "riskaversetrajopt_torch/csrc/saa_admm.cu",
          "replaces": "riskaversetrajopt_tpu/ops/pallas/experimental/"
                      "saa_admm.py:793"}
    b2 = {"name": "saa_admm_f_chunk", "route": "cuda",
          "source": "riskaversetrajopt_torch/csrc/saa_admm_f.cu",
          "replaces": "riskaversetrajopt_tpu/ops/pallas/experimental/"
                      "saa_admm_f.py:425"}
    t = time.perf_counter()
    stats, problem = phase1(torch, dev)
    b1.update(stats)
    log(f"[phase 1] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    opt64, gold = phase2(torch, dev)
    log(f"[phase 2] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    b1["launches"] = phase3(torch, dev, opt64, gold)
    log(f"[phase 3] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    b2.update(phase4(torch, problem))
    log(f"[phase 4] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    b2["launches"] = phase5(torch, dev, opt64, gold)
    log(f"[phase 5] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    phase6(torch, problem)
    log(f"[phase 6] {time.perf_counter() - t:.2f} s")
    for k in (b1, b2):
        k["card"] = smi
    print(json.dumps({"kernels": [b1, b2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
