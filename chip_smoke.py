#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (riskaversetrajopt_torch) on one GPU.

Phases, in order (each prints its seconds; any failure exits non-zero):
  0. card name and power limit, torch/CUDA versions; TF32 off; build the
     hand-written kernel csrc/saa_admm.cu for sm_90a.
  1. the fused ADMM-chunk kernel against its plain PyTorch version
     (one_iter_ref) on the M=1000 scaled problem of a real define phase at
     scp_iter=3, 100 iterations each, both on the card; time both.
  2. the float64 'admm' SCP at M=1000, 15 iterations, golden SCP config, on
     the committed omegas fixture; held to the committed golden trajectory.
  3. the float32 '_admm-pallas' SCP at M=1000, 15 iterations, through the
     kernel; every iterate finite and the out-of-sample Monte-Carlo safe
     fraction >= 1 - alpha on 10000 fresh samples.
Then one JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}.

Run from the repository root with no arguments: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures"
M, ALPHA, SCP_ITERS, CHUNK = 1000, 0.2, 15, 100
# Kernel vs plain after 100 iterations, |a - b| <= TOL * (1 + |b|) per
# element: both run float32 with sums taken in different orders (blocked
# partials in the kernel, cuBLAS/ATen reductions in the plain version), and
# the 1e3 rho of the equality rows amplifies those ulp-level differences in
# the dual update (tests/test_pallas_admm.py:108-114 uses the same 2e-2).
KERNEL_TOL = 2e-2


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
    path, secs, out = build.build("saa_admm")
    log(f"built {path.name} in {secs:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "Compiling entry" in line:
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


def phase1(torch, dev):
    from riskaversetrajopt_torch.core.config import DroneScenario, SolverConfig
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.ops import admm
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective,
    )
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    opt = SAATrajOpt(DroneModel(DroneScenario(M=M)), scp_cfg=golden_scp_config(),
                     device=dev)
    om = load_omegas(torch, torch.float64, dev)
    data = opt._define(opt.model.initial_guess(), om, ALPHA)
    data32 = type(data)(*(x.to(torch.float32) for x in data))
    st, scp_iter, cfg = opt._static_for(M), 3, SolverConfig()
    ops = SAAQPOps(st, data32, scp_iter)
    _, q = build_objective(st, data32)
    l, u = build_bounds(st, data32, scp_iter)
    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=5)
    p, _ = sk.scaled_structure(st, data32, scp_iter, scaling,
                               torch.tensor(cfg.rho, device=dev), cfg)
    d = sk.kernel_dims(st)
    s0 = sk.init_scaled_state(p)

    def plain():
        s = s0
        for _ in range(CHUNK):
            s = sk.one_iter_ref(p, s, d)
        return s

    ref = plain()
    before = sk.admm_chunk.launches
    out = sk.admm_chunk(p, s0, d, CHUNK)
    again = sk.admm_chunk(p, s0, d, CHUNK)
    torch.cuda.synchronize()
    if sk.admm_chunk.launches != before + 2:
        raise AssertionError("admm_chunk did not count its launches")
    errs, abs_errs = {}, {}
    for name, a, b in zip(ref._fields, out, ref):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"kernel field {name} is not finite")
        diff = torch.abs(a - b)
        errs[name] = float(torch.max(diff / (1.0 + torch.abs(b))))
        abs_errs[name] = float(torch.max(diff))
    log("max |kernel - plain| / (1 + |plain|) per field after "
        f"{CHUNK} iterations: " + json.dumps({k: f"{v:.3e}" for k, v in errs.items()}))
    max_rel = max(errs.values())
    if max_rel > KERNEL_TOL:
        raise AssertionError(f"kernel disagrees with one_iter_ref: {max_rel:.3e}")
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError("two kernel runs from one state differ")
    log("kernel repeat run: bitwise identical")

    reps = 10
    sk.admm_chunk(p, s0, d, CHUNK)  # warm
    t_k = cuda_time(torch, lambda: sk.admm_chunk(p, s0, d, CHUNK), reps)
    t_p = cuda_time(torch, plain, 3)
    log(f"kernel {t_k * 1e6 / CHUNK:.2f} us/iter, plain one_iter_ref "
        f"{t_p * 1e6 / CHUNK:.2f} us/iter (M={M}, chunk={CHUNK})")
    return {
        "max_rel_err": max_rel, "max_abs_err": max(abs_errs.values()),
        "ms": t_k * 1e3, "plain_ms": t_p * 1e3,
        "us_per_iter": t_k * 1e6 / CHUNK, "plain_us_per_iter": t_p * 1e6 / CHUNK,
    }


def phase2(torch, dev):
    import numpy as np

    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt, l2_error_us

    opt = SAATrajOpt(DroneModel(DroneScenario(M=M)), scp_cfg=golden_scp_config(),
                     device=dev)
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


def phase3(torch, dev, opt64, gold):
    from riskaversetrajopt_torch.core.config import DroneScenario, SolverConfig
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    cfg = SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=20000,
                       polish=False, rho_warm_start=True)
    opt = SAATrajOpt(DroneModel(DroneScenario(M=M)), scp_cfg=golden_scp_config(),
                     qp_backend="_admm-pallas", admm_cfg=cfg,
                     dtype=torch.float32, device=dev)
    om = load_omegas(torch, torch.float32, dev)
    sk.admm_chunk.launches = 0
    t0 = time.perf_counter()
    res = opt.solve(om, alpha=ALPHA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.admm_chunk.launches
    if launches == 0:
        raise AssertionError("'_admm-pallas' did not launch the kernel")
    for name in ("us", "xs", "l2_errors", "us_history"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise AssertionError(f"'_admm-pallas' {name} is not finite")
    mc_om = opt64.sample(torch.Generator().manual_seed(99), 10000)
    mc = opt64.monte_carlo(res.us.to(torch.float64), mc_om, ALPHA)
    mc_gold = opt64.monte_carlo(gold, mc_om, ALPHA)
    safe = float(mc["safe_frac"])
    log(f"f32 _admm-pallas: {wall:.2f} s, {launches} kernel calls, qp_iters "
        f"{res.qp_iters.tolist()}, qp_solved {res.qp_solved.tolist()}")
    log(f"  MC (10000 samples, seed 99): safe {safe:.4f}, AVaR "
        f"{float(mc['avar']):.4f}, cost {float(mc['cost']):.4f} "
        f"(golden: safe {float(mc_gold['safe_frac']):.4f}, cost "
        f"{float(mc_gold['cost']):.4f})")
    if not safe >= 1 - ALPHA:
        raise AssertionError(f"MC safe fraction {safe:.4f} < {1 - ALPHA}")
    return launches


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
    kernel = {"name": "saa_admm_chunk", "route": "cuda",
              "source": "riskaversetrajopt_torch/csrc/saa_admm.cu",
              "replaces": "riskaversetrajopt_tpu/ops/pallas/experimental/"
                          "saa_admm.py:793", "card": smi}
    t = time.perf_counter()
    kernel.update(phase1(torch, dev))
    log(f"[phase 1] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    opt64, gold = phase2(torch, dev)
    log(f"[phase 2] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    kernel["launches"] = phase3(torch, dev, opt64, gold)
    log(f"[phase 3] {time.perf_counter() - t:.2f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
