"""Drone timing benchmark — parity with drone/drone_times.py.

The counterpart of ``riskaversetrajopt_tpu/experiments/drone_times.py``:
per-SCP-iteration define and solve times from SAATrajOpt.solve_instrumented
over M in {20, 30, 50} (x repeats, 15 SCP iterations, alpha=0.05), written
to results/drone_computation_times.npy, and under --plot the time/iteration
stacked bars and cumulative time against M (drone_times.py:509-674).

It also records the "fused" time of each instance: the wall time of a plain
SAATrajOpt.solve, timed after one warm call on the same instance and closed
by a device synchronize (results/drone_fused_times.npy). Each repeat's
omegas come from its own seed derived from --seed.

On the card: python -m riskaversetrajopt_torch.experiments.drone_times;
on the host: main([...], device="cpu").
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from riskaversetrajopt_torch.core.config import DroneScenario, SolverConfig
from riskaversetrajopt_torch.experiments import common
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.models.drone import DroneModel
from riskaversetrajopt_torch.scp.driver import SAATrajOpt


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--Ms", type=int, nargs="+", default=[20, 30, 50])
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--scp-iters", type=int, default=15)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--results", default="results")
    # the defaults reproduce the reference's x64 harness; --dtype f32
    # --eps 1e-4 --polish is the float32 speed configuration
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    ap.add_argument("--eps", type=float, default=None)
    ap.add_argument("--eps-rel", type=float, default=None)
    ap.add_argument("--polish", action="store_true", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(device)
    solver_kw = {}
    if args.eps is not None or args.polish is not None:
        eps = 1e-6 if args.eps is None else args.eps
        solver_kw["admm_cfg"] = SolverConfig(
            eps_abs=eps,
            eps_rel=eps if args.eps_rel is None else args.eps_rel,
            max_iter=20000,
            polish=bool(args.polish),
        )
    if args.dtype == "f32":
        solver_kw["dtype"] = torch.float32

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rdir = common.results_dir(args.results)
    n_m, n_r, n_i = len(args.Ms), args.repeats, args.scp_iters
    define_t = np.zeros((n_r, n_m, n_i))
    solve_t = np.zeros((n_r, n_m, n_i))
    cum_t = np.zeros((n_r, n_m, n_i))
    l2_err = np.zeros((n_r, n_m, n_i))
    fused_t = np.zeros((n_r, n_m))

    seeds = common.sweep_seeds(args.seed, args.repeats)
    for im, M in enumerate(args.Ms):
        model = DroneModel(DroneScenario(M=M), device=device)
        scp_cfg = dataclasses.replace(
            model.default_scp_config(), num_iters=args.scp_iters
        )
        opt = SAATrajOpt(model, method="saa", scp_cfg=scp_cfg, device=device,
                         **solver_kw)
        for r in range(args.repeats):
            omegas = opt.sample(common.generator(seeds[r]), M=M)
            out = opt.solve_instrumented(omegas, args.alpha)
            define_t[r, im] = out["define_times"]
            solve_t[r, im] = out["solve_times"]
            cum_t[r, im] = out["cum_times"]
            l2_err[r, im] = out["l2_errors"]
            # the whole SCP solve, timed after one warm call
            if r == 0:
                opt.solve(omegas, args.alpha)
                sync()
            t0 = time.perf_counter()
            opt.solve(omegas, args.alpha)
            sync()
            fused_t[r, im] = time.perf_counter() - t0
        print(f"M={M}: define/iter(med)={np.median(define_t[:, im]) * 1e3:.2f}ms "
              f"solve/iter(med)={np.median(solve_t[:, im]) * 1e3:.2f}ms "
              f"cum@10(med)={np.median(cum_t[:, im, min(9, n_i - 1)]) * 1e3:.1f}ms "
              f"fused-total(med)={np.median(fused_t[:, im]) * 1e3:.1f}ms")

    common.save_timing(
        rdir / "drone_computation_times.npy",
        args.Ms, define_t, solve_t, cum_t, l2_err,
    )
    np.save(rdir / "drone_fused_times.npy", fused_t)

    if args.plot:
        plt = common.setup_matplotlib()
        fdir = common.figures_dir()
        first = 2
        its = np.arange(n_i)[first:] + 1
        idx = n_m - 1
        fig, ax = plt.subplots(figsize=(10, 3.2))
        d_med = np.median(define_t, axis=0)[idx, first:] * 1e3
        s_med = np.median(solve_t, axis=0)[idx, first:] * 1e3
        ax.bar(its, d_med, 0.35, color="#0C7BDC", label="define")
        ax.bar(its, s_med, 0.35, bottom=d_med, color="#FFC20A", label="solve")
        ax.set_xlabel("SCP iteration $k$")
        ax.set_ylabel("Time / SCP iter. (ms)")
        ax.legend()
        fig.savefig(fdir / "drone_times_per_iter.png", dpi=150,
                    bbox_inches="tight")

        fig = plt.figure(figsize=(4, 3.2))
        cum10 = np.median(cum_t, axis=0)[:, min(9, n_i - 1)] * 1e3
        plt.bar(range(n_m), cum10, 0.7, color="#0C7BDC")
        plt.xticks(range(n_m), [str(m) for m in args.Ms])
        plt.xlabel("Samples $M$")
        plt.ylabel("Time (ms)")
        fig.savefig(fdir / "drone_times_vs_M.png", dpi=150,
                    bbox_inches="tight")
        print("  saved timing figures")


if __name__ == "__main__":
    main()
