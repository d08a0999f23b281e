"""Car/pedestrian SAA workload — parity with car/driving.py.

The counterpart of ``riskaversetrajopt_tpu/experiments/driving.py``, with the
same flags, stages and result files: the SAA sweep over alphas x repeats
with the reference's timing harness (define/solve split, cumulative times,
L2 errors — car/driving.py:482-513), the deterministic baseline,
Monte-Carlo validation with AVaR, persistence, and the computation-time
plots.

By default each (alpha, repeat) runs SAATrajOpt.solve_instrumented, which
fills results/driving_computation_times.npy; --batched solves the sweep
through SAATrajOpt.solve_many instead (the timing arrays stay zero, the L2
errors are filled). Each repeat's omegas come from its own seed derived
from --seed, the baseline's from --seed + 1 and the Monte-Carlo samples
from --seed + 2. Each stage prints its wall time.

Usage (on the card):
  python -m riskaversetrajopt_torch.experiments.driving \
      [--alphas 0.01 0.02 0.05 0.1] [--repeats 30] [--M 50] [--scp-iters 15]
      [--batched] [--skip-saa] [--skip-baseline] [--skip-mc] [--plot]
On the host: main([...], device="cpu").
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from riskaversetrajopt_torch.core.config import CarScenario
from riskaversetrajopt_torch.experiments import common
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.models.car import CarModel
from riskaversetrajopt_torch.scp.driver import SAATrajOpt


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.01, 0.02, 0.05, 0.1])
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--M", type=int, default=50)
    ap.add_argument("--mc-M", type=int, default=10000)
    ap.add_argument("--scp-iters", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--skip-saa", action="store_true")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--skip-mc", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--results", default="results")
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = ap.parse_args(argv)

    device = resolve_device(device)
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    scn = CarScenario(M=args.M)
    model = CarModel(scn, device=device)
    rdir = common.results_dir(args.results)
    scp_cfg = dataclasses.replace(
        model.default_scp_config(), num_iters=args.scp_iters
    )
    opt = SAATrajOpt(model, method="saa", scp_cfg=scp_cfg, dtype=dtype,
                     device=device)

    n_a, n_r, n_i = len(args.alphas), args.repeats, args.scp_iters
    define_t = np.zeros((n_r, n_a, n_i))
    solve_t = np.zeros((n_r, n_a, n_i))
    cum_t = np.zeros((n_r, n_a, n_i))
    l2_err = np.zeros((n_r, n_a, n_i))

    if not args.skip_saa:
        print("[driving] >>> Computing SAA solutions")
        with common.Stage(device):
            oms = [opt.sample(common.generator(s), M=args.M)
                   for s in common.sweep_seeds(args.seed, args.repeats)]
            if args.batched:
                pairs = [(ia, r) for ia in range(n_a) for r in range(n_r)]
                om_all = type(oms[0])(*(
                    torch.stack(f) for f in zip(*(oms[r] for _, r in pairs))))
                res = opt.solve_many(om_all,
                                     [args.alphas[ia] for ia, _ in pairs])
                for i, (ia, r) in enumerate(pairs):
                    common.save_traj(
                        rdir / f"driving_alpha={args.alphas[ia]}_repeat={r}.npy",
                        res.us[i], res.xs[i],
                    )
                    l2_err[r, ia] = common.to_numpy(res.l2_errors[i])
            else:
                for ia, alpha in enumerate(args.alphas):
                    for r in range(n_r):
                        out = opt.solve_instrumented(oms[r], alpha)
                        define_t[r, ia] = out["define_times"]
                        solve_t[r, ia] = out["solve_times"]
                        cum_t[r, ia] = out["cum_times"]
                        l2_err[r, ia] = out["l2_errors"]
                        common.save_traj(
                            rdir / f"driving_alpha={alpha}_repeat={r}.npy",
                            out["us"], out["xs"],
                        )
            common.save_timing(
                rdir / "driving_computation_times.npy",
                args.alphas, define_t, solve_t, cum_t, l2_err,
            )
            print("  final L2 (median over sweep):",
                  float(np.median(l2_err[:, :, -1])))

    if not args.skip_baseline:
        print("[driving] >>> Computing baseline solution")
        with common.Stage(device):
            opt_b = SAATrajOpt(model, method="baseline", scp_cfg=scp_cfg,
                               dtype=dtype, device=device)
            om_b = opt_b.sample(common.generator(args.seed + 1), M=args.M,
                                method="baseline")
            res_b = opt_b.solve(om_b, alpha=0.05)
            common.save_traj(rdir / "driving_baseline.npy", res_b.us,
                             res_b.xs)

    if not args.skip_mc:
        print("[driving] >>> Monte Carlo validation")
        with common.Stage(device):
            monte_carlo_report(opt, rdir, args)

    if args.plot:
        plot_times(rdir, n_i)


def monte_carlo_report(opt, rdir, args):
    """The Monte-Carlo report of car/driving.py:618-740: each alpha's SAA
    solutions, the baseline, and the Gaussian baseline's solutions where
    the driving_gaussian experiment wrote them."""
    mc_om = opt.sample(common.generator(args.seed + 2), M=args.mc_M)
    for alpha in args.alphas:
        safes, avars, costs = [], [], []
        for r in range(args.repeats):
            try:
                us, _ = common.load_traj(
                    rdir / f"driving_alpha={alpha}_repeat={r}.npy"
                )
            except FileNotFoundError:
                continue
            mc = opt.monte_carlo(torch.from_numpy(us), mc_om, alpha)
            safes.append(float(mc["safe_frac"]))
            avars.append(float(mc["avar"]))
            costs.append(float(mc["cost"]))
        if safes:
            print(f"  alpha={alpha}: safe(mean)={np.mean(safes):.4f} "
                  f"safe(med)={np.median(safes):.4f} "
                  f"avar(mean)={np.mean(avars):.4f} "
                  f"cost(mean)={np.mean(costs):.4f}")
    try:
        us_b, _ = common.load_traj(rdir / "driving_baseline.npy")
        mc_b = opt.monte_carlo(torch.from_numpy(us_b), mc_om, args.alphas[0])
        print(f"  baseline: safe={float(mc_b['safe_frac']):.4f} "
              f"cost={float(mc_b['cost']):.4f}")
    except FileNotFoundError:
        pass
    # Gaussian-baseline comparison in the same report (car/driving.py:
    # 719-740, with the run-this-first guidance of driving.py:724-728)
    print("  Monte-Carlo: Gaussian baseline")
    for alpha in args.alphas:
        gfile = rdir / f"driving_gaussian_alpha={alpha}.npy"
        if not gfile.is_file():
            print(f"    {gfile} does not exist. "
                  "run the driving_gaussian experiment first.")
            continue
        us_g, _ = common.load_traj(gfile)
        mc_g = opt.monte_carlo(torch.from_numpy(us_g), mc_om, alpha)
        print(f"    alpha={alpha}: safe={float(mc_g['safe_frac']):.4f} "
              f"cost={float(mc_g['cost']):.4f}")


def plot_times(rdir, n_i):
    """The computation-time plots of car/driving.py:743-869."""
    plt = common.setup_matplotlib()
    fdir = common.figures_dir()
    try:
        alphas_l, dt_, st_, ct_, l2_ = common.load_timing(
            rdir / "driving_computation_times.npy"
        )
    except FileNotFoundError:
        print("  timing file missing (run non-batched SAA first)")
        return
    idx = min(1, len(alphas_l) - 1)
    first = 2
    fig = plt.figure(figsize=[10, 3.7])
    med = np.median(l2_, axis=0)[idx, first:]
    its = np.arange(n_i)[first:] + 1
    plt.plot(its, med, "k-o")
    plt.yscale("log")
    plt.xlabel("SCP Iteration $k$")
    plt.ylabel("Relative error")
    fig.savefig(fdir / "driving_l2_convergence.png", dpi=150,
                bbox_inches="tight")

    fig, ax = plt.subplots(figsize=(10, 3.2))
    d_med = np.median(dt_, axis=0)[idx, first:] * 1e3
    s_med = np.median(st_, axis=0)[idx, first:] * 1e3
    ax.bar(its, d_med, 0.35, color="#0C7BDC", label="define")
    ax.bar(its, s_med, 0.35, bottom=d_med, color="#FFC20A", label="solve")
    ax.set_xlabel("SCP iteration $k$")
    ax.set_ylabel("Time / SCP iter. (ms)")
    ax.legend()
    ax2 = ax.twinx()
    ax2.plot(its, np.median(ct_, axis=0)[idx, first:] * 1e3, "k--")
    ax2.set_ylabel("Total time (ms)")
    fig.savefig(fdir / "driving_times.png", dpi=150, bbox_inches="tight")

    # cumulative time at the 10th SCP iteration vs alpha, as a bar chart
    # (car/driving.py:849-868)
    scp_iter = min(9, ct_.shape[2] - 1)
    cum_med = np.median(ct_, axis=0)[:, scp_iter]
    fig = plt.figure(figsize=(4, 3.2))
    plt.grid(axis="y")
    xs_pos = np.arange(len(alphas_l))
    plt.bar(xs_pos, 1e3 * cum_med, 0.7, color="#0C7BDC")
    plt.xlabel(r"Risk parameter $\alpha$")
    plt.ylabel("Time (ms)")
    plt.xticks(xs_pos, [str(a) for a in alphas_l])
    plt.tight_layout()
    fig.savefig(fdir / "driving_cum_time_vs_alpha.png", dpi=150,
                bbox_inches="tight")
    print("  saved timing figures")


if __name__ == "__main__":
    main()
