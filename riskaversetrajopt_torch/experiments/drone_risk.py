"""Drone SAA workload — parity with drone/drone_risk.py.

The counterpart of ``riskaversetrajopt_tpu/experiments/drone_risk.py``, with
the same flags, stages and result files: SAA solutions over the
(alpha x repeat) sweep, the deterministic baseline, Monte-Carlo validation
with AVaR, result persistence in the reference `.npy` layout, and a
trajectory plot.

The sweep runs through SAATrajOpt.solve_many, `--batch-chunk` instances
(alpha, repeat pairs) per call, each instance at its own convergence
schedule. Random streams come from torch.Generators: each repeat's omegas
from its own seed derived from --seed, the baseline's from --seed + 1 and
the Monte-Carlo samples from --seed + 2. Each stage prints its wall time.

Usage (on the card):
  python -m riskaversetrajopt_torch.experiments.drone_risk \
      [--alphas 0.05 0.1 0.2 0.3] [--repeats 30] [--M 50] [--scp-iters 60]
      [--skip-saa] [--skip-baseline] [--skip-mc] [--plot]
On the host: main([...], device="cpu").
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from riskaversetrajopt_torch.core.config import DroneScenario
from riskaversetrajopt_torch.experiments import common
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.models.drone import DroneModel
from riskaversetrajopt_torch.scp.driver import SAATrajOpt


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.05, 0.1, 0.2, 0.3])
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--M", type=int, default=50)
    ap.add_argument("--mc-M", type=int, default=10000)
    ap.add_argument("--scp-iters", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-chunk", type=int, default=8,
                    help="(alpha, repeat) instances solved per solve_many "
                         "call")
    ap.add_argument("--skip-saa", action="store_true")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--skip-mc", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--results", default="results")
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = ap.parse_args(argv)

    device = resolve_device(device)
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    scn = DroneScenario(M=args.M)
    model = DroneModel(scn, device=device)
    rdir = common.results_dir(args.results)
    scp_cfg = dataclasses.replace(
        model.default_scp_config(), num_iters=args.scp_iters
    )
    opt = SAATrajOpt(model, method="saa", scp_cfg=scp_cfg, dtype=dtype,
                     device=device)

    if not args.skip_saa:
        print("[drone_risk] >>> Computing SAA solutions (solve_many sweep)")
        with common.Stage(device):
            # all repeats sampled up front (drone_risk.py:480-490)
            oms = [opt.sample(common.generator(s), M=args.M)
                   for s in common.sweep_seeds(args.seed, args.repeats)]
            pairs = [(alpha, r) for alpha in args.alphas
                     for r in range(args.repeats)]
            chunk = max(1, args.batch_chunk)
            finals = []
            for lo in range(0, len(pairs), chunk):
                part = pairs[lo:lo + chunk]
                om_part = type(oms[0])(*(
                    torch.stack(f) for f in zip(*(oms[r] for _, r in part))))
                res = opt.solve_many(om_part, [a for a, _ in part])
                for i, (alpha, r) in enumerate(part):
                    common.save_traj(
                        rdir / f"drone_alpha={alpha}_repeat={r}.npy",
                        res.us[i], res.xs[i],
                    )
                finals.append(res.l2_errors[:, -1])
            print("  final L2 (median over sweep):",
                  float(torch.median(torch.cat(finals))))

    if not args.skip_baseline:
        print("[drone_risk] >>> Computing baseline solution")
        with common.Stage(device):
            opt_b = SAATrajOpt(model, method="baseline", scp_cfg=scp_cfg,
                               dtype=dtype, baseline_pad=1e-3, device=device)
            om_b = opt_b.sample(common.generator(args.seed + 1), M=args.M,
                                method="baseline")
            res_b = opt_b.solve(om_b, alpha=0.1)
            common.save_traj(rdir / "drone_baseline.npy", res_b.us, res_b.xs)

    if not args.skip_mc:
        print("[drone_risk] >>> Monte Carlo validation")
        with common.Stage(device):
            mc_om = opt.sample(common.generator(args.seed + 2), M=args.mc_M)
            for alpha in args.alphas:
                safes, avars, costs = [], [], []
                for r in range(args.repeats):
                    us, _ = common.load_traj(
                        rdir / f"drone_alpha={alpha}_repeat={r}.npy"
                    )
                    mc = opt.monte_carlo(torch.from_numpy(us), mc_om, alpha)
                    safes.append(float(mc["safe_frac"]))
                    avars.append(float(mc["avar"]))
                    costs.append(float(mc["cost"]))
                print(f"  alpha={alpha}: safe(mean)={np.mean(safes):.4f} "
                      f"safe(med)={np.median(safes):.4f} "
                      f"avar(mean)={np.mean(avars):.4f} "
                      f"cost(mean)={np.mean(costs):.4f}")
            try:
                us_b, _ = common.load_traj(rdir / "drone_baseline.npy")
                mc_b = opt.monte_carlo(torch.from_numpy(us_b), mc_om,
                                       args.alphas[0])
                print(f"  baseline: safe={float(mc_b['safe_frac']):.4f} "
                      f"cost={float(mc_b['cost']):.4f}")
            except FileNotFoundError:
                print("  baseline results missing — run without "
                      "--skip-baseline")

    if args.plot:
        plt = common.setup_matplotlib()
        from matplotlib.patches import Circle

        fdir = common.figures_dir()
        alpha, r = args.alphas[0], min(1, args.repeats - 1)
        us, xs = common.load_traj(rdir / f"drone_alpha={alpha}_repeat={r}.npy")
        fig = plt.figure(figsize=[6, 3])
        for i in range(min(args.M, xs.shape[0])):
            plt.plot(xs[i, :, 0], xs[i, :, 1], c="b", alpha=0.3)
        for i in range(scn.n_obs):
            plt.gca().add_patch(
                Circle(scn.obs_positions[i][:2].numpy(),
                       radius=float(scn.obs_radii[i]), color="r", alpha=0.3)
            )
        plt.scatter(*scn.x_init[:2].numpy(), color="k")
        plt.scatter(*scn.x_final[:2].numpy(), color="k")
        plt.xlabel("$p_x$")
        plt.ylabel("$p_y$")
        fig.savefig(fdir / "drone_risk_trajectories.png", dpi=150,
                    bbox_inches="tight")
        print("  saved", fdir / "drone_risk_trajectories.png")


if __name__ == "__main__":
    main()
