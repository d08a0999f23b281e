"""Gaussian car baseline — parity with car/driving_gaussian.py.

The counterpart of ``riskaversetrajopt_tpu/experiments/driving_gaussian.py``,
with the same flags and result files: for each alpha, SCP with quantile
back-off chance constraints and optimal risk allocation
(models/car_gaussian.py), saved as results/driving_gaussian_alpha=<a>.npy
in the reference's sequential-save layout, which the Monte-Carlo report of
the driving CLI reads.

Usage (on the card):
  python -m riskaversetrajopt_torch.experiments.driving_gaussian \
      [--alphas 0.01 0.02 0.05 0.1] [--scp-iters 60] [--dtype f64|f32]
      [--plot] [--results results]
On the host: main([...], device="cpu").
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from riskaversetrajopt_torch.core.config import CarScenario
from riskaversetrajopt_torch.experiments import common
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.models.car_gaussian import GaussianCarPlanner


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.01, 0.02, 0.05, 0.1])
    ap.add_argument("--scp-iters", type=int, default=60)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--results", default="results")
    # float32: the 1e-8-tolerance QPs run through the iterative-refinement
    # solve ('admm-ir', models/car_gaussian.py)
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = ap.parse_args(argv)

    device = resolve_device(device)
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    rdir = common.results_dir(args.results)
    for alpha in args.alphas:
        print(f"[driving_gaussian] >>> alpha={alpha}")
        with common.Stage(device):
            p = GaussianCarPlanner(CarScenario(), alpha=alpha,
                                   num_scp_iters=args.scp_iters, dtype=dtype,
                                   device=device)
            res = p.solve()
            print(f"  L2 final={float(res.l2_errors[-1]):.2e} "
                  f"sum(alphas_risk)={float(torch.sum(res.alphas_risk)):.4f}")
            common.save_traj(
                rdir / f"driving_gaussian_alpha={alpha}.npy", res.us, res.xs)

    if args.plot:
        plot(rdir, args.alphas[0], device)


def plot(rdir, alpha, device):
    """The mean trajectory with ~90 % covariance ellipses of the pedestrian
    (figures/driving_gaussian.png)."""
    from matplotlib.patches import Ellipse

    plt = common.setup_matplotlib()
    fdir = common.figures_dir()
    us, xs = common.load_traj(rdir / f"driving_gaussian_alpha={alpha}.npy")
    p = GaussianCarPlanner(CarScenario(), alpha=alpha, device=device)
    Sigmas = common.to_numpy(p.covariance_trajectory(
        torch.as_tensor(us, dtype=p.dtype, device=p.device)))
    fig = plt.figure(figsize=[6, 3])
    plt.plot(xs[:, 0], xs[:, 1], "b-+")
    for t in range(1, xs.shape[0]):
        vals, vecs = np.linalg.eigh(Sigmas[t][4:6, 4:6])
        ang = np.degrees(np.arctan2(vecs[1, 0], vecs[0, 0]))
        w, h = 2 * np.sqrt(np.maximum(vals, 0) * 4.6)  # ~90% chi2
        plt.gca().add_patch(
            Ellipse(xs[t, 4:6], w, h, angle=ang, color="g", alpha=0.15))
    plt.plot(xs[:, 4], xs[:, 5], "g.")
    plt.xlabel("$p^x$")
    plt.ylabel("$p^y$")
    fig.savefig(fdir / "driving_gaussian.png", dpi=150, bbox_inches="tight")
    print("  saved", fdir / "driving_gaussian.png")


if __name__ == "__main__":
    main()
