"""Gaussian drone baseline — parity with drone/drone_gaussian.py.

The counterpart of ``riskaversetrajopt_tpu/experiments/drone_gaussian.py``,
with the same flags and result files: for each alpha, the NLP with
risk-allocation variables (models/drone_gaussian.py), warm-started from the
SAA solution results/drone_alpha=<a>_repeat=0.npy that the drone_risk CLI
writes (the reference's cross-script contract, drone_gaussian.py:104-116),
saved as results/drone_gaussian_alpha=<a>.npy in the reference's
sequential-save layout. Each solve prints its wall time.

Usage (on the card, after drone_risk into the same --results):
  python -m riskaversetrajopt_torch.experiments.drone_gaussian \
      [--alphas 0.05 0.1 0.2 0.3] [--tol 1e-6] [--max-iter 1500]
      [--results results] [--dtype f64|f32]
On the host: main([...], device="cpu").
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from riskaversetrajopt_torch.core.config import DroneScenario
from riskaversetrajopt_torch.experiments import common
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.models.drone_gaussian import GaussianDronePlanner
from riskaversetrajopt_torch.ops.nlp_ipm import NLPConfig


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.05, 0.1, 0.2, 0.3])
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=1500)
    ap.add_argument("--results", default="results")
    # float32 adds the NLP's symmetric KKT equilibration
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = ap.parse_args(argv)

    device = resolve_device(device)
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    rdir = common.results_dir(args.results)
    for alpha in args.alphas:
        warm = rdir / f"drone_alpha={alpha}_repeat=0.npy"
        if not Path(warm).is_file():
            raise FileNotFoundError(
                f"{warm} does not exist.\nrun the drone_risk experiment first."
            )
        us_init, _ = common.load_traj(warm)
        print(f"[drone_gaussian] >>> alpha={alpha}")
        with common.Stage(device):
            p = GaussianDronePlanner(DroneScenario(), alpha=alpha, dtype=dtype,
                                     device=device)
            res = p.solve(
                us_init=torch.as_tensor(us_init),
                cfg=NLPConfig(tol=args.tol, max_iter=args.max_iter,
                              kkt_ruiz_iters=3 if dtype == torch.float32
                              else 0))
            print(f"  iters={res.nlp.iters} solved={res.nlp.solved} "
                  f"prim={float(res.nlp.prim_res):.2e} "
                  f"dual={float(res.nlp.dual_res):.2e} "
                  f"sum(alphas)={float(torch.sum(res.alphas_risk)):.8f}")
            common.save_traj(rdir / f"drone_gaussian_alpha={alpha}.npy",
                             res.us, res.xs)


if __name__ == "__main__":
    main()
