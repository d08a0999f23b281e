"""Hopper contact-implicit workload — parity with hopper/hopper.py.

The counterpart of ``riskaversetrajopt_tpu/experiments/hopper.py``, with
the same flags and result files: the two-phase workflow of
hopper/README.md:9-25 (the baseline NLP from the teleporting initial
guess, then the SAA NLPs warm-started from it), both phases in one run or
one of them with --phase; then Monte-Carlo validation of the no-slip
constraint on the solved contact schedule over fresh friction fields
(hopper.py:898-1008), and the trajectory figure.

The JAX CLI takes its dtype from the process's x64 flag; this one takes
--dtype (f64 by default), and --kkt-ruiz defaults to 0 in f64 and 3 in
f32. Friction fields come from torch.Generators: the SAA field from
--seed, the Monte-Carlo fields from --seed + 100. Each stage prints its
wall time.

Usage (on the card):
  python -m riskaversetrajopt_torch.experiments.hopper \
      [--alphas 0.05 0.1 0.2 0.3 0.5 0.75] [--phase baseline|saa|both]
      [--tol 1e-3] [--max-iter 3000] [--damp-iters 50] [--damp-max 0.1]
      [--kkt-ruiz N] [--mc-M 10000] [--seed 1] [--skip-mc] [--plot]
      [--results results] [--dtype f64|f32]
On the host: main([...], device="cpu").
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from riskaversetrajopt_torch.core.config import HopperScenario
from riskaversetrajopt_torch.experiments import common
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.models.hopper import HopperModel
from riskaversetrajopt_torch.ops.cvar import avar
from riskaversetrajopt_torch.ops.nlp_ipm import NLPConfig, solve_nlp


def solve_phase(model, field, method, alpha, Z0, tol, max_iter,
                damp_iters=0, damp_max=0.1, kkt_ruiz=0):
    f, g, gL, gU, n_eq, xL, xU = model.make_nlp(field, method, alpha)
    res = solve_nlp(f, g, gL, gU, n_eq, xL, xU, Z0,
                    NLPConfig(tol=tol, max_iter=max_iter,
                              damp_iters=damp_iters, damp_max=damp_max,
                              kkt_ruiz_iters=kkt_ruiz))
    xs, us, _, _, _ = model.split_z(res.Z)
    return res, xs, us


def save_xs_us(path, xs, us):
    """The hopper files' layout: np.save of xs, then of us, in one file."""
    with open(path, "wb") as f:
        np.save(f, common.to_numpy(xs))
        np.save(f, common.to_numpy(us))


def load_xs_us(path):
    with open(path, "rb") as f:
        xs = np.load(f)
        us = np.load(f)
    return xs, us


def report(res, xs):
    print(f"  iters={res.iters} solved={res.solved} "
          f"prim={float(res.prim_res):.2e} dual={float(res.dual_res):.2e} "
          f"jumped={float(xs[-1, 0]):.4f}")


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.05, 0.1, 0.2, 0.3, 0.5, 0.75])
    ap.add_argument("--phase", choices=["baseline", "saa", "both"],
                    default="both")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--max-iter", type=int, default=3000)
    # first-steps fraction-to-boundary damping of the COLD baseline phase
    # (NLPConfig.damp_iters); the warm SAA phase runs undamped
    ap.add_argument("--damp-iters", type=int, default=50)
    ap.add_argument("--damp-max", type=float, default=0.1)
    # symmetric KKT equilibration sweeps (default: 0 in f64, 3 in f32)
    ap.add_argument("--kkt-ruiz", type=int, default=None)
    ap.add_argument("--mc-M", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--skip-mc", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--results", default="results")
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = ap.parse_args(argv)

    device = resolve_device(device)
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    kkt_ruiz = (args.kkt_ruiz if args.kkt_ruiz is not None
                else 3 if dtype == torch.float32 else 0)
    rdir = common.results_dir(args.results)
    model = HopperModel(HopperScenario(), device=device)
    M = model.M
    field = model.sample_friction(common.generator(args.seed), M, "saa")
    field_base = model.sample_friction(common.generator(args.seed), M,
                                       "baseline")

    if args.phase in ("baseline", "both"):
        print("[hopper] >>> Solving baseline")
        # the damped barrier path passes through a point that certifies at
        # tol 1e-3 before the optimum, so under damping the baseline
        # certifies at 1e-4 (JAX CLI, hopper.py:82-90)
        base_tol = min(args.tol, 1e-4) if args.damp_iters > 0 else args.tol
        if base_tol != args.tol:
            print(f"[hopper] note: baseline tol tightened {args.tol:g} -> "
                  f"{base_tol:g} (damped path certifies prematurely at "
                  f"looser tol; pass --damp-iters 0 to keep --tol)")
        with common.Stage(device):
            res, xs, us = solve_phase(
                model, field_base, "baseline", 0.1,
                model.initial_guess(M, dtype), base_tol, args.max_iter,
                damp_iters=args.damp_iters, damp_max=args.damp_max,
                kkt_ruiz=kkt_ruiz)
            report(res, xs)
            save_xs_us(rdir / "hopper_base_results.npy", xs, us)

    if args.phase in ("saa", "both"):
        xs_g, us_g = load_xs_us(rdir / "hopper_base_results.npy")
        s = model.scn
        Z0 = np.zeros(model.num_vars)
        Z0[: (s.S + 1) * s.n_x] = xs_g.reshape(-1)
        Z0[(s.S + 1) * s.n_x : (s.S + 1) * s.n_x + s.S * s.n_u] = \
            us_g.reshape(-1)
        Z0 = torch.as_tensor(Z0, dtype=dtype, device=device)
        for alpha in args.alphas:
            print(f"[hopper] >>> Solving SAA alpha={alpha}")
            with common.Stage(device):
                res, xs, us = solve_phase(
                    model, field, "saa", alpha, Z0, args.tol, args.max_iter,
                    kkt_ruiz=kkt_ruiz)
                report(res, xs)
                save_xs_us(rdir / f"hopper_saa_alpha={alpha}_results.npy",
                           xs, us)

    if not args.skip_mc:
        print("[hopper] >>> Monte Carlo validation")
        with common.Stage(device):
            monte_carlo(model, args, rdir, device)

    if args.plot:
        plot(model, args.alphas, rdir)


def monte_carlo(model, args, rdir, device):
    """The no-slip constraint on each solved plan's contact schedule over
    --mc-M fresh friction fields: the fraction of fields where its maximum
    over the contact steps is <= 1e-6, and the AVaR of that maximum."""
    mc_field = model.sample_friction(common.generator(args.seed + 100),
                                     args.mc_M, "saa")
    names = [("baseline", rdir / "hopper_base_results.npy", None)] + [
        (f"alpha={a}", rdir / f"hopper_saa_alpha={a}_results.npy", a)
        for a in args.alphas]
    for name, path, alpha in names:
        try:
            xs, us = load_xs_us(path)
        except FileNotFoundError:
            continue
        xs_t = torch.as_tensor(xs, dtype=torch.float64, device=device)
        us_t = torch.as_tensor(us, dtype=torch.float64, device=device)
        px = model.end_effector_position(xs_t)[model.contact_x_idx, 0]
        forces = us_t[model.contact_u_idx, 2:]
        mx = torch.amax(model.slip(px, forces, mc_field), dim=1)  # (mc_M,)
        msg = (f"  {name}: jumped={xs[-1, 0]:.4f} "
               f"safe={float(torch.mean((mx <= 1e-6).double())):.4f}")
        if alpha is not None:
            msg += f" avar={float(avar(mx, alpha)):.5f}"
        print(msg)


def plot(model, alphas, rdir):
    """The trajectory-snapshot figure (hopper/hopper.py:790-893): centre of
    mass (dashed) and end effector (solid), the baseline in black and each
    alpha on a bwr colormap, leg links at selected steps, the ground, an
    alpha colorbar."""
    print("[hopper] >>> Plotting trajectories")
    plt = common.setup_matplotlib()
    import matplotlib.pylab as pl_cm

    fdir = common.figures_dir()
    entries = []
    for a in alphas:
        try:
            entries.append((a, load_xs_us(
                rdir / f"hopper_saa_alpha={a}_results.npy")[0]))
        except FileNotFoundError:
            print(f"  results for alpha={a} missing "
                  "(run the saa phase first)")
    try:
        xs_base = load_xs_us(rdir / "hopper_base_results.npy")[0]
    except FileNotFoundError:
        xs_base = None
    if not entries and xs_base is None:
        return

    def ee_of(xs):
        return model.end_effector_position(torch.as_tensor(xs)).numpy()

    colors = pl_cm.cm.bwr(np.linspace(0, 1, max(len(entries), 1)))
    fig = plt.figure(figsize=[6, 3])
    xmin, xmax, ymin, ymax = -0.1, 1.25, -0.1, 1.75
    plt.plot([xmin, xmax], [0.0, 0.0], "r--")
    plt.fill_between([xmin, xmax], [-1, -1], [0.0, 0.0], color="r",
                     alpha=0.2)
    ts_to_plot = [0, 6, 10, 12, 14, 16, 18, 20, 24, model.scn.S]

    def draw(xs, color, with_links, lw=3, a_line=1.0):
        com = xs[:, :2]
        ee = ee_of(xs)
        plt.plot(com[:, 0], com[:, 1], c=color, ls="--", lw=lw, alpha=a_line)
        plt.plot(ee[:, 0], ee[:, 1], c=color, ls="-", lw=lw, alpha=a_line)
        if with_links:
            plt.scatter(com[ts_to_plot, 0], com[ts_to_plot, 1], c=[color],
                        s=250, alpha=0.5)
            for t in ts_to_plot:
                plt.plot([com[t, 0], ee[t, 0]], [com[t, 1], ee[t, 1]],
                         c=color, ls="-", lw=3, alpha=0.5)
            plt.scatter(ee[ts_to_plot, 0], ee[ts_to_plot, 1], c="#9d7200",
                        s=50)

    if xs_base is not None:
        draw(xs_base, "k", with_links=True, lw=2, a_line=0.7)
    for i, (a, xs_a) in enumerate(entries):
        draw(xs_a, colors[i], with_links=(i == len(entries) - 1))
    if entries:
        sm = plt.cm.ScalarMappable(
            cmap=pl_cm.cm.bwr,
            norm=plt.Normalize(vmin=min(a for a, _ in entries),
                               vmax=max(a for a, _ in entries)))
        cbar = plt.colorbar(sm, ax=plt.gca(), ticks=[a for a, _ in entries])
        cbar.set_label(r"$\alpha$", rotation="horizontal")
    plt.xlabel("$p_x$")
    plt.ylabel("$p_z$", rotation=0)
    plt.xlim((xmin, xmax))
    plt.ylim((ymin, ymax))
    fig.savefig(fdir / "hopper_trajectories.png", dpi=150,
                bbox_inches="tight")
    print("  saved", fdir / "hopper_trajectories.png")


if __name__ == "__main__":
    main()
