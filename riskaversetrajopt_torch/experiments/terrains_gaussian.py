"""Friction-field visualization — parity with hopper/terrains_gaussian.py.

The counterpart of ``riskaversetrajopt_tpu/experiments/terrains_gaussian.py``
with the same flags: sampled random-Fourier-feature friction coefficient
fields mu(px, omega) over position, saved as
figures/hopper_friction_fields.png. The fields come from a torch.Generator
seeded with --seed.

Usage (on the card):
  python -m riskaversetrajopt_torch.experiments.terrains_gaussian \
      [--num-fields 10] [--seed 1]
On the host: main([...], device="cpu").
"""

from __future__ import annotations

import argparse

import torch

from riskaversetrajopt_torch.core.config import HopperScenario
from riskaversetrajopt_torch.experiments import common
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.models.hopper import HopperModel


def friction_fields(model, num_fields, seed):
    """(pxs (400,), mus (num_fields, 400)): num_fields friction fields drawn
    from a generator seeded with `seed`, each at 400 positions in
    [-1, 3]."""
    field = model.sample_friction(common.generator(seed), num_fields, "saa")
    pxs = torch.linspace(-1.0, 3.0, 400, dtype=torch.float64,
                         device=model.device)
    return pxs, model.friction_at_px(pxs[None, :, None],
                                     tuple(v[:, None, :] for v in field))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-fields", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    model = HopperModel(HopperScenario(), device=resolve_device(device))
    pxs, mus = (common.to_numpy(v) for v in
                friction_fields(model, args.num_fields, args.seed))

    plt = common.setup_matplotlib()
    fdir = common.figures_dir()
    fig = plt.figure(figsize=[6, 3])
    for i in range(args.num_fields):
        plt.plot(pxs, mus[i], alpha=0.7)
    plt.axhline(model.scn.mu_nom, color="k", ls="--", lw=1)
    plt.xlabel("$p_x$")
    plt.ylabel(r"$\mu(p_x, \omega)$")
    fig.savefig(fdir / "hopper_friction_fields.png", dpi=150,
                bbox_inches="tight")
    print("saved", fdir / "hopper_friction_fields.png")


if __name__ == "__main__":
    main()
