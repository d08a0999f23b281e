"""The benchmark's own draw of problem instances.

A frozen copy of the drone's sampling distributions (the upstream
drone_utils.py:61-93, as DroneModel.sample draws them): uniform masses in
[nom - delta, nom + delta], uniform per-(obstacle, axis) radius
perturbations baked into Q = diag(1/length^2), and Brownian increments
sqrt(dt) * N(0, I). Instance k of seed s comes from a torch.Generator on
`device` seeded from (s, k) alone, so the same seed gives the same
instances on every run and the program's own sampler never decides them.
"""

from __future__ import annotations

import math

import torch

_MASK = (1 << 63) - 1


def instance_seed(seed: int, k: int) -> int:
    """The generator seed of instance k of a run seeded `seed` (any whole
    number, negative or past 64 bits included)."""
    return ((int(seed) & _MASK) * 1_000_003 + k) & _MASK


def drone_instance(cfg: dict, seed: int, k: int, M: int, device):
    """(mass (M,), obs_Q (M, n_obs, 3, 3), dWs (M, S, n_x)) in float64."""
    gen = torch.Generator(device=device)
    gen.manual_seed(instance_seed(seed, k))
    kw = dict(generator=gen, device=device, dtype=torch.float64)
    n_obs, S, n_x = cfg["n_obs"], cfg["S"], cfg["n_x"]
    dt = cfg["T"] / S
    nom, delta = cfg["mass_nom"], cfg["mass_delta"]
    masses = (nom - delta) + (2 * delta) * torch.rand(M, **kw)
    deltas = cfg["obs_radii_deltas"] * (2 * torch.rand(M, n_obs, 3, **kw) - 1)
    radii = torch.tensor(cfg["obs_radii"], dtype=torch.float64, device=device)
    lengths = radii[None, :, None] + deltas
    obs_Q = torch.diag_embed(1.0 / lengths**2)
    dWs = math.sqrt(dt) * torch.randn(M, S, n_x, **kw)
    return masses, obs_Q, dWs
