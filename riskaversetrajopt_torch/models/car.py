"""Planar ego car + interactive pedestrian (social-force interaction), with
uncertain interaction gains, uncertain pedestrian initial state and Brownian
noise on the pedestrian velocity.

The counterpart of ``riskaversetrajopt_tpu/models/car.py`` (reference
car/driving.py:83-236). Every function broadcasts over leading sample
dimensions (see models/base.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from riskaversetrajopt_torch.core.config import CarScenario, SCPConfig
from riskaversetrajopt_torch.models.base import resolve_device


class CarOmega(NamedTuple):
    """Per-sample uncertain parameters (leading axis M when batched)."""

    state_init: torch.Tensor  # (n_x,) or (M, n_x)
    omega_speed: torch.Tensor  # () or (M,)
    omega_repulsive: torch.Tensor  # () or (M,)
    dWs: torch.Tensor  # (S, n_x) or (M, S, n_x) -- already scaled by sqrt(dt)


class CarModel:
    """SAA car model. Reference: car/driving.py Model (lines 83-236).

    Array constants live on ``device`` (the card unless the caller passes
    another, e.g. ``device="cpu"``) in ``dtype``; ``to`` returns a copy
    converted to another device or dtype."""

    def __init__(self, scn: CarScenario = CarScenario(), device=None,
                 dtype=torch.float64):
        self.scn = scn
        self.n_x = scn.n_x
        self.n_u = scn.n_u
        self.S = scn.S
        self.dt = scn.dt
        self.K = scn.S  # one separation-distance constraint per step
        self.n_fc = 4  # ego final state rows (driving.py:216-221)
        self.row_scale = 1.0  # car packing applies no multiplier
        # slack objective weight (driving.py:386-389)
        self.slack_penalty = 1000.0
        self.device = resolve_device(device)
        self.dtype = dtype
        kw = dict(device=self.device, dtype=dtype)
        self._goal = torch.cat(
            [scn.position_ego_goal, scn.velocity_ego_goal]).to(**kw)
        self._R = scn.R.to(**kw)

    def to(self, device=None, dtype=None) -> "CarModel":
        return CarModel(
            self.scn,
            self.device if device is None else device,
            self.dtype if dtype is None else dtype,
        )

    # -- dynamics ----------------------------------------------------------
    def _force_on_pedestrian(self, x, omega_speed, omega_repulsive):
        """Social-force interaction (driving.py:145-158): repulsion from the
        ego car plus the desired-speed restoring force, which the reference
        drives with x[7] (the pedestrian's y velocity) and adds to both
        components."""
        positions_delta = x[..., 0:2] - x[..., 4:6]
        dist = torch.linalg.norm(positions_delta, dim=-1, keepdim=True)
        force = -omega_repulsive[..., None] * positions_delta / dist
        return force + omega_speed[..., None] * (
            self.scn.speed_ped_des - x[..., 7:8])

    def drift(self, x, u, omega: CarOmega):
        """b(x, u, omega): Dubins-like ego (px, py, v, phi) + double-integrator
        pedestrian driven by the interaction force (driving.py:160-178)."""
        vel, phi = x[..., 2], x[..., 3]
        force = self._force_on_pedestrian(x, omega.omega_speed,
                                          omega.omega_repulsive)
        u0, u1, _ = torch.broadcast_tensors(u[..., 0], u[..., 1], vel)
        return torch.stack(
            [vel * torch.cos(phi), vel * torch.sin(phi), u0, u1,
             x[..., 6], x[..., 7], force[..., 0], force[..., 1]],
            dim=-1,
        )

    def dispersion(self, x, u, omega: CarOmega, dW):
        """sigma @ dW with sigma = beta * I on the pedestrian-velocity block
        (driving.py:180-184), in matvec form."""
        return torch.cat(
            [torch.zeros_like(dW[..., :6]), self.scn.beta * dW[..., 6:8]],
            dim=-1,
        )

    def x0(self, omega: CarOmega):
        return omega.state_init

    # -- constraints -------------------------------------------------------
    def ineq_constraints(self, xs, omega: CarOmega):
        """g_t = -(separation_distance(x_t) - d_min) <= 0 for t = 1..S
        (driving.py:223-236, negated at driving.py:270).
        xs: (..., S+1, n_x); returns (..., S)."""
        delta = xs[..., 1:, 0:2] - xs[..., 1:, 4:6]
        dist = torch.linalg.norm(delta, dim=-1)
        return -(dist - self.scn.min_separation_distance)

    def final_constraints(self, xs):
        """Ego final state rows xs[-1, :4] - goal (driving.py:216-221)."""
        return xs[..., -1, :4] - self._goal

    # -- objective ---------------------------------------------------------
    def control_cost(self, us_mat):
        """dt * sum_t u_t^T R u_t (driving.py:623-629)."""
        return self.dt * torch.sum(
            torch.einsum("ti,ij,tj->t", us_mat, self._R, us_mat)
        )

    # -- sampling ----------------------------------------------------------
    def sample(self, generator: torch.Generator, M: int,
               method: str = "saa") -> CarOmega:
        """Reference distributions (driving.py:94-120): uniform interaction
        gains, Gaussian pedestrian initial-state perturbation with std
        sqrt(variance_ped_initial_state), Brownian increments sqrt(dt)*N(0,I).
        'baseline' zeroes the gains and the noise but keeps the nominal
        initial state (driving.py:117-120).

        Numbers are drawn on the generator's device in float64 and then
        moved to the model's device and dtype."""
        scn = self.scn
        gdev = generator.device
        kw = dict(generator=generator, device=gdev, dtype=torch.float64)
        zeros = dict(dtype=torch.float64, device=gdev)
        states_init = scn.state_init.to(gdev).expand(M, scn.n_x).clone()
        if method == "saa":
            def uniform(nom, delta):
                return (nom - delta) + 2 * delta * torch.rand(M, **kw)

            omegas_speed = uniform(scn.omega_speed_nom, scn.omega_speed_del)
            omegas_repulsive = uniform(scn.omega_repulsive_nom,
                                       scn.omega_repulsive_del)
            std = torch.sqrt(scn.variance_ped_initial_state).to(gdev)
            states_init[:, 4:] += torch.randn(M, 4, **kw) @ std.T
            dWs = math.sqrt(scn.dt) * torch.randn(M, scn.S, scn.n_x, **kw)
        elif method == "baseline":
            omegas_speed = torch.zeros(M, **zeros)
            omegas_repulsive = torch.zeros(M, **zeros)
            dWs = torch.zeros(M, scn.S, scn.n_x, **zeros)
        else:
            raise ValueError(f"unknown sampling method: {method}")
        kw = dict(device=self.device, dtype=self.dtype)
        return CarOmega(
            state_init=states_init.to(**kw),
            omega_speed=omegas_speed.to(**kw),
            omega_repulsive=omegas_repulsive.to(**kw),
            dWs=dWs.to(**kw),
        )

    def default_scp_config(self) -> SCPConfig:
        """Reference SCP knobs: 15 iterations (driving.py:60), the first
        iteration gated by zeroing the rows, whose bounds become (-inf, 0)
        through the reference's NaN-through-OSQP quirk (driving.py:411-415,
        see the JAX ops/saa_qp.py docstring)."""
        return SCPConfig(
            num_iters=15, gate_iters=1, gate_row_scale=0.0,
            gate_bound_l=-math.inf, gate_bound_u=0.0,
        )

    # -- initial guess -----------------------------------------------------
    def initial_guess(self):
        """Midpoint-of-bounds + 1e-2 on every control (driving.py:132-143)."""
        return torch.full((self.S, self.n_u), 1e-2, device=self.device,
                          dtype=self.dtype)
