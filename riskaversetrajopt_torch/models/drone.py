"""Drone point-mass model with quadratic drag, state-feedback-corrected
control, uncertain mass and uncertain ellipsoidal obstacles.

The counterpart of ``riskaversetrajopt_tpu/models/drone.py`` (reference
drone/drone_risk.py:70-213 and drone/drone_utils.py:61-93). Every function
broadcasts over leading sample dimensions (see models/base.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from riskaversetrajopt_torch.core.config import DroneScenario, SCPConfig
from riskaversetrajopt_torch.models.base import resolve_device


class DroneOmega(NamedTuple):
    """Per-sample uncertain parameters (leading axis M when batched)."""

    mass: torch.Tensor  # () or (M,)
    obs_Q: torch.Tensor  # (n_obs, 3, 3) or (M, n_obs, 3, 3)
    dWs: torch.Tensor  # (S, n_x) or (M, S, n_x) -- already scaled by sqrt(dt)


class DroneModel:
    """SAA drone model. Reference: drone/drone_risk.py Model (lines 70-213).

    Array constants live on ``device`` (the card unless the caller passes
    another, e.g. ``device="cpu"``) in ``dtype``; ``to`` returns a copy
    converted to another device or dtype."""

    def __init__(self, scn: DroneScenario = DroneScenario(), device=None,
                 dtype=torch.float64):
        self.scn = scn
        self.n_x = scn.n_x
        self.n_u = scn.n_u
        self.S = scn.S
        self.dt = scn.dt
        self.n_obs = scn.n_obs
        self.K = scn.n_obs * scn.S
        self.n_fc = scn.n_x
        # conditioning multiplier on CVaR sample rows (drone_risk.py:310,353)
        self.row_scale = 0.01
        # slack objective weight (drone_risk.py:388-390)
        self.slack_penalty = 10000.0
        self.device = resolve_device(device)
        self.dtype = dtype
        kw = dict(device=self.device, dtype=dtype)
        self._fb_gain = scn.feedback_gain.to(**kw)
        self._obs_positions = scn.obs_positions.to(**kw)
        self._x_init = scn.x_init.to(**kw)
        self._x_final = scn.x_final.to(**kw)
        self._R = scn.R.to(**kw)

    def to(self, device=None, dtype=None) -> "DroneModel":
        return DroneModel(
            self.scn,
            self.device if device is None else device,
            self.dtype if dtype is None else dtype,
        )

    # -- dynamics ----------------------------------------------------------
    def drift(self, x, u, omega: DroneOmega):
        """b(x, u, mass): velocity kinematics + feedback-corrected thrust with
        |v|v drag (drone_risk.py:122-131)."""
        v = x[..., 3:6]
        control_applied = u + torch.einsum("ij,...j->...i", self._fb_gain, x)
        acc = (
            control_applied - self.scn.drag_coefficient * torch.abs(v) * v
        ) / omega.mass[..., None]
        return torch.cat([v, acc], dim=-1)

    def dispersion(self, x, u, omega: DroneOmega, dW):
        """sigma(x, u, mass) @ dW with sigma = (beta/mass) I on the velocity
        block (drone_risk.py:133-137), in matvec form."""
        scale = self.scn.beta / omega.mass
        return torch.cat(
            [torch.zeros_like(dW[..., :3]), scale[..., None] * dW[..., 3:6]],
            dim=-1,
        )

    def x0(self, omega: DroneOmega):
        return self._x_init

    # -- constraints -------------------------------------------------------
    def _quad(self, xs, omega: DroneOmega):
        p = xs[..., 1:, :2]  # (..., S, 2)
        op = self._obs_positions[:, :2]  # (n_obs, 2)
        Q2 = omega.obs_Q[..., :, :2, :2]  # (..., n_obs, 2, 2)
        d = p[..., None, :, :] - op[:, None, :]  # (..., n_obs, S, 2)
        return torch.einsum("...jti,...jik,...jtk->...jt", d, Q2, d)

    def ineq_constraints(self, xs, omega: DroneOmega):
        """Obstacle-avoidance constraints g <= 0, flattened obstacle-major:
        row j*S + t <-> obstacle j at step t+1 (drone_risk.py:169-213).
        xs: (..., S+1, n_x); returns (..., n_obs * S)."""
        quad = self._quad(xs, omega)
        return (1.0 - quad).reshape(*quad.shape[:-2], self.K)

    def ineq_constraints_euclidean(self, xs, omega: DroneOmega):
        """1 - sqrt((p-op)^T Q (p-op)), the MC-verification variant of
        drone_main_plot.py:198-208."""
        quad = self._quad(xs, omega)
        return (1.0 - torch.sqrt(quad)).reshape(*quad.shape[:-2], self.K)

    def final_constraints(self, xs):
        """x_T - x_final (drone_risk.py:164-167)."""
        return xs[..., -1, :] - self._x_final

    # -- objective ---------------------------------------------------------
    def control_cost(self, us_mat):
        """dt * sum_t u_t^T R u_t (drone_risk.py:649-654)."""
        return self.dt * torch.sum(
            torch.einsum("ti,ij,tj->t", us_mat, self._R, us_mat)
        )

    # -- sampling ----------------------------------------------------------
    def sample(self, generator: torch.Generator, M: int,
               method: str = "saa") -> DroneOmega:
        """Draw per-sample uncertainty with the reference distributions
        (drone_utils.py:61-93): uniform masses in [nom-delta, nom+delta],
        uniform per-(obstacle, axis) radius perturbations baked into
        Q = diag(1/length^2), Brownian increments sqrt(dt)*N(0, I).
        'baseline' zeroes all uncertainty (drone_utils.py:77-92).

        Numbers are drawn on the generator's device in float64 and then
        moved to the model's device and dtype."""
        scn = self.scn
        gdev = generator.device
        kw = dict(generator=generator, device=gdev, dtype=torch.float64)
        radii = scn.obs_radii.to(gdev)
        if method == "saa":
            masses = (scn.mass_nom - scn.mass_delta) + (
                2 * scn.mass_delta
            ) * torch.rand(M, **kw)
            deltas = scn.obs_radii_deltas * (
                2 * torch.rand(M, scn.n_obs, 3, **kw) - 1
            )
            lengths = radii[None, :, None] + deltas
            q_diag = 1.0 / lengths**2
            dWs = math.sqrt(scn.dt) * torch.randn(M, scn.S, scn.n_x, **kw)
        elif method == "baseline":
            masses = torch.full((M,), scn.mass_nom, dtype=torch.float64,
                                device=gdev)
            q_diag = (1.0 / radii**2)[None, :, None].expand(M, scn.n_obs, 3)
            dWs = torch.zeros(M, scn.S, scn.n_x, dtype=torch.float64,
                              device=gdev)
        else:
            raise ValueError(f"unknown sampling method: {method}")
        obs_Q = torch.diag_embed(q_diag)  # (M, n_obs, 3, 3)
        kw = dict(device=self.device, dtype=self.dtype)
        return DroneOmega(mass=masses.to(**kw), obs_Q=obs_Q.to(**kw),
                          dWs=dWs.to(**kw))

    def default_scp_config(self) -> SCPConfig:
        """Reference SCP knobs: 60 iterations (drone_risk.py:56), first 2
        iterations gated with row scale 1e-7 and bounds +/-0.1
        (drone_risk.py:413-417)."""
        return SCPConfig(
            num_iters=60, gate_iters=2, gate_row_scale=1e-7,
            gate_bound_l=-0.1, gate_bound_u=0.1,
        )

    # -- initial guess -----------------------------------------------------
    def initial_guess(self):
        """Midpoint-of-bounds + 1e-2 on the first n_u-1 controls
        (drone_risk.py:108-120: only indices :(n_u-1) get the offset)."""
        us = torch.zeros(self.S, self.n_u, device=self.device, dtype=self.dtype)
        us[:, : self.n_u - 1] = 1e-2
        return us
