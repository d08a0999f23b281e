"""Typed configuration for the drone, car and hopper scenarios, the SCP
driver and the ADMM solver.

Field for field the dataclasses of ``riskaversetrajopt_tpu/core/config.py``
(same names, same defaults; the comments there explain each knob). Array
valued scenario constants are properties returning float64 CPU tensors;
callers move them to their device and dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SCPConfig:
    """Sequential-convex-programming driver knobs: iteration count and the
    iteration gating of the risk/obstacle rows (drone_risk.py:413-417)."""

    num_iters: int = 15
    gate_iters: int = 2
    gate_row_scale: float = 1e-7
    gate_bound_l: float = -0.1
    gate_bound_u: float = 0.1


@dataclass(frozen=True)
class SolverConfig:
    """ADMM QP solver knobs with OSQP-equivalent semantics."""

    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    max_iter: int = 4000
    check_every: int = 25
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    rho_warm_start: bool = False
    rho_epoch_every: int = 0
    rho_update_factor: float = 5.0
    sigma: float = 1e-6
    alpha_relax: float = 1.6
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 50
    polish: bool = True
    polish_refine_iters: int = 3
    kkt_refine_iters: int = 1
    kkt_refine_mode: str = "true"
    kkt_refine_period: int = 1
    kkt_chol_inverse: bool = False
    sweep_precision: str = "highest"
    scaled_termination: bool = False
    eps_sched_iters: int = 0
    eps_sched_factor: float = 1.0
    check_backoff_max: int = 1
    anderson_depth: int = 0
    ds_kkt_passes: int = 1


@dataclass(frozen=True)
class PDIPConfig:
    """Primal-dual interior-point NLP solver knobs (IPOPT-equivalent); the
    JAX package defines it and nothing reads it there either."""

    tol: float = 1e-6
    max_iter: int = 300
    mu_init: float = 1e-1
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    tau_min: float = 0.99
    reg_init: float = 1e-8
    reg_max: float = 1e8
    bound_push: float = 1e-2
    bound_frac: float = 1e-2


@dataclass(frozen=True)
class MeshConfig:
    """Layout of the ranks: samples split over `sample_devices` ranks and
    independent problems over `batch_devices` (parallel/mesh.py)."""

    sample_devices: int = 1
    batch_devices: int = 1
    sample_axis: str = "samples"
    batch_axis: str = "batch"


@dataclass(frozen=True)
class DroneScenario:
    """Drone point-mass with quadratic drag, feedback-corrected control, mass
    uncertainty and uncertain ellipsoidal obstacles (drone_params.py:1-45)."""

    n_x: int = 6
    n_u: int = 3
    S: int = 20
    M: int = 50
    T: float = 50.0
    u_max: float = 10.0
    mass_nom: float = 32.0
    mass_delta: float = 3.0
    beta: float = 1e-2
    drag_coefficient: float = 0.2
    n_obs: int = 3
    obs_radii_deltas: float = 0.025
    osqp_tol: float = 1e-3

    @property
    def dt(self) -> float:
        return self.T / self.S

    @property
    def R(self) -> torch.Tensor:
        return torch.eye(self.n_u, dtype=torch.float64)

    @property
    def feedback_gain(self) -> torch.Tensor:
        K = torch.zeros(self.n_u, self.n_x, dtype=torch.float64)
        K[:, :3] = 0.05 * torch.eye(self.n_u, dtype=torch.float64)
        K[:, 3:] = 0.25 * torch.eye(self.n_u, dtype=torch.float64)
        return -K

    @property
    def obs_positions(self) -> torch.Tensor:
        return torch.tensor(
            [[-1.4, -0.1, 0.0], [-0.7, 0.3, 0.0], [-0.3, 0.25, 0.0]],
            dtype=torch.float64,
        )

    @property
    def obs_radii(self) -> torch.Tensor:
        return torch.tensor([0.3, 0.2, 0.2], dtype=torch.float64)

    @property
    def x_init(self) -> torch.Tensor:
        return torch.tensor([-1.9, 0.05, 0.2, 0.0, 0.0, 0.0], dtype=torch.float64)

    @property
    def x_final(self) -> torch.Tensor:
        return torch.zeros(self.n_x, dtype=torch.float64)


@dataclass(frozen=True)
class CarScenario:
    """Planar ego car + interactive pedestrian (social-force model); values
    of car/driving_params.py:1-42."""

    n_x: int = 8
    n_u: int = 2
    S: int = 20
    M: int = 50
    T: float = 10.0
    u_max: float = 100.0
    beta: float = 3e-2  # diffusion magnitude, car/driving.py:94
    omega_speed_nom: float = 0.1
    omega_speed_del: float = 0.075
    omega_repulsive_nom: float = 0.05
    omega_repulsive_del: float = 0.045
    ego_width: float = 2.695
    ego_height: float = 1.663
    ped_radius: float = 0.5
    speed_ped_des: float = 1.3
    osqp_tol: float = 3e-4

    @property
    def dt(self) -> float:
        return self.T / self.S

    @property
    def R(self) -> torch.Tensor:
        return torch.diag(torch.tensor([1.0, 1.0 / 3.0], dtype=torch.float64))

    @property
    def min_separation_distance(self) -> float:
        return float(self.ped_radius
                     + math.sqrt(self.ego_width**2 + self.ego_height**2))

    @property
    def position_ego_init(self) -> torch.Tensor:
        return torch.tensor([-20.0, 0.0], dtype=torch.float64)

    @property
    def position_ped_init(self) -> torch.Tensor:
        return torch.tensor([0.0, -6.0], dtype=torch.float64)

    @property
    def velocity_ego_init(self) -> torch.Tensor:
        return torch.tensor([4.0, 0.0], dtype=torch.float64)

    @property
    def velocity_ped_init(self) -> torch.Tensor:
        return torch.tensor([0.0, self.speed_ped_des], dtype=torch.float64)

    @property
    def position_ego_goal(self) -> torch.Tensor:
        return torch.tensor([20.0, 0.1], dtype=torch.float64)

    @property
    def velocity_ego_goal(self) -> torch.Tensor:
        return torch.tensor([4.1, 0.0], dtype=torch.float64)

    @property
    def state_init(self) -> torch.Tensor:
        return torch.cat([self.position_ego_init, self.velocity_ego_init,
                          self.position_ped_init, self.velocity_ped_init])

    @property
    def variance_ped_initial_state(self) -> torch.Tensor:
        return torch.diag(
            torch.tensor([1e-1, 1e-1, 1e-4, 1e-4], dtype=torch.float64) ** 2)


@dataclass(frozen=True)
class HopperScenario:
    """2-D single-leg hopper with contact-implicit direct transcription
    (hopper/hopper.py:43-89; dynamics credited there to
    dojo-sim/ContactImplicitMPC.jl)."""

    n_x: int = 8
    n_u: int = 4
    S: int = 30
    M: int = 30
    T: float = 2.0
    time_jump: int = 10
    time_land: int = 20
    u_max: float = 1000.0
    mass_body: float = 3.0
    mass_leg: float = 0.3
    inertia_body: float = 0.75
    inertia_leg: float = 0.075
    gravity: float = 9.81
    max_contact_force: float = 1000.0
    mu_nom: float = 0.10
    num_mu_features: int = 30
    mu_intensity_scale: float = 0.025

    @property
    def dt(self) -> float:
        return self.T / self.S

    @property
    def num_vars(self) -> int:
        return (self.S + 1) * self.n_x + self.S * self.n_u + self.M + 2

    @property
    def state_initial(self) -> torch.Tensor:
        return torch.tensor([1e-6, 1.0, -1e-6, 1.0, 0.0, 0.0, 0.0, 0.0],
                            dtype=torch.float64) + 2e-7

    @property
    def state_final(self) -> torch.Tensor:
        return torch.tensor([0.15, 1.0, -1e-6, 1.0, 0.0, 0.0, 0.0, 0.0],
                            dtype=torch.float64) + 2e-7
