"""Gaussian-linearization drone baseline, solved as one NLP with optimal
risk allocation over (timestep, obstacle) pairs and obstacle radii.

The counterpart of ``riskaversetrajopt_tpu/models/drone_gaussian.py``
(reference drone/drone_gaussian.py): the decision vector is
Z = [us (S*n_u) | alphas_risk (S*n_obs + n_obs)], a risk per (step,
obstacle) pair and one per obstacle radius; the obstacle rows are
quantile-padded with the radius back-off rad_max - (alpha_obs/3)(rad_max -
rad_min) (drone_gaussian.py:251-255); the covariance follows the iid-mass
approximation (drone_gaussian.py:176-227). The NLP goes through
``ops/nlp_ipm.py`` (the reference: IPOPT at tol 1e-8), warm-started from
the SAA solution of drone_risk (drone_gaussian.py:104-116) via `us_init`.

The planner runs on the card unless `device` names another. The JAX
package's `ConstBind` and `solve(jitted=True)` (its array constants passed
as jit arguments for the TPU runtime) have no counterpart here: `solve`
runs the barrier loop eagerly. The Lagrangian's Hessian differentiates
through the covariance recursion, which takes a ``jacfwd`` at each step,
so every function here is functional for ``torch.func``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from riskaversetrajopt_torch.core.config import DroneScenario
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.models.drone import DroneModel, DroneOmega
from riskaversetrajopt_torch.ops.gaussian import (
    normal_quantile,
    propagate_covariance,
)
from riskaversetrajopt_torch.ops.nlp_ipm import NLPConfig, NLPResult, solve_nlp


class GaussianDroneResult(NamedTuple):
    us: torch.Tensor  # (S, n_u)
    alphas_risk: torch.Tensor  # (S*n_obs + n_obs,)
    xs: torch.Tensor  # (S+1, n_x) mean trajectory
    Sigmas: torch.Tensor  # (S+1, n_x, n_x)
    nlp: NLPResult


class GaussianDronePlanner:
    def __init__(self, scn: DroneScenario = DroneScenario(), alpha: float = 0.1,
                 dtype=torch.float64, device=None):
        self.scn = scn
        self.alpha = alpha
        self.dtype = dtype
        self.device = resolve_device(device)
        self.drone = DroneModel(scn, device=self.device, dtype=dtype)
        self.S, self.n_x, self.n_u = scn.S, scn.n_x, scn.n_u
        self.n_obs = scn.n_obs
        self.n_us = self.S * self.n_u
        self.n_alpha = self.S * self.n_obs + self.n_obs
        self.nv = self.n_us + self.n_alpha
        self.mass_var = (2 * scn.mass_delta) ** 2 / 12.0  # drone_gaussian.py:82
        # every array constant in the planner's dtype, so that a float32
        # planner computes in float32 throughout
        kw = dict(dtype=dtype, device=self.device)
        self._x_init = scn.x_init.to(**kw)
        self._x_final = scn.x_final.to(**kw)
        self._obs_positions = scn.obs_positions.to(**kw)
        self._obs_radii = scn.obs_radii.to(**kw)
        self._R = scn.R.to(**kw)
        self._nominal_omega = DroneOmega(
            mass=torch.tensor(scn.mass_nom, **kw),
            obs_Q=torch.zeros(scn.n_obs, 3, 3, **kw),
            dWs=torch.zeros(scn.S, scn.n_x, **kw),
        )
        # the diffusion sigma: (beta / mass_nom) I on the velocity block
        sig = torch.zeros(self.n_x, self.n_x, dtype=torch.float64)
        sig[3:6, 3:6] = (scn.beta / scn.mass_nom) * torch.eye(
            3, dtype=torch.float64)
        self._disp = sig.to(**kw)

    def split_z(self, Z):
        us = Z[: self.n_us].reshape(self.S, self.n_u)
        alphas = Z[self.n_us :]
        # the state risks are stored obstacle-major then transposed
        # (reshape((n_obs, S), 'F').T at drone_gaussian.py:358-359)
        a_state = alphas[: self.S * self.n_obs].reshape(self.S, self.n_obs)
        a_obs = alphas[self.S * self.n_obs :]
        return us, a_state, a_obs

    # -- mean + covariance (drone_gaussian.py:161-227) ---------------------
    def mean_trajectory(self, us_mat):
        om = self._nominal_omega
        x = self._x_init.to(us_mat.dtype)
        xs = [x]
        for u in us_mat:
            x = x + self.scn.dt * self.drone.drift(x, u, om)
            xs.append(x)
        return torch.stack(xs)

    def covariance_trajectory(self, us_mat):
        return self._covariances(self.mean_trajectory(us_mat), us_mat)

    def _covariances(self, xs, us_mat):
        """The covariance recursion along the mean trajectory xs. The
        drift's x and mass Jacobians at every step depend only on the mean
        trajectory, so one vmapped jacfwd computes them all before the
        recursion reads them, step by step."""
        om = self._nominal_omega

        def drift(x, u, mass):
            return self.drone.drift(x, u, om._replace(mass=mass))

        J_x, J_m = vmap(jacfwd(drift, argnums=(0, 2)), in_dims=(0, 0, None))(
            xs[:-1], us_mat, om.mass)
        # propagate_covariance calls drift_jac_x first at each step
        step = iter(range(self.S))
        at = {}

        def jac_x(x, u):
            at["t"] = next(step)
            return J_x[at["t"]]

        dt = us_mat.dtype
        return propagate_covariance(
            xs, us_mat, torch.zeros(self.n_x, self.n_x, dtype=dt,
                                    device=us_mat.device),
            jac_x, lambda x, u: self._disp.to(dt),
            [lambda x, u: J_m[at["t"]]], [self.mass_var], self.scn.dt,
        )

    # -- constraints -------------------------------------------------------
    def obstacle_constraints(self, us_mat, a_state, a_obs):
        """(n_obs, S) quantile-padded obstacle rows
        (drone_gaussian.py:238-316): g = -(dist - pad - radius_backoff)."""
        xs = self.mean_trajectory(us_mat)
        return self._obstacles(xs, self._covariances(xs, us_mat), a_state,
                               a_obs)

    def _obstacles(self, xs, Sigmas, a_state, a_obs):
        dt = xs.dtype
        scn = self.scn
        r = self._obs_radii.to(dt)
        rad_min = r - scn.obs_radii_deltas
        rad_max = r + scn.obs_radii_deltas
        radius = rad_max - (a_obs / 3.0) * (rad_max - rad_min)  # (n_obs,)
        p = xs[1:, :2]  # (S, 2)
        Sig = Sigmas[1:, :2, :2]  # (S, 2, 2)
        delta = p[None] - self._obs_positions.to(dt)[:, None, :2]
        dist = torch.linalg.norm(delta, dim=-1)  # (n_obs, S)
        normal = delta / dist[..., None]
        # the clamp: the position variance is exactly zero at t=1 and sqrt's
        # derivative is infinite at 0; it moves the padding by
        # < ndtri(1-a)*1e-6
        var = torch.clamp(
            torch.einsum("jti,tik,jtk->jt", normal, Sig, normal), min=1e-12)
        pad = normal_quantile(1 - a_state.T) * torch.sqrt(var)
        return -(dist - pad - radius[:, None])

    def state_bound_constraints(self, us_mat):
        """The xs[:, :2] box rows (drone_gaussian.py:368-374)."""
        return self._state_bounds(self.mean_trajectory(us_mat))

    def _state_bounds(self, xs):
        hi = (xs[:, :2] - 0.5).reshape(-1)
        lo = torch.stack([-xs[:, 0] - 2.0, -xs[:, 1] - 0.5], -1).reshape(-1)
        return torch.cat([hi, lo])

    # -- NLP assembly (drone_gaussian.py:400-526) --------------------------
    def f(self, Z):
        us, _, _ = self.split_z(Z)
        R = self._R.to(Z.dtype)
        # a (1,) sum, then the 0-dim value: forward-mode AD of a 0-dim
        # tensor times a Python float yields a float64 tangent in torch
        return (2.0 * self.scn.dt * torch.sum(
            torch.einsum("ti,ij,tj->t", us, R, us))[None])[0]

    def g(self, Z):
        us, a_state, a_obs = self.split_z(Z)
        xs = self.mean_trajectory(us)
        g_final = xs[-1] - self._x_final.to(Z.dtype)
        g_obs = self._obstacles(xs, self._covariances(xs, us), a_state,
                                a_obs).reshape(-1)
        alphas = Z[self.n_us :]
        g_ctrl = torch.cat([Z[: self.n_us], alphas, torch.sum(alphas)[None]])
        return torch.cat([g_final, g_obs, self._state_bounds(xs), g_ctrl])

    def bounds(self):
        scn = self.scn
        kw = dict(dtype=self.dtype, device=self.device)
        big = 1e15
        n_eq = self.n_x
        m_obs = self.n_obs * self.S + 4 * (self.S + 1)
        # final state; obstacle and state-box rows <= 0; control bounds;
        # alpha in [1e-6, alpha]; sum alpha in [0, alpha]
        g_L = torch.cat([
            torch.zeros(n_eq, **kw), torch.full((m_obs,), -big, **kw),
            torch.full((self.n_us,), -scn.u_max, **kw),
            torch.full((self.n_alpha,), 1e-6, **kw), torch.zeros(1, **kw)])
        g_U = torch.cat([
            torch.zeros(n_eq, **kw), torch.zeros(m_obs, **kw),
            torch.full((self.n_us,), scn.u_max, **kw),
            torch.full((self.n_alpha,), self.alpha, **kw),
            torch.full((1,), self.alpha, **kw)])
        x_L = torch.full((self.nv,), -1000.0, **kw)
        x_U = torch.full((self.nv,), 1000.0, **kw)
        return g_L, g_U, n_eq, x_L, x_U

    def initial_guess(self, us_init: Optional[torch.Tensor] = None):
        """The SAA solution as the controls' warm start
        (drone_gaussian.py:104-116) and a uniform risk allocation
        (drone_gaussian.py:118-124)."""
        kw = dict(dtype=self.dtype, device=self.device)
        us = (torch.zeros(self.n_us, **kw) if us_init is None
              else torch.as_tensor(us_init).reshape(-1).to(**kw))
        a0 = self.alpha / (self.S * self.n_obs + self.n_obs)
        return torch.cat([us, torch.full((self.n_alpha,), a0, **kw)])

    def solve(self, us_init: Optional[torch.Tensor] = None,
              cfg: Optional[NLPConfig] = None) -> GaussianDroneResult:
        """The barrier solve. Default config: tol 1e-6, 1500 iterations
        (about 500 are needed from the SAA warm start; the reference runs
        IPOPT with max_iter 3000, drone_gaussian.py:500-502), and in float32
        three symmetric Ruiz sweeps of the KKT matrix, whose raw
        conditioning exceeds 1/eps_f32."""
        if cfg is None:
            cfg = NLPConfig(tol=1e-6, max_iter=1500,
                            kkt_ruiz_iters=3 if self.dtype == torch.float32
                            else 0)
        g_L, g_U, n_eq, x_L, x_U = self.bounds()
        res = solve_nlp(self.f, self.g, g_L, g_U, n_eq, x_L, x_U,
                        self.initial_guess(us_init), cfg)
        us, _, _ = self.split_z(res.Z)
        return GaussianDroneResult(
            us=us, alphas_risk=res.Z[self.n_us :],
            xs=self.mean_trajectory(us),
            Sigmas=self.covariance_trajectory(us), nlp=res)
