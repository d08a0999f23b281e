"""Gaussian-linearization car baseline with optimal risk allocation.

The counterpart of ``riskaversetrajopt_tpu/models/car_gaussian.py``
(reference car/driving_gaussian.py): the pedestrian-state mean and
covariance are propagated through the linearized social-force dynamics, the
separation constraint becomes a quantile back-off with per-step risk
allocations alpha_t that are themselves QP variables (bounds
100*OSQP_TOL <= alpha_t <= alpha, sum_t alpha_t <= alpha), and SCP solves a
dense QP per iteration over z = [us | alphas_risk | one unused trailing
column, the reference's slack that enters no row, kept for layout parity].

The planner runs on the card unless `device` names another. The JAX
package's `ConstBind` and `solve_jitted` (its array constants passed as jit
arguments for the TPU runtime) have no counterpart here: `solve` runs the
SCP loop eagerly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd

from riskaversetrajopt_torch.core.config import CarScenario, SolverConfig
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.models.car import CarModel, CarOmega
from riskaversetrajopt_torch.ops import admm
from riskaversetrajopt_torch.ops.gaussian import (
    normal_quantile,
    propagate_covariance,
)
from riskaversetrajopt_torch.ops.ipm import IPMConfig, solve_qp_ipm
from riskaversetrajopt_torch.ops.qp_refine import IRConfig, solve_dense_qp_ir


class GaussianCarResult(NamedTuple):
    us: torch.Tensor  # (S, n_u)
    alphas_risk: torch.Tensor  # (S,)
    xs: torch.Tensor  # (S+1, n_x) mean trajectory
    Sigmas: torch.Tensor  # (S+1, n_x, n_x)
    l2_errors: torch.Tensor  # (num_scp_iters,)
    # per-SCP-iteration QP certification flags ('admm-ir' certifies the
    # OSQP_TOL=1e-8 stress tolerance with compensated residuals; 'ipm'
    # reports its own convergence flag)
    qp_solved: Optional[torch.Tensor] = None


class GaussianCarPlanner:
    OSQP_TOL = 1e-8  # the reference's override (driving_gaussian.py:27)

    def __init__(self, scn: CarScenario = CarScenario(), alpha: float = 0.1,
                 num_scp_iters: int = 60, dtype=torch.float64, device=None):
        self.scn = scn
        self.alpha = alpha
        self.num_scp_iters = num_scp_iters
        self.dtype = dtype
        self.device = resolve_device(device)
        self.car = CarModel(scn, device=self.device, dtype=dtype)
        self.S, self.n_x, self.n_u = scn.S, scn.n_x, scn.n_u
        self.nv = self.n_u * self.S + self.S + 1
        # variances of the uniform interaction gains (driving_gaussian.py:
        # 81-84)
        self.var_speed = (2 * scn.omega_speed_del) ** 2 / 12.0
        self.var_rep = (2 * scn.omega_repulsive_del) ** 2 / 12.0
        kw = dict(dtype=dtype, device=self.device)
        Sigma0 = torch.zeros(scn.n_x, scn.n_x, dtype=torch.float64)
        Sigma0[4:, 4:] = scn.variance_ped_initial_state
        self.Sigma0 = Sigma0.to(**kw)
        self._state_init = scn.state_init.to(**kw)
        self._goal = torch.cat(
            [scn.position_ego_goal, scn.velocity_ego_goal]).to(**kw)
        self._R_diag = torch.diagonal(scn.R).to(**kw)
        self._nominal_omega = CarOmega(
            state_init=self._state_init,
            omega_speed=torch.tensor(scn.omega_speed_nom, **kw),
            omega_repulsive=torch.tensor(scn.omega_repulsive_nom, **kw),
            dWs=torch.zeros(scn.S, scn.n_x, **kw),
        )

    # -- mean + covariance propagation (driving_gaussian.py:171-228) -------
    def mean_trajectory(self, us_mat):
        om = self._nominal_omega
        x = self._state_init.to(us_mat.dtype)
        xs = [x]
        for u in us_mat:
            x = x + self.scn.dt * self.car.drift(x, u, om)
            xs.append(x)
        return torch.stack(xs)

    def covariance_trajectory(self, us_mat):
        return self._covariances(self.mean_trajectory(us_mat), us_mat)

    def _covariances(self, xs, us_mat):
        """The covariance recursion along the mean trajectory xs; the drift
        Jacobians in x and in both gains come from one jacfwd per step."""
        om = self._nominal_omega

        def drift(x, u, os, orp):
            return self.car.drift(
                x, u, om._replace(omega_speed=os, omega_repulsive=orp))

        jac = jacfwd(drift, argnums=(0, 2, 3))
        last = {}

        def jacs(x, u):
            # propagate_covariance asks for the three Jacobians at one (x, u)
            # in turn: compute them once
            if last.get("at") is not x:
                last["at"] = x
                last["j"] = jac(x, u, om.omega_speed, om.omega_repulsive)
            return last["j"]

        kw = dict(dtype=us_mat.dtype, device=us_mat.device)
        sig = torch.zeros(self.n_x, self.n_x, **kw)
        sig[6:, 6:] = self.scn.beta * torch.eye(2, **kw)
        return propagate_covariance(
            xs, us_mat, self.Sigma0.to(us_mat.dtype),
            lambda x, u: jacs(x, u)[0], lambda x, u: sig,
            [lambda x, u: jacs(x, u)[1], lambda x, u: jacs(x, u)[2]],
            [self.var_speed, self.var_rep], self.scn.dt,
        )

    # -- constraints -------------------------------------------------------
    def separation_constraints(self, us_mat, alphas_risk):
        """-(quantile-padded separation distances) at t = 1..S
        (driving_gaussian.py:237-264)."""
        xs = self.mean_trajectory(us_mat)
        return self._separation(xs, self._covariances(xs, us_mat),
                                alphas_risk)

    def _separation(self, xs, Sigmas, alphas_risk):
        xs = xs[1:]
        Sig_p = Sigmas[1:, 4:6, 4:6]
        delta = xs[:, 0:2] - xs[:, 4:6]
        dist = torch.linalg.norm(delta, dim=-1)
        normal = delta / dist[:, None]
        # the clamp guards the sqrt derivative at zero variance
        var = torch.clamp(
            torch.einsum("ti,tij,tj->t", normal, Sig_p, normal), min=1e-12)
        pad = normal_quantile(1 - alphas_risk) * torch.sqrt(var)
        return -(dist - pad - self.scn.min_separation_distance)

    def final_constraints(self, us_mat):
        xs = self.mean_trajectory(us_mat)
        return xs[-1, :4] - self._goal.to(us_mat.dtype)

    # -- QP assembly (driving_gaussian.py:271-426) --------------------------
    def build_qp(self, us_prev, alphas_prev, scp_iter: int):
        S, n_u, n_x = self.S, self.n_u, self.n_x
        nv = self.nv
        kw = dict(dtype=us_prev.dtype, device=us_prev.device)

        def cons(us_mat, alphas):
            xs = self.mean_trajectory(us_mat)
            return (xs[-1, :4] - self._goal.to(us_mat.dtype),
                    self._separation(xs, self._covariances(xs, us_mat),
                                     alphas))

        v_final, g_obs = cons(us_prev, alphas_prev)
        (F_u, F_a), (G_u, G_a) = jacfwd(cons, argnums=(0, 1))(
            us_prev, alphas_prev)
        F_u = F_u.reshape(4, n_u * S)
        G_u = G_u.reshape(S, n_u * S)

        us_vec = us_prev.reshape(-1)
        f_rhs = -v_final + F_u @ us_vec  # F_a = 0, kept general
        f_rhs = f_rhs + F_a @ alphas_prev
        g_up = -g_obs + G_u @ us_vec + G_a @ alphas_prev

        inf = float("inf")
        # [final (4) | obs (S)] with iteration gating on rows >= n_x
        A_top = torch.zeros(4 + S, nv, **kw)
        A_top[:4, : n_u * S] = F_u
        A_top[:4, n_u * S : n_u * S + S] = F_a
        A_top[4:, : n_u * S] = G_u
        A_top[4:, n_u * S : n_u * S + S] = G_a
        l_top = torch.cat([f_rhs, torch.full((S,), -inf, **kw)])
        u_top = torch.cat([f_rhs, g_up])
        if scp_iter < 1:
            # the reference's gating: rows >= n_x zeroed, their lower bound
            # NaN (OSQP reads -inf) and their upper 0 (car_gaussian.py:183)
            gate = torch.arange(4 + S, device=kw["device"]) >= n_x
            A_top = torch.where(gate[:, None], 0.0, A_top)
            l_top = torch.where(gate, -inf, l_top)
            u_top = torch.where(gate, 0.0, u_top)

        # control and risk-allocation rows (driving_gaussian.py:271-301)
        A_cr = torch.zeros(n_u * S + S + 1, nv, **kw)
        A_cr[: n_u * S, : n_u * S] = torch.eye(n_u * S, **kw)
        A_cr[n_u * S : n_u * S + S, n_u * S : n_u * S + S] = torch.eye(S, **kw)
        A_cr[-1, n_u * S : n_u * S + S] = 1.0
        lo_alpha = 100 * self.OSQP_TOL
        l_cr = torch.cat([torch.full((n_u * S,), -self.scn.u_max, **kw),
                          torch.full((S + 1,), lo_alpha, **kw)])
        u_cr = torch.cat([torch.full((n_u * S,), self.scn.u_max, **kw),
                          torch.full((S + 1,), self.alpha, **kw)])

        A = torch.cat([A_top, A_cr])
        l = torch.cat([l_top, l_cr])
        u = torch.cat([u_top, u_cr])

        P = torch.zeros(nv, nv, **kw)
        idx = torch.arange(n_u * S, device=kw["device"])
        P[idx, idx] = (2.0 * self.scn.dt * self._R_diag).repeat(S).to(**kw)
        q = torch.zeros(nv, **kw)
        return P, q, A, l, u

    def initial_guess(self):
        kw = dict(dtype=self.dtype, device=self.device)
        us = torch.full((self.S, self.n_u), 1e-2, **kw)
        alphas = (self.alpha / self.S) * torch.ones(self.S, **kw)
        return us, alphas

    # -- SCP loop (driving_gaussian.py:466-499) ----------------------------
    def solve(self, ipm_cfg: Optional[IPMConfig] = None,
              qp_backend: Optional[str] = None) -> GaussianCarResult:
        """The full SCP solve. qp_backend: 'ipm' (the float64 default:
        Mehrotra at tol 1e-7) or 'admm-ir' (the float32 default: warm-started
        dense ADMM with compensated iterative refinement, certifying the
        reference's OSQP_TOL=1e-8 from float32 arithmetic; a plain float32
        IPM diverges on these QPs)."""
        from riskaversetrajopt_torch.scp.driver import l2_error_us

        if qp_backend is None:
            qp_backend = "admm-ir" if self.dtype == torch.float32 else "ipm"
        ipm_cfg = ipm_cfg or IPMConfig(tol=1e-7, max_iter=50)
        S, n_u = self.S, self.n_u
        ir_cfg = SolverConfig(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000,
                              polish=False, kkt_refine_iters=1)
        kw = dict(dtype=self.dtype, device=self.device)
        us_prev, alphas_prev = self.initial_guess()
        # build_qp's rows: A_top (4 + S) + A_cr (n_u*S + S + 1)
        wx = torch.zeros(self.nv, **kw)
        wy = torch.zeros(4 + S + n_u * S + S + 1, **kw)
        l2s, solved = [], []
        for scp_iter in range(self.num_scp_iters):
            P, q, A, l, u = self.build_qp(us_prev, alphas_prev, scp_iter)
            if qp_backend == "admm-ir":
                sol = solve_dense_qp_ir(
                    P, q, A, l, u, ir_cfg, IRConfig(rounds=10, work_eps=1e-5),
                    x0=wx, y0=wy)
            else:
                sol = solve_qp_ipm(admm.DenseQPOps(P, A), q, l, u, n_eq=4,
                                   cfg=ipm_cfg)
            us = sol.x[: n_u * S].reshape(S, n_u)
            l2s.append(l2_error_us(us, us_prev))
            solved.append(bool(sol.solved))
            us_prev, alphas_prev = us, sol.x[n_u * S : n_u * S + S]
            wx, wy = sol.x, sol.y
        return GaussianCarResult(
            us=us_prev, alphas_risk=alphas_prev,
            xs=self.mean_trajectory(us_prev),
            Sigmas=self.covariance_trajectory(us_prev),
            l2_errors=torch.stack(l2s) if l2s else torch.zeros(0, **kw),
            qp_solved=torch.tensor(solved, dtype=torch.bool),
        )
