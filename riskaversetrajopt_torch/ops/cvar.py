"""Risk estimators: VaR / AVaR (CVaR) of sampled statistics.

The counterpart of ``riskaversetrajopt_tpu/ops/cvar.py``: the
Rockafellar-Uryasev estimation QP the reference solves per evaluation
(car/driving.py:639-671) has the empirical VaR as its optimal t, so both
estimators reduce to one sort. `avar_qp` solves that QP (by the
interior-point method) as the parity check of `avar`.
"""

from __future__ import annotations

import torch

from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.ops.ipm import IPMConfig, solve_qp_ipm


def var_sorted(Z, alpha):
    """Empirical VaR_alpha: the (floor(alpha*M)+1)-th largest sample
    (monte_carlo_var, drone_main_plot.py:640-652)."""
    M = Z.shape[0]
    Z_sorted = torch.sort(Z).values
    xth = int(torch.floor(torch.as_tensor(alpha, dtype=Z.dtype) * M))
    return Z_sorted[M - xth - 1]


def avar(Z, alpha):
    """Empirical AVaR_alpha: t* + mean(max(Z - t*, 0)) / alpha with t* the
    empirical VaR (car/driving.py:639-671)."""
    t = var_sorted(Z, alpha)
    return t + torch.mean(torch.clamp(Z - t, min=0.0)) / alpha


class AVaRQPOps:
    """Matrix-free operator of the Rockafellar-Uryasev estimation QP
    (cvar.py:36-90)

        min 1/(M alpha) sum y_i + t   s.t.  -y <= 0,  -y - t <= -Z

    over z = [y (M) | t], rows [(-I 0); (-I -1)]: the reference's dense
    (2M, M+1) matrix (car/driving.py:645-658) is never formed. The KKT
    matrix sigma I + A^T R A is diagonal-plus-arrow; the solve is a scalar
    Schur complement over t."""

    def __init__(self, M):
        self.M = M

    def matvec_P(self, z):
        return torch.zeros_like(z)

    def matvec_A(self, z):
        y, t = z[:-1], z[-1]
        return torch.cat([-y, -y - t])

    def rmatvec_A(self, w):
        w1, w2 = w[: self.M], w[self.M :]
        return torch.cat([-w1 - w2, -torch.sum(w2)[None]])

    def row_inf_norms(self, D):
        D_y, D_t = D[:-1], D[-1]
        return torch.cat([D_y, torch.maximum(D_y, D_t)])

    def col_inf_norms(self, E):
        E1, E2 = E[: self.M], E[self.M :]
        return torch.cat([torch.maximum(E1, E2), torch.amax(E2)[None]])

    def col_inf_norms_P(self, D):
        return torch.zeros_like(D)

    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        r1, r2 = rho_vec[: self.M], rho_vec[self.M :]
        Dy = sigma_vec[:-1] + r1 + r2
        S_t = sigma_vec[-1] + torch.sum(r2) - torch.sum(r2 * r2 / Dy)
        return Dy, r2, S_t

    def kkt_solve(self, factor, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        Dy, r2, S_t = factor
        r_y, r_t = rhs[:-1], rhs[-1]
        t = (r_t - torch.sum(r2 * r_y / Dy)) / S_t
        y = (r_y - r2 * t) / Dy
        return torch.cat([y, t[None]])


def avar_qp(Z, alpha, cfg=None, device=None):
    """AVaR by the reference's own formulation, the QP
    inf_t t + 1/(M alpha) sum y_i s.t. y >= 0, y >= Z - t, solved by the
    interior-point method on AVaRQPOps (cvar.py:93-108): the parity check of
    `avar`. `Z` is a tensor (the solve runs on its device unless `device`
    names another) or an array (on the card unless `device` names another,
    models.base.resolve_device)."""
    if not isinstance(Z, torch.Tensor) or device is not None:
        Z = torch.as_tensor(Z).to(resolve_device(device))
    M = Z.shape[0]
    kw = dict(dtype=Z.dtype, device=Z.device)
    q = torch.cat([torch.full((M,), 1.0 / (M * alpha), **kw),
                   torch.ones(1, **kw)])
    l = torch.full((2 * M,), float("-inf"), **kw)
    u = torch.cat([torch.zeros(M, **kw), -Z])
    sol = solve_qp_ipm(AVaRQPOps(M), q, l, u, n_eq=0,
                       cfg=cfg or IPMConfig(tol=1e-8))
    t_risk = sol.x[-1]
    return t_risk + torch.mean(torch.clamp(Z - t_risk, min=0.0) / alpha)
