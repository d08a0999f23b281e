"""Primal-dual interior-point QP solver (Mehrotra predictor-corrector).

The counterpart of ``riskaversetrajopt_tpu/ops/ipm.py`` (its module
docstring gives the reasoning). Solves the OSQP-form problem
    minimize    (1/2) x^T P x + q^T x
    subject to  l <= A x <= u
where the FIRST n_eq rows are equalities (l_i == u_i) handled exactly via a
dense Schur complement on their multipliers, and the remaining rows get
logarithmic barriers on their finite sides. It drives the same operator
interface as ops/admm.py (factorize / kkt_solve with per-row weights).

Newton reduction (rows split eq / ineq; W_l = Lambda_l S_l^-1 etc.):
    N dx + A_eq^T dy_eq = R,   N = P + sigma I + A_in^T (W_l + W_u) A_in
    A_eq dx = -r_eq
    => (A_eq N^-1 A_eq^T) dy_eq = A_eq N^-1 R + r_eq   (n_eq x n_eq dense)
with fraction-to-boundary steps and the Mehrotra centering
sigma = (mu_aff / mu)^3.

The iteration is a Python loop; the iterates stay on the device and the
host reads one flag per iteration (whether to stop), where the JAX
while-loop evaluates its condition.

Every reduction over the variables or the rows (the norms, mu, the
step-length minima, the equality Schur block) is taken from the operator's
`reductions` (ops/admm.py), so the solver runs on a sample-sharded
operator as on a whole one: every quantity the stopping rule reads comes
out of a global reduction, so every process takes the same decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from riskaversetrajopt_torch.ops.admm import (
    QPSolution,
    ScaledOps,
    _polish,
    reductions,
    ruiz_equilibrate,
)


class IPMConfig(NamedTuple):
    tol: float = 1e-8
    max_iter: int = 50
    tau: float = 0.995  # fraction-to-boundary
    sigma_reg: float = 1e-9  # primal regularization in N
    s_init: float = 1.0
    lam_init: float = 1.0
    # optional active-set polish of the final iterate, accepted only when
    # it improves both residuals (off: on the degenerate CVaR epigraph QPs
    # the active set is often not unique and the candidate is rejected)
    polish: bool = False
    polish_refine_iters: int = 3


def solve_qp_ipm(ops, q, l, u, n_eq: int, cfg: IPMConfig = IPMConfig(),
                 scale: bool = True, ruiz_iters: int = 5) -> QPSolution:
    """Interior-point solve (ipm.py:59-113). `ops` follows the ops/admm.py
    operator interface; the first `n_eq` rows of (l, u) must have l == u.

    With `scale` (default) the iteration runs on the Ruiz-equilibrated
    problem (essential in float32: the raw SAA QP loses its small Newton
    pivots) and the returned solution, residuals and `solved` flag are
    certified UNSCALED (OSQP termination semantics)."""
    if not scale:
        return _solve_qp_ipm_raw(ops, q, l, u, n_eq, cfg)
    scaling = ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters)
    sops = ScaledOps(ops, scaling)
    sol = _solve_qp_ipm_raw(sops, scaling.c * scaling.D * q, scaling.E * l,
                            scaling.E * u, n_eq, cfg)
    x = scaling.D * sol.x
    y = scaling.E * sol.y / scaling.c
    Ax = ops.matvec_A(x)
    z = torch.clamp(Ax, l, u)
    Px = ops.matvec_P(x)
    Aty = ops.rmatvec_A(y)
    prim, dual, n_Ax, n_Px, n_Aty, n_q = reductions(ops).amax(*(
        torch.abs(v) for v in (Ax - z, Px + q + Aty, Ax, Px, Aty, q)))
    one = torch.ones((), dtype=q.dtype, device=q.device)
    p_sc = torch.maximum(n_Ax, one)
    d_sc = torch.maximum(torch.maximum(n_Px, n_Aty), torch.maximum(n_q, one))
    solved = (prim <= cfg.tol * p_sc) & (dual <= cfg.tol * d_sc)
    return QPSolution(x=x, y=y, z=z, iters=sol.iters, prim_res=prim,
                      dual_res=dual, solved=bool(solved))


class _State(NamedTuple):
    x: torch.Tensor
    y_eq: torch.Tensor
    s_l: torch.Tensor
    s_u: torch.Tensor
    lam_l: torch.Tensor
    lam_u: torch.Tensor


class _Res(NamedTuple):
    r_eq: torch.Tensor
    r_l: torch.Tensor
    r_u: torch.Tensor
    r_d: torch.Tensor
    mu: torch.Tensor
    prim: torch.Tensor
    dual: torch.Tensor
    p_scale: torch.Tensor
    d_scale: torch.Tensor


def _solve_qp_ipm_raw(ops, q, l, u, n_eq: int,
                      cfg: IPMConfig = IPMConfig()) -> QPSolution:
    """Mehrotra predictor-corrector on the problem as given
    (ipm.py:116-395). Returns the best iterate seen: the QPs here can be
    dual-degenerate and late barrier iterations may diverge. The vectors
    of the inequality rows (s_l, s_u, lam_l, lam_u) have the layout "w_in"
    of `reductions` (a sample-sharded operator's n_eq is its n_fc)."""
    red = reductions(ops)
    dtype, device = q.dtype, q.device
    kw = dict(dtype=dtype, device=device)
    n = q.shape[0]
    m = l.shape[0]
    mi = m - n_eq  # inequality rows
    zero = torch.zeros((), **kw)
    one = torch.ones((), **kw)
    inf = torch.tensor(float("inf"), **kw)
    nan = torch.tensor(float("nan"), **kw)

    b_eq = l[:n_eq]
    l_in = l[n_eq:]
    u_in = u[n_eq:]
    has_l = torch.isfinite(l_in)
    has_u = torch.isfinite(u_in)
    # a sum of 0/1 values: exact in any order
    sides_l, sides_u = red.sum((has_l.to(dtype), "w_in"),
                               (has_u.to(dtype), "w_in"))
    n_sides = torch.clamp(sides_l + sides_u, min=1)
    sigma_vec = torch.full((n,), cfg.sigma_reg, **kw)

    # A_eq^T columns through rmatvec of the one-hot equality rows
    eye_rows = torch.eye(n_eq, m, **kw)
    A_eq_T = (torch.stack([ops.rmatvec_A(e) for e in eye_rows]) if n_eq > 0
              else torch.zeros(0, n, **kw))  # (n_eq, n): row i = A_eq[i, :]
    zeros_eq = torch.zeros(n_eq, **kw)

    def rmatvec_with(w_eq, w_in):
        return ops.rmatvec_A(torch.cat([w_eq, w_in]))

    n_q, n_l, n_u = red.amax(
        torch.abs(q), torch.abs(torch.where(torch.isfinite(l), l, zero)),
        torch.abs(torch.where(torch.isfinite(u), u, zero)))
    q_norm = n_q + 1.0
    # bound scale for relative primal termination
    b_norm = torch.maximum(n_l, n_u) + 1.0
    # barrier-weight safeguard: float32 KKT factorizations lose the
    # small-pivot information once weights pass ~1e6
    w_max = 1e13 if dtype == torch.float64 else 3e6

    def residuals(s: _State) -> _Res:
        Ax = ops.matvec_A(s.x)
        Ax_in = Ax[n_eq:]
        r_eq = Ax[:n_eq] - b_eq
        r_l = torch.where(has_l, Ax_in - s.s_l - l_in, zero)
        r_u = torch.where(has_u, u_in - Ax_in - s.s_u, zero)
        Px = ops.matvec_P(s.x)
        Aty = rmatvec_with(s.y_eq, s.lam_u - s.lam_l)
        r_d = Px + q + Aty
        d_l, d_u = red.dots((s.s_l, s.lam_l, "w_in"), (s.s_u, s.lam_u, "w_in"))
        mu = (d_l + d_u) / n_sides
        n_req, n_l, n_u, dual, n_Px, n_Aty, n_Ax = red.amax(*(
            torch.abs(v) for v in (r_eq, r_l, r_u, r_d, Px, Aty, Ax)))
        prim = torch.maximum(n_req, torch.maximum(n_l, n_u))
        # OSQP-style relative scales: the duals of degenerate CVaR rows are
        # legitimately large
        d_scale = torch.maximum(torch.maximum(n_Px, n_Aty), q_norm)
        p_scale = torch.maximum(n_Ax, b_norm)
        return _Res(r_eq, r_l, r_u, r_d, mu, prim, dual, p_scale, d_scale)

    def primal_dual_steps(ds_l, ds_u, dlam_l, dlam_u):
        """The primal and the dual step length: the largest a in (0, 1]
        with v + a dv >= (1 - tau) v on each side's mask (the four ratio
        minima in one global reduction)."""
        ratios = []
        for v, dv, mask in ((s.s_l, ds_l, has_l), (s.s_u, ds_u, has_u),
                            (s.lam_l, dlam_l, has_l),
                            (s.lam_u, dlam_u, has_u)):
            neg = dv < 0
            ratios.append(torch.where(mask & neg,
                                      -v / torch.where(neg, dv, -one), inf))
        sl, su, ll, lu = (torch.minimum(one, cfg.tau * r)
                          for r in red.amin(*ratios))
        return torch.minimum(sl, su), torch.minimum(ll, lu)

    x0 = torch.zeros(n, **kw)
    Ax0 = ops.matvec_A(x0)[n_eq:]
    lam0 = torch.full((mi,), cfg.lam_init, **kw)
    s = _State(
        x=x0,
        y_eq=torch.zeros(n_eq, **kw),
        s_l=torch.where(has_l, torch.clamp(Ax0 - l_in, min=cfg.s_init), one),
        s_u=torch.where(has_u, torch.clamp(u_in - Ax0, min=cfg.s_init), one),
        lam_l=torch.where(has_l, lam0, zero),
        lam_u=torch.where(has_u, lam0, zero),
    )
    best, best_merit = s, inf
    best_prim = best_dual = inf
    res = residuals(s)
    it = 0
    done = False
    while not done and it < cfg.max_iter:
        w_l = torch.clamp(torch.where(has_l, s.lam_l / s.s_l, zero), 0.0, w_max)
        w_u = torch.clamp(torch.where(has_u, s.lam_u / s.s_u, zero), 0.0, w_max)
        rho_vec = torch.cat([zeros_eq, w_l + w_u])
        factor = ops.factorize(rho_vec, sigma_vec, 1.0)

        # Schur columns of the equality rows: N^-1 A_eq^T
        NiAeqT = (torch.stack([ops.kkt_solve(factor, col, rho_vec, sigma_vec,
                                             1.0) for col in A_eq_T])
                  if n_eq > 0 else torch.zeros(0, n, **kw))  # (n_eq, n)
        S_eq = (red.cross(A_eq_T, NiAeqT.T, "x")
                + cfg.sigma_reg * torch.eye(n_eq, **kw))

        def solve_step(r_cl, r_cu):
            """The reduced Newton system for the complementarity residuals
            r_c = S Lam e - target."""
            v = (torch.where(has_u, r_cu / s.s_u, zero) + w_u * res.r_u
                 - torch.where(has_l, r_cl / s.s_l, zero) - w_l * res.r_l)
            R = -res.r_d + rmatvec_with(zeros_eq, v)
            NiR = ops.kkt_solve(factor, R, rho_vec, sigma_vec, 1.0)
            if n_eq > 0:
                # a singular S_eq gives a NaN step, which is rejected below
                # (jnp.linalg.solve returns one; torch.linalg.solve raises)
                dy_eq, info = torch.linalg.solve_ex(
                    S_eq, red.cross(A_eq_T, NiR, "x") + res.r_eq)
                dy_eq = torch.where(info == 0, dy_eq, nan)
                dx = NiR - NiAeqT.T @ dy_eq
            else:
                dy_eq, dx = zeros_eq, NiR
            Adx = ops.matvec_A(dx)[n_eq:]
            ds_l = torch.where(has_l, Adx + res.r_l, zero)
            ds_u = torch.where(has_u, res.r_u - Adx, zero)
            dlam_l = torch.where(has_l, -(r_cl + s.lam_l * ds_l) / s.s_l, zero)
            dlam_u = torch.where(has_u, -(r_cu + s.lam_u * ds_u) / s.s_u, zero)
            return dx, dy_eq, ds_l, ds_u, dlam_l, dlam_u

        # --- affine (predictor) step ---
        r_cl_aff = s.s_l * s.lam_l
        r_cu_aff = s.s_u * s.lam_u
        dxa, dya, dsla, dsua, dlla, dlua = solve_step(r_cl_aff, r_cu_aff)
        a_p, a_d = primal_dual_steps(dsla, dsua, dlla, dlua)
        aff_l, aff_u = red.dots(
            (s.s_l + a_p * dsla, s.lam_l + a_d * dlla, "w_in"),
            (s.s_u + a_p * dsua, s.lam_u + a_d * dlua, "w_in"))
        mu_aff = (aff_l + aff_u) / n_sides
        sig = torch.clamp((mu_aff / (res.mu + 1e-30)) ** 3, 0.0, 1.0)

        # --- corrector ---
        r_cl = torch.where(has_l, r_cl_aff + dsla * dlla - sig * res.mu, zero)
        r_cu = torch.where(has_u, r_cu_aff + dsua * dlua - sig * res.mu, zero)
        dx, dy_eq, ds_l, ds_u, dlam_l, dlam_u = solve_step(r_cl, r_cu)
        a_p, a_d = primal_dual_steps(ds_l, ds_u, dlam_l, dlam_u)

        new = _State(
            x=s.x + a_p * dx,
            y_eq=s.y_eq + a_d * dy_eq,
            s_l=torch.where(has_l, s.s_l + a_p * ds_l, one),
            s_u=torch.where(has_u, s.s_u + a_p * ds_u, one),
            lam_l=torch.where(has_l, s.lam_l + a_d * dlam_l, zero),
            lam_u=torch.where(has_u, s.lam_u + a_d * dlam_u, zero),
        )
        res_new = residuals(new)
        # reject non-finite steps (extreme barrier weights near degeneracy)
        # and terminate at the previous iterate
        ok = (torch.isfinite(res_new.mu) & torch.isfinite(res_new.prim)
              & torch.isfinite(res_new.dual))
        s = _State(*(torch.where(ok, a, b) for a, b in zip(new, s)))
        prim = torch.where(ok, res_new.prim, res.prim)
        dual = torch.where(ok, res_new.dual, res.dual)
        mu = torch.where(ok, res_new.mu, res.mu)

        merit = torch.maximum(
            prim / res_new.p_scale,
            torch.maximum(dual / res_new.d_scale, mu / res_new.d_scale))
        improved = merit < best_merit
        best = _State(*(torch.where(improved, a, b) for a, b in zip(s, best)))
        best_prim = torch.where(improved, prim, best_prim)
        best_dual = torch.where(improved, dual, best_dual)
        diverged = merit > 1e3 * best_merit
        best_merit = torch.where(improved, merit, best_merit)
        it += 1
        done = bool((merit <= cfg.tol) | ~ok | diverged)
        # the residuals of the next iteration's state (used only if it runs,
        # which needs ok: then s is the new state)
        res = res_new

    # the best iterate seen (the final one when converged)
    x_out = best.x
    y_out = torch.cat([best.y_eq, best.lam_u - best.lam_l])
    z_out = torch.clamp(ops.matvec_A(x_out), l, u)
    if cfg.polish:
        eq_mask = torch.arange(m, device=device) < n_eq
        pad = torch.zeros(n_eq, dtype=torch.bool, device=device)
        lower_active = torch.cat([pad, has_l & (best.lam_l > best.s_l)])
        upper_active = torch.cat([pad, has_u & (best.lam_u > best.s_u)])
        x_out, y_out, z_out, _ = _polish(
            ops, q, l, u, x_out, y_out, z_out, cfg, eq_mask=eq_mask,
            active_masks=(lower_active, upper_active))
    return QPSolution(x=x_out, y=y_out, z=z_out, iters=it,
                      prim_res=best_prim, dual_res=best_dual,
                      solved=bool(best_merit <= cfg.tol))
