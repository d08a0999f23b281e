"""ADMM QP solver with OSQP-equivalent semantics.

The counterpart of ``riskaversetrajopt_tpu/ops/admm.py`` (its module
docstring describes the algorithm: modified Ruiz equilibration, per-row rho,
over-relaxation, unscaled-residual termination, adaptive rho, polishing and
the OSQP infeasibility certificates).

Problem form:
    minimize    (1/2) x^T P x + q^T x
    subject to  l <= A x <= u

The loops are Python loops. The iterates stay on the device; the host reads
device scalars only at the termination checks (one small transfer each),
exactly where the JAX while-loops evaluate their conditions.

Operator interface:
    matvec_P(x), matvec_A(x), rmatvec_A(w)
    factorize(rho_vec, sigma_vec, cost_scale) -> factor
    kkt_solve(factor, rhs, rho_vec, sigma_vec, cost_scale) -> x
        solves (cost_scale*P + diag(sigma_vec) + A^T diag(rho_vec) A) x = rhs
    row_inf_norms(D), col_inf_norms(E), col_inf_norms_P(D)   (for Ruiz)
    reductions (optional): the global reductions over the solver's vectors
        (LocalReductions when absent; parallel/distributed.SampleShard's
        for an operator whose samples are split over processes)
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch

from riskaversetrajopt_torch.core.config import SolverConfig

_RHO_MIN = 1e-6
_RHO_MAX = 1e6
_LOOSE_RHO = 1e-6
_EQ_TOL = 1e-9
_MIN_SCALING = 1e-4
_MAX_SCALING = 1e4
_AA_LAM = 1e-8  # Anderson's Tikhonov term, relative to the Gram's mean diagonal


class LocalReductions:
    """The reductions admm_solve takes over its vectors, where one process
    holds every entry: plain torch reductions. An operator whose vectors
    are split over processes carries its own (`ops.reductions`, the same
    methods as collectives). `layout` names what a vector indexes: "x" the
    variables, "w" the constraint rows, "w_in" the rows past the first
    n_fc (the interior-point method's inequality rows), "xww" the
    concatenation (x, z, y) of Anderson acceleration."""

    def amax(self, *ts):
        """The maximum of each tensor of non-negative values (0 for an
        empty one), stacked."""
        return torch.stack([_amax0(t) for t in ts])

    def amin(self, *ts):
        """The minimum of each tensor (inf for an empty one), stacked."""
        return torch.stack([_amin_inf(t) for t in ts])

    def sum(self, *pairs):
        """The sum of each (tensor, layout), stacked."""
        return torch.stack([torch.sum(t) for t, _ in pairs])

    def mean(self, t, layout):
        return torch.mean(t)

    def dots(self, *triples):
        """torch.dot of each (a, b, layout), stacked."""
        return torch.stack([torch.dot(a, b) for a, b, _ in triples])

    def cross(self, A, B, layout):
        """A @ B, contracting the last axis of A (a vector of `layout` per
        row) with the first of B."""
        return A @ B

    def all(self, b):
        return torch.all(b)

    def any(self, b):
        return torch.any(b)

    def gram(self, F, layout):
        """F F^T over the rows of F (each a vector of `layout`)."""
        return F @ F.T


def _amax0(t):
    """torch.amax(t), 0 for an empty t (jnp.max(..., initial=0.0))."""
    if t.numel() == 0:
        return torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.amax(t)


def _amin_inf(t):
    """torch.amin(t), inf for an empty t."""
    if t.numel() == 0:
        return torch.full((), float("inf"), dtype=t.dtype, device=t.device)
    return torch.amin(t)


LOCAL = LocalReductions()


def reductions(ops):
    return getattr(ops, "reductions", LOCAL)


class QPSolution(NamedTuple):
    x: torch.Tensor  # primal solution (n,)
    y: torch.Tensor  # dual solution (m,)
    z: torch.Tensor  # projected constraint values (m,)
    iters: int  # iterations taken
    prim_res: torch.Tensor  # 0-d
    dual_res: torch.Tensor  # 0-d
    solved: bool
    # OSQP-style infeasibility certificates
    prim_infeasible: bool = False
    dual_infeasible: bool = False
    # final adapted rho (0-d); the SCP driver threads it into the next QP
    # as rho0 when SolverConfig.rho_warm_start is on (OSQP keeps rho in its
    # workspace across the reference's update()/solve() loop)
    rho: Optional[torch.Tensor] = None
    # under cfg.polish: whether the polished iterate replaced the ADMM one
    # (it does only if it lowers both residuals)
    polished: bool = False


class Scaling(NamedTuple):
    """Ruiz equilibration scalings: x = D xbar, constraint rows scaled by E,
    cost scaled by c."""

    D: torch.Tensor  # (n,)
    E: torch.Tensor  # (m,)
    c: torch.Tensor  # 0-d


def ruiz_equilibrate(ops, q, l, u, iters: int = 5) -> Scaling:
    """Modified Ruiz equilibration (OSQP sec 5.1), matrix-free: scales rows
    and columns of [[P, A^T], [A, 0]] toward unit infinity norm, then
    normalizes the cost."""
    red = reductions(ops)
    kw = dict(dtype=q.dtype, device=q.device)
    D = torch.ones(q.shape[0], **kw)
    E = torch.ones(l.shape[0], **kw)
    c = torch.ones((), **kw)
    for _ in range(iters):
        colP = c * D * ops.col_inf_norms_P(D)
        colA = ops.col_inf_norms(E) * D
        col = torch.maximum(colP, colA)
        rowA = ops.row_inf_norms(D) * E
        d_new = 1.0 / torch.sqrt(torch.clamp(col, _MIN_SCALING, _MAX_SCALING))
        e_new = 1.0 / torch.sqrt(torch.clamp(rowA, _MIN_SCALING, _MAX_SCALING))
        D = D * d_new
        E = E * e_new
        # cost normalization
        colP_new = c * D * ops.col_inf_norms_P(D)
        gamma_denom = torch.maximum(
            red.mean(colP_new, "x"), red.amax(torch.abs(c * D * q))[0]
        )
        gamma = 1.0 / torch.clamp(gamma_denom, _MIN_SCALING, _MAX_SCALING)
        # bound the accumulated cost scaling (a fully degenerate objective
        # would compound gamma every sweep)
        c = torch.clamp(c * gamma, 1e-6, 1e6)
    return Scaling(D=D, E=E, c=c)


class ScaledOps:
    """Wraps an operator bundle with Ruiz scalings: Abar = E A D,
    Pbar = c D P D, solving in the scaled space."""

    def __init__(self, inner, scaling: Scaling):
        self.inner = inner
        self.s = scaling
        self.reductions = reductions(inner)

    def matvec_P(self, x):
        s = self.s
        return s.c * s.D * self.inner.matvec_P(s.D * x)

    def matvec_A(self, x):
        s = self.s
        return s.E * self.inner.matvec_A(s.D * x)

    def rmatvec_A(self, w):
        s = self.s
        return s.D * self.inner.rmatvec_A(s.E * w)

    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        # c D P D + diag(sigma) + D A^T E R E A D
        #   = D (cP + diag(sigma/D^2) + A^T (R E^2) A) D
        s = self.s
        return self.inner.factorize(
            rho_vec * s.E**2, sigma_vec / s.D**2, cost_scale * s.c
        )

    def kkt_solve(self, factor, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        s = self.s
        x = self.inner.kkt_solve(
            factor, rhs / s.D, rho_vec * s.E**2, sigma_vec / s.D**2,
            cost_scale * s.c,
        )
        return x / s.D


def rho_vector(l, u, rho):
    """Per-row penalty following OSQP's classification: equality rows
    (u - l <= tol) get 1e3*rho, fully-loose rows get RHO_MIN, others rho."""
    rho = torch.as_tensor(rho, dtype=l.dtype, device=l.device)
    eq = (u - l) <= _EQ_TOL
    loose = torch.isinf(-l) & torch.isinf(u)
    rho_vec = torch.where(eq, 1e3 * rho, rho)
    rho_vec = torch.where(loose, torch.full_like(rho_vec, _LOOSE_RHO), rho_vec)
    return torch.clamp(rho_vec, _RHO_MIN, _RHO_MAX)


def certificate_terms(q, l, u, dy, dx, Atdy, Pdx, Adx, red=LOCAL):
    """OSQP infeasibility-certificate conditions (Stellato et al. sec 3.4)
    from the unscaled between-check deltas. Returns two 0-d bool tensors."""
    eps_inf = 1e-4
    inf = torch.tensor(float("inf"), dtype=u.dtype, device=u.device)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    dy_norm, Atdy_norm, dx_norm, Pdx_norm = red.amax(
        torch.abs(dy), torch.abs(Atdy), torch.abs(dx), torch.abs(Pdx))
    sup_u, sup_l = red.sum(
        (torch.where(dy > 0, torch.where(torch.isfinite(u), u, inf) * dy,
                     zero), "w"),
        (torch.where(dy < 0, torch.where(torch.isfinite(l), l, -inf) * dy,
                     zero), "w"),
    )
    sup = sup_u + sup_l
    prim_inf = (
        (dy_norm > 1e-10)
        & (Atdy_norm <= eps_inf * dy_norm)
        & (sup <= eps_inf * dy_norm)
    )

    tol = eps_inf * dx_norm
    cone_ok = red.all(
        torch.where(
            torch.isinf(u),
            torch.isinf(-l) | (Adx >= -tol),
            torch.where(torch.isinf(-l), Adx <= tol, torch.abs(Adx) <= tol),
        )
    )
    dual_inf = (
        (dx_norm > 1e-10)
        & (Pdx_norm <= tol)
        & (red.dots((q, dx, "x"))[0] <= tol)
        & cone_ok
    )
    return prim_inf, dual_inf


def anderson_step(hist, g, f, red=LOCAL):
    """One safeguarded type-II Anderson step (OSQP v1 style; admm.py:391-421
    of the JAX package) on the fixed-point map w -> T(w), w = (x, z, y).

    `hist` = (w_hist, f_hist, cnt): circular buffers of the last `depth`
    pairs (T(w), F = T(w) - w) and the number of pairs pushed so far (a host
    int). Pushes (g, f) = (T(w), T(w) - w), solves the Tikhonov-regularized
    least-squares min ||sum_i a_i F_i|| s.t. sum_i a_i = 1 over the valid
    pairs (invalid rows and columns of the Gram matrix set to the identity,
    so their coefficients solve to 0) and returns the new history and
    sum_i a_i T(w_i) if its predicted residual does not exceed the plain
    step's and it is finite, else g."""
    w_hist, f_hist, cnt = hist
    depth = w_hist.shape[0]
    dtype, device = g.dtype, g.device
    slot = cnt % depth
    w_hist[slot] = g
    f_hist[slot] = f
    cnt += 1
    valid = torch.arange(depth, device=device) < min(cnt, depth)
    Fm = torch.where(valid[:, None], f_hist, 0.0)
    gram = red.gram(Fm, "xww")
    scale = torch.trace(gram) / max(min(cnt, depth), 1) + 1e-30
    eye = torch.eye(depth, dtype=dtype, device=device)
    gram = gram + _AA_LAM * scale * eye
    gram = torch.where(torch.outer(valid, valid), gram, eye)
    beta = torch.linalg.solve(gram, valid.to(dtype))
    a = beta / (torch.sum(beta) + 1e-30)
    a = torch.where(valid, a, 0.0)
    w_acc = a @ w_hist
    r_acc = a @ Fm
    rr, ff = red.sum((r_acc * r_acc, "xww"), (f * f, "xww"))
    ok = red.all(torch.isfinite(w_acc)) & (rr <= ff)
    return (w_hist, f_hist, cnt), torch.where(ok, w_acc, g)


def admm_solve(
    ops,
    q,
    l,
    u,
    cfg: SolverConfig,
    x0=None,
    y0=None,
    scaling: Optional[Scaling] = None,
    rho0=None,
    eps_scale=None,
) -> QPSolution:
    """Run ADMM to the OSQP termination criterion.

    With `scaling` the iteration runs in the equilibrated space while
    termination uses unscaled residuals; x0/y0 and the returned solution are
    always unscaled. `eps_scale` multiplies both termination thresholds (the
    inexact-SCP hook, SolverConfig.eps_sched_iters).

    Loop structure (admm.py:519-588): an outer loop refactorizes at each rho
    epoch and an inner loop iterates at fixed (rho, factor); every
    `interval` iterations a termination check computes residuals,
    certificates, the next interval and the adaptive-rho request.

    With cfg.anderson_depth > 0 each iteration of the inner loop is followed
    by a safeguarded Anderson step (`anderson_step`); its history restarts
    at every termination check, hence at every rho epoch too."""
    red = reductions(ops)
    dtype, device = q.dtype, q.device
    kw = dict(dtype=dtype, device=device)
    n = q.shape[0]
    m = l.shape[0]

    if scaling is None:
        scaling = Scaling(
            D=torch.ones(n, **kw), E=torch.ones(m, **kw), c=torch.ones((), **kw)
        )
        sops = ops
    else:
        sops = ScaledOps(ops, scaling)
    D, E, c = scaling.D, scaling.E, scaling.c

    qs = c * D * q
    ls = E * l
    us = E * u
    x = torch.zeros(n, **kw) if x0 is None else x0.to(dtype) / D
    y = torch.zeros(m, **kw) if y0 is None else y0.to(dtype) * c / E
    z = torch.clamp(sops.matvec_A(x), ls, us)

    sigma_vec = torch.full((n,), cfg.sigma, **kw)
    alpha = torch.tensor(cfg.alpha_relax, **kw)
    rho = torch.clamp(
        torch.as_tensor(cfg.rho if rho0 is None else rho0, **kw),
        _RHO_MIN, _RHO_MAX,
    )
    ruf = float(cfg.rho_update_factor)
    q_norm_unscaled = red.amax(torch.abs(q))[0]
    eps_s = torch.as_tensor(1.0 if eps_scale is None else eps_scale, **kw)

    # Periodic KKT refinement (cfg.kkt_refine_period > 1): the refined solve
    # runs only on every P-th iteration, the unrefined one otherwise
    period = int(cfg.kkt_refine_period)
    two_path = (
        period > 1
        and cfg.kkt_refine_iters > 0
        and hasattr(ops, "kkt_refine_iters")
    )
    if two_path:
        inner0 = copy.copy(ops)
        inner0.kkt_refine_iters = 0
        sops0 = inner0 if sops is ops else ScaledOps(inner0, scaling)

    def one_iter(x, z, y, rv, factor, it):
        rhs = sigma_vec * x - qs + sops.rmatvec_A(rv * z - y)
        solver = sops0 if two_path and it % period != 0 else sops
        xt = solver.kkt_solve(factor, rhs, rv, sigma_vec)
        zt = sops.matvec_A(xt)
        x_next = alpha * xt + (1 - alpha) * x
        z_relax = alpha * zt + (1 - alpha) * z
        z_next = torch.clamp(z_relax + y / rv, ls, us)
        y_next = y + rv * (z_relax - z_next)
        return x_next, z_next, y_next

    def residuals(x, z, y):
        """Unscaled residuals + eps thresholds + scaled ratio for rho."""
        Ax_s = sops.matvec_A(x)
        Px_s = sops.matvec_P(x)
        Aty_s = sops.rmatvec_A(y)
        Ax = Ax_s / E
        zu = z / E
        Px = Px_s / (c * D)
        Aty = Aty_s / (c * D)
        (prim, dual, n_Ax, n_zu, n_Px, n_Aty, prim_s, dual_s, n_Ax_s, n_z,
         n_Px_s, n_Aty_s, n_qs) = red.amax(*(torch.abs(v) for v in (
             Ax - zu, Px + q + Aty, Ax, zu, Px, Aty, Ax_s - z,
             Px_s + qs + Aty_s, Ax_s, z, Px_s, Aty_s, qs)))
        eps_prim = eps_s * (cfg.eps_abs + cfg.eps_rel * torch.maximum(
            n_Ax, n_zu))
        eps_dual = eps_s * (cfg.eps_abs + cfg.eps_rel * torch.maximum(
            torch.maximum(n_Px, n_Aty), q_norm_unscaled))
        # adaptive-rho ratio uses scaled residuals (OSQP sec 5.2)
        denom_p = torch.maximum(n_Ax_s, n_z) + 1e-30
        denom_d = torch.maximum(torch.maximum(n_Px_s, n_Aty_s), n_qs) + 1e-30
        ratio = (prim_s / denom_p) / (dual_s / denom_d + 1e-30)
        return prim, dual, eps_prim, eps_dual, ratio

    # iteration state; the scalars the loop conditions need live on the host
    it = 0
    interval = int(cfg.check_every)
    done = prim_inf = dual_inf = False
    prim_res = torch.tensor(float("inf"), **kw)
    dual_res = torch.tensor(float("inf"), **kw)

    def check(x_new, z_new, y_new, x_old, y_old, interval):
        """One termination check after `interval` iterations. Returns the
        device residuals, rho request and the host flags."""
        prim, dual, eps_prim, eps_dual, ratio = residuals(x_new, z_new, y_new)
        solved = (prim <= eps_prim) & (dual <= eps_dual)
        dy = (y_new - y_old) * E / c  # unscaled dual delta
        dx = (x_new - x_old) * D  # unscaled primal delta
        p_inf, d_inf = certificate_terms(
            q, l, u, dy, dx, ops.rmatvec_A(dy), ops.matvec_P(dx),
            ops.matvec_A(dx), red,
        )
        far = (prim > 100.0 * eps_prim) | (dual > 100.0 * eps_dual)
        if cfg.adaptive_rho:
            rho_new = torch.clamp(rho * torch.sqrt(ratio), _RHO_MIN, _RHO_MAX)
            refactor = ((rho_new > ruf * rho) | (rho_new < rho / ruf)) & ~solved
        else:
            rho_new = rho
            refactor = torch.zeros((), dtype=torch.bool, device=device)
        flags = torch.stack([solved, p_inf, d_inf, far, refactor]).tolist()
        return prim, dual, rho_new, flags

    depth = int(cfg.anderson_depth)
    factor = sops.factorize(rho_vector(ls, us, rho), sigma_vec)
    epoch = int(cfg.rho_epoch_every) if cfg.adaptive_rho else 0
    epoch_end = min(it + epoch, cfg.max_iter) if epoch > 0 else None
    refactor = False
    rho_next = rho
    while not done and it < cfg.max_iter:
        rv = rho_vector(ls, us, rho)  # fixed within one rho epoch
        # inner fixed-rho loop
        while not done and (
            it < epoch_end if epoch > 0 else (not refactor and it < cfg.max_iter)
        ):
            x_old, y_old = x, y
            if depth > 0:
                # the history restarts at every termination check
                hist = (torch.zeros(depth, n + 2 * m, **kw),
                        torch.zeros(depth, n + 2 * m, **kw), 0)
            for j in range(interval):
                xp, zp, yp = one_iter(x, z, y, rv, factor, it + j)
                if depth == 0:
                    x, z, y = xp, zp, yp
                    continue
                g = torch.cat([xp, zp, yp])
                hist, w_new = anderson_step(
                    hist, g, g - torch.cat([x, z, y]), red)
                x, z, y = w_new[:n], w_new[n:n + m], w_new[n + m:]
            prim_res, dual_res, rho_c, (solved, prim_inf, dual_inf, far,
                                        refactor) = check(
                x, z, y, x_old, y_old, interval
            )
            if refactor:
                rho_next = rho_c
            if cfg.check_backoff_max > 1 and far:
                iv = min(2 * interval, cfg.check_backoff_max * cfg.check_every)
            else:
                iv = cfg.check_every
            it += interval
            # never overshoot the iteration cap by more than the final check
            interval = max(min(iv, cfg.max_iter - it), 1)
            done = solved or prim_inf or dual_inf
        if not cfg.adaptive_rho:
            break
        # rho epoch boundary: adopt the requested rho and refactorize
        if refactor:
            rho = rho_next
        refactor = False
        if epoch > 0:
            epoch_end = min(it + epoch, cfg.max_iter)
        if not done and it < cfg.max_iter:
            factor = sops.factorize(rho_vector(ls, us, rho), sigma_vec)

    # unscale
    x_u = D * x
    y_u = E * y / c
    z_u = z / E
    polished = False
    if cfg.polish:
        x_u, y_u, z_u, polished = _polish(ops, q, l, u, x_u, y_u, z_u, cfg)

    return QPSolution(
        x=x_u,
        y=y_u,
        z=z_u,
        iters=it,
        prim_res=prim_res,
        dual_res=dual_res,
        solved=bool(done and not (prim_inf or dual_inf)),
        prim_infeasible=bool(prim_inf),
        dual_infeasible=bool(dual_inf),
        rho=rho,
        polished=polished,
    )


def _polish(ops, q, l, u, x, y, z, cfg, eq_mask=None, active_masks=None):
    """Static-shape analog of OSQP polishing (admm.py:612-729): solve the
    KKT system with the active rows treated as stiff equalities (penalty
    factor as preconditioner + exact-residual refinement), then an
    active-set correction pass; accepted only if both residuals improve.

    `active_masks` = (lower, upper) is a caller-supplied active set (the
    IPM's lambda > s test: its duals are strictly interior, so the dual
    sign over-selects); else the active set is the dual sign with a
    relative dtype-aware threshold. Rows of `eq_mask` are always active and
    never dropped. Returns x, y, z and whether the polished iterate was
    accepted."""
    red = reductions(ops)
    dtype = q.dtype
    n = q.shape[0]
    kw = dict(dtype=dtype, device=q.device)
    f32 = torch.finfo(dtype).bits <= 32
    w_big = torch.tensor(1e4 if f32 else 1e7, **kw)
    sigma_p = torch.full((n,), 1e-7 if f32 else 1e-9, **kw)
    zero = torch.zeros((), **kw)
    eps = torch.finfo(dtype).eps
    if active_masks is not None:
        lower_active, upper_active = active_masks
    else:
        y_tol = eps**0.75 * torch.clamp(red.amax(torch.abs(y))[0], min=1.0)
        lower_active = y < -y_tol
        upper_active = y > y_tol
    if eq_mask is not None:
        # equality rows: l == u, so which bound they take is immaterial
        lower_active = lower_active | eq_mask
    eq_like = lower_active & upper_active

    def solve_with(low, up):
        active = low | up
        b = torch.where(low, l, torch.where(up, u, zero))
        b = torch.where(torch.isfinite(b), b, zero)
        w = torch.where(active, w_big, zero)
        factor = ops.factorize(w, sigma_p, 1.0)
        rhs = -q + ops.rmatvec_A(w * b)
        x_pol = ops.kkt_solve(factor, rhs, w, sigma_p, 1.0)
        y_pol = torch.where(active, w * (ops.matvec_A(x_pol) - b), zero)
        for _ in range(cfg.polish_refine_iters):
            r_x = -q - ops.matvec_P(x_pol) - ops.rmatvec_A(y_pol)
            r_b = torch.where(active, b - ops.matvec_A(x_pol), zero)
            dx = ops.kkt_solve(
                factor, r_x + ops.rmatvec_A(w * r_b), w, sigma_p, 1.0
            )
            dy = torch.where(active, w * (ops.matvec_A(dx) - r_b), zero)
            x_pol, y_pol = x_pol + dx, y_pol + dy
        return x_pol, y_pol

    x_pol, y_pol = solve_with(lower_active, upper_active)

    # Active-set correction: drop rows whose multiplier took the wrong sign
    # and re-solve once; equality rows are never dropped
    s_tol = eps**0.5 * torch.clamp(red.amax(torch.abs(y_pol))[0], min=1.0)
    droppable = ~eq_like if eq_mask is None else ~(eq_like | eq_mask)
    wrong = droppable & (
        (lower_active & ~upper_active & (y_pol > s_tol))
        | (upper_active & ~lower_active & (y_pol < -s_tol))
    )
    if bool(red.any(wrong)):
        x_pol, y_pol = solve_with(lower_active & ~wrong, upper_active & ~wrong)

    z_pol = torch.clamp(ops.matvec_A(x_pol), l, u)

    def resid(xx, yy, zz):
        return red.amax(torch.abs(ops.matvec_A(xx) - zz),
                        torch.abs(ops.matvec_P(xx) + q + ops.rmatvec_A(yy)))

    p0, d0 = resid(x, y, z)
    p1, d1 = resid(x_pol, y_pol, z_pol)
    better = (p1 <= torch.clamp(p0, min=1e-10)) & (d1 <= torch.clamp(d0, min=1e-10))
    pick = lambda a, bb: torch.where(better, a, bb)  # noqa: E731
    return pick(x_pol, x), pick(y_pol, y), pick(z_pol, z), bool(better)


class DenseQPOps:
    """Dense instantiation (admm.py:731-782): P (n, n) and A (m, n)
    materialized; the KKT system cP + diag(sigma) + A^T R A is solved by
    Cholesky with `kkt_refine_iters` iterative-refinement passes. A factor
    that fails is all NaN, as jnp.linalg.cholesky returns it."""

    def __init__(self, P, A, kkt_refine_iters: int = 1):
        self.P = P
        self.A = A
        self.kkt_refine_iters = kkt_refine_iters

    def matvec_P(self, x):
        return self.P @ x

    def matvec_A(self, x):
        return self.A @ x

    def rmatvec_A(self, w):
        return self.A.T @ w

    def row_inf_norms(self, D):
        return torch.amax(torch.abs(self.A) * D[None, :], dim=1)

    def col_inf_norms(self, E):
        return torch.amax(E[:, None] * torch.abs(self.A), dim=0)

    def col_inf_norms_P(self, D):
        return torch.amax(D[:, None] * torch.abs(self.P), dim=0)

    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        K = (cost_scale * self.P + torch.diag(sigma_vec)
             + self.A.T @ (rho_vec[:, None] * self.A))
        chol, info = torch.linalg.cholesky_ex(K)
        return torch.where(info == 0, chol, torch.full_like(chol, float("nan")))

    def kkt_solve(self, chol, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        def solve(r):
            t = torch.linalg.solve_triangular(chol, r[:, None], upper=False)
            return torch.linalg.solve_triangular(chol.T, t, upper=True)[:, 0]

        x = solve(rhs)
        for _ in range(self.kkt_refine_iters):
            r = rhs - (cost_scale * (self.P @ x) + sigma_vec * x
                       + self.A.T @ (rho_vec * (self.A @ x)))
            x = x + solve(r)
        return x


def solve_dense_qp(P, q, A, l, u, cfg: SolverConfig = SolverConfig(), x0=None,
                   y0=None, scale: bool = True,
                   ruiz_iters: int = 5) -> QPSolution:
    """One-call dense QP solve (OSQP setup + solve; admm.py:785-800)."""
    ops = DenseQPOps(P, A, kkt_refine_iters=cfg.kkt_refine_iters)
    scaling = ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters) if scale else None
    return admm_solve(ops, q, l, u, cfg, x0=x0, y0=y0, scaling=scaling)
