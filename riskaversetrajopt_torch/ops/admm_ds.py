"""Double-single (compensated float32) ADMM for the structured SAA QP.

The counterpart of ``riskaversetrajopt_tpu/ops/admm_ds.py`` (its module
docstring gives the reasoning: float32 iterates inject ~6e-8 noise per
iteration and land on other points of a degenerate optimal face than the
float64 path; carrying the iterates as ds pairs tracks the float64 one). It
runs the OSQP-semantics iteration of ops/admm.py with:

- the iterate triple (x, z, y) as ds pairs (ops/dsjit.py);
- both Jacobian sweeps of an iteration compensated end to end
  (qp_refine._ds_matvec_A / _ds_rmatvec_A, the Ruiz scalings applied as
  exact ds rescalings);
- the float32 Schur factorization of ops/saa_qp.py as a preconditioner,
  refined against the compensated true residual (`ds_kkt_passes` rounds);
- the relaxation constant alpha and 1 - alpha as ds pairs of their float64
  values; relax, clip and dual updates elementwise in ds;
- the termination residuals (unscaled) and the adaptive-rho ratio in ds.

Everything runs in q's dtype (float32 is the intended one). The loops are
Python loops with one host read per termination check, as in ops/admm.py.
Like dsjit, this module runs eagerly and must not go under torch.compile.
Sample-sharded (`shard`), the compensated sweeps add the processes'
partial sums in double-single (SampleShard.ds_sum) and the residuals'
maxima are global, so every process takes the same decisions.
"""

from __future__ import annotations

import torch

from riskaversetrajopt_torch.core.config import SolverConfig
from riskaversetrajopt_torch.ops import admm
from riskaversetrajopt_torch.ops import dsjit as ds
from riskaversetrajopt_torch.ops.qp_refine import _ds_matvec_A, _ds_rmatvec_A
from riskaversetrajopt_torch.ops.saa_qp import (
    SAAQPOps,
    SAAQPStatic,
    build_bounds,
    build_objective,
)

_RHO_MIN = 1e-6
_RHO_MAX = 1e6


def _ds_const(v, like):
    """ds pair of the float64 value of a config constant, in like's dtype
    and device (the map constants then match the float64 map to ~1e-16)."""
    kw = dict(dtype=like.dtype, device=like.device)
    h = torch.tensor(float(v), **kw)
    return h, torch.tensor(float(v) - float(h), **kw)


class _DSScaledOps:
    """Compensated scaled-space operator views: Abar = E A D, Pbar = c D P D.
    Every method takes and returns ds pairs; D, E, c are the exact Ruiz
    scalings."""

    def __init__(self, ops: SAAQPOps, scaling: admm.Scaling):
        self.ops = ops
        self.s = scaling

    def matvec_A(self, xh, xl):
        s = self.s
        th, tl = ds.ds_scale(xh, xl, s.D)
        rh, rl = _ds_matvec_A(self.ops, th, tl)
        return ds.ds_scale(rh, rl, s.E)

    def rmatvec_A(self, wh, wl):
        s = self.s
        th, tl = ds.ds_scale(wh, wl, s.E)
        rh, rl = _ds_rmatvec_A(self.ops, th, tl)
        return ds.ds_scale(rh, rl, s.D)

    def matvec_P(self, xh, xl):
        # c * D * p_diag * D * x, chained so that every factor stays exact
        s = self.s
        th, tl = ds.ds_scale(xh, xl, s.D)
        th, tl = ds.ds_scale(th, tl, self.ops.p_diag)
        th, tl = ds.ds_scale(th, tl, s.D)
        return ds.ds_scale(th, tl, s.c)


def _ds_bounds(b, scale):
    """ds pair of scale * b with the +/-inf rows passed through exactly."""
    fin = torch.isfinite(b)
    h, lo = ds.two_prod(torch.where(fin, b, torch.zeros_like(b)), scale)
    return torch.where(fin, h, b), torch.where(fin, lo, torch.zeros_like(b))


def _ds_clip(ah, al, lh, ll, uh, ul):
    """clip((ah, al), (lh, ll), (uh, ul)) with a lexicographic ds compare
    (the pairs are normalized, so hi-then-lo decides the true order)."""
    below = (ah < lh) | ((ah == lh) & (al < ll))
    above = (ah > uh) | ((ah == uh) & (al > ul))
    h = torch.where(below, lh, torch.where(above, uh, ah))
    lo = torch.where(below, ll, torch.where(above, ul, al))
    return h, lo


def solve_saa_qp_ds(
    st: SAAQPStatic,
    data,
    scp_iter: int,
    cfg: SolverConfig,
    x0=None,
    y0=None,
    rho0=None,
    ruiz_iters: int = 5,
    ds_kkt_passes: int = 1,
    shard=None,
) -> admm.QPSolution:
    """OSQP-semantics ADMM with double-single iterates (admm_ds.py:151-385).
    The infeasibility flags are always False, as in the JAX package. Under
    `shard`, this process's share of a sample-sharded QP
    (ops/saa_qp.solve_saa_qp)."""
    ops = SAAQPOps(
        st, data, scp_iter,
        kkt_refine_iters=max(1, cfg.kkt_refine_iters),
        kkt_refine_mode="factored",
        sweep_precision="highest",
        kkt_chol_inverse=cfg.kkt_chol_inverse,
        shard=shard,
    )
    red = admm.reductions(ops)
    _, q = build_objective(st, data)
    l, u = build_bounds(st, data, scp_iter, shard)
    dtype, device = q.dtype, q.device
    kw = dict(dtype=dtype, device=device)
    n = q.shape[0]
    m = l.shape[0]

    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters)
    D, E, c = scaling.D, scaling.E, scaling.c
    sops = admm.ScaledOps(ops, scaling)  # the float32 KKT preconditioner
    dops = _DSScaledOps(ops, scaling)

    # the scaled data as exact ds rescalings of the problem data
    qs_h, qs_l = ds.two_prod(q, D)
    qs_h, qs_l = ds.ds_scale(qs_h, qs_l, c)
    ls_h, ls_l = _ds_bounds(l, E)
    us_h, us_l = _ds_bounds(u, E)
    ls_f, us_f = ls_h, us_h  # rounded bounds for the rho-row classes

    sigma_vec = torch.full((n,), cfg.sigma, **kw)
    a_h, a_l = _ds_const(cfg.alpha_relax, q)
    oma_h, oma_l = _ds_const(1.0 - float(cfg.alpha_relax), q)
    rho = torch.clamp(
        torch.as_tensor(cfg.rho if rho0 is None else rho0, **kw),
        _RHO_MIN, _RHO_MAX)
    ruf = float(cfg.rho_update_factor)
    q_norm_unscaled = red.amax(torch.abs(q))[0]

    # scaled warm start: x = x0 / D, y = y0 * c / E (ds divisions, products)
    if x0 is None:
        xh, xl = torch.zeros(n, **kw), torch.zeros(n, **kw)
    else:
        xh, xl = ds.ds_div(x0.to(dtype), torch.zeros(n, **kw), D)
    if y0 is None:
        yh, yl = torch.zeros(m, **kw), torch.zeros(m, **kw)
    else:
        yh, yl = ds.two_prod(y0.to(dtype), c)
        yh, yl = ds.ds_div(yh, yl, E)
    zh, zl = _ds_clip(*dops.matvec_A(xh, xl), ls_h, ls_l, us_h, us_l)

    def kkt_solve_ds(factor, rv, rh, rl):
        """The float32 factor solve plus `ds_kkt_passes` rounds against the
        compensated true residual of K = Pbar + diag(sigma) + Abar^T R Abar."""
        xt_h = sops.kkt_solve(factor, rh + rl, rv, sigma_vec)
        xt = (xt_h, torch.zeros_like(xt_h))
        for _ in range(ds_kkt_passes):
            ph, pl = dops.matvec_P(*xt)
            ah, al = dops.matvec_A(*xt)
            ah, al = ds.ds_scale(ah, al, rv)
            bh, bl = dops.rmatvec_A(ah, al)
            th, tl = ds.ds_add(ph, pl, bh, bl)
            sh, sl = ds.ds_scale(xt[0], xt[1], sigma_vec)
            th, tl = ds.ds_add(th, tl, sh, sl)
            res_h, res_l = ds.ds_add(rh, rl, -th, -tl)
            dx = sops.kkt_solve(factor, res_h + res_l, rv, sigma_vec)
            xt = ds.ds_add(xt[0], xt[1], dx, torch.zeros_like(dx))
        return xt

    def one_iter(xh, xl, zh, zl, yh, yl, rv, factor):
        # rhs = sigma x - qs + Abar^T (rv z - y)
        wh, wl = ds.ds_scale(zh, zl, rv)
        wh, wl = ds.ds_add(wh, wl, -yh, -yl)
        rh, rl = dops.rmatvec_A(wh, wl)
        sh, sl = ds.ds_scale(xh, xl, sigma_vec)
        rh, rl = ds.ds_add(rh, rl, sh, sl)
        rh, rl = ds.ds_add(rh, rl, -qs_h, -qs_l)
        xt_h, xt_l = kkt_solve_ds(factor, rv, rh, rl)
        zt_h, zt_l = dops.matvec_A(xt_h, xt_l)
        # x_next = alpha xt + (1 - alpha) x
        ax_h, ax_l = ds.ds_mul(xt_h, xt_l, a_h, a_l)
        ox_h, ox_l = ds.ds_mul(xh, xl, oma_h, oma_l)
        xn_h, xn_l = ds.ds_add(ax_h, ax_l, ox_h, ox_l)
        # z_relax = alpha zt + (1 - alpha) z
        az_h, az_l = ds.ds_mul(zt_h, zt_l, a_h, a_l)
        oz_h, oz_l = ds.ds_mul(zh, zl, oma_h, oma_l)
        zr_h, zr_l = ds.ds_add(az_h, az_l, oz_h, oz_l)
        # z_next = clip(z_relax + y / rv, ls, us)
        yr_h, yr_l = ds.ds_div(yh, yl, rv)
        arg_h, arg_l = ds.ds_add(zr_h, zr_l, yr_h, yr_l)
        zn_h, zn_l = _ds_clip(arg_h, arg_l, ls_h, ls_l, us_h, us_l)
        # y_next = y + rv (z_relax - z_next)
        dh, dl = ds.ds_add(zr_h, zr_l, -zn_h, -zn_l)
        dh, dl = ds.ds_scale(dh, dl, rv)
        yn_h, yn_l = ds.ds_add(yh, yl, dh, dl)
        return xn_h, xn_l, zn_h, zn_l, yn_h, yn_l

    def residuals(xh, xl, zh, zl, yh, yl):
        """Unscaled OSQP residuals, their thresholds and the scaled rho
        ratio, all evaluated in ds (ops/admm.py's residuals)."""
        Axs = dops.matvec_A(xh, xl)
        Pxs = dops.matvec_P(xh, xl)
        Atys = dops.rmatvec_A(yh, yl)
        Ax = ds.ds_div(*Axs, E)
        zu = ds.ds_div(zh, zl, E)
        Px = ds.ds_div(*ds.ds_div(*Pxs, D), c)
        Aty = ds.ds_div(*ds.ds_div(*Atys, D), c)
        dh, dl = ds.ds_add(*Px, *Aty)
        dh, dl = ds.ds_add(dh, dl, q, torch.zeros_like(q))
        sd_h, sd_l = ds.ds_add(Pxs[0], Pxs[1], qs_h, qs_l)
        sd_h, sd_l = ds.ds_add(sd_h, sd_l, Atys[0], Atys[1])
        # every maximum in one global reduction; the adaptive-rho ratio on
        # the scaled residuals (OSQP sec 5.2)
        (prim, dual, n_Ax, n_zu, n_Px, n_Aty, prim_s, dual_s, n_Axs, n_zh,
         n_Pxs, n_Atys, n_qs) = red.amax(*(torch.abs(v) for v in (
             ds.ds_round(*ds.ds_add(*Ax, -zu[0], -zu[1])), ds.ds_round(dh, dl),
             ds.ds_round(*Ax), ds.ds_round(*zu), ds.ds_round(*Px),
             ds.ds_round(*Aty),
             ds.ds_round(*ds.ds_add(Axs[0], Axs[1], -zh, -zl)),
             ds.ds_round(sd_h, sd_l), Axs[0], zh, Pxs[0], Atys[0], qs_h)))
        eps_prim = cfg.eps_abs + cfg.eps_rel * torch.maximum(n_Ax, n_zu)
        eps_dual = cfg.eps_abs + cfg.eps_rel * torch.maximum(
            torch.maximum(n_Px, n_Aty), q_norm_unscaled)
        denom_p = torch.maximum(n_Axs, n_zh) + 1e-30
        denom_d = torch.maximum(torch.maximum(n_Pxs, n_Atys), n_qs) + 1e-30
        ratio = (prim_s / denom_p) / (dual_s / denom_d + 1e-30)
        return prim, dual, eps_prim, eps_dual, ratio

    check = int(cfg.check_every)
    it = 0
    done = refactor = False
    prim_res = torch.tensor(float("inf"), **kw)
    dual_res = torch.tensor(float("inf"), **kw)
    rho_next = rho
    factor = sops.factorize(admm.rho_vector(ls_f, us_f, rho), sigma_vec)
    # two-level loop as in ops/admm.admm_solve: an outer loop per rho epoch
    # (refactorize), an inner loop of `check` iterations per termination
    # check at fixed rho; without adaptive rho, the inner loop alone
    while not done and it < cfg.max_iter:
        rv = admm.rho_vector(ls_f, us_f, rho)
        while not done and not refactor and it < cfg.max_iter:
            state = (xh, xl, zh, zl, yh, yl)
            for _ in range(check):
                state = one_iter(*state, rv, factor)
            xh, xl, zh, zl, yh, yl = state
            prim_res, dual_res, eps_prim, eps_dual, ratio = residuals(*state)
            solved = (prim_res <= eps_prim) & (dual_res <= eps_dual)
            if cfg.adaptive_rho:
                rho_new = torch.clamp(rho * torch.sqrt(ratio), _RHO_MIN,
                                      _RHO_MAX)
                want = (((rho_new > ruf * rho) | (rho_new < rho / ruf))
                        & ~solved)
            else:
                rho_new = rho
                want = torch.zeros((), dtype=torch.bool, device=device)
            done, refactor = torch.stack([solved, want]).tolist()
            rho_next = rho_new
            it += check
        if not cfg.adaptive_rho:
            break
        if refactor:
            rho = rho_next
        refactor = False
        if not done and it < cfg.max_iter:
            factor = sops.factorize(admm.rho_vector(ls_f, us_f, rho),
                                    sigma_vec)

    # unscale (ds) and round
    xu = ds.ds_round(*ds.ds_scale(xh, xl, D))
    yu_h, yu_l = ds.ds_scale(yh, yl, E)
    yu = ds.ds_round(*ds.ds_div(yu_h, yu_l, c))
    zu = ds.ds_round(*ds.ds_div(zh, zl, E))
    return admm.QPSolution(
        x=xu, y=yu, z=zu, iters=it, prim_res=prim_res, dual_res=dual_res,
        solved=bool(done), prim_infeasible=False, dual_infeasible=False,
        rho=rho,
    )
