"""Iterative refinement of QP solutions: KKT residuals of 1e-6..1e-9 from
float32 arithmetic.

The counterpart of ``riskaversetrajopt_tpu/ops/qp_refine.py`` (its module
docstring gives the reasoning). Plain float32 ADMM stalls near unscaled
residuals of ~1e-5; this module closes the gap with QP-level iterative
refinement (Gleixner et al.):

1. a base solve with the ordinary ADMM;
2. the exact residual data at the incumbent (x0, y0) in compensated
   double-single arithmetic (ops/dsjit.py):
       r_d = P x0 + q + A^T y0,   r_l = l - A x0,   r_u = u - A x0;
3. a CORRECTION QP with the same operator and Ruiz scaling,
       min 1/2 dx (P + prox I) dx + (Delta r_d)^T dx
       s.t. Delta r_l <= A dx <= Delta r_u,
   with Delta an exact power of two that makes the data O(1);
4. x <- x0 + dx/Delta (double-single), y <- y0 + w/Delta, and again,
   each round skipped once the compensated unscaled residuals certify.

Like dsjit, this module runs eagerly and must not go under torch.compile.

On a sample-sharded operator (SAAQPOps(shard=...)) the compensated sums over
the sample axis stay compensated across processes (SampleShard.ds_sum) and
the residuals' maxima are global (the operator's `reductions`), so every
process certifies, and refines, in step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from riskaversetrajopt_torch.core.config import SolverConfig
from riskaversetrajopt_torch.ops import admm
from riskaversetrajopt_torch.ops import dsjit as ds
from riskaversetrajopt_torch.ops.saa_qp import (
    SAAQPOps,
    SAAQPStatic,
    build_bounds,
    build_objective,
    make_ops,
)


class IRConfig(NamedTuple):
    """Refinement knobs (qp_refine.py:65-100). `rounds` correction solves
    run after the base solve; each is skipped once the certified residuals
    meet the target (SolverConfig.eps_abs/eps_rel)."""

    rounds: int = 4
    #: tolerance of the correction ADMM solves
    work_eps: float = 3e-4
    #: base-solve tolerances and iteration cap; None = work_eps / max_iter.
    #: Set to the target, they keep the base on the warm-started ADMM path
    #: that follows the reference's solution branch
    base_eps_abs: Optional[float] = None
    base_eps_rel: Optional[float] = None
    base_max_iter: Optional[int] = None
    #: residual -> Delta headroom: Delta ~= 2^round(log2(margin / res))
    margin: float = 0.1
    delta_max: float = 1e10
    #: proximal weight of the correction QP's objective: on degenerate
    #: optimal faces it makes the correction the projection of the
    #: incumbent onto the face, instead of a wander along it
    prox: float = 1e-3


def _ds_chunk(M):
    """Sample-axis chunk of the compensated G contractions (a working-set
    bound of the JAX package's TPU fusions, qp_refine.py:103-114); the
    contractions reduce over the minor axis, so it changes no number."""
    return 128 if M > 256 else None


def _scalar(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _ds_matvec_A(ops: SAAQPOps, x_h, x_l):
    """Compensated matvec_A of a ds vector; mirrors SAAQPOps.matvec_A
    (row order [final | cvar | y | sample | slack | control]; under a
    shard, this process's y and sample rows)."""
    st, sc = ops.st, ops.scales
    n, M = st.n, ops.Ml
    u_h, y_h = x_h[:n], x_h[n:n + M]
    u_l, y_l = x_l[:n], x_l[n:n + M]
    s_h, s_l = x_h[n + M], x_l[n + M]
    t_h, t_l = x_h[n + M + 1], x_l[n + M + 1]

    # final rows: F @ u
    ph, pe = ds.two_prod(ops.data.F, u_h[None, :])
    pe = pe + ops.data.F * u_l[None, :]
    rf_h, rf_l = ds.ds_sum(ph, pe, axis=1)

    # CVaR row: c * (sum(y) + s + M*alpha*t), M the global sample count
    ((sy_h, sy_l),) = ops._sum_ds(ds.ds_sum(y_h, y_l, axis=0))
    ma_h, ma_l = ds.two_prod(_scalar(float(st.M), x_h), ops.data.alpha)
    mat_h, mat_l = ds.ds_mul(ma_h, ma_l, t_h, t_l)
    rc_h, rc_l = ds.ds_add(sy_h, sy_l, s_h, s_l)
    rc_h, rc_l = ds.ds_add(rc_h, rc_l, mat_h, mat_l)
    rc_h, rc_l = ds.ds_scale(rc_h, rc_l, sc.c)

    # y rows: sc.y * (-y - s)
    ry_h, ry_l = ds.ds_add(-y_h, -y_l, -s_h, -s_l)
    ry_h, ry_l = ds.ds_scale(ry_h, ry_l, sc.y)

    # sample rows: (g*m) * (G u - gy*(y + t))
    gu_h, gu_l = ds.contract_mkn_n(ops.data.G, u_h, u_l, chunk=_ds_chunk(M))
    yt_h, yt_l = ds.ds_add(y_h[:, None], y_l[:, None], t_h.expand(M, 1),
                           t_l.expand(M, 1))
    yt_h, yt_l = ds.ds_scale(yt_h, yt_l, sc.gy)
    rg_h, rg_l = ds.ds_add(gu_h, gu_l, -yt_h, -yt_l)
    gm_h, gm_l = ds.two_prod(sc.g, ops.m)
    rg_h, rg_l = ds.ds_mul(rg_h, rg_l, gm_h.expand(rg_h.shape),
                           gm_l.expand(rg_h.shape))

    rs_h, rs_l = ds.ds_scale(-s_h, -s_l, sc.s)

    h = torch.cat([rf_h, rc_h[None], ry_h, rg_h.reshape(-1), rs_h[None], u_h])
    lo = torch.cat([rf_l, rc_l[None], ry_l, rg_l.reshape(-1), rs_l[None], u_l])
    return h, lo


def _ds_rmatvec_A(ops: SAAQPOps, w, w_lo=None):
    """Compensated rmatvec_A of a dual vector w; `w_lo` makes (w, w_lo) a
    double-single input, else w is exact as given."""
    st, sc = ops.st, ops.scales
    M = ops.Ml
    w_f, w_c, w_y, w_G, w_s, w_u = ops._split_w(w)
    if w_lo is None:
        w_lo = torch.zeros_like(w)
    wl_f, wl_c, wl_y, wl_G, wl_s, wl_u = ops._split_w(w_lo)

    gm_h, gm_l = ds.two_prod(sc.g, ops.m)
    wg_h, wg_l = ds.ds_mul(gm_h.expand(w_G.shape), gm_l.expand(w_G.shape),
                           w_G, wl_G)

    # u part: F^T w_f + einsum(G, wG) + w_u
    ph, pe = ds.two_prod(ops.data.F, w_f[:, None])
    pe = pe + ops.data.F * wl_f[:, None]
    ftw_h, ftw_l = ds.ds_sum(ph, pe, axis=0)
    rows_h, rows_l = ds.ds_sum(wg_h, wg_l, axis=1)  # (M,)
    cw_h, cw_l = ds.ds_scale(w_c, wl_c, sc.c)
    yw_h, yw_l = ds.ds_scale(w_y, wl_y, sc.y)
    gy_rows_h, gy_rows_l = ds.ds_scale(rows_h, rows_l, sc.gy)

    # the three sums over the sample axis (over every process's samples)
    (gtw_h, gtw_l), (syw_h, syw_l), (srows_h, srows_l) = ops._sum_ds(
        ds.contract_mkn_mk(ops.data.G, wg_h, wg_l, chunk=_ds_chunk(M)),
        ds.ds_sum(yw_h, yw_l, axis=0),
        ds.ds_sum(gy_rows_h, gy_rows_l, axis=0))
    u_h, u_l = ds.ds_add(ftw_h, ftw_l, gtw_h, gtw_l)
    u_h, u_l = ds.ds_add(u_h, u_l, w_u, wl_u)

    y_h, y_l = ds.ds_add(cw_h.expand(M), cw_l.expand(M), -yw_h, -yw_l)
    y_h, y_l = ds.ds_add(y_h, y_l, -gy_rows_h, -gy_rows_l)

    sw_h, sw_l = ds.ds_scale(w_s, wl_s, sc.s)
    s_h, s_l = ds.ds_add(cw_h, cw_l, -syw_h, -syw_l)
    s_h, s_l = ds.ds_add(s_h, s_l, -sw_h, -sw_l)

    ma_h, ma_l = ds.two_prod(_scalar(float(st.M), w), ops.data.alpha)
    cma_h, cma_l = ds.ds_mul(ma_h, ma_l, cw_h, cw_l)
    t_h, t_l = ds.ds_add(cma_h, cma_l, -srows_h, -srows_l)

    h = torch.cat([u_h, y_h, s_h[None], t_h[None]])
    lo = torch.cat([u_l, y_l, s_l[None], t_l[None]])
    return h, lo


def _ds_sub_bound(b, ax_h, ax_l):
    """Compensated b - Ax with +/-inf rows passed through."""
    s_h, s_e = ds.two_sum(b, -ax_h)
    fin = torch.isfinite(b)
    return torch.where(fin, s_h, b), torch.where(fin, s_e - ax_l,
                                                 torch.zeros_like(b))


class _Residuals(NamedTuple):
    prim: torch.Tensor
    dual: torch.Tensor
    eps_prim: torch.Tensor
    eps_dual: torch.Tensor
    rd_h: torch.Tensor
    rd_l: torch.Tensor
    rl_h: torch.Tensor
    rl_l: torch.Tensor
    ru_h: torch.Tensor
    ru_l: torch.Tensor

    def certified(self) -> bool:
        return bool((self.prim <= self.eps_prim) & (self.dual <= self.eps_dual))


def _finish(l, u, ax_h, ax_l, px_h, px_l, aty_h, aty_l, rd_h, rd_l, q, cfg,
            red=admm.LOCAL):
    """The unscaled OSQP residuals and thresholds from the compensated
    Ax, Px, A^T y and r_d (z = clip(Ax)); the maxima from `red`."""
    rl_h, rl_l = _ds_sub_bound(l, ax_h, ax_l)  # l - Ax
    ru_h, ru_l = _ds_sub_bound(u, ax_h, ax_l)  # u - Ax
    ninf = torch.full_like(l, float("-inf"))
    viol = torch.maximum(
        torch.where(torch.isfinite(l), ds.ds_round(rl_h, rl_l), ninf),
        torch.where(torch.isfinite(u), ds.ds_round(-ru_h, -ru_l), ninf))
    ax = ds.ds_round(ax_h, ax_l)
    z = torch.clamp(ax, l, u)
    prim, dual, n_ax, n_z, n_px, n_aty, n_q = red.amax(
        torch.clamp(viol, min=0.0), *(torch.abs(v) for v in (
            ds.ds_round(rd_h, rd_l), ax, z, ds.ds_round(px_h, px_l),
            ds.ds_round(aty_h, aty_l), q)))
    eps_prim = cfg.eps_abs + cfg.eps_rel * torch.maximum(n_ax, n_z)
    eps_dual = cfg.eps_abs + cfg.eps_rel * torch.maximum(
        torch.maximum(n_px, n_aty), n_q)
    return _Residuals(prim, dual, eps_prim, eps_dual,
                      rd_h, rd_l, rl_h, rl_l, ru_h, ru_l)


def _residuals(ops, q, l, u, p_diag, x_h, x_l, y, cfg):
    """Compensated unscaled OSQP residuals of the structured QP at (x, y)."""
    ax_h, ax_l = _ds_matvec_A(ops, x_h, x_l)
    px_h, px_e = ds.two_prod(p_diag, x_h)
    px_e = px_e + p_diag * x_l
    rd_h, rd_l = ds.ds_add(px_h, px_e, q, torch.zeros_like(q))
    aty_h, aty_l = _ds_rmatvec_A(ops, y)
    rd_h, rd_l = ds.ds_add(rd_h, rd_l, aty_h, aty_l)
    return _finish(l, u, ax_h, ax_l, px_h, px_e, aty_h, aty_l, rd_h, rd_l,
                   q, cfg, admm.reductions(ops))


def _pow2(x):
    """The power of two nearest a positive scalar in log scale: 2^round(
    log2 x), built exactly from the binary exponent (torch.frexp/ldexp)."""
    mant, exp = torch.frexp(x)  # x = mant 2^exp, mant in [0.5, 1)
    # log2 x = exp + log2(mant), log2(mant) in [-1, 0): round half to even
    # as jnp.round does
    k = exp.to(x.dtype) + torch.round(torch.log2(mant))
    return torch.ldexp(torch.ones_like(x), k)


def _ds_matvec_dense(Amat, x_h, x_l):
    """Compensated Amat @ (x_h, x_l) for a dense matrix (ds output)."""
    p, e = ds.two_prod(Amat, x_h[None, :])
    e = e + Amat * x_l[None, :]
    return ds.ds_sum(p, e, axis=1)


def _ds_rmatvec_dense(Amat, w, w_lo=None):
    """Compensated Amat.T @ (w, w_lo) for a dense matrix (ds output)."""
    p, e = ds.two_prod(Amat, w[:, None])
    if w_lo is not None:
        e = e + Amat * w_lo[:, None]
    return ds.ds_sum(p, e, axis=0)


def _residuals_dense(P, A, q, l, u, x_h, x_l, y, cfg, y_l=None):
    """Compensated unscaled OSQP residuals of a dense (P, A) QP at (x, y);
    `y` may be a ds pair through `y_l` (the dense loop carries its dual in
    ds: once the dual residual nears eps |y|, its corrections fall below
    the ulp of y)."""
    ax_h, ax_l = _ds_matvec_dense(A, x_h, x_l)
    px_h, px_l = _ds_matvec_dense(P, x_h, x_l)
    rd_h, rd_l = ds.ds_add(px_h, px_l, q, torch.zeros_like(q))
    aty_h, aty_l = _ds_rmatvec_dense(A, y, y_l)
    rd_h, rd_l = ds.ds_add(rd_h, rd_l, aty_h, aty_l)
    return _finish(l, u, ax_h, ax_l, px_h, px_l, aty_h, aty_l, rd_h, rd_l,
                   q, cfg)


def _leg_configs(cfg: SolverConfig, ir: IRConfig):
    """The correction solves' config (work_eps, no polish) and the base
    solve's (base_* or work_eps, no polish)."""
    work_cfg = dataclasses.replace(cfg, eps_abs=ir.work_eps,
                                   eps_rel=ir.work_eps, polish=False)
    base_cfg = dataclasses.replace(
        cfg,
        eps_abs=ir.work_eps if ir.base_eps_abs is None else ir.base_eps_abs,
        eps_rel=ir.work_eps if ir.base_eps_rel is None else ir.base_eps_rel,
        max_iter=cfg.max_iter if ir.base_max_iter is None else ir.base_max_iter,
        polish=False,
    )
    return work_cfg, base_cfg


def _correction_data(res: _Residuals, q, l, u, ir: IRConfig):
    """Delta and the correction QP's (q, l, u): the residual data scaled to
    O(1) by an exact power of two."""
    tiny = torch.tensor(1e-30, dtype=q.dtype, device=q.device)
    scale = torch.maximum(torch.maximum(res.prim, res.dual), tiny)
    delta = _pow2(torch.clamp(ir.margin / scale, 1.0, ir.delta_max))
    dq = delta * ds.ds_round(res.rd_h, res.rd_l)
    dl = torch.where(torch.isfinite(l), delta * ds.ds_round(res.rl_h, res.rl_l),
                     l)
    du = torch.where(torch.isfinite(u), delta * ds.ds_round(res.ru_h, res.ru_l),
                     u)
    return delta, dq, dl, du


def solve_dense_qp_ir(P, q, A, l, u, cfg: SolverConfig,
                      ir: IRConfig = IRConfig(), x0=None, y0=None,
                      ruiz_iters: int = 5) -> admm.QPSolution:
    """Dense-matrix refinement (qp_refine.py:298-387): a float32 ADMM base
    solve and correction rounds with compensated residuals, certified at
    cfg.eps_abs/eps_rel far below the float32 floor. The path of the
    Gaussian-baseline planners' QPs (the reference solves them with OSQP at
    eps 1e-8 in float64, car/driving_gaussian.py:27)."""
    ops = admm.DenseQPOps(P, A, kkt_refine_iters=cfg.kkt_refine_iters)
    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters)
    work_cfg, base_cfg = _leg_configs(cfg, ir)
    base = admm.admm_solve(ops, q, l, u, base_cfg, x0=x0, y0=y0,
                           scaling=scaling)
    x_h, x_l = base.x, torch.zeros_like(base.x)
    y_h, y_lo = base.y, torch.zeros_like(base.y)
    iters = base.iters
    res = _residuals_dense(P, A, q, l, u, x_h, x_l, y_h, cfg, y_l=y_lo)
    prox_ops = _ProxOps(ops, torch.tensor(ir.prox, dtype=q.dtype,
                                          device=q.device))
    for _ in range(ir.rounds):
        if res.certified():
            break
        delta, dq, dl, du = _correction_data(res, q, l, u, ir)
        corr = admm.admm_solve(prox_ops, dq, dl, du, work_cfg, scaling=scaling)
        x_h, x_l = ds.ds_add(x_h, x_l, corr.x / delta, torch.zeros_like(corr.x))
        y_h, y_lo = ds.ds_add(y_h, y_lo, corr.y / delta,
                              torch.zeros_like(corr.y))
        res = _residuals_dense(P, A, q, l, u, x_h, x_l, y_h, cfg, y_l=y_lo)
        iters += corr.iters
    z = torch.clamp(ds.ds_round(*_ds_matvec_dense(A, x_h, x_l)), l, u)
    return admm.QPSolution(
        x=ds.ds_round(x_h, x_l), y=ds.ds_round(y_h, y_lo), z=z, iters=iters,
        prim_res=res.prim, dual_res=res.dual, solved=res.certified(),
        prim_infeasible=base.prim_infeasible,
        dual_infeasible=base.dual_infeasible,
    )


class _ProxOps:
    """Adds `sig * I` to the operator's quadratic term (P + sig I) through
    the sigma_vec argument, which every factorize/kkt_solve applies to all
    variable blocks. Under admm.ScaledOps the inner call receives
    sigma_vec + cost_scale*sig, so the prox acts in the unscaled space. It
    carries the inner operator's reductions and shard: without them a
    sample-sharded solve would take each process's partial residuals for
    global ones."""

    def __init__(self, inner, sig):
        self.inner = inner
        self.sig = sig
        self.reductions = admm.reductions(inner)
        self.shard = getattr(inner, "shard", None)

    def matvec_P(self, x):
        return self.inner.matvec_P(x) + self.sig * x

    def matvec_A(self, x):
        return self.inner.matvec_A(x)

    def rmatvec_A(self, w):
        return self.inner.rmatvec_A(w)

    def row_inf_norms(self, D):
        return self.inner.row_inf_norms(D)

    def col_inf_norms(self, E):
        return self.inner.col_inf_norms(E)

    def col_inf_norms_P(self, D):
        return torch.maximum(self.inner.col_inf_norms_P(D), self.sig * D)

    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        return self.inner.factorize(rho_vec, sigma_vec + cost_scale * self.sig,
                                    cost_scale)

    def kkt_solve(self, factor, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        return self.inner.kkt_solve(factor, rhs, rho_vec,
                                    sigma_vec + cost_scale * self.sig,
                                    cost_scale)


def solve_saa_qp_ir(st: SAAQPStatic, data, scp_iter: int, cfg: SolverConfig,
                    ir: IRConfig = IRConfig(), x0=None, y0=None,
                    ruiz_iters: int = 5, shard=None) -> admm.QPSolution:
    """Structured ADMM + iterative refinement to cfg.eps_abs/eps_rel
    (qp_refine.py:432-577). With cfg.polish the certified point is snapped
    to its active-set vertex, kept only if its compensated residuals still
    certify. Under `shard`, this process's share of a sample-sharded QP
    (ops/saa_qp.solve_saa_qp)."""
    ops = make_ops(st, data, scp_iter, cfg, shard)
    p_diag, q = build_objective(st, data)
    l, u = build_bounds(st, data, scp_iter, shard)
    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters)
    work_cfg, base_cfg = _leg_configs(cfg, ir)
    base = admm.admm_solve(ops, q, l, u, base_cfg, x0=x0, y0=y0,
                           scaling=scaling)
    x_h, x_l = base.x, torch.zeros_like(base.x)
    y = base.y
    iters = base.iters
    res = _residuals(ops, q, l, u, p_diag, x_h, x_l, y, cfg)
    prox_ops = _ProxOps(ops, torch.tensor(ir.prox, dtype=q.dtype,
                                          device=q.device))
    for _ in range(ir.rounds):
        if res.certified():
            break
        delta, dq, dl, du = _correction_data(res, q, l, u, ir)
        corr = admm.admm_solve(prox_ops, dq, dl, du, work_cfg, scaling=scaling)
        x_h, x_l = ds.ds_add(x_h, x_l, corr.x / delta, torch.zeros_like(corr.x))
        y = y + corr.y / delta
        res = _residuals(ops, q, l, u, p_diag, x_h, x_l, y, cfg)
        iters += corr.iters
    x = ds.ds_round(x_h, x_l)
    z = torch.clamp(ds.ds_round(*_ds_matvec_A(ops, x_h, x_l)), l, u)
    if cfg.polish:
        # deterministic active-set vertex on top of the certified point,
        # accepted only if its compensated residuals still certify
        xp, yp, zp, _ = admm._polish(ops, q, l, u, x, y, z, cfg)
        resp = _residuals(ops, q, l, u, p_diag, xp, torch.zeros_like(xp), yp,
                          cfg)
        if resp.certified():
            x, y, z, res = xp, yp, zp, resp
    return admm.QPSolution(
        x=x, y=y, z=z, iters=iters, prim_res=res.prim, dual_res=res.dual,
        solved=res.certified(),
        prim_infeasible=base.prim_infeasible,
        dual_infeasible=base.dual_infeasible,
    )
