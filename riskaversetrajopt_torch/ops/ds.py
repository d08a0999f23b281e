"""Double-single (two-float) compensated arithmetic: the float32-at-1e-8
path of the dense Gaussian-baseline QPs.

The counterpart of ``riskaversetrajopt_tpu/ops/ds.py`` (its module docstring
gives the reasoning): OSQP at eps 1e-8 (car/driving_gaussian.py:27) is below
what a plain float32 iterate can represent. This module provides

- Dekker's error-free transforms (`two_sum`, `two_prod` with a
  multiplicative split; no FMA assumed);
- a compensated dense matvec, `ds_matvec`, whose (hi, lo) result is
  accurate to ~eps^2 relative;
- `refine_kkt_ds`: iterative refinement of a KKT system with a float32 LU
  factorization and double-single residuals;
- `solve_dense_qp_ds`: a float32 ADMM with polish picks the active set,
  then a refined active-set KKT solve reaches true (float64-verified)
  residuals of 1e-8 from float32 arithmetic.

Like ``ops/dsjit.py`` this module runs eagerly, one kernel per op, so each
product and each sum is rounded on its own; it must not go under
``torch.compile`` (which may contract a multiply and an add into an FMA),
and no fused op (``addcmul``, ``lerp``, ``addmm``) may stand inside a
transform. The multiplicative split of `two_prod` relies on that rounding,
unlike the bit-masking split of dsjit. All functions take float32 or
float64.
"""

from __future__ import annotations

import numpy as np
import torch

from riskaversetrajopt_torch.core.config import SolverConfig
from riskaversetrajopt_torch.ops import admm
from riskaversetrajopt_torch.ops.dsjit import two_sum

# Dekker splitting constant: 2^ceil(p/2) + 1 with p the significand bits
_SPLIT = {torch.float32: 4097.0, torch.float64: 134217729.0}

__all__ = ["two_sum", "two_prod", "ds_add", "ds_matvec", "pow2_equilibrate",
           "refine_kkt_ds", "kkt_residuals_ds", "solve_dense_qp_ds"]


def _split(a):
    c = _SPLIT[a.dtype] * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker, no FMA)."""
    a, b = torch.broadcast_tensors(a, b)
    p = a * b
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def ds_add(hi1, lo1, hi2, lo2):
    """(hi1, lo1) + (hi2, lo2), renormalized with a full two_sum (ds.py:78;
    dsjit's ds_add renormalizes with quick_two_sum)."""
    s, e = two_sum(hi1, hi2)
    e = e + (lo1 + lo2)
    return two_sum(s, e)


def ds_matvec(A, x_hi, x_lo):
    """Compensated A @ x for a ds vector x: (hi, lo) per row.

    All products are formed in one error-free two_prod over the matrix, then
    summed column by column with error-free sums, in column order."""
    m = A.shape[0]
    P, Pe = two_prod(A, x_hi[None, :])
    Pe = Pe + A * x_lo[None, :]
    acc_hi = A.new_zeros(m)
    acc_lo = A.new_zeros(m)
    for j in range(A.shape[1]):
        acc_hi, e = two_sum(acc_hi, P[:, j])
        acc_lo = acc_lo + (e + Pe[:, j])
    return two_sum(acc_hi, acc_lo)


def pow2_equilibrate(K, iters: int = 4):
    """Symmetric diagonal scaling D of powers of two (exact to apply) that
    brings the rows and columns of D K D toward unit inf-norm; computed on
    the host in float64, returned in K's dtype and device."""
    Kn = K.detach().to("cpu", torch.float64).numpy()
    d = np.ones(Kn.shape[0])
    for _ in range(iters):
        r = np.abs(np.diag(d) @ Kn @ np.diag(d)).max(axis=1)
        r = np.where(r > 0, r, 1.0)
        d = d * np.exp2(np.round(-0.5 * np.log2(r)))
    return torch.as_tensor(d, dtype=K.dtype, device=K.device)


def refine_kkt_ds(K_factor, rhs, K_target=None, num_iters: int = 25):
    """Solve K_target s = rhs with an LU factorization of K_factor (a
    regularized preconditioner) and double-single iterative refinement; the
    iterate is a ds pair. Residuals are measured against K_target (default
    K_factor), so a regularized factorization converges to the solution of
    the unregularized system."""
    dtype = K_factor.dtype
    K_target = K_factor if K_target is None else K_target
    LU, piv = torch.linalg.lu_factor(K_factor)

    def solve(r):
        return torch.linalg.lu_solve(LU, piv, r[:, None])[:, 0]

    x_hi = solve(rhs)
    x_lo = torch.zeros_like(x_hi)
    for _ in range(num_iters):
        Kx_hi, Kx_lo = ds_matvec(K_target, x_hi, x_lo)
        r_hi, r_e = two_sum(rhs, -Kx_hi)  # r = rhs - K x in ds
        r = r_hi + (r_e - Kx_lo)
        d = solve(r.to(dtype))
        x_hi, x_lo = ds_add(x_hi, x_lo, d, torch.zeros_like(d))
    return x_hi, x_lo


def kkt_residuals_ds(P, q, A_act, b_act, x_hi, x_lo, y_act_hi, y_act_lo):
    """Compensated unscaled KKT residuals of an active-set solution:
    dual = P x + q + A_act^T y, prim = A_act x - b_act (the hi parts)."""
    Px_hi, Px_lo = ds_matvec(P, x_hi, x_lo)
    Aty_hi, Aty_lo = ds_matvec(A_act.T, y_act_hi, y_act_lo)
    d_hi, d_e = two_sum(Px_hi, Aty_hi)
    dual_hi, dual_e = two_sum(d_hi, q)
    dual = dual_hi + (dual_e + d_e + Px_lo + Aty_lo)
    Ax_hi, Ax_lo = ds_matvec(A_act, x_hi, x_lo)
    p_hi, p_e = two_sum(Ax_hi, -b_act)
    prim = p_hi + (p_e + Ax_lo)
    return prim, dual


def _host64(t):
    return t.detach().to("cpu", torch.float64).numpy()


def solve_dense_qp_ds(P, q, A, l, u, cfg=None, refine_iters: int = 25):
    """Float32-only dense QP solve to 1e-8-class true residuals (ds.py:161).

    1. OSQP-semantics ADMM with polish picks the active set.
    2. The active-set KKT system [[P + dI, A_a^T], [A_a, -dI]] is factored
       and ds-refined; x and the active duals are ds pairs.
    3. The active set is corrected one row at a time: the worst violated
       row joins it; once feasible, wrong-sign duals leave it.

    The active-set logic runs on the host (the set is data-dependent); the
    KKT solves run on the tensors' device. Returns (x_hi, x_lo, y, info)
    with y float64 (hi + lo of the active duals)."""
    dtype, device = P.dtype, P.device
    cfg = cfg or SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=100000)
    sol = admm.solve_dense_qp(P, q, A, l, u, cfg)
    y = sol.y.detach().cpu().numpy()
    z = sol.z.detach().cpu().numpy()
    l_np, u_np = l.detach().cpu().numpy(), u.detach().cpu().numpy()
    z_tol = np.sqrt(np.finfo(z.dtype).eps) * max(1.0, np.abs(z).max())
    low = ((y < -1e-12) | (z - l_np < z_tol)) & np.isfinite(l_np)
    upp = ((y > 1e-12) | (u_np - z < z_tol)) & np.isfinite(u_np)
    eq = np.isfinite(l_np) & np.isfinite(u_np) & (u_np - l_np < 1e-12)
    # the active rows are taken at float32 whatever the dtype (ds.py:187)
    A_np = A.detach().cpu().numpy().astype(np.float32)
    n = P.shape[0]
    m = A.shape[0]
    kw = dict(dtype=dtype, device=device)
    delta = torch.tensor(1e-7, **kw)

    def prune_ordered(act_list):
        """Maximal independent row subset by float32 QR in the given order
        (newest rows first), so that a dependency evicts the old row: pivoted
        QR would keep the larger norm and could evict the row just added."""
        if not act_list:
            return []
        At = np.ascontiguousarray(A_np[np.asarray(act_list)].T)
        R = torch.linalg.qr(torch.from_numpy(At), mode="r").R
        diag = np.abs(np.diag(R.numpy()))
        thresh = (diag.max() if diag.size else 1.0) * np.sqrt(
            np.finfo(np.float32).eps)
        return [act_list[k] for k in range(diag.size) if diag[k] > thresh]

    def kkt_solve(act, at_lower):
        b_act = torch.as_tensor(np.where(at_lower, l_np, u_np)[act], **kw)
        A_act = torch.as_tensor(A_np[act], **kw)
        na = int(act.sum())
        K0 = torch.zeros((n + na, n + na), **kw)
        K0[:n, :n] = P
        K0[:n, n:] = A_act.T
        K0[n:, :n] = A_act
        # power-of-two equilibration: exact to apply, restores the float32
        # refinement's contraction on the ill-conditioned KKT systems
        d_sc = pow2_equilibrate(K0)
        K0_s = d_sc[:, None] * K0 * d_sc[None, :]
        sign = torch.cat([torch.ones(n, **kw), -torch.ones(na, **kw)])
        K_s = K0_s + delta * torch.diag(d_sc * d_sc * sign)
        rhs_s = d_sc * torch.cat([-q, b_act])
        y_hi, y_lo = refine_kkt_ds(K_s, rhs_s, K_target=K0_s,
                                   num_iters=refine_iters)
        s_hi, s_lo = d_sc * y_hi, d_sc * y_lo  # unscale exactly
        return s_hi[:n], s_lo[:n], s_hi[n:], s_lo[n:], A_act, b_act

    at_lower = low & ~eq
    act_list = [int(i) for i in np.flatnonzero(eq)] + [
        int(i) for i in np.flatnonzero((low | upp) & ~eq)]
    act_list = prune_ordered(act_list)
    tol_u = 1e-9 * (1.0 + np.abs(np.where(np.isfinite(u_np), u_np, 0.0)))
    tol_l = 1e-9 * (1.0 + np.abs(np.where(np.isfinite(l_np), l_np, 0.0)))
    A64 = A_np.astype(np.float64)
    for _ in range(80):
        act = np.zeros(m, bool)
        act[np.asarray(act_list, int)] = True
        x_hi, x_lo, ya_hi, ya_lo, A_act, b_act = kkt_solve(act, at_lower)
        Ax = A64 @ (_host64(x_hi) + _host64(x_lo))
        # per-row tolerances: the rows span orders of magnitude
        excess_u = np.where(~act, Ax - (u_np + tol_u), -np.inf)
        excess_l = np.where(~act, (l_np - tol_l) - Ax, -np.inf)
        worst = int(np.argmax(np.maximum(excess_u, excess_l)))
        if max(excess_u[worst], excess_l[worst]) > 0:
            at_lower[worst] = excess_l[worst] >= excess_u[worst]
            act_list = prune_ordered([worst] + act_list)
            continue
        ya = _host64(ya_hi)
        act_idx = np.flatnonzero(act)  # the active rows in sorted order
        y_tol = 1e-9 * (1.0 + np.abs(ya))
        sign_err = np.zeros(act_idx.size)
        for k, row in enumerate(act_idx):
            if eq[row]:
                continue
            if at_lower[row]:
                sign_err[k] = max(0.0, ya[k] - y_tol[k])
            else:
                sign_err[k] = max(0.0, -ya[k] - y_tol[k])
        if sign_err.size and sign_err.max() > 0:
            drop = int(act_idx[int(np.argmax(sign_err))])
            act_list = [r for r in act_list if r != drop]
            continue
        break
    act = np.zeros(m, bool)
    act[np.asarray(act_list, int)] = True

    prim, dual = kkt_residuals_ds(P, q, A_act, b_act, x_hi, x_lo, ya_hi,
                                  ya_lo)
    # the duals leave as hi + lo: the ds pair is the computed object
    y_full = np.zeros(m, np.float64)
    y_full[act] = _host64(ya_hi) + _host64(ya_lo)
    info = {
        "active": act,
        "prim_res": float(torch.amax(torch.abs(prim))) if act.any() else 0.0,
        "dual_res": float(torch.amax(torch.abs(dual))),
        "admm_iters": int(sol.iters),
    }
    return x_hi, x_lo, torch.as_tensor(y_full, device=device), info
