"""Structured SAA SCP subproblem: CVaR epigraph packing + sample-parallel KKT.

The counterpart of ``riskaversetrajopt_tpu/ops/saa_qp.py`` (its module
docstring describes the row layout, the MULTIPLIER row scaling, the gating
and the Schur-complement factorization). Decision vector
z = [u (n) | y (M) | s | t]; row blocks
[final (n_fc) | CVaR row | -y_i - s rows (M) | sample blocks (M*K) |
 slack row | control rows (n)]. The only large object is the stack of
per-sample constraint Jacobians G (M, K, n).

Sample-sharded mode (`shard`, a parallel/distributed.SampleShard): this
process holds samples [offset, offset + M_local) of the M in SAAQPStatic.M:
its slice of G, g_up and y, and its y rows and sample rows; u, s, t, the
final, CVaR and slack rows and the control rows are replicated on every
process. Every sum and max over the sample axis is a collective over the
shard's group (`SampleShard.sum` / `max`), each a vector of at most
(n+2)^2 entries, never G; `SampleShard.reductions` gives the ADMM its
global reductions with the replicated entries counted once. With
`shard=None` one process holds every sample and the arithmetic is the
unsharded one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from riskaversetrajopt_torch.core.config import SolverConfig
from riskaversetrajopt_torch.ops import admm, dsjit
from riskaversetrajopt_torch.ops.rollout import SampleLinearization

SWEEP_PRECISIONS = ("highest", "high", "default")


def check_sweep_precision(precision: str):
    if precision not in SWEEP_PRECISIONS:
        raise ValueError(f"sweep_precision must be one of {SWEEP_PRECISIONS}, "
                         f"got {precision!r}")


def _bf16(x):
    """x rounded to the nearest bfloat16, kept in x's type."""
    return x.to(torch.bfloat16).to(x.dtype)


def sweep_matmul(a, b, precision="highest"):
    """a @ b for the G-sweeps at a TPU matmul precision
    (core/config.py:124-131 of the JAX package), for float32 operands:
      "highest": exact float32 products, float32 accumulation;
      "high":    bf16x3, each operand split into a bf16 hi part and a bf16
                 lo part, hi*hi + hi*lo + lo*hi accumulated in float32;
      "default": operands rounded to bf16, float32 accumulation.
    A product of two bf16 values is exact in float32, so float32 matmuls of
    the rounded parts (TF32 off) give these meanings on every device.
    Float64 operands are always multiplied exactly."""
    check_sweep_precision(precision)
    if precision == "highest" or a.dtype != torch.float32:
        return a @ b
    a_hi, b_hi = _bf16(a), _bf16(b)
    if precision == "default":
        return a_hi @ b_hi
    a_lo, b_lo = _bf16(a - a_hi), _bf16(b - b_hi)
    return (a_hi @ b_hi + a_hi @ b_lo) + a_lo @ b_hi


class SAAQPStatic(NamedTuple):
    """Static problem structure."""

    n: int  # n_u * S control variables
    M: int  # samples
    K: int  # inequality constraints per sample
    n_fc: int  # final (equality) rows
    n_x: int  # state dim — the gating threshold row index
    row_scale: float  # MULTIPLIER on sample rows (drone 0.01, car 1.0)
    slack_penalty: float  # P[-2,-2] and q[-2] (car 1e3, drone 1e4)
    u_max: float
    baseline: bool  # 'baseline' method (no CVaR rows, padded sample rows)
    baseline_pad: float  # drone baseline safety padding (1e-3)
    gate_iters: int
    gate_scale: float  # A-row scale during gated iterations
    gate_l: float  # gated lower bound (-inf for car, -0.1 for drone)
    gate_u: float  # gated upper bound


class SAAQPData(NamedTuple):
    """Per-SCP-iteration numeric data (linearization at the previous iterate)."""

    F: torch.Tensor  # (n_fc, n) sample-averaged final-constraint Jacobian
    f_rhs: torch.Tensor  # (n_fc,) equality rhs
    G: torch.Tensor  # (M, K, n) per-sample constraint Jacobians
    g_up: torch.Tensor  # (M, K) linearized upper bounds (before row_scale)
    p_diag_u: torch.Tensor  # (n,) control-block objective diagonal (2*dt*R)
    alpha: torch.Tensor  # risk level (0-d)


def pack_saa_qp_data(
    lin: SampleLinearization, us_prev_vec, p_diag_u, alpha, shard=None
) -> SAAQPData:
    """Build per-iteration QP data from a batched linearization
    (car/driving.py:289-296):
      equality rows:  F u = mean_i(-f_i + F_i u_prev)  with F = mean_i F_i
      sample rows:    G_i u <= -g_i + G_i u_prev
    With `shard` the linearization holds this process's samples; F and
    f_rhs are the means over all M (the local means weighted M_local / M
    and summed over the processes)."""
    F = torch.mean(lin.f_jac, dim=0)
    f_rhs = torch.mean(-lin.f_val + lin.f_jac @ us_prev_vec, dim=0)
    if shard is not None:
        w = shard.M_local / shard.M
        F, f_rhs = shard.sum(F * w, f_rhs * w)
    g_up = -lin.g_val + lin.g_jac @ us_prev_vec
    G = lin.g_jac
    return SAAQPData(
        F=F, f_rhs=f_rhs, G=G, g_up=g_up, p_diag_u=p_diag_u,
        alpha=torch.as_tensor(alpha, dtype=G.dtype, device=G.device),
    )


class _RowScales(NamedTuple):
    """Per-segment A-row scaling implementing iteration gating and the
    baseline-method row shape in fixed layout."""

    c: torch.Tensor  # 0-d, CVaR row
    y: torch.Tensor  # (M,), -y_i - s rows
    gy: torch.Tensor  # 0-d, multiplies the y/t couplings of sample rows
    g: torch.Tensor  # 0-d, multiplies the whole sample-row blocks
    s: torch.Tensor  # 0-d, slack row


def _y_gated(st: SAAQPStatic, device, shard=None):
    """Which y rows gate (by absolute sample index, see the JAX module
    docstring), for this process's samples."""
    i = torch.arange(st.M, device=device)
    if shard is not None:
        i = i[shard.offset:shard.offset + shard.M_local]
    return i >= (st.n_x - st.n_fc - 1)


def _row_scales(st: SAAQPStatic, scp_iter: int, dtype, device,
                shard=None) -> _RowScales:
    gating = scp_iter < st.gate_iters
    kw = dict(dtype=dtype, device=device)
    gate = torch.tensor(st.gate_scale, **kw)
    one = torch.tensor(1.0, **kw)
    # absolute row index >= n_x is gated (see the JAX module docstring)
    c_gated = st.n_fc >= st.n_x
    y_gated = _y_gated(st, device, shard)

    c = gate if gating and c_gated else one
    y = torch.where(y_gated & gating, gate, one)
    g = gate if gating else one
    s = gate if gating else one
    if st.baseline:
        # baseline: no CVaR/y/slack rows; sample rows touch only u
        c, y, s = c * 0.0, y * 0.0, s * 0.0
        gy = torch.tensor(0.0, **kw)
    else:
        gy = one
    return _RowScales(c=c, y=y, gy=gy, g=g, s=s)


def build_bounds(st: SAAQPStatic, data: SAAQPData, scp_iter: int,
                 shard=None):
    """Assemble (l, u) in reference row order with gating applied (this
    process's rows under `shard`)."""
    kw = dict(dtype=data.G.dtype, device=data.G.device)
    Ml = data.G.shape[0]
    inf = float("inf")
    gating = scp_iter < st.gate_iters

    def full(size, v):
        return torch.full((size,), v, **kw)

    l_final = data.f_rhs
    u_final = data.f_rhs
    # CVaR row: gated only when its absolute row index >= n_x (true for the
    # drone where n_fc == n_x; the reference car keeps it live)
    c_gated = st.n_fc >= st.n_x
    l_c = full(1, st.gate_l if gating and c_gated else -inf)
    u_c = full(1, st.gate_u if gating and c_gated else 0.0)
    # y rows gate only where the static row-index mask says so
    y_gated = _y_gated(st, data.G.device, shard) & gating
    l_y = torch.where(y_gated, torch.tensor(st.gate_l, **kw),
                      torch.tensor(-inf, **kw))
    u_y = torch.where(y_gated, torch.tensor(st.gate_u, **kw),
                      torch.tensor(0.0, **kw))

    m = torch.tensor(st.row_scale, **kw)
    g_ub = m * (data.g_up - (st.baseline_pad if st.baseline else 0.0))
    if gating:
        l_g, u_g = full(Ml * st.K, st.gate_l), full(Ml * st.K, st.gate_u)
        l_s, u_s = full(1, st.gate_l), full(1, st.gate_u)
    else:
        l_g, u_g = full(Ml * st.K, -inf), g_ub.reshape(-1)
        l_s, u_s = full(1, -inf), full(1, 0.0)

    l_u = full(st.n, -st.u_max)
    u_u = full(st.n, st.u_max)

    l = torch.cat([l_final, l_c, l_y, l_g, l_s, l_u])
    u = torch.cat([u_final, u_c, u_y, u_g, u_s, u_u])
    return l, u


def build_objective(st: SAAQPStatic, data: SAAQPData):
    """P diagonal and q in variable order [u | y | s | t]
    (car/driving.py:375-389, drone/drone_risk.py:376-391). The objective
    does not depend on the method: the baseline keeps the slack penalty on an
    unconstrained slack variable, as the reference does."""
    kw = dict(dtype=data.G.dtype, device=data.G.device)
    Ml = data.G.shape[0]  # this process's samples (all M unsharded)
    p_diag = torch.cat([
        data.p_diag_u.to(**kw),
        torch.zeros(Ml, **kw),
        torch.tensor([st.slack_penalty, 0.0], **kw),
    ])
    q = torch.zeros(st.n + Ml + 2, **kw)
    q[-2] = st.slack_penalty
    return p_diag, q


def _solve_triangular_vec(L, b, upper):
    return torch.linalg.solve_triangular(L, b[:, None], upper=upper)[:, 0]


class SAAQPOps:
    """Structured operator bundle consumed by ops.admm.admm_solve.

    kkt_refine_mode: "true" (residual through matvec_A/rmatvec_A, two extra
    G-sweeps a pass) or "factored" (residual against the stored Schur
    blocks). kkt_chol_inverse: apply the Schur solve through an explicit
    inverse formed once per factorization. factorize_compensated: None =
    auto (on for float32): every reduction of the factorization over the M
    sample axis goes through the double-single pairwise sums of
    ops/dsjit.py. sweep_precision: the precision of the per-iteration
    G-sweeps in matvec_A / rmatvec_A (`sweep_matmul`); the factorization
    stays exact. shard: this process's share of the samples (module
    docstring); None, every sample."""

    def __init__(self, st: SAAQPStatic, data: SAAQPData, scp_iter: int,
                 kkt_refine_iters=1, kkt_refine_mode="true",
                 factorize_compensated=None, sweep_precision="highest",
                 kkt_chol_inverse=False, shard=None):
        check_sweep_precision(sweep_precision)
        self.st = st
        self.shard = shard
        self.Ml = data.G.shape[0]  # this process's samples
        if shard is not None:
            if self.Ml != shard.M_local or st.M != shard.M:
                raise ValueError(
                    f"SAAQPOps: {self.Ml} local samples of {st.M}, but the "
                    f"shard holds {shard.M_local} of {shard.M}")
            self.reductions = shard.reductions(st.n, st.n_fc, st.K)
        self.sweep_precision = sweep_precision
        self.data = data
        self.kkt_refine_mode = kkt_refine_mode
        self.kkt_chol_inverse = kkt_chol_inverse
        self.dtype = data.G.dtype
        self.device = data.G.device
        if factorize_compensated is None:
            factorize_compensated = self.dtype == torch.float32
        self.factorize_compensated = factorize_compensated
        self.m = torch.tensor(st.row_scale, dtype=self.dtype, device=self.device)
        self.scales = _row_scales(st, int(scp_iter), self.dtype, self.device,
                                  shard)
        self.p_diag, _ = build_objective(st, data)
        self.Malpha = st.M * data.alpha
        self.kkt_refine_iters = kkt_refine_iters
        # some y meets the CVaR row alone: its y row and every sample row
        # are zeroed while the CVaR row is live (the car's gated iteration);
        # a property of the whole structure, so of every sample's y row
        sc = (self.scales if shard is None else
              _row_scales(st, int(scp_iter), self.dtype, self.device))
        self.free_y = bool(
            (sc.c != 0) & (sc.g * sc.gy == 0) & torch.any(sc.y == 0))

    def _sum(self, *ts):
        """Sums over this process's samples -> sums over all M (each
        tensor as it is when one process holds every sample)."""
        return ts if self.shard is None else self.shard.sum(*ts)

    def _max(self, *ts):
        return ts if self.shard is None else self.shard.max(*ts)

    def _sum_ds(self, *pairs):
        """Double-single (hi, lo) sums over this process's samples -> the
        compensated sums over all M (SampleShard.ds_sum)."""
        return pairs if self.shard is None else self.shard.ds_sum(*pairs)

    # -- pieces ------------------------------------------------------------
    def _split_z(self, z):
        n, M = self.st.n, self.Ml
        return z[:n], z[n : n + M], z[n + M], z[n + M + 1]

    def _split_w(self, w):
        st, M = self.st, self.Ml
        o = st.n_fc
        w_f = w[:o]
        w_c = w[o]
        o += 1
        w_y = w[o : o + M]
        o += M
        w_G = w[o : o + M * st.K].reshape(M, st.K)
        o += M * st.K
        w_s = w[o]
        o += 1
        w_u = w[o:]
        return w_f, w_c, w_y, w_G, w_s, w_u

    # -- ADMM operator interface ------------------------------------------
    def matvec_P(self, z):
        return self.p_diag * z

    def matvec_A(self, z):
        sc, m = self.scales, self.m
        u, y, s, t = self._split_z(z)
        r_final = self.data.F @ u
        # CVaR row: sum(y) + s + M*alpha*t <= 0 — the reference's column
        # range n_u*S..-2 INCLUSIVE covers the slack column
        # (car/driving.py:341-342, drone/drone_risk.py:336-337)
        (sum_y,) = self._sum(torch.sum(y))
        r_c = sc.c * (sum_y + s + self.Malpha * t)
        r_y = sc.y * (-y - s)
        Gu = sweep_matmul(self.data.G, u, self.sweep_precision)
        r_G = sc.g * m * (Gu - sc.gy * (y[:, None] + t))
        r_s = sc.s * (-s)
        return torch.cat(
            [r_final, r_c[None], r_y, r_G.reshape(-1), r_s[None], u]
        )

    def rmatvec_A(self, w):
        st, sc, m = self.st, self.scales, self.m
        w_f, w_c, w_y, w_G, w_s, w_u = self._split_w(w)
        wG = sc.g * m * w_G  # (M, K) effective sample-row weights
        G = self.data.G
        row_sums = torch.sum(wG, dim=1)  # (M,)
        sweep, sum_yw, sum_rows = self._sum(
            sweep_matmul(wG.reshape(-1), G.reshape(-1, st.n),
                         self.sweep_precision),
            torch.sum(sc.y * w_y), torch.sum(row_sums))
        u_part = self.data.F.T @ w_f + sweep + w_u
        y_part = sc.c * w_c - sc.y * w_y - sc.gy * row_sums
        s_part = sc.c * w_c - sum_yw - sc.s * w_s
        t_part = sc.c * self.Malpha * w_c - sc.gy * sum_rows
        return torch.cat([u_part, y_part, s_part[None], t_part[None]])

    # -- Ruiz structural norms --------------------------------------------
    def row_inf_norms(self, D):
        """max_j |A_ij| D_j per row, segment-wise without materializing A."""
        sc, m = self.scales, self.m
        D_u, D_y, D_s, D_t = self._split_z(D)
        r_final = torch.amax(torch.abs(self.data.F) * D_u[None, :], dim=1)
        (max_Dy,) = self._max(torch.amax(D_y))
        r_c = sc.c * torch.maximum(
            torch.maximum(max_Dy, D_s), self.Malpha * D_t
        )
        r_y = sc.y * torch.maximum(D_y, D_s)
        gu = torch.amax(torch.abs(self.data.G) * D_u[None, None, :], dim=2)
        r_G = sc.g * m * torch.maximum(
            gu, sc.gy * torch.maximum(D_y[:, None], D_t)
        )
        r_s = sc.s * D_s
        return torch.cat(
            [r_final, r_c[None], r_y, r_G.reshape(-1), r_s[None], D_u]
        )

    def col_inf_norms(self, E):
        """max_i E_i |A_ij| per column, segment-wise."""
        sc, m = self.scales, self.m
        E_f, E_c, E_y, E_G, E_s, E_u = self._split_w(E)
        max_GE, max_yE, max_EG = self._max(
            torch.amax(torch.abs(self.data.G) * E_G[:, :, None], dim=(0, 1)),
            torch.amax(sc.y * E_y), torch.amax(E_G))
        c_u = torch.maximum(
            torch.amax(torch.abs(self.data.F) * E_f[:, None], dim=0),
            torch.maximum(sc.g * m * max_GE, E_u),
        )
        c_y = torch.maximum(
            sc.c * E_c,
            torch.maximum(sc.y * E_y,
                          sc.g * m * sc.gy * torch.amax(E_G, dim=1)),
        )
        c_s = torch.maximum(
            sc.c * E_c, torch.maximum(max_yE, sc.s * E_s)
        )
        c_t = torch.maximum(
            sc.c * self.Malpha * E_c, sc.g * m * sc.gy * max_EG
        )
        return torch.cat([c_u, c_y, c_s[None], c_t[None]])

    def col_inf_norms_P(self, D):
        return self.p_diag * D  # P is diagonal

    # -- KKT factorization: Schur complement over samples ------------------
    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        """Factor N = c*P + diag(sigma) + A^T R A by eliminating the y-block.

        y-block: N_yy = D + beta * 11^T with
          D_i = sigma_y_i + rho_y_i*sc_y_i^2 + gy^2 m^2 sum_k rho_G_ik
          beta = rho_c * sc_c^2
        The coupled block v = (u, s, t) is solved densely after the
        Sherman-Morrison elimination of y.

        Compensated formation (saa_qp.py:424-516 of the JAX package): every
        reduction over the M sample axis is a double-single pairwise sum;
        the per-sample contractions over K stay plain (K ~ 60 terms, a few
        ulps), it is the M = 1000-term accumulation that compensation
        removes. Cost: one (M, n, n) intermediate and log2(M) folds, paid
        at refactorization only. Sharded, each process forms its samples'
        terms and the sums over M are two collectives: B, the u-t coupling
        and the diagonal sums (n^2 + n + 2 entries), then C^T Dinv C
        ((n+2)^2) and the Sherman-Morrison sums (n + 4)."""
        st, sc, m = self.st, self.scales, self.m
        data = self.data
        n, M = st.n, self.Ml
        rho_f, rho_c, rho_y, rho_G, rho_s, rho_u = self._split_w(rho_vec)
        sigma_u, sigma_y, sigma_s, sigma_t = self._split_z(sigma_vec)
        dtype, device = self.dtype, self.device
        comp = self.factorize_compensated

        def msum(x):
            """Sum over the leading M axis (compensated when enabled)."""
            if comp:
                return dsjit.ds_round(*dsjit.sum1_ds(x, axis=0))
            return torch.sum(x, dim=0)

        g2 = (sc.g * m) ** 2  # effective squared sample-row scale
        wG = g2 * rho_G  # (M, K)
        rowsum_wG = torch.sum(wG, dim=1)  # (M,)

        # --- y block ---
        D = sigma_y + rho_y * sc.y**2 + sc.gy**2 * rowsum_wG  # (M,)
        beta = rho_c * sc.c**2

        # --- coupled block N_vv (v = [u, s, t]) ---
        if comp:
            B = msum(torch.einsum("mkn,mk,mkp->mnp", data.G, wG, data.G))
        else:
            B = torch.einsum("mkn,mk,mkp->np", data.G, wG, data.G)
        # per-sample rows G_i^T wG_i (M, n): reduced over M for the u-t
        # coupling, kept per-sample as the y-v coupling C_u below
        GtwG = torch.einsum("mkn,mk->mn", data.G, wG)
        B, sum_GtwG, sum_y2, sum_rows = self._sum(
            B, msum(GtwG), msum(rho_y * sc.y**2), msum(rowsum_wG))
        N_uu = (
            torch.diag(cost_scale * self.p_diag[:n] + sigma_u + rho_u)
            + data.F.T @ (rho_f[:, None] * data.F)
            + B
        )
        N_ut = -sc.gy * sum_GtwG
        # ss: sigma_s + c*P_ss + sum_i rho_y sc_y^2 + rho_s sc_s^2 + beta
        N_ss = (
            cost_scale * self.p_diag[n + M]
            + sigma_s
            + sum_y2
            + rho_s * sc.s**2
            + beta
        )
        N_tt = sigma_t + beta * self.Malpha**2 + sc.gy**2 * sum_rows
        N_st = beta * self.Malpha

        N_vv = torch.zeros(n + 2, n + 2, dtype=dtype, device=device)
        N_vv[:n, :n] = N_uu
        N_vv[:n, n + 1] = N_ut
        N_vv[n + 1, :n] = N_ut
        N_vv[n, n] = N_ss
        N_vv[n, n + 1] = N_st
        N_vv[n + 1, n] = N_st
        N_vv[n + 1, n + 1] = N_tt

        # --- y-v coupling C (M, n+2): row i = [C_u_i | C_s_i | C_t_i] ---
        C_u = -sc.gy * GtwG
        C_s = (rho_y * sc.y**2 + beta)[:, None]
        C_t = (beta * self.Malpha + sc.gy**2 * rowsum_wG)[:, None]
        C = torch.cat([C_u, C_s, C_t], dim=1)

        # --- Schur complement S = N_vv - C^T Nyy^-1 C via Sherman-Morrison ---
        if self.free_y:
            S, denom_yy = self._schur_free(N_vv, C, D, beta)
        else:
            Dinv = 1.0 / D
            DinvC = Dinv[:, None] * C
            if comp:
                p, e = dsjit.two_prod(C[:, :, None], DinvC[:, None, :])
                CtDinvC = dsjit.ds_round(*dsjit.ds_sum(p, e, axis=0))
            else:
                CtDinvC = C.T @ DinvC
            (CtDinvC,) = self._sum(CtDinvC)
            # the Sherman-Morrison denominator of the y-block solves is
            # loop-invariant per factorization (a plain sum, as in JAX)
            one_DinvC, sum_Dinv, sum_Dinv_yy = self._sum(
                msum(DinvC), msum(Dinv), torch.sum(Dinv))
            denom = 1.0 + beta * sum_Dinv
            S = N_vv - (CtDinvC
                        - (beta / denom) * torch.outer(one_DinvC, one_DinvC))
            denom_yy = 1.0 + beta * sum_Dinv_yy
        chol_S = _jittered_cholesky(S)
        if self.kkt_chol_inverse:
            eye_v = torch.eye(n + 2, dtype=dtype, device=device)
            t1 = torch.linalg.solve_triangular(chol_S, eye_v, upper=False)
            S_op = torch.linalg.solve_triangular(chol_S.T, t1, upper=True)
        else:
            S_op = chol_S
        return (S_op, C, D, beta, N_vv, denom_yy)

    def _schur_free(self, N_vv, C, D, beta):
        """S and the Sherman-Morrison denominator where some y meets the
        CVaR row alone (free_y): its D is sigma alone (Dinv = 1/sigma ~ 1e6),
        and C^T Dinv C and the Sherman-Morrison term cancel to a result 1e6
        times smaller than either. Both are formed in float64 from the
        values the iteration applies (C, D and beta as stored), and S is
        rounded to the working type; kkt_solve runs the y-block solves in
        float64 too. In float64 this is the ordinary arithmetic."""
        f64 = torch.float64
        C64, beta64 = C.to(f64), beta.to(f64)
        Dinv = 1.0 / D.to(f64)
        DinvC = Dinv[:, None] * C64
        (CtDinvC,) = self._sum(C64.T @ DinvC)
        one_DinvC, sum_Dinv = self._sum(torch.sum(DinvC, dim=0),
                                        torch.sum(Dinv))
        denom = 1.0 + beta64 * sum_Dinv
        S = N_vv.to(f64) - (CtDinvC - (beta64 / denom)
                            * torch.outer(one_DinvC, one_DinvC))
        return S.to(self.dtype), denom

    def _solve_yy(self, D, beta, r, denom):
        """(D + beta 11^T)^-1 r via Sherman-Morrison."""
        Dinv_r = r / D
        (sum_Dinv_r,) = self._sum(torch.sum(Dinv_r))
        return Dinv_r - (beta * sum_Dinv_r / denom) / D

    def kkt_solve(self, factor, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        S_op, C, D, beta, N_vv, denom_yy = factor
        n, M = self.st.n, self.Ml
        r_y = rhs[n : n + M]
        r_v = torch.cat([rhs[:n], rhs[n + M :]])

        # the y-block elimination in float64 where some y meets the CVaR
        # row alone (see _schur_free); else the casts are no-ops
        wt = torch.float64 if self.free_y else self.dtype
        C_w, D_w, beta_w, S_w = C.to(wt), D.to(wt), beta.to(wt), S_op.to(wt)

        def solve_once(r_v, r_y):
            r_v, r_y = r_v.to(wt), r_y.to(wt)
            Nyy_inv_ry = self._solve_yy(D_w, beta_w, r_y, denom_yy)
            (CtN,) = self._sum(C_w.T @ Nyy_inv_ry)
            rhs_v = r_v - CtN
            if self.kkt_chol_inverse:
                v = S_w @ rhs_v  # S_op = S^-1 (see factorize)
            else:
                t1 = _solve_triangular_vec(S_w, rhs_v, upper=False)
                v = _solve_triangular_vec(S_w.T, t1, upper=True)
            y = self._solve_yy(D_w, beta_w, r_y - C_w @ v, denom_yy)
            return v.to(self.dtype), y.to(self.dtype)

        def residual_true(x):
            return rhs - (
                cost_scale * self.matvec_P(x)
                + sigma_vec * x
                + self.rmatvec_A(rho_vec * self.matvec_A(x))
            )

        def residual_factored(v, y):
            # N x through the stored blocks: N = [[N_vv, C^T], [C, D+b11^T]]
            Cty, sum_y = self._sum(C.T @ y, torch.sum(y))
            Nx_v = N_vv @ v + Cty
            Nx_y = C @ v + D * y + beta * sum_y
            return torch.cat([r_v - Nx_v, r_y - Nx_y])

        v, y = solve_once(r_v, r_y)
        x = torch.cat([v[:n], y, v[n:]])
        for _ in range(self.kkt_refine_iters):
            if self.kkt_refine_mode == "factored":
                rf = residual_factored(torch.cat([x[:n], x[n + M :]]),
                                       x[n : n + M])
                res_v, res_y = rf[: n + 2], rf[n + 2 :]
            else:
                res = residual_true(x)
                res_v = torch.cat([res[:n], res[n + M :]])
                res_y = res[n : n + M]
            dv, dy = solve_once(res_v, res_y)
            x = x + torch.cat([dv[:n], dy, dv[n:]])
        return x


def _jittered_cholesky(S):
    """Cholesky of S, escalating a trace-scaled jitter while it fails
    (saa_qp.py:517-534): the Schur subtraction can lose positive
    definiteness to roundoff under extreme penalty weights. Like the JAX
    factor, a factor that still fails at jitter 1e-1 is all NaN."""
    dtype = S.dtype
    n = S.shape[0]
    eye = torch.eye(n, dtype=dtype, device=S.device)
    scale = torch.mean(torch.diagonal(S))
    jit_f = 1e-7 if dtype == torch.float32 else 0.0
    chol, info = torch.linalg.cholesky_ex(S + jit_f * scale * eye)
    while int(info) != 0 and jit_f < 1e-1:
        jit_f = max(jit_f * 100.0, 1e-6)
        chol, info = torch.linalg.cholesky_ex(S + jit_f * scale * eye)
    if int(info) != 0:
        chol = torch.full_like(chol, float("nan"))
    return chol


def make_ops(st: SAAQPStatic, data: SAAQPData, scp_iter: int,
             cfg: SolverConfig, shard=None) -> SAAQPOps:
    """SAAQPOps carrying cfg's KKT and sweep knobs (solve_saa_qp's
    construction)."""
    return SAAQPOps(
        st, data, scp_iter, kkt_refine_iters=cfg.kkt_refine_iters,
        kkt_refine_mode=cfg.kkt_refine_mode,
        sweep_precision=cfg.sweep_precision,
        kkt_chol_inverse=cfg.kkt_chol_inverse, shard=shard,
    )


def gather_warm(st: SAAQPStatic, shard, x, w):
    """The global x = [u | y (M) | s | t] and w = [final | CVaR | y rows (M)
    | sample rows (M*K) | slack | u] from this process's share of a
    sample-sharded QP's vectors (every process's samples at its offset; two
    all-reduces, none larger than M*K)."""
    n, K, o, Ml = st.n, st.K, st.n_fc + 1, shard.M_local
    g = o + Ml + Ml * K  # the end of this process's sample rows
    y = shard.gather(torch.stack([x[n:n + Ml], w[o:o + Ml]], dim=1))
    rows = shard.gather(w[o + Ml:g].reshape(Ml, K))
    return (torch.cat([x[:n], y[:, 0], x[n + Ml:]]),
            torch.cat([w[:o], y[:, 1], rows.reshape(-1), w[g:]]))


def local_warm(st: SAAQPStatic, shard, x, w):
    """This process's share of global vectors x and w (gather_warm's
    inverse)."""
    n, K, o, M = st.n, st.K, st.n_fc + 1, st.M
    a, b = shard.offset, shard.offset + shard.M_local
    return (torch.cat([x[:n], x[n + a:n + b], x[n + M:]]),
            torch.cat([w[:o], w[o + a:o + b],
                       w[o + M + a * K:o + M + b * K], w[o + M + M * K:]]))


def solve_saa_qp(
    st: SAAQPStatic,
    data: SAAQPData,
    scp_iter: int,
    cfg: SolverConfig,
    x0=None,
    y0=None,
    scale: bool = True,
    ruiz_iters: int = 5,
    rho0=None,
    eps_scale=None,
    shard=None,
) -> admm.QPSolution:
    """Solve one SCP subproblem with the structured operator (under
    `shard`, this process's share of a sample-sharded one: x, y and z hold
    its entries, the replicated ones identical on every process)."""
    ops = make_ops(st, data, scp_iter, cfg, shard)
    _, q = build_objective(st, data)
    l, u = build_bounds(st, data, scp_iter, shard)
    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters) if scale else None
    return admm.admm_solve(ops, q, l, u, cfg, x0=x0, y0=y0, scaling=scaling,
                           rho0=rho0, eps_scale=eps_scale)
