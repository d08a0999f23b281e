"""Nonlinear-programming interior-point solver (an IPOPT-like barrier
method).

The counterpart of ``riskaversetrajopt_tpu/ops/nlp_ipm.py``, which replaces
the reference's IPOPT for the hopper's direct transcription
(hopper/hopper.py:646-669) and the drone's Gaussian NLP
(drone/drone_gaussian.py:503-526). Problem form:

    min f(Z)   s.t.  gL <= g(Z) <= gU   (first n_eq rows equalities),
                     xL <= Z <= xU

Box bounds are folded in as identity constraint rows after the g rows;
inequality rows get slacks with log barriers on their finite sides. Each
barrier iteration solves the augmented (indefinite) Newton system

    [[H + tau I,  J^T  ]  [dZ]   [-r_d            ]
     [J,          block]] [dy] = [-r_eq | v / D   ]

(block: -1e-8 on the equality rows, -1/D on the inequality rows) by LU with
one step of iterative refinement, and takes a fraction-to-boundary step
accepted by backtracking Armijo on the barrier merit
phi = f - mu sum(log s) + nu ||constraint residuals||_1, with an adaptive
regularization tau and penalty nu. H is the exact Hessian of the Lagrangian
and J the Jacobian of the constraints: one ``torch.func.jacfwd`` of the
Lagrangian's gradient (``torch.func.hessian``'s forward-over-reverse) gives
both, the gradient itself being the dual residual.

The barrier loop and the backtracking are Python loops (JAX: two
``lax.while_loop``s): one host read decides each trial step and one ends
each iteration. `f` and `g` must be functional for ``torch.func``: no
in-place writes to tensors that depend on Z, no ``.item()``, no branch on
values. The compensated options (`merit_compensated`,
`kkt_ds_refine_iters`) run on ``ops/dsjit.py``: eagerly, never under
``torch.compile``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jacfwd
from torch.utils._pytree import tree_map

from riskaversetrajopt_torch.ops import dsjit


class NLPConfig(NamedTuple):
    """Field for field ``riskaversetrajopt_tpu/ops/nlp_ipm.py:NLPConfig``
    (its comments explain each knob)."""

    tol: float = 1e-6
    max_iter: int = 300
    mu_init: float = 1e-1
    kappa_mu: float = 0.2  # IPOPT linear mu decrease factor
    theta_mu: float = 1.5  # IPOPT superlinear mu exponent
    kappa_eps: float = 10.0  # barrier-problem tolerance = kappa_eps * mu
    tau_min: float = 0.99  # fraction-to-boundary floor
    bound_push: float = 1e-2  # initial point push-off from bounds
    tau_reg_init: float = 1e-8
    tau_reg_max: float = 1e6
    max_backtracks: int = 12
    nu_init: float = 1.0
    nu_margin: float = 10.0
    # IPOPT gradient-based scaling: f and each g row scaled so that their
    # first derivatives at Z0 are at most this
    scaling_max_gradient: float = 100.0
    # 'loqo' (adaptive, IPOPT mu_oracle=loqo) or 'monotone'
    # (Fiacco-McCormick)
    mu_strategy: str = "loqo"
    # symmetric Ruiz sweeps on the augmented KKT matrix before the LU
    # (float32 hardening; 0 = off)
    kkt_ruiz_iters: int = 0
    # line-search merit and its decrement in double-single arithmetic
    # (float32 hardening)
    merit_compensated: bool = False
    # compensated iterative-refinement rounds on the KKT solve (float32
    # hardening; use with kkt_ruiz_iters)
    kkt_ds_refine_iters: int = 0
    # cap the primal step at damp_max for the first damp_iters iterations
    damp_iters: int = 0
    damp_max: float = 0.1
    # second-order correction of a rejected full step (IPOPT sec 2.4)
    soc: bool = False


class NLPResult(NamedTuple):
    Z: torch.Tensor
    y_eq: torch.Tensor
    lam_l: torch.Tensor
    lam_u: torch.Tensor
    iters: int
    prim_res: torch.Tensor
    dual_res: torch.Tensor
    comp_res: torch.Tensor
    solved: bool
    f_val: torch.Tensor


# the per-iteration diagnostics `solve_nlp.last_trace` holds after a call
# with trace_iters > 0, in the order of the JAX package's trace tuple
TRACE_FIELDS = ("prim", "dual", "comp", "mu", "tau_reg", "nu", "a_p", "ok",
                "d_tau_used", "d_maxD", "d_minsl", "d_dynorm", "d_theta")


class _S(NamedTuple):
    Z: torch.Tensor
    y_eq: torch.Tensor
    s_l: torch.Tensor
    s_u: torch.Tensor
    lam_l: torch.Tensor
    lam_u: torch.Tensor
    mu: torch.Tensor
    tau_reg: torch.Tensor
    nu: torch.Tensor
    it: int
    prim: torch.Tensor
    dual: torch.Tensor
    comp: torch.Tensor
    done: bool
    a_p: torch.Tensor  # diagnostics: last primal step length
    ok: bool  # diagnostics: last line-search success
    d_tau_used: torch.Tensor
    d_maxD: torch.Tensor
    d_minsl: torch.Tensor
    d_dynorm: torch.Tensor
    d_theta: torch.Tensor


def _to_numpy(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def classify_rows(g_L, g_U, n_eq: int):
    """The equality-row reclassification permutation, on the host.

    IPOPT treats any row with gL == gU as an equality; rows such as the
    hopper's flight-phase contact-force pins (l = u = 0 among the
    inequalities, hopper.py:416-421) would otherwise make the slack barrier
    infeasible. Returns (perm, n_eq): the equality rows first, in order,
    then the others."""
    gLn = _to_numpy(g_L)
    gUn = _to_numpy(g_U)
    eq_mask = (gUn - gLn) <= 1e-12
    eq_mask[:n_eq] = True
    perm = np.concatenate([np.where(eq_mask)[0], np.where(~eq_mask)[0]])
    return perm, int(eq_mask.sum())


def _max0(x):
    """max(x), 0 for an empty x (jnp.max(..., initial=0.0) of |.|)."""
    return torch.amax(x) if x.numel() else x.new_zeros(())


def _min_inf(x):
    """min(x), inf for an empty x (jnp.min(..., initial=inf))."""
    return torch.amin(x) if x.numel() else x.new_full((), float("inf"))


def _nanmin(x):
    """min over the non-NaN entries; NaN when every entry is NaN."""
    nan = torch.isnan(x)
    m = torch.amin(torch.where(nan, float("inf"), x))
    return torch.where(torch.all(nan), float("nan"), m)


def _graphed(fn, *args):
    """fn captured once in a CUDA graph at the shapes and dtypes of args:
    each call copies its arguments into the graph's inputs and replays it,
    so the thousands of small kernels of a torch.func evaluation launch
    without the host's cost per operation. The kernels are the eager
    ones, in the same order; the outputs are cloned out of the graph's
    buffers. fn must not synchronize with the host."""
    static = [a.clone() for a in args]
    side = torch.cuda.Stream(device=static[0].device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)  # one eager run first: lazy initialisations
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)

    def call(*a):
        for dst, src in zip(static, a):
            dst.copy_(src)
        graph.replay()
        return tree_map(torch.clone, out)

    return call


def solve_nlp(
    f_fn: Callable,
    g_fn: Callable,
    g_L,
    g_U,
    n_eq: int,
    x_L,
    x_U,
    Z0: torch.Tensor,
    cfg: NLPConfig = NLPConfig(),
    trace_iters: int = 0,
    params=None,
    row_perm=None,
    cuda_graphs: bool = True,
) -> NLPResult:
    """Solve the NLP from the initial guess Z0 (on Z0's device, in Z0's
    dtype; the bounds may be tensors or arrays and are converted to both).

    With `params`, the callbacks are called as ``f_fn(Z, params)`` and
    ``g_fn(Z, params)``. `row_perm` is a precomputed
    ``classify_rows(g_L, g_U, n_eq)``. With `trace_iters` > 0 exactly that
    many iterations run (an iteration after convergence leaves the state
    as it is, and max_iter is not read), and ``solve_nlp.last_trace`` holds
    one (trace_iters,) tensor per name of TRACE_FIELDS.

    On the card (Z0 on a CUDA device, `cuda_graphs` True) the evaluation
    at each new point and the merit at each trial point replay CUDA
    graphs captured at the first call (`_graphed`): the same kernels,
    launched without the host's cost per operation."""
    if params is not None:
        f_user, g_user = f_fn, g_fn
        f_fn = lambda Z: f_user(Z, params)  # noqa: E731
        g_fn = lambda Z: g_user(Z, params)  # noqa: E731
    dtype, device = Z0.dtype, Z0.device
    kw = dict(dtype=dtype, device=device)
    n = Z0.shape[0]

    def as_t(a):
        return (a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
                ).to(**kw)

    # -- reclassify zero-gap rows as equalities (see classify_rows) --------
    perm, n_eq = (classify_rows(g_L, g_U, n_eq) if row_perm is None
                  else row_perm)
    perm_t = torch.as_tensor(np.asarray(perm), dtype=torch.long,
                             device=device)
    m_g = int(perm_t.shape[0])
    g_orig = g_fn
    g_fn = lambda Z: g_orig(Z)[perm_t]  # noqa: E731
    g_L = as_t(g_L)[perm_t]
    g_U = as_t(g_U)[perm_t]
    x_L, x_U = as_t(x_L), as_t(x_U)

    # -- IPOPT gradient-based problem scaling at Z0 ------------------------
    g_max = cfg.scaling_max_gradient
    gf0 = grad(f_fn)(Z0)
    scale_f = torch.clamp(
        g_max / torch.clamp(torch.amax(torch.abs(gf0)), min=1e-8), max=1.0)
    if m_g > 0:
        row_norms0 = torch.amax(torch.abs(jacfwd(g_fn)(Z0)), dim=1)
        row_scale = torch.clamp(g_max / torch.clamp(row_norms0, min=1e-8),
                                max=1.0)
    else:
        row_scale = torch.zeros(0, **kw)
    f_raw, g_raw = f_fn, g_fn
    f_fn = lambda Z: (scale_f * f_raw(Z)).to(dtype)  # noqa: E731
    g_L = torch.where(torch.abs(g_L) < 1e14, row_scale * g_L, g_L)
    g_U = torch.where(torch.abs(g_U) < 1e14, row_scale * g_U, g_U)

    # box bounds folded in as identity rows after the g rows, in Z0's dtype
    def c_fn(Z):
        return torch.cat([(row_scale * g_raw(Z)).to(dtype), Z])

    c_L = torch.cat([g_L, x_L])
    c_U = torch.cat([g_U, x_U])
    m = m_g + n

    b_eq = c_L[:n_eq]
    l_in = c_L[n_eq:]
    u_in = c_U[n_eq:]
    has_l = l_in > -1e14  # the reference's -1e15 is "no bound"
    has_u = u_in < 1e14

    def lagrangian_grad(Z, y_eq, lam_in):
        """(grad_Z L, c) with L = f + y_eq.c_eq + lam_in.c_in, twice: once
        to differentiate (the gradient's jacfwd is the Hessian of L,
        torch.func.hessian's forward-over-reverse, and c's is the
        constraint Jacobian, in one pass) and once as jacfwd's aux (the
        values)."""
        def lag(Z):
            c = c_fn(Z)
            return (f_fn(Z) + torch.dot(y_eq, c[:n_eq])
                    + torch.dot(lam_in, c[n_eq:])), c

        out = grad(lag, has_aux=True)(Z)
        return out, out

    jac_lag = jacfwd(lagrangian_grad, has_aux=True)

    grad_f = grad(f_fn)

    def evaluate(Z, y_eq, lam_l, lam_u):
        """What every error and direction at (Z, multipliers) reads: the
        constraint values c, their Jacobian J, the dual residual
        r_d = grad f + J_eq^T y_eq + J_in^T (lam_u - lam_l) and the
        Lagrangian's Hessian H."""
        (H, J), (_, c) = jac_lag(Z, y_eq, lam_u - lam_l)
        r_d = grad_f(Z) + J[:n_eq].T @ y_eq + J[n_eq:].T @ (lam_u - lam_l)
        return c, J, r_d, H

    # -- initial point ------------------------------------------------------
    inf = float("inf")
    push = cfg.bound_push * torch.clamp(torch.abs(x_L), min=1.0)
    Z_init = torch.clamp(
        Z0,
        torch.where(x_L > -1e14, x_L + push, -inf),
        torch.where(x_U < 1e14,
                    x_U - cfg.bound_push * torch.clamp(torch.abs(x_U), min=1.0),
                    inf),
    )
    c0 = c_fn(Z_init)[n_eq:]
    s_l0 = torch.where(has_l, torch.clamp(c0 - l_in, min=cfg.bound_push), 1.0)
    s_u0 = torch.where(has_u, torch.clamp(u_in - c0, min=cfg.bound_push), 1.0)
    # centred multipliers lam = mu/s: the initial complementarity residual
    # is zero even for huge slacks (the hopper's 1e6 slack bound)
    lam_l0 = torch.where(has_l, cfg.mu_init / s_l0, 0.0)
    lam_u0 = torch.where(has_u, cfg.mu_init / s_u0, 0.0)
    mu0 = torch.tensor(cfg.mu_init, **kw)
    nu0 = torch.tensor(cfg.nu_init, **kw)

    def kkt_errors(ev, y_eq, s_l, s_u, lam_l, lam_u):
        """The residuals at a point (ev: evaluate() at its Z and
        multipliers); comp(mu) is the complementarity error with target
        mu."""
        c, _, r_d, _ = ev
        r_eq = c[:n_eq] - b_eq
        ci = c[n_eq:]
        r_l = torch.where(has_l, ci - s_l - l_in, 0.0)
        r_u = torch.where(has_u, u_in - ci - s_u, 0.0)
        prod_l, prod_u = s_l * lam_l, s_u * lam_u

        def comp(mu):
            return torch.maximum(
                torch.amax(torch.abs(torch.where(has_l, prod_l - mu, 0.0))),
                torch.amax(torch.abs(torch.where(has_u, prod_u - mu, 0.0))))

        # IPOPT's scaling s_d of the dual residual
        lam_sum = (torch.sum(torch.abs(lam_l)) + torch.sum(torch.abs(lam_u))
                   + torch.sum(torch.abs(y_eq)))
        s_d = torch.clamp(lam_sum / max(m, 1), min=100.0) / 100.0
        prim = torch.maximum(
            _max0(torch.abs(r_eq)),
            torch.maximum(torch.amax(torch.abs(r_l)),
                          torch.amax(torch.abs(r_u))))
        dual = torch.amax(torch.abs(r_d)) / s_d
        return r_eq, r_l, r_u, r_d, prim, dual, comp

    def merit(Z, s_l, s_u, mu, nu, c=None):
        """((phi_hi, phi_lo), theta); phi_lo is zero unless
        cfg.merit_compensated, where the sums are double-single. `c` is
        c_fn(Z) where the caller has it."""
        c = c_fn(Z) if c is None else c
        logs_l = torch.where(has_l, torch.log(torch.clamp(s_l, min=1e-300)),
                             0.0)
        logs_u = torch.where(has_u, torch.log(torch.clamp(s_u, min=1e-300)),
                             0.0)
        t_eq = torch.abs(c[:n_eq] - b_eq)
        t_l = torch.abs(torch.where(has_l, c[n_eq:] - s_l - l_in, 0.0))
        t_u = torch.abs(torch.where(has_u, u_in - c[n_eq:] - s_u, 0.0))
        if not cfg.merit_compensated:
            barrier = -mu * (torch.sum(logs_l) + torch.sum(logs_u))
            theta = torch.sum(t_eq) + torch.sum(t_l) + torch.sum(t_u)
            return (f_fn(Z) + barrier + nu * theta,
                    torch.zeros_like(barrier)), theta
        bh, bl = dsjit.ds_add(*dsjit.sum1_ds(logs_l), *dsjit.sum1_ds(logs_u))
        bh, bl = dsjit.ds_scale(bh, bl, -mu)
        th, tl = dsjit.ds_add(*dsjit.sum1_ds(t_eq), *dsjit.ds_add(
            *dsjit.sum1_ds(t_l), *dsjit.sum1_ds(t_u)))
        nh, nl = dsjit.ds_scale(th, tl, nu)
        ph, pl = dsjit.ds_add(bh, bl, nh, nl)
        ph, pl = dsjit.ds_add(ph, pl, f_fn(Z), torch.zeros_like(ph))
        return (ph, pl), th

    def body(s: _S, ev):
        """One barrier iteration from state s (ev: evaluate() at s);
        returns the new state and evaluate() at it."""
        r_eq, r_l, r_u, r_d, _, _, _ = kkt_errors(
            ev, s.y_eq, s.s_l, s.s_u, s.lam_l, s.lam_u)
        _, J, _, H = ev
        J_in = J[n_eq:]
        H = 0.5 * (H + H.T)

        w_l = torch.where(has_l, s.lam_l / s.s_l, 0.0)
        w_u = torch.where(has_u, s.lam_u / s.s_u, 0.0)
        D = w_l + w_u

        # complementarity residuals of the centred step
        r_cl = torch.where(has_l, s.s_l * s.lam_l - s.mu, 0.0)
        r_cu = torch.where(has_u, s.s_u * s.lam_u - s.mu, 0.0)
        v = (torch.where(has_u, r_cu / s.s_u, 0.0) + w_u * r_u
             - torch.where(has_l, r_cl / s.s_l, 0.0) - w_l * r_l)

        # the augmented KKT matrix (rows: dy_i = D_i (J_i dZ) - v_i,
        # rearranged to J_i dZ - dy_i / D_i = v_i / D_i; loose rows D = 0
        # read -1/eps and pin dy ~ 0)
        D_safe = torch.clamp(D, 1e-20, 1e20)
        diag_block = torch.cat([torch.full((n_eq,), -1e-8, **kw),
                                -1.0 / D_safe])
        rhs_rows = torch.cat([-r_eq, v / D_safe])
        tau_used = s.tau_reg
        K = torch.cat([
            torch.cat([H + tau_used * torch.eye(n, **kw), J.T], dim=1),
            torch.cat([J, torch.diag(diag_block)], dim=1),
        ])
        d_eq, Ks = None, K
        if cfg.kkt_ruiz_iters > 0:
            # symmetric Ruiz: d K d -> unit row inf-norms
            d_eq = torch.ones(n + m, **kw)
            for _ in range(cfg.kkt_ruiz_iters):
                rn = torch.amax(torch.abs(Ks), dim=1)
                d_new = 1.0 / torch.sqrt(torch.clamp(rn, 1e-12, 1e12))
                d_eq = d_eq * d_new
                Ks = (d_new[:, None] * Ks) * d_new[None, :]
        # a singular matrix gives inf/NaN directions that the line search
        # rejects (jax.scipy.linalg.lu_factor does not raise either)
        lu, piv, _ = torch.linalg.lu_factor_ex(Ks, check_errors=False)

        def lu_apply(r):
            if d_eq is None:
                return torch.linalg.lu_solve(lu, piv, r[:, None])[:, 0]
            # K x = r  <=>  (dKd)(d^-1 x) = d r
            return d_eq * torch.linalg.lu_solve(lu, piv,
                                                (d_eq * r)[:, None])[:, 0]

        def solve_kkt(rhs):
            sol = lu_apply(rhs)
            if cfg.kkt_ds_refine_iters <= 0:
                # one refinement step against the unscaled system
                return sol + lu_apply(rhs - K @ sol)
            # compensated refinement: ds residual, ds-accumulated solution
            sh, sl = sol, torch.zeros_like(sol)
            for _ in range(cfg.kkt_ds_refine_iters):
                kh, kl = dsjit.dot2(K, sh)
                kl = kl + K @ sl
                rh, rl = dsjit.ds_add(rhs, torch.zeros_like(rhs), -kh, -kl)
                corr = lu_apply(rh + rl)
                sh, sl = dsjit.ds_add(sh, sl, corr, torch.zeros_like(corr))
            return sh + sl

        tau_ftb = torch.clamp(1.0 - s.mu, min=cfg.tau_min)

        def max_step(vv, dv, mask):
            ratio = torch.where(mask & (dv < 0),
                                -vv / torch.where(dv < 0, dv, -1.0), inf)
            return torch.clamp(tau_ftb * _min_inf(ratio), max=1.0)

        def mk_dirs(sol):
            """The direction bundle of an augmented-KKT solution."""
            dZ = sol[:n]
            dy_eq = sol[n : n + n_eq]
            JdZ = J_in @ dZ
            ds_l = torch.where(has_l, JdZ + r_l, 0.0)
            ds_u = torch.where(has_u, r_u - JdZ, 0.0)
            dlam_l = torch.where(has_l, -(r_cl + s.lam_l * ds_l) / s.s_l, 0.0)
            dlam_u = torch.where(has_u, -(r_cu + s.lam_u * ds_u) / s.s_u, 0.0)
            a_p_max = torch.minimum(max_step(s.s_l, ds_l, has_l),
                                    max_step(s.s_u, ds_u, has_u))
            if s.it < cfg.damp_iters:
                a_p_max = torch.clamp(a_p_max, max=cfg.damp_max)
            a_d = torch.minimum(max_step(s.lam_l, dlam_l, has_l),
                                max_step(s.lam_u, dlam_u, has_u))
            return dZ, dy_eq, ds_l, ds_u, dlam_l, dlam_u, a_p_max, a_d

        dirs = mk_dirs(solve_kkt(torch.cat([-r_d, rhs_rows])))
        dZ, dy_eq, ds_l, ds_u, dlam_l, dlam_u, a_p_max, a_d = dirs

        # penalty update: nu dominates the multipliers (a non-finite trial
        # direction leaves it as it was)
        lam_norm = torch.maximum(
            _max0(torch.abs(dy_eq + s.y_eq)),
            torch.maximum(torch.amax(torch.abs(s.lam_l + dlam_l)),
                          torch.amax(torch.abs(s.lam_u + dlam_u))))
        nu = torch.where(torch.isfinite(lam_norm),
                         torch.maximum(s.nu, cfg.nu_margin * lam_norm), s.nu)

        # backtracking Armijo on the merit
        phi0, theta0 = merit(s.Z, s.s_l, s.s_u, s.mu, nu, c=ev[0])

        def try_alpha(a, dZ_, ds_l_, ds_u_):
            """Accept on merit decrease or violation decrease (one host
            read); the decrement is a DIFFERENCE so that the compensated
            mode resolves it below float32's resolution of the merit."""
            phi, theta = merit_at(s.Z + a * dZ_, s.s_l + a * ds_l_,
                                  s.s_u + a * ds_u_, s.mu, nu)
            if cfg.merit_compensated:
                dh, _ = dsjit.ds_add(phi[0], phi[1], -phi0[0], -phi0[1])
            else:
                dh = phi[0] - phi0[0]
            ok = torch.isfinite(phi[0]) & (
                (dh <= -1e-8 * a * torch.abs(phi0[0]))
                | (theta <= 0.99 * theta0))
            return bool(ok)

        ok = try_alpha(a_p_max, dZ, ds_l, ds_u)
        if cfg.soc and not ok:
            # second-order correction: one constraint evaluation at the
            # rejected trial point and one solve on the same factorization,
            # taken only if the corrected full step passes the line search
            ct = c_fn(s.Z + a_p_max * dZ)
            r_eq_soc = a_p_max * r_eq + (ct[:n_eq] - b_eq)
            d2 = mk_dirs(solve_kkt(torch.cat([-r_d, -r_eq_soc,
                                              v / D_safe])))
            if try_alpha(d2[6], d2[0], d2[2], d2[3]):
                dZ, dy_eq, ds_l, ds_u, dlam_l, dlam_u, a_p_max, a_d = d2
                ok = True

        a_p, k = a_p_max, 0
        while not ok and k < cfg.max_backtracks:
            a_p = a_p * 0.5
            ok = try_alpha(a_p, dZ, ds_l, ds_u)
            k += 1

        if ok:
            Z_new = s.Z + a_p * dZ
            s_l_new = torch.where(has_l, s.s_l + a_p * ds_l, 1.0)
            s_u_new = torch.where(has_u, s.s_u + a_p * ds_u, 1.0)
            lam_l_new = torch.where(has_l, s.lam_l + a_d * dlam_l, 0.0)
            lam_u_new = torch.where(has_u, s.lam_u + a_d * dlam_u, 0.0)
            y_eq_new = s.y_eq + a_d * dy_eq
            # IPOPT's kappa_sigma safeguard (eq. 16): each bound multiplier
            # within a factor 1e10 of mu/s
            k_sig = 1e10
            lam_l_new = torch.where(has_l, torch.clamp(
                lam_l_new, s.mu / (k_sig * s_l_new), k_sig * s.mu / s_l_new),
                0.0)
            lam_u_new = torch.where(has_u, torch.clamp(
                lam_u_new, s.mu / (k_sig * s_u_new), k_sig * s.mu / s_u_new),
                0.0)
            tau_reg = torch.clamp(tau_used / 3.0, min=cfg.tau_reg_init)
            ev = evaluate(Z_new, y_eq_new, lam_l_new, lam_u_new)
        else:
            # the line search failed: keep the iterate, raise the
            # regularization
            Z_new, s_l_new, s_u_new = s.Z, s.s_l, s.s_u
            lam_l_new, lam_u_new, y_eq_new = s.lam_l, s.lam_u, s.y_eq
            tau_reg = torch.clamp(torch.clamp(tau_used * 10.0, min=1e-6),
                                  max=cfg.tau_reg_max)

        _, _, _, _, prim0, dual0, comp = kkt_errors(
            ev, y_eq_new, s_l_new, s_u_new, lam_l_new, lam_u_new)
        err_mu = torch.maximum(prim0, torch.maximum(dual0, comp(s.mu)))
        if cfg.mu_strategy == "loqo":
            # LOQO's adaptive rule: mu follows the iterate's complementarity,
            # centring harder when the products are unbalanced
            prods = torch.cat([
                torch.where(has_l, s_l_new * lam_l_new, float("nan")),
                torch.where(has_u, s_u_new * lam_u_new, float("nan")),
            ])
            avg = torch.nanmean(prods)
            xi = _nanmin(prods) / torch.clamp(avg, min=1e-300)
            sigma_c = 0.1 * torch.clamp(
                0.05 * (1.0 - xi) / torch.clamp(xi, min=1e-6), max=2.0) ** 3
            mu_new = torch.clamp(sigma_c * avg, cfg.tol / 10.0, 1e2)
        else:
            # monotone Fiacco-McCormick (IPOPT eq. 7)
            mu_new = torch.where(
                err_mu <= cfg.kappa_eps * s.mu,
                torch.clamp(torch.minimum(cfg.kappa_mu * s.mu,
                                          s.mu ** cfg.theta_mu),
                            min=cfg.tol / 10.0),
                s.mu)
        mu_new = torch.where(torch.isfinite(mu_new), mu_new, s.mu)

        # convergence at mu -> 0: the errors with mu = 0 complementarity
        comp0 = comp(0.0)
        done = bool((torch.maximum(prim0, torch.maximum(dual0, comp0))
                     <= cfg.tol) | ~torch.isfinite(err_mu))
        return _S(
            Z=Z_new, y_eq=y_eq_new, s_l=s_l_new, s_u=s_u_new,
            lam_l=lam_l_new, lam_u=lam_u_new, mu=mu_new, tau_reg=tau_reg,
            nu=nu, it=s.it + 1, prim=prim0, dual=dual0, comp=comp0,
            done=done, a_p=a_p, ok=ok, d_tau_used=tau_used,
            d_maxD=torch.amax(D),
            d_minsl=_min_inf(torch.where(has_l, s.s_l, inf)),
            d_dynorm=_max0(torch.abs(dy_eq)), d_theta=theta0,
        ), ev

    merit_at = merit
    if device.type == "cuda" and cuda_graphs:
        evaluate = _graphed(evaluate, Z_init, torch.zeros(n_eq, **kw),
                            lam_l0, lam_u0)
        merit_at = _graphed(merit, Z_init, s_l0, s_u0, mu0, nu0)

    zero = torch.zeros((), **kw)
    s = _S(
        Z=Z_init, y_eq=torch.zeros(n_eq, **kw), s_l=s_l0, s_u=s_u0,
        lam_l=lam_l0, lam_u=lam_u0,
        mu=mu0, tau_reg=torch.tensor(cfg.tau_reg_init, **kw), nu=nu0, it=0,
        prim=torch.tensor(inf, **kw), dual=torch.tensor(inf, **kw),
        comp=torch.tensor(inf, **kw), done=False, a_p=zero, ok=True,
        d_tau_used=zero, d_maxD=zero, d_minsl=zero, d_dynorm=zero,
        d_theta=zero,
    )
    ev = evaluate(s.Z, s.y_eq, s.lam_l, s.lam_u)
    if trace_iters:
        rows = []
        for _ in range(trace_iters):
            if not s.done:
                s, ev = body(s, ev)
            rows.append([torch.as_tensor(getattr(s, f), device=device)
                         for f in TRACE_FIELDS])
        solve_nlp.last_trace = tuple(torch.stack(col) for col in zip(*rows))
    else:
        while not s.done and s.it < cfg.max_iter:
            s, ev = body(s, ev)

    return NLPResult(
        Z=s.Z, y_eq=s.y_eq, lam_l=s.lam_l, lam_u=s.lam_u, iters=s.it,
        prim_res=s.prim, dual_res=s.dual, comp_res=s.comp,
        solved=bool(torch.maximum(s.prim, torch.maximum(s.dual, s.comp))
                    <= cfg.tol),
        f_val=f_fn(s.Z),
    )
