"""Fused ADMM iterations of the structured SAA QP: host code and wrapper of
the hand-written Hopper kernel ``csrc/saa_admm.cu``.

The counterpart of ``riskaversetrajopt_tpu/ops/pallas/experimental/
saa_admm.py`` in the natural layout: the scaled Jacobian stack Gs is
(M, K, n), sample-row arrays are (M, K), per-sample arrays are (M,), and the
"small rows" are one vector [final (n_fc) | cvar | slack | control (n)]. The
TPU tile padding, the packed column slots and the lane masks are gone.

The scaled problem folds Ruiz D/E/c, the gating and the MULTIPLIER into
kernel-ready arrays (`scaled_structure`). The KKT solve (`kkt_solve`)
eliminates the y block by Sherman-Morrison with the column-scaled CVaR
rank-1 vector and applies the explicit inverse of the (n+2) Schur
complement, formed in float64 whatever the working dtype. Where some y
meets the CVaR row alone (the car's gated iteration, `sm_free`), the
Sherman-Morrison step takes a form that float32 can carry (`kkt_solve`).

`one_iter_ref` is the plain PyTorch iteration; `admm_chunk` launches the
kernel for CUDA tensors and runs `one_iter_ref` only for CPU tensors. The
kernel runs a whole chunk in one cooperative launch (`launch_shape` says on
how many blocks, and what of each block's data is resident in shared
memory); `csrc/saa_admm_common.cuh` describes its phases.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from riskaversetrajopt_torch.ops import admm as admm_mod
from riskaversetrajopt_torch.ops.saa_qp import (
    SAAQPData,
    SAAQPOps,
    SAAQPStatic,
    build_bounds,
    build_objective,
    make_ops,
)


class KernelDims(NamedTuple):
    n: int
    n_fc: int
    M: int
    K: int


def kernel_dims(st: SAAQPStatic) -> KernelDims:
    return KernelDims(n=st.n, n_fc=st.n_fc, M=st.M, K=st.K)


class ScaledSAA(NamedTuple):
    """Kernel-ready scaled problem data + factorization, all float32.
    The field order is the kernel's pointer order (csrc/saa_admm.cu Prob)."""

    Gs: torch.Tensor  # (M, K, n)
    eGy: torch.Tensor  # (M, K)
    eGt: torch.Tensor  # (M, K)
    rv_G: torch.Tensor  # (M, K)
    lb_G: torch.Tensor  # (M, K), -inf where unbounded
    ub_G: torch.Tensor  # (M, K)
    rv_y: torch.Tensor  # (M,)
    lb_y: torch.Tensor  # (M,)
    ub_y: torch.Tensor  # (M,)
    cy_hat: torch.Tensor  # (M,) scaled CVaR-row y coefficients
    yd_hat: torch.Tensor  # (M,) scaled y-row y coefficients
    ys_hat: torch.Tensor  # (M,) scaled y-row slack coefficients
    Dinv: torch.Tensor  # (M,) inverse of the y-block diagonal
    wD: torch.Tensor  # (M,) Dinv * cy_hat (Sherman-Morrison vector)
    rv_small: torch.Tensor  # (n_fc+2+n,)
    lb_small: torch.Tensor  # (n_fc+2+n,)
    ub_small: torch.Tensor  # (n_fc+2+n,)
    Fs: torch.Tensor  # (n_fc, n)
    cu: torch.Tensor  # (n,)
    q_hat_u: torch.Tensor  # (n,)
    Sinv: torch.Tensor  # (n+2, n+2) inverse Schur complement
    Cbar: torch.Tensor  # (M, n+2) y-v coupling
    ct_hat: torch.Tensor  # () scaled CVaR-row t coefficient
    cs_hat: torch.Tensor  # () scaled CVaR-row slack coefficient
    ss_hat: torch.Tensor  # () scaled slack-row coefficient
    q_hat_s: torch.Tensor  # ()
    sm_beta: torch.Tensor  # () rho of the CVaR row
    sm_denom: torch.Tensor  # () Sherman-Morrison denominator
    sigma: torch.Tensor  # ()
    alpha_relax: torch.Tensor  # ()
    # () 1 where some y meets the CVaR row alone, else 0; kept on the host
    # (it picks the kernel's instantiation, read without a device sync)
    sm_free: torch.Tensor


class ScaledState(NamedTuple):
    """Scaled ADMM iterate, all float32 (kernel pointer order, State)."""

    u: torch.Tensor  # (n,)
    s: torch.Tensor  # ()
    t: torch.Tensor  # ()
    y: torch.Tensor  # (M,)
    z_y: torch.Tensor  # (M,)
    yd_y: torch.Tensor  # (M,)
    z_G: torch.Tensor  # (M, K)
    yd_G: torch.Tensor  # (M, K)
    z_small: torch.Tensor  # (n_fc+2+n,)
    yd_small: torch.Tensor  # (n_fc+2+n,)


def _split_rows(v, st: SAAQPStatic):
    """Row vector in reference order -> (final, cvar, y, G (M, K), slack,
    control)."""
    n_fc, M, K = st.n_fc, st.M, st.K
    o = n_fc + 1 + M
    return (v[:n_fc], v[n_fc], v[n_fc + 1 : o],
            v[o : o + M * K].reshape(M, K), v[o + M * K], v[o + M * K + 1 :])


def _small(f, c, s, u):
    return torch.cat([f, c.reshape(1), s.reshape(1), u])


def scaled_structure(
    st: SAAQPStatic, data: SAAQPData, scp_iter: int, scaling, rho, cfg,
):
    """Fold Ruiz scalings + gating + MULTIPLIER into kernel-ready float32
    arrays and factorize the scaled KKT (saa_admm.py:156-374). The Schur
    block and its inverse are formed in float64 from the float32 arrays.
    Returns (ScaledSAA, (D, E, c)) with the float32 scalings for unscaling."""
    f32 = torch.float32
    n, M = st.n, st.M
    ops = SAAQPOps(st, data, scp_iter)
    sc = ops.scales
    m_row = ops.m

    D = scaling.D.to(f32)
    E = scaling.E.to(f32)
    c_cost = scaling.c.to(f32)
    D_u, D_y, D_s, D_t = D[:n], D[n : n + M], D[n + M], D[n + M + 1]
    E_f, E_c, E_y, E_G, E_s, E_u = _split_rows(E, st)

    l_un, u_un = build_bounds(st, data, scp_iter)
    ls = (E * l_un).to(f32)
    us = (E * u_un).to(f32)
    rho_vec = admm_mod.rho_vector(ls, us, rho).to(f32)
    rv_f, rv_c, rv_y, rv_G, rv_s, rv_u = _split_rows(rho_vec, st)

    eG = (sc.g * m_row * E_G).to(f32)  # (M, K)
    Gs = eG[:, :, None] * data.G.to(f32) * D_u[None, None, :]
    eGy = (sc.gy * eG * D_y[:, None]).to(f32)
    eGt = (sc.gy * eG * D_t).to(f32)

    Fs = (E_f[:, None] * data.F.to(f32)) * D_u[None, :]
    cu = (E_u * D_u).to(f32)
    cy_hat = (sc.c * E_c * D_y).to(f32)
    ct_hat = (sc.c * E_c * ops.Malpha * D_t).to(f32)
    # the CVaR row includes the slack column (car/driving.py:341-342)
    cs_hat = (sc.c * E_c * D_s).to(f32)
    yd_hat = (sc.y * E_y * D_y).to(f32)
    ys_hat = (sc.y * E_y * D_s).to(f32)
    ss_hat = (sc.s * E_s * D_s).to(f32)

    p_diag, q = build_objective(st, data)
    p_hat = (c_cost * D * D * p_diag).to(f32)
    q_hat = (c_cost * D * q).to(f32)
    sigma = torch.tensor(cfg.sigma, dtype=f32, device=Gs.device)

    # --- scaled KKT factorization (Schur over samples, SM on the y block),
    # in float64: the kernel applies the explicit inverse without in-kernel
    # refinement, so the inversion error feeds the iteration directly ---
    h = lambda x: x.to(torch.float64)  # noqa: E731
    rv_G_h, eGy_h, eGt_h, Gs_h = h(rv_G), h(eGy), h(eGt), h(Gs)
    Dbar = h(sigma) + h(rv_y) * h(yd_hat) ** 2 + torch.sum(rv_G_h * eGy_h**2, dim=1)
    w_vec = h(cy_hat)
    Dinv = 1.0 / Dbar
    wD = Dinv * w_vec
    rv_c_h = h(rv_c)
    sm_denom = 1.0 + rv_c_h * torch.sum(w_vec * wD)

    C_u = -torch.einsum("mk,mkn->mn", rv_G_h * eGy_h, Gs_h)
    C_s = (h(rv_y) * h(yd_hat) * h(ys_hat) + rv_c_h * w_vec * h(cs_hat))[:, None]
    C_t = (torch.sum(rv_G_h * eGy_h * eGt_h, dim=1)
           + rv_c_h * w_vec * h(ct_hat))[:, None]
    Cbar = torch.cat([C_u, C_s, C_t], dim=1)  # (M, n+2)

    B = torch.einsum("mkn,mk,mkp->np", Gs_h, rv_G_h, Gs_h)
    N_uu = (
        torch.diag(h(p_hat[:n] + sigma + rv_u * cu**2))
        + h(Fs).T @ (h(rv_f)[:, None] * h(Fs))
        + B
    )
    N_ut = -torch.einsum("mk,mkn->n", rv_G_h * eGt_h, Gs_h)
    N_ss = (
        h(p_hat[n + M]) + h(sigma)
        + torch.sum(h(rv_y) * h(ys_hat) ** 2)
        + h(rv_s) * h(ss_hat) ** 2
        + rv_c_h * h(cs_hat) ** 2
    )
    N_tt = h(sigma) + rv_c_h * h(ct_hat) ** 2 + torch.sum(rv_G_h * eGt_h**2)
    N_st = rv_c_h * h(cs_hat) * h(ct_hat)
    N_vv = torch.zeros(n + 2, n + 2, dtype=torch.float64, device=Gs.device)
    N_vv[:n, :n] = N_uu
    N_vv[:n, n + 1] = N_ut
    N_vv[n + 1, :n] = N_ut
    N_vv[n, n] = N_ss
    N_vv[n, n + 1] = N_st
    N_vv[n + 1, n] = N_st
    N_vv[n + 1, n + 1] = N_tt

    # a y that meets the CVaR row alone has Dbar = sigma (Dinv = 1e6): the
    # car's y rows at its gated iteration, where the y rows of the samples
    # past n_x - n_fc - 1 and every sample row are zeroed
    free = bool(torch.any((yd_hat == 0) & torch.all(eGy == 0, dim=1)
                          & (cy_hat != 0)))
    if free:
        # S from the float32 values the iteration applies, so that its KKT
        # solve is the exact solve of one symmetric system: formed from the
        # unrounded values, S is inconsistent with them at 1e-7, which the
        # 1e6 of Dinv carries into a drift of t and the free y
        Dinv, wD, Cbar = (x.to(f32).to(torch.float64) for x in (Dinv, wD, Cbar))
        sm_denom = (1.0 + rv_c_h * torch.sum(w_vec * wD)).to(f32).to(torch.float64)
    DinvC = Dinv[:, None] * Cbar
    CtwD = Cbar.T @ wD
    S = N_vv - (Cbar.T @ DinvC - (rv_c_h / sm_denom) * torch.outer(CtwD, CtwD))
    Sinv = torch.linalg.inv(S).to(f32)

    ls_f, ls_c, ls_y, ls_G, ls_s, ls_u = _split_rows(ls, st)
    us_f, us_c, us_y, us_G, us_s, us_u = _split_rows(us, st)
    p = ScaledSAA(
        Gs=Gs.contiguous(),
        eGy=eGy.contiguous(),
        eGt=eGt.contiguous(),
        rv_G=rv_G.contiguous(),
        lb_G=ls_G.contiguous(),
        ub_G=us_G.contiguous(),
        rv_y=rv_y.contiguous(),
        lb_y=ls_y.contiguous(),
        ub_y=us_y.contiguous(),
        cy_hat=cy_hat,
        yd_hat=yd_hat.contiguous(),
        ys_hat=ys_hat.contiguous(),
        Dinv=Dinv.to(f32),
        wD=wD.to(f32),
        rv_small=_small(rv_f, rv_c, rv_s, rv_u),
        lb_small=_small(ls_f, ls_c, ls_s, ls_u),
        ub_small=_small(us_f, us_c, us_s, us_u),
        Fs=Fs.contiguous(),
        cu=cu,
        q_hat_u=q_hat[:n].contiguous(),
        Sinv=Sinv.contiguous(),
        Cbar=Cbar.to(f32).contiguous(),
        ct_hat=ct_hat,
        cs_hat=cs_hat,
        ss_hat=ss_hat,
        q_hat_s=q_hat[n + M].clone(),
        sm_beta=rv_c.clone(),
        sm_denom=sm_denom.to(f32),
        sigma=sigma,
        alpha_relax=torch.tensor(cfg.alpha_relax, dtype=f32, device=Gs.device),
        sm_free=torch.tensor(float(free), dtype=f32),
    )
    return p, (D, E, c_cost)


def init_scaled_state(p: ScaledSAA) -> ScaledState:
    """Cold start: zero iterate, rows projected onto their bounds."""
    zeros = torch.zeros_like
    return ScaledState(
        u=zeros(p.q_hat_u),
        s=zeros(p.sigma),
        t=zeros(p.sigma),
        y=zeros(p.rv_y),
        z_y=torch.clamp(zeros(p.rv_y), p.lb_y, p.ub_y),
        yd_y=zeros(p.rv_y),
        z_G=torch.clamp(zeros(p.rv_G), p.lb_G, p.ub_G),
        yd_G=zeros(p.rv_G),
        z_small=torch.clamp(zeros(p.rv_small), p.lb_small, p.ub_small),
        yd_small=zeros(p.rv_small),
    )


def _row_update(al, z, yd, zt, rv, lb, ub):
    """ADMM relax/project/dual update for one row section."""
    z_relax = al * zt + (1 - al) * z
    z_next = torch.clamp(z_relax + yd / rv, lb, ub)
    yd_next = yd + rv * (z_relax - z_next)
    return z_next, yd_next


def kkt_solve(p, y, w_c, w_y, rowsum_y, rhs_v):
    """The KKT solve of one iteration: (v, y_t) = (u_t | s_t | t_t, y_t)
    from the y iterate `y`, w of the CVaR row `w_c`, w of the y rows `w_y`,
    sum_k eGy w per sample `rowsum_y` and the right-hand side of (u, s, t)
    `rhs_v`. `p` is a ScaledSAA or a ScaledSAAF.

    The y block is Dbar + beta cy cy^T (beta the CVaR row's rho, cy =
    cy_hat), solved by Sherman-Morrison for r = rhs_y (g_y) and for
    q = rhs_y - Cbar v (y_t): Dinv r - beta (wD . r) / denom wD, as the JAX
    kernel forms it. Where some y meets the CVaR row alone (p.sm_free), its
    Dinv is 1/sigma = 1e6 and that form cancels terms 1e6 times its result:
    float32 then diverges. There the right-hand sides are written
    r = sigma y + cy mu - B (mu = w_c and B1 = yd_hat w_y + rowsum_y for
    g_y; mu = w_c - beta c2, c2 = cs_hat s_t + ct_hat t_t, and B1 + Cbar v -
    beta cy c2 for y_t), and with a = Dinv sigma, X = sum(cy a y - wD B),
    Sherman-Morrison is exactly
        a y - Dinv B + wD (mu - beta X) / denom,
    which never forms Dinv r. The CUDA kernel takes the same branch."""
    n = rhs_v.shape[0] - 2
    beta, denom = p.sm_beta, p.sm_denom
    if not bool(p.sm_free):
        rhs_y = p.sigma * y + p.cy_hat * w_c - p.yd_hat * w_y - rowsum_y

        def sm_apply(r):
            return p.Dinv * r - (beta * torch.sum(p.wD * r) / denom) * p.wD

        g_y = sm_apply(rhs_y)
        v = (rhs_v - p.Cbar.T @ g_y) @ p.Sinv
        return v, sm_apply(rhs_y - p.Cbar @ v)
    a = p.Dinv * p.sigma
    B1 = p.yd_hat * w_y + rowsum_y
    X1 = torch.sum(p.cy_hat * a * y - p.wD * B1)
    g_y = a * y - p.Dinv * B1 + p.wD * ((w_c - beta * X1) / denom)
    v = (rhs_v - p.Cbar.T @ g_y) @ p.Sinv
    c2 = p.cs_hat * v[n] + p.ct_hat * v[n + 1]
    cv = p.Cbar @ v - beta * p.cy_hat * c2
    X2 = X1 - torch.sum(p.wD * cv)
    y_t = (a * y - p.Dinv * (B1 + cv)
           + p.wD * ((w_c - beta * c2 - beta * X2) / denom))
    return v, y_t


def one_iter_ref(p: ScaledSAA, s: ScaledState, d: KernelDims) -> ScaledState:
    """One scaled ADMM iteration in plain PyTorch (the kernel's plain
    version; saa_admm.py:_iter_body)."""
    n, n_fc = d.n, d.n_fc
    al, sig = p.alpha_relax, p.sigma

    # sweep 1: A^T contribution of the sample rows + per-sample sums
    w_G = p.rv_G * s.z_G - s.yd_G
    u_part = w_G.reshape(-1) @ p.Gs.reshape(-1, n)
    rowsum_y = torch.sum(p.eGy * w_G, dim=1)
    eGtw_sum = torch.sum(p.eGt * w_G)

    # KKT solve: Sherman-Morrison on the y block + explicit Schur inverse
    w_small = p.rv_small * s.z_small - s.yd_small
    w_y = p.rv_y * s.z_y - s.yd_y
    w_c, w_s = w_small[n_fc], w_small[n_fc + 1]
    for j in range(n_fc):
        u_part = u_part + w_small[j] * p.Fs[j]
    u_part = u_part + p.cu * w_small[n_fc + 2 :]
    rhs_u = sig * s.u - p.q_hat_u + u_part
    rhs_s = (sig * s.s - p.q_hat_s + p.cs_hat * w_c
             - torch.sum(p.ys_hat * w_y) - p.ss_hat * w_s)
    rhs_t = sig * s.t + p.ct_hat * w_c - eGtw_sum
    v, y_t = kkt_solve(p, s.y, w_c, w_y, rowsum_y,
                       torch.cat([rhs_u, rhs_s[None], rhs_t[None]]))
    u_t, s_t, t_t = v[:n], v[n], v[n + 1]

    # sweep 2: zt of the sample rows + their row update
    zt_G = p.Gs @ u_t - p.eGy * y_t[:, None] - p.eGt * t_t
    z_G, yd_G = _row_update(al, s.z_G, s.yd_G, zt_G, p.rv_G, p.lb_G, p.ub_G)

    # small rows, y rows and the coupled variables
    zt_y = -p.yd_hat * y_t - p.ys_hat * s_t
    zt_c = torch.sum(p.cy_hat * y_t) + p.cs_hat * s_t + p.ct_hat * t_t
    zt_s = -p.ss_hat * s_t
    zt_small = _small(p.Fs @ u_t, zt_c, zt_s, p.cu * u_t)
    z_y, yd_y = _row_update(al, s.z_y, s.yd_y, zt_y, p.rv_y, p.lb_y, p.ub_y)
    z_small, yd_small = _row_update(
        al, s.z_small, s.yd_small, zt_small, p.rv_small, p.lb_small, p.ub_small
    )
    return ScaledState(
        u=al * u_t + (1 - al) * s.u,
        s=al * s_t + (1 - al) * s.s,
        t=al * t_t + (1 - al) * s.t,
        y=al * y_t + (1 - al) * s.y,
        z_y=z_y,
        yd_y=yd_y,
        z_G=z_G,
        yd_G=yd_G,
        z_small=z_small,
        yd_small=yd_small,
    )


def _check_kernel_inputs(p: ScaledSAA, state: ScaledState, d: KernelDims):
    MK = (d.M, d.K)
    check_tensors("admm_chunk", p, state, d, {
        "Gs": (*MK, d.n), "eGy": MK, "eGt": MK, "rv_G": MK, "lb_G": MK,
        "ub_G": MK, "z_G": MK, "yd_G": MK,
    })


def check_tensors(who: str, p, state, d: KernelDims, sample_rows: dict):
    """Raise unless every field of `p` and `state` is a contiguous float32
    tensor on p's device of its shape: `sample_rows` gives the shapes of the
    layout's G and sample-row fields; the others are the same in both
    layouts (scalars are ())."""
    n, n_fc, M = d.n, d.n_fc, d.M
    ns = (n_fc + 2 + n,)
    shapes = dict(
        rv_small=ns, lb_small=ns, ub_small=ns, z_small=ns, yd_small=ns,
        Fs=(n_fc, n), cu=(n,), q_hat_u=(n,), u=(n,), Sinv=(n + 2, n + 2),
        Cbar=(M, n + 2), **sample_rows,
    )
    for name in ("rv_y", "lb_y", "ub_y", "cy_hat", "yd_hat", "ys_hat", "Dinv",
                 "wD", "y", "z_y", "yd_y"):
        shapes[name] = (M,)
    device = p[0].device
    for name, x in list(zip(p._fields, p)) + list(zip(state._fields, state)):
        want = shapes.get(name, ())
        on = x.device if name == "sm_free" else device  # a host flag
        if x.device != on or x.dtype != torch.float32:
            raise ValueError(
                f"{who}: {name} must be float32 on {on}, got "
                f"{x.dtype} on {x.device}"
            )
        if tuple(x.shape) != want or not x.is_contiguous():
            raise ValueError(
                f"{who}: {name} must be a contiguous {want} tensor, "
                f"got {tuple(x.shape)} (contiguous={x.is_contiguous()})"
            )


class LaunchShape(NamedTuple):
    """How a chunk call runs on the card (the kernels' C shape queries): one
    cooperative launch of `grid_blocks` co-resident blocks, each owning
    `samples_per_block` contiguous samples with `smem_bytes_per_block` of
    shared memory, which holds Sinv, its G slab where `resident` and its
    sample rows where `rows_resident`. Each block writes one partial row of
    `partial_width` float32 values per iteration."""

    grid_blocks: int
    samples_per_block: int
    smem_bytes_per_block: int
    resident: bool
    rows_resident: bool
    partial_width: int


def declare(lib, prefix: str, chunk_args: int, shape_args: int):
    """Declare the C signatures of a kernel library's entry points:
    <prefix>_chunk(ptrs, n_ptrs, `chunk_args` ints, stream),
    <prefix>_shape(`shape_args` ints, int out[7]), <prefix>_max_n() and
    <prefix>_error_string(err)."""
    i = ctypes.c_int
    fn = getattr(lib, f"{prefix}_chunk")
    fn.argtypes = [ctypes.c_void_p, i] + [i] * chunk_args + [ctypes.c_void_p]
    fn.restype = i
    fn = getattr(lib, f"{prefix}_shape")
    fn.argtypes = [i] * shape_args + [ctypes.POINTER(i)]
    fn.restype = i
    getattr(lib, f"{prefix}_max_n").argtypes = []
    getattr(lib, f"{prefix}_max_n").restype = i
    fn = getattr(lib, f"{prefix}_error_string")
    fn.argtypes = [i]
    fn.restype = ctypes.c_char_p
    return lib


def cuda_error(lib, prefix: str, err: int) -> RuntimeError:
    text = getattr(lib, f"{prefix}_error_string")(err).decode()
    return RuntimeError(f"{prefix}_chunk failed: CUDA error {err} ({text})")


def query_shape(lib, prefix: str, device, *args) -> LaunchShape:
    """The C shape query <prefix>_shape(*args) on `device`."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = getattr(lib, f"{prefix}_shape")(*args, out)
    if err != 0:
        raise cuda_error(lib, prefix, err)
    grid, spb, smem, g_res, rows_res, pw, _ = out
    return LaunchShape(grid, spb, smem, bool(g_res), bool(rows_res), pw)


def kernel_scratch(shape: LaunchShape, d: KernelDims, device) -> list:
    """The scratch list of a chunk call (csrc/saa_admm_common.cuh Scratch).
    After the call `partials` holds the last iteration's partial rows (the
    first n columns of each sum to its sweep-1 product), `y_t` and `vt` its
    y_t and u_t | s_t | t_t. `rhs_y` and `w` hold rows only where they are
    not resident in shared memory."""
    f32 = dict(dtype=torch.float32, device=device)
    rows = 0 if shape.rows_resident else d.M
    return [
        torch.empty(shape.grid_blocks * shape.partial_width, **f32),  # partials
        torch.empty(rows, **f32),  # rhs_y
        torch.empty(2 * rows * d.K, **f32),  # w
        torch.empty(d.M, **f32),  # y_t
        torch.empty(d.n + 2, **f32),  # vt
    ]


def _library():
    """The kernel library with its C signatures declared (built on first
    use)."""
    from riskaversetrajopt_torch.ops.cuda import build

    lib = declare(build.load("saa_admm"), "saa_admm", 6, 4)
    lib.saa_admm_sync_floor.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
    lib.saa_admm_sync_floor.restype = ctypes.c_int
    return lib


def launch_shape(d: KernelDims, device) -> LaunchShape:
    """How kernel B1 runs a chunk call of these dims on `device`."""
    return query_shape(_library(), "saa_admm", device, d.M, d.K, d.n, d.n_fc)


def _kernel_chunk(p: ScaledSAA, state: ScaledState, d: KernelDims,
                  chunk: int) -> ScaledState:
    lib = _library()
    if d.n > lib.saa_admm_max_n():
        raise ValueError(f"admm_chunk: n={d.n} exceeds the kernel's "
                         f"{lib.saa_admm_max_n()} columns")
    _check_kernel_inputs(p, state, d)
    dev = p.Gs.device
    with torch.cuda.device(dev):
        out = ScaledState(*(torch.empty_like(x) for x in state))
        scratch = kernel_scratch(launch_shape(d, dev), d, dev)
        # every field but sm_free (the last), which picks the kernel
        tensors = list(p[:-1]) + list(state) + list(out) + scratch
        ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.saa_admm_chunk(ptrs, len(tensors), d.M, d.K, d.n, d.n_fc,
                                 chunk, int(bool(p.sm_free)), stream)
        if err != 0:
            raise cuda_error(lib, "saa_admm", err)
        admm_chunk.launches += 1
    return out


def sync_floor(d: KernelDims, device, iters: int) -> None:
    """One cooperative launch on kernel B1's grid for these dims that only
    crosses three grid barriers per iteration, `iters` times: the
    dependency-chain floor of a chunk call, which chip_smoke.py times. No
    solver path calls it."""
    lib = _library()
    grid = launch_shape(d, device).grid_blocks
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.saa_admm_sync_floor(grid, iters, stream)
    if err != 0:
        raise cuda_error(lib, "saa_admm", err)


def admm_chunk(p: ScaledSAA, state: ScaledState, d: KernelDims,
               chunk: int) -> ScaledState:
    """Run `chunk` scaled ADMM iterations (saa_admm.py:admm_chunk_pallas).

    CUDA tensors launch the hand-written kernel (csrc/saa_admm.cu) and
    count one launch; a CPU tensor runs `one_iter_ref`; any other device
    raises."""
    if p.Gs.device.type == "cuda":
        return _kernel_chunk(p, state, d, chunk)
    if p.Gs.device.type != "cpu":
        raise ValueError(f"admm_chunk: no kernel for device {p.Gs.device}")
    for _ in range(chunk):
        state = one_iter_ref(p, state, d)
    return state


admm_chunk.launches = 0


# ---------------------------------------------------------------------------
# state <-> flat conversion (warm starts and residual checks)
# ---------------------------------------------------------------------------


def state_to_flat(s: ScaledState, d: KernelDims):
    """Scaled kernel state -> scaled flat (x, z, yd) in reference row order."""
    n_fc = d.n_fc
    x = torch.cat([s.u, s.y, s.s.reshape(1), s.t.reshape(1)])

    def rows(z_G, z_y, z_small):
        return torch.cat([
            z_small[: n_fc + 1], z_y, z_G.reshape(-1), z_small[n_fc + 1 :],
        ])

    return x, rows(s.z_G, s.z_y, s.z_small), rows(s.yd_G, s.yd_y, s.yd_small)


def flat_to_state(x, z, yd, st: SAAQPStatic) -> ScaledState:
    """Scaled flat (x, z, yd) -> kernel state (float32)."""
    n, M = st.n, st.M
    f32 = torch.float32

    def seg(v):
        v_f, v_c, v_y, v_G, v_s, v_u = _split_rows(v.to(f32), st)
        return v_G.contiguous(), v_y.contiguous(), _small(v_f, v_c, v_s, v_u)

    z_G, z_y, z_small = seg(z)
    yd_G, yd_y, yd_small = seg(yd)
    x = x.to(f32)
    return ScaledState(
        u=x[:n].contiguous(), s=x[n + M].clone(), t=x[n + M + 1].clone(),
        y=x[n : n + M].contiguous(), z_y=z_y, yd_y=yd_y, z_G=z_G, yd_G=yd_G,
        z_small=z_small, yd_small=yd_small,
    )


# ---------------------------------------------------------------------------
# solver integration: chunked ADMM with termination checks between chunks
# ---------------------------------------------------------------------------


class _Natural:
    """How the chunked solve talks to kernel B1: it takes the natural-layout
    structure and state as they are."""

    @staticmethod
    def problem(p: ScaledSAA, d: KernelDims, prev=None) -> ScaledSAA:
        return p

    @staticmethod
    def state_in(s: ScaledState, d: KernelDims) -> ScaledState:
        return s

    @staticmethod
    def state_out(s: ScaledState, d: KernelDims) -> ScaledState:
        return s

    @staticmethod
    def run(p: ScaledSAA, s: ScaledState, d: KernelDims, chunk: int, cfg):
        return admm_chunk(p, s, d, chunk)


def solve_chunked(
    st: SAAQPStatic,
    data: SAAQPData,
    scp_iter: int,
    cfg,
    layout,
    x0=None,
    y0=None,
    ruiz_iters: int = 5,
    chunk: int = 100,
    rho0=None,
) -> admm_mod.QPSolution:
    """OSQP-semantics solve of the structured SAA QP with a fused kernel
    (saa_admm.py:907-1061, saa_admm_f.py:443-593): `chunk` ADMM iterations
    per kernel call, unscaled-residual termination checked between chunks,
    adaptive rho by re-forming the scaled structure, and under cfg.polish
    the active-set polish of ops/admm.py on the unscaled iterate (its
    float32 factorization is the compensated one). Float32 only.

    `layout` maps the natural scaled structure and state to the kernel's
    (`problem`, `state_in`, `state_out`) and runs one chunk (`run`)."""
    if data.G.dtype != torch.float32:
        raise ValueError(
            f"the fused-kernel ADMM solves float32 problems; got {data.G.dtype}"
        )
    d = kernel_dims(st)
    f32 = torch.float32
    ops = make_ops(st, data, scp_iter, cfg)
    _, q = build_objective(st, data)
    l, u = build_bounds(st, data, scp_iter)
    scaling = admm_mod.ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters)
    rho = torch.clamp(
        torch.as_tensor(cfg.rho if rho0 is None else rho0, dtype=f32,
                        device=q.device),
        1e-6, 1e6,
    )
    ruf = float(cfg.rho_update_factor)
    p, (D, E, c_cost) = scaled_structure(st, data, scp_iter, scaling, rho, cfg)
    kp = layout.problem(p, d)
    sops = admm_mod.ScaledOps(ops, scaling)

    if x0 is None:
        state = init_scaled_state(p)
    else:
        xbar = x0.to(f32) / D
        ybar = c_cost * y0.to(f32) / E
        zbar = torch.clamp(sops.matvec_A(xbar), E * l, E * u)
        state = flat_to_state(xbar, zbar, ybar, st)
    state = layout.state_in(state, d)

    q_norm = torch.amax(torch.abs(q))
    qs_v = c_cost * D * q
    amax = lambda v: torch.amax(torch.abs(v))  # noqa: E731

    def residuals(xb, zb, yb):
        x_u = D * xb
        z_u = zb / E
        y_u = E * yb / c_cost
        Ax = ops.matvec_A(x_u)
        Px = ops.matvec_P(x_u)
        Aty = ops.rmatvec_A(y_u)
        prim = amax(Ax - z_u)
        dual = amax(Px + q + Aty)
        eps_prim = cfg.eps_abs + cfg.eps_rel * torch.maximum(amax(Ax), amax(z_u))
        eps_dual = cfg.eps_abs + cfg.eps_rel * torch.maximum(
            torch.maximum(amax(Px), amax(Aty)), q_norm)
        # adaptive-rho ratio from SCALED residuals (OSQP sec 5.2)
        Ax_s = sops.matvec_A(xb)
        Px_s = sops.matvec_P(xb)
        Aty_s = sops.rmatvec_A(yb)
        prim_s = amax(Ax_s - zb)
        dual_s = amax(Px_s + qs_v + Aty_s)
        den_ps = torch.maximum(amax(Ax_s), amax(zb)) + 1e-30
        den_ds = torch.maximum(
            torch.maximum(amax(Px_s), amax(Aty_s)), amax(qs_v)) + 1e-30
        ratio = (prim_s / den_ps) / (dual_s / den_ds + 1e-30)
        return prim, dual, (prim <= eps_prim) & (dual <= eps_dual), ratio

    it = 0
    done = False
    prim = dual = torch.tensor(float("inf"), dtype=f32, device=q.device)
    while not done and it < cfg.max_iter:
        state = layout.run(kp, state, d, chunk, cfg)
        prim, dual, ok, ratio = residuals(
            *state_to_flat(layout.state_out(state, d), d))
        if cfg.adaptive_rho:
            rho_new = torch.clamp(rho * torch.sqrt(ratio), 1e-6, 1e6)
            do_update = ((rho_new > ruf * rho) | (rho_new < rho / ruf)) & ~ok
            done, update = torch.stack([ok, do_update]).tolist()
            if update:
                rho = rho_new
                p = scaled_structure(st, data, scp_iter, scaling, rho, cfg)[0]
                kp = layout.problem(p, d, prev=kp)
        else:
            done = bool(ok)
        it += chunk

    xb, zb, yb = state_to_flat(layout.state_out(state, d), d)
    x_u, y_u, z_u = D * xb, E * yb / c_cost, zb / E
    polished = False
    if cfg.polish:
        x_u, y_u, z_u, polished = admm_mod._polish(ops, q, l, u, x_u, y_u,
                                                   z_u, cfg)
    return admm_mod.QPSolution(
        x=x_u, y=y_u, z=z_u, iters=it, prim_res=prim, dual_res=dual,
        solved=bool(done), rho=rho, polished=polished,
    )


def solve_saa_qp_pallas(
    st: SAAQPStatic,
    data: SAAQPData,
    scp_iter: int,
    cfg,
    x0=None,
    y0=None,
    ruiz_iters: int = 5,
    chunk: int = 100,
    rho0=None,
) -> admm_mod.QPSolution:
    """The '_admm-pallas' solve (saa_admm.py:907-1061): `solve_chunked`
    with kernel B1, 100 iterations per call. Float32 only."""
    return solve_chunked(st, data, scp_iter, cfg, _Natural, x0=x0, y0=y0,
                         ruiz_iters=ruiz_iters, chunk=chunk, rho0=rho0)
