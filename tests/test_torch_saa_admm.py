"""The port's fused-ADMM host code (ops/cuda/saa_admm.py) against the JAX
package's Pallas host code (ops/pallas/experimental/saa_admm.py) on the same
float32 problem, M=12. JAX runs its plain `one_iter_ref` here, never
interpret mode; test_torch_cuda_kernels.py holds the CUDA kernel against the
port's plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core.config import SolverConfig as TSolverConfig
from riskaversetrajopt_torch.ops.cuda import saa_admm as tk
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.ops import admm as jadmm
from riskaversetrajopt_tpu.ops.pallas.experimental import saa_admm as jk
from riskaversetrajopt_tpu.ops.saa_qp import (
    SAAQPOps,
    build_bounds,
    build_objective,
)
from tests.test_saa_qp import dense_reference_A, make_problem

CFG = SolverConfig()
TCFG = TSolverConfig()


def _setup(scp_iter, M=12):
    """test_pallas_admm.py:setup on both sides: the JAX scaled structure and
    the port's, formed from the same float32 data, Ruiz scaling and rho."""
    st, data = make_problem(M=M)
    data32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), data)
    ops = SAAQPOps(st, data32, jnp.asarray(scp_iter))
    _, q = build_objective(st, data32)
    l, u = build_bounds(st, data32, jnp.asarray(scp_iter))
    scaling = jadmm.ruiz_equilibrate(ops, q, l, u, iters=5)
    rho = jnp.asarray(CFG.rho, jnp.float32)
    p_j, _ = jk.scaled_structure(st, data32, jnp.asarray(scp_iter), scaling,
                                 rho, CFG, TM=8)
    d_j = jk.kernel_dims(st, TM=8)
    tst = tqp.SAAQPStatic(*st[:14])
    tdata = interop.saa_qp_data(data32, dtype=torch.float32)
    p_t, _ = tk.scaled_structure(
        tst, tdata, scp_iter, interop.scaling(scaling, dtype=torch.float32),
        torch.tensor(CFG.rho, dtype=torch.float32), TCFG,
    )
    return st, data32, p_j, d_j, tst, tdata, p_t, tk.kernel_dims(tst)


@pytest.fixture(scope="module")
def setups():
    cache = {}

    def get(scp_iter):
        if scp_iter not in cache:
            cache[scp_iter] = _setup(scp_iter)
        return cache[scp_iter]

    return get


@pytest.mark.parametrize("scp_iter", [0, 3])
def test_scaled_structure_matches(setups, scp_iter):
    """Elementwise fields are the same float32 products in the same order
    (equal to an ulp); Sinv, Cbar and the Sherman-Morrison terms are formed
    in float64 from the same float32 arrays on both sides and differ only by
    float64 summation order before the cast to float32."""
    _, _, p_j, d_j, _, _, p_t, _ = setups(scp_iter)
    ref = interop.scaled_saa(p_j, d_j)
    for name, a, b in zip(p_t._fields, p_t, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        a, b = a.numpy(), b.numpy()
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=name)
        fin = np.isfinite(b)
        np.testing.assert_allclose(
            a[fin], b[fin], rtol=2e-6, atol=2e-6 * np.max(np.abs(b[fin]), initial=0),
            err_msg=name,
        )


def test_init_state_matches(setups):
    _, _, p_j, d_j, _, _, p_t, _ = setups(3)
    ref = interop.scaled_state(jk.init_scaled_state(p_j, d_j), d_j)
    for name, a, b in zip(ref._fields, tk.init_scaled_state(p_t), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


@pytest.mark.parametrize(
    "scp_iter,dtype,tol",
    [(0, "float64", 1e-4), (3, "float64", 1e-4), (3, "float32", 2e-2)],
)
def test_one_iter_ref_matches(setups, scp_iter, dtype, tol):
    """Five plain iterations on both sides, from the JAX structure carried
    over by interop, compared through state_to_flat, to `tol` of each
    vector's scale.

    float64 checks the logic: the JAX iteration rounds the Schur solve
    v = r_v Sinv to float32 (preferred_element_type), which the 1e3 rho of
    the equality rows amplifies to ~1e-5 of scale in the duals. float32 is
    the kernel's dtype: there each side lies ~1e-3 (x, z) and ~1e-2 (duals)
    from the float64 iteration at scp_iter 3 (and O(1) in the equality-row
    duals of the gated scp_iter 0), so two float32 runs are held to the 2e-2
    of test_pallas_admm.py:108-114."""
    st, _, p_j, d_j, tst, _, _, d_t = setups(scp_iter)
    p_j = jax.tree.map(lambda x: jnp.asarray(x, dtype), p_j)
    p = interop.scaled_saa(p_j, d_j)  # float32 values, exact in float64
    p = type(p)(*(x.to(getattr(torch, dtype)) for x in p))
    s_j = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                       jk.init_scaled_state(p_j, d_j))
    s_t = tk.init_scaled_state(p)
    for _ in range(5):
        s_j = jk.one_iter_ref(p_j, s_j, d_j)
        s_t = tk.one_iter_ref(p, s_t, d_t)
    for name, a, b in zip("x z yd".split(), tk.state_to_flat(s_t, d_t),
                          jk.state_to_flat(p_j, s_j, st, d_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=tol * np.max(np.abs(b)), err_msg=name)


def _three_phase_chunk(p, s, d, chunk, blocks, fault=None):
    """`chunk` iterations as the CUDA kernel's cooperative grid runs them
    (csrc/saa_admm_common.cuh), in plain torch; `blocks` are slices of
    contiguous samples, possibly empty. Phase 1: the previous iteration's
    CVaR row is completed from the blocks' sums of cy_hat y_t; each block
    writes its partial row (u_part, sum ys_hat w_y, sum eGt w, sum wD r_y,
    Cbar^T (Dinv r_y)). Phase 2 reduces the rows in block order and forms
    r_v with Cbar^T g_y = Cbar^T (Dinv r_y) - coef CtwD, CtwD = Cbar^T wD
    reduced once from per-block parts; v = r_v Sinv; the small rows but the
    CVaR row; each block sums wD q, q = r_y - Cbar v. Phase 3 reduces those
    sums to coef2 and updates each block's rows from y_t. The last CVaR row
    is completed at chunk end. With p.sm_free the same columns carry the
    cancellation-free form of kkt_solve: r_y is B1 = yd_hat w_y + sum_k eGy
    w, the partial row has X1 = sum (cy_hat a y - wD B1) and
    Cbar^T (a y - Dinv B1) (a = Dinv sigma), the blocks sum wD cv with
    cv = Cbar v - beta cy_hat (cs_hat s_t + ct_hat t_t), and y_t =
    a y - Dinv (B1 + cv) + wD kappa2. `fault` plants one of the faults of
    kernel_ab.py's FAULTS in the free-row form: "x1_sign" (+ wD B1 in X1),
    "kappa2_no_c2" or "cv_no_c2" (beta c2 dropped there)."""
    sign = 1.0 if fault == "x1_sign" else -1.0
    c2_k = 0.0 if fault == "kappa2_no_c2" else 1.0
    c2_cv = 0.0 if fault == "cv_no_c2" else 1.0
    n, n_fc = d.n, d.n_fc
    al, sig, beta, denom = p.alpha_relax, p.sigma, p.sm_beta, p.sm_denom
    free = bool(p.sm_free)
    a = p.Dinv * sig
    ctwd = sum(p.Cbar[b].T @ p.wD[b] for b in blocks)
    u, s_, t, y, z_y, yd_y, z_G, yd_G, z_small, yd_small = (x.clone() for x in s)
    cvar = slice(n_fc, n_fc + 1)
    cy_parts, v = None, None

    for _ in range(chunk):
        # phase 1: the previous CVaR row, then one partial row per block
        if cy_parts is not None:
            zt_c = sum(cy_parts) + p.cs_hat * v[n] + p.ct_hat * v[n + 1]
            z_small[cvar], yd_small[cvar] = tk._row_update(
                al, z_small[cvar], yd_small[cvar], zt_c, p.rv_small[cvar],
                p.lb_small[cvar], p.ub_small[cvar])
        w_small = p.rv_small * z_small - yd_small
        w_c, w_s = w_small[n_fc], w_small[n_fc + 1]
        r_y = torch.zeros_like(y)
        rows = []
        for b in blocks:
            w = p.rv_G[b] * z_G[b] - yd_G[b]
            w_y = p.rv_y[b] * z_y[b] - yd_y[b]
            if free:
                r_y[b] = p.yd_hat[b] * w_y + torch.sum(p.eGy[b] * w, dim=1)
                x1 = torch.sum(p.cy_hat[b] * a[b] * y[b]
                               + sign * p.wD[b] * r_y[b])
                cd = p.Cbar[b].T @ (a[b] * y[b] - p.Dinv[b] * r_y[b])
            else:
                r_y[b] = (sig * y[b] + p.cy_hat[b] * w_c - p.yd_hat[b] * w_y
                          - torch.sum(p.eGy[b] * w, dim=1))
                x1 = torch.sum(p.wD[b] * r_y[b])
                cd = p.Cbar[b].T @ (p.Dinv[b] * r_y[b])
            rows.append(torch.cat([
                w.reshape(-1) @ p.Gs[b].reshape(-1, n),
                torch.sum(p.ys_hat[b] * w_y)[None],
                torch.sum(p.eGt[b] * w)[None],
                x1[None],
                cd,
            ]))
        # phase 2: reduced partials, r_v -> v, the small rows, sum wD q
        pr = sum(rows)
        coef = (-(w_c - beta * pr[n + 2]) / denom if free
                else beta * pr[n + 2] / denom)
        rhs = torch.cat([
            sig * u - p.q_hat_u + pr[:n] + w_small[:n_fc] @ p.Fs
            + p.cu * w_small[n_fc + 2:],
            (sig * s_ - p.q_hat_s + p.cs_hat * w_c - pr[n]
             - p.ss_hat * w_s)[None],
            (sig * t + p.ct_hat * w_c - pr[n + 1])[None],
        ])
        v = (rhs - (pr[n + 3:] - coef * ctwd)) @ p.Sinv
        u_t, s_t, t_t = v[:n], v[n], v[n + 1]
        c2 = p.cs_hat * s_t + p.ct_hat * t_t
        if free:
            cv = p.Cbar @ v - c2_cv * beta * p.cy_hat * c2
            q = r_y + cv
            wq = sum(torch.sum(p.wD[b] * cv[b]) for b in blocks)
        else:
            q = r_y - p.Cbar @ v
            wq = sum(torch.sum(p.wD[b] * q[b]) for b in blocks)
        zt_small = tk._small(p.Fs @ u_t, z_small[n_fc], -p.ss_hat * s_t,
                             p.cu * u_t)
        keep = z_small[cvar].clone(), yd_small[cvar].clone()
        z_small, yd_small = tk._row_update(al, z_small, yd_small, zt_small,
                                           p.rv_small, p.lb_small, p.ub_small)
        z_small[cvar], yd_small[cvar] = keep
        u = al * u_t + (1 - al) * u
        s_ = al * s_t + (1 - al) * s_
        t = al * t_t + (1 - al) * t
        # phase 3: coef2, then each block's rows and its sum cy_hat y_t
        if free:
            coef2 = -(w_c - c2_k * beta * c2 - beta * (pr[n + 2] - wq)) / denom
        else:
            coef2 = beta * wq / denom
        cy_parts = []
        for b in blocks:
            if free:
                y_t = a[b] * y[b] - p.Dinv[b] * q[b] - coef2 * p.wD[b]
            else:
                y_t = p.Dinv[b] * q[b] - coef2 * p.wD[b]
            cy_parts.append(torch.sum(p.cy_hat[b] * y_t))
            z_y[b], yd_y[b] = tk._row_update(
                al, z_y[b], yd_y[b], -p.yd_hat[b] * y_t - p.ys_hat[b] * s_t,
                p.rv_y[b], p.lb_y[b], p.ub_y[b])
            y[b] = al * y_t + (1 - al) * y[b]
            zt_G = p.Gs[b] @ u_t - p.eGy[b] * y_t[:, None] - p.eGt[b] * t_t
            z_G[b], yd_G[b] = tk._row_update(al, z_G[b], yd_G[b], zt_G,
                                             p.rv_G[b], p.lb_G[b], p.ub_G[b])
    if cy_parts is not None:
        zt_c = sum(cy_parts) + p.cs_hat * v[n] + p.ct_hat * v[n + 1]
        z_small[cvar], yd_small[cvar] = tk._row_update(
            al, z_small[cvar], yd_small[cvar], zt_c, p.rv_small[cvar],
            p.lb_small[cvar], p.ub_small[cvar])
    return tk.ScaledState(u, s_, t, y, z_y, yd_y, z_G, yd_G, z_small, yd_small)


@pytest.mark.parametrize("spb", [5, 1, 2, 4])
def test_three_phase_kernel_algebra(setups, spb):
    """The kernel's three-phase restructuring of the iteration, in float64
    (`_three_phase_chunk`: blocks of `spb` samples at M=12, ragged at 5,
    with an empty block as a grid larger than M leaves one): ten
    iterations, run as one chunk and as two chunks of five, equal the
    port's `one_iter_ref` to 1e-10 of each field's scale; and JAX's
    `one_iter_ref` through interop to the 1e-4 of test_one_iter_ref_matches
    (JAX rounds v = r_v Sinv to float32). The sound block splits read at
    most 2.3e-12 on the primal fields and 8.5e-12 on the duals (the dual
    update multiplies a row residual's rounding by its rho, 100 on the
    equality rows; the plain iteration merely relaid out, one_iter_ref_f,
    reads 8.6e-12 there), so 1e-12 cannot be held; a decomposition that
    drops a term or reads the CVaR row one iteration late reads 1e-2 or
    more."""
    st, _, p_j, d_j, _, _, _, d = setups(3)
    p_j = jax.tree.map(lambda x: jnp.asarray(x, "float64"), p_j)
    p = interop.scaled_saa(p_j, d_j)
    p = type(p)(*(x.double() for x in p))
    blocks = [slice(m0, min(m0 + spb, d.M)) for m0 in range(0, d.M, spb)]
    blocks.append(slice(d.M, d.M))
    s0 = tk.init_scaled_state(p)
    ref = s0
    for _ in range(10):
        ref = tk.one_iter_ref(p, ref, d)
    one = _three_phase_chunk(p, s0, d, 10, blocks)
    two = _three_phase_chunk(p, _three_phase_chunk(p, s0, d, 5, blocks), d,
                             5, blocks)
    for out in (one, two):
        for name, a, b in zip(ref._fields, out, ref):
            scale = max(float(torch.max(torch.abs(b))), 1.0)
            assert float(torch.max(torch.abs(a - b))) <= 1e-10 * scale, name
    s_j = jk.init_scaled_state(p_j, d_j)
    for _ in range(10):
        s_j = jk.one_iter_ref(p_j, s_j, d_j)
    for name, a, b in zip("x z yd".split(), tk.state_to_flat(one, d),
                          jk.state_to_flat(p_j, s_j, st, d_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.max(np.abs(b)), err_msg=name)


def test_flat_state_roundtrip(setups):
    """state_to_flat / flat_to_state only move float32 values: exact."""
    _, _, _, _, tst, _, p_t, d_t = setups(3)
    s = tk.init_scaled_state(p_t)
    for _ in range(3):
        s = tk.one_iter_ref(p_t, s, d_t)
    flat = tk.state_to_flat(s, d_t)
    back = tk.flat_to_state(*flat, tst)
    for name, a, b in zip(s._fields, back, s):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_admm_chunk_on_cpu_is_the_plain_iteration(setups):
    """On CPU tensors admm_chunk runs one_iter_ref and counts no launch."""
    _, _, _, _, _, _, p_t, d_t = setups(3)
    s0 = tk.init_scaled_state(p_t)
    ref = s0
    for _ in range(4):
        ref = tk.one_iter_ref(p_t, ref, d_t)
    before = tk.admm_chunk.launches
    out = tk.admm_chunk(p_t, s0, d_t, 4)
    assert tk.admm_chunk.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_kernel_wrapper_rejects_bad_inputs(setups):
    """No quiet fallback: an unknown device raises, and the kernel's input
    check refuses a wrong dtype, shape or layout."""
    _, _, _, _, _, _, p_t, d_t = setups(3)
    s0 = tk.init_scaled_state(p_t)
    meta = lambda nt: type(nt)(*(x.to("meta") for x in nt))  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        tk.admm_chunk(meta(p_t), meta(s0), d_t, 1)
    tk._check_kernel_inputs(p_t, s0, d_t)
    for bad in (p_t._replace(Gs=p_t.Gs.double()),
                p_t._replace(Fs=p_t.Fs.T.contiguous().T),
                p_t._replace(cu=p_t.cu[:-1])):
        with pytest.raises(ValueError, match="admm_chunk"):
            tk._check_kernel_inputs(bad, s0, d_t)


def test_solve_saa_qp_pallas_quality():
    """test_pallas_admm.py:136-170 on the port's CPU path (plain iteration):
    feasible to 2e-2 against the dense constraint matrix, with the objective
    of the structured 'admm' solve at the same tolerance (this small f32
    problem stalls near eps 1e-3 for every backend, so the contract is
    solution quality at a fixed budget, not the solved flag). The reference
    solve is the port's float64 one, which test_torch_admm.py holds to the
    JAX solve. test_torch_saa_admm_f.py holds the polished float32 solve."""
    st, data = make_problem(M=12)
    tst, tdata = tqp.SAAQPStatic(*st[:14]), interop.saa_qp_data(data)
    cfg = TSolverConfig(eps_abs=1e-3, eps_rel=1e-3, max_iter=4000,
                        polish=False)
    sol_k = tk.solve_saa_qp_pallas(
        tst, type(tdata)(*(x.float() for x in tdata)), 3, cfg, chunk=50)
    assert float(sol_k.prim_res) < 2e-2
    sol_x = tqp.solve_saa_qp(tst, tdata, 3, cfg)
    A, ld, ud = dense_reference_A(st, jax.tree.map(np.asarray, data), 3)
    p_diag, q = (np.asarray(v) for v in build_objective(st, data))
    x_k, x_x = sol_k.x.double().numpy(), sol_x.x.numpy()
    for x in (x_k, x_x):
        Ax = A @ x
        assert np.max(Ax - ud) < 2e-2 and np.max(ld - Ax) < 2e-2
    obj = lambda v: 0.5 * np.sum(p_diag * v * v) + q @ v  # noqa: E731
    assert abs(obj(x_k) - obj(x_x)) <= 5e-2 * (1 + abs(obj(x_x)))


def test_solve_saa_qp_pallas_refuses_what_it_cannot_do():
    """The fused kernels take float32 only: a float64 problem raises before
    any iteration, with or without polish (float32 polish runs since the
    compensated factorization of ops/dsjit.py is ported)."""
    st, data = make_problem(M=12)
    tst = tqp.SAAQPStatic(*st[:14])
    tdata = interop.saa_qp_data(data)
    for polish in (False, True):
        with pytest.raises(ValueError, match="float32"):
            tk.solve_saa_qp_pallas(tst, tdata, 3, TSolverConfig(polish=polish))

