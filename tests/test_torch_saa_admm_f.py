"""The port's lane-flat fused-ADMM host code (ops/cuda/saa_admm_f.py) against
the JAX package's (ops/pallas/experimental/saa_admm_f.py) on the same float32
problem, M=12: the layout maps, the plain iteration against JAX's kernel in
interpret mode and against the port's B1 iteration, the wrapper's CPU path,
and the '_admm-pallas-f' solve (with the polished '_admm-pallas' solve)
beside JAX's structured solver. test_torch_cuda_kernels.py holds the CUDA
kernel against the plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core.config import SolverConfig as TSolverConfig
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc
from riskaversetrajopt_torch.ops.cuda import saa_admm as tk
from riskaversetrajopt_torch.ops.cuda import saa_admm_f as tkf
from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.ops.pallas.experimental import saa_admm as jk
from riskaversetrajopt_tpu.ops.pallas.experimental import saa_admm_f as jkf
from riskaversetrajopt_tpu.ops.saa_qp import build_objective, solve_saa_qp
from tests.test_saa_qp import dense_reference_A, make_problem
from tests.test_torch_saa_admm import _setup


@pytest.fixture(scope="module")
def setup3():
    return _setup(3)


def _iterate(fn, p, s, d, n):
    for _ in range(n):
        s = fn(p, s, d)
    return s


def test_f_layout_roundtrips_exact(setup3):
    """to_f puts Gs[i, k] at G2 row k*M + i and G2T is its transpose;
    state_to_f / f_to_state only move float32 values: exact."""
    *_, p_t, d = setup3
    pf = tkf.to_f(p_t, d)
    G2 = pf.G2.reshape(d.K, d.M, d.n)
    assert torch.equal(G2, p_t.Gs.transpose(0, 1))
    assert torch.equal(pf.G2T, pf.G2.T)
    assert torch.equal(pf.eGy_f.reshape(d.K, d.M), p_t.eGy.T)
    assert all(torch.equal(a, b) for a, b in zip(pf[7:], p_t[6:]))
    s = _iterate(tk.one_iter_ref, p_t, tk.init_scaled_state(p_t), d, 3)
    back = tkf.f_to_state(tkf.state_to_f(s, d), d)
    for name, a, b in zip(s._fields, back, s):
        assert torch.equal(a, b), name


def test_interop_f_layout_matches_to_f(setup3):
    """interop.scaled_saa_f / scaled_state_f of JAX's padded F layout equal
    the port's to_f / state_to_f of the interop'd natural layout exactly
    (float32 moves only)."""
    _, _, p_j, d_j, _, _, _, d_t = setup3
    got = interop.scaled_saa_f(jkf.to_f(p_j, d_j), d_j)
    want = tkf.to_f(interop.scaled_saa(p_j, d_j), d_t)
    for name, a, b in zip(want._fields, got, want):
        assert a.shape == b.shape and torch.equal(a, b), name
    s_j = jk.init_scaled_state(p_j, d_j)
    for _ in range(2):
        s_j = jk.one_iter_ref(p_j, s_j, d_j)
    got = interop.scaled_state_f(jkf.state_to_f(s_j, d_j), d_j)
    want = tkf.state_to_f(interop.scaled_state(s_j, d_j), d_t)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


def test_one_iter_ref_f_matches_jax_interpret(setup3):
    """Four plain iterations against JAX's kernel B2 in interpret mode from
    the same state, to the 2e-2 of test_pallas_admm.py:221-239 (float32
    sums in another order, amplified by the 1e3 rho of the equality rows)."""
    _, _, p_j, d_j, _, _, _, d_t = setup3
    pf_j = jkf.to_f(p_j, d_j)
    s0_j = jkf.state_to_f(jk.init_scaled_state(p_j, d_j), d_j)
    out_j = interop.scaled_state_f(
        jkf.admm_chunk_pallas_f(pf_j, s0_j, d_j, 4, interpret=True), d_j)
    pf = interop.scaled_saa_f(pf_j, d_j)
    out = _iterate(tkf.one_iter_ref_f, pf,
                   interop.scaled_state_f(s0_j, d_j), d_t, 4)
    for name, a, b in zip(out._fields, out, out_j):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=2e-2,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-4),
                                       (torch.float32, 2e-2)])
def test_one_iter_ref_f_matches_one_iter_ref(setup3, dtype, tol):
    """The F-layout iteration is B1's in another layout: five iterations
    agree through f_to_state to `tol` of each field's scale. float64 checks
    the logic (the sums differ only in order); float32 is the kernels' type,
    where the 1e3 rho of the equality rows amplifies that order into ~1e-2
    of the duals' scale, so it is held to 2e-2 as kernel checks are."""
    *_, p_t, d = setup3
    p = type(p_t)(*(x.to(dtype) for x in p_t))
    s0 = tk.init_scaled_state(p)
    ref = _iterate(tk.one_iter_ref, p, s0, d, 5)
    out = tkf.f_to_state(
        _iterate(tkf.one_iter_ref_f, tkf.to_f(p, d), tkf.state_to_f(s0, d),
                 d, 5), d)
    for name, a, b in zip(ref._fields, out, ref):
        scale = float(torch.max(torch.abs(b))) if b.numel() else 0.0
        assert float(torch.max(torch.abs(a - b))) <= tol * max(scale, 1e-30), name


def test_admm_chunk_f_on_cpu_is_the_plain_iteration(setup3):
    """On CPU tensors admm_chunk_f runs one_iter_ref_f at the precision it
    is given and counts no launch."""
    *_, p_t, d = setup3
    pf = tkf.to_f(p_t, d)
    s0 = tkf.state_to_f(tk.init_scaled_state(p_t), d)
    before = tkf.admm_chunk_f.launches
    for prec in tqp.SWEEP_PRECISIONS:
        ref = _iterate(lambda p, s, d: tkf.one_iter_ref_f(p, s, d, prec),
                       pf, s0, d, 3)
        out = tkf.admm_chunk_f(pf, s0, d, 3, prec)
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), prec
    assert tkf.admm_chunk_f.launches == before


@pytest.mark.parametrize("precision", tqp.SWEEP_PRECISIONS)
def test_sweep_checks_tell_precisions_apart(setup3, precision):
    """admm_step_f on CPU tensors is one plain iteration with its sweep
    operands. kernel_checks holds it as it holds kernel B2 on the card: its
    sweeps hold at their own precision and fail at each other one (what a
    kernel computing the wrong precision would show), and step_err_f of the
    plain step against the plain iteration is 0."""
    *_, p_t, d = setup3
    pf = tkf.to_f(p_t, d)
    s = tkf.admm_chunk_f(pf, tkf.state_to_f(tk.init_scaled_state(p_t), d),
                         d, 3, precision)
    step = tkf.admm_step_f(pf, s, d, precision)
    ref = tkf.one_iter_ref_f(pf, s, d, precision)
    assert all(torch.equal(a, b) for a, b in zip(step.state, ref))
    assert kc.step_err_f(pf, s, step, d, precision) == (0.0, 0.0)
    errs = kc.sweep_errs_f(pf, s, step, d)
    kc.check_sweeps_f(errs, precision)
    for other in tqp.SWEEP_PRECISIONS:
        if other != precision:
            with pytest.raises(AssertionError, match="sweep"):
                kc.check_sweeps_f(errs, other)


def test_kernel_wrapper_f_rejects_bad_inputs(setup3):
    """No quiet fallback: an unknown device or precision raises, and the
    kernel's input check refuses a wrong dtype, shape or layout."""
    *_, p_t, d = setup3
    pf = tkf.to_f(p_t, d)
    s0 = tkf.state_to_f(tk.init_scaled_state(p_t), d)
    meta = lambda nt: type(nt)(*(x.to("meta") for x in nt))  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        tkf.admm_chunk_f(meta(pf), meta(s0), d, 1)
    with pytest.raises(ValueError, match="sweep_precision"):
        tkf.admm_chunk_f(pf, s0, d, 1, "tf32")
    tkf._check_kernel_inputs(pf, s0, d)
    for bad_p, bad_s in ((pf._replace(G2=pf.G2.double()), s0),
                         (pf._replace(G2T=pf.G2), s0),
                         (pf._replace(Fs=pf.Fs.T.contiguous().T), s0),
                         (pf, s0._replace(zG_f=s0.zG_f[:-1]))):
        with pytest.raises(ValueError, match="admm_chunk_f"):
            tkf._check_kernel_inputs(bad_p, bad_s, d)


@pytest.fixture(scope="module")
def quality_reference():
    """JAX's structured float32 solve of the M=12 problem at scp_iter 3,
    with the dense constraint matrix (test_pallas_admm.py:242-268)."""
    st, data = make_problem(M=12)
    data32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), data)
    cfg = SolverConfig(eps_abs=1e-3, eps_rel=1e-3, max_iter=4000)
    x_ref = np.asarray(solve_saa_qp(st, data32, jnp.asarray(3), cfg).x,
                       np.float64)
    A, ld, ud = dense_reference_A(st, jax.tree.map(np.asarray, data32), 3)
    p_diag, q = (np.asarray(v, np.float64) for v in build_objective(st, data32))
    return st, data32, x_ref, A, ld, ud, p_diag, q


@pytest.mark.parametrize("solver", ["_admm-pallas-f", "_admm-pallas"])
def test_fused_solvers_quality_polished(quality_reference, solver):
    """solve_saa_qp_pallas_f, and solve_saa_qp_pallas, with polish on
    (SolverConfig's default, so the float32 compensated factorization runs)
    meet the contract of test_pallas_admm.py:242-268 beside JAX's solver:
    primal residual < 2e-2, feasible to 2e-2 against the dense constraint
    matrix, objective within 5e-2 of JAX's (this small float32 problem
    stalls near eps 1e-3 for every backend, so the contract is solution
    quality at a fixed budget, not the solved flag)."""
    st, data32, x_ref, A, ld, ud, p_diag, q = quality_reference
    solve = {"_admm-pallas-f": tkf.solve_saa_qp_pallas_f,
             "_admm-pallas": tk.solve_saa_qp_pallas}[solver]
    cfg = TSolverConfig(eps_abs=1e-3, eps_rel=1e-3, max_iter=4000)
    assert cfg.polish
    sol = solve(tqp.SAAQPStatic(*st[:14]),
                interop.saa_qp_data(data32, dtype=torch.float32), 3, cfg,
                chunk=50)
    assert float(sol.prim_res) < 2e-2
    for x in (sol.x.double().numpy(), x_ref):
        Ax = A @ x
        assert np.max(Ax - ud) < 2e-2 and np.max(ld - Ax) < 2e-2
    obj = lambda v: 0.5 * np.sum(p_diag * v * v) + q @ v  # noqa: E731
    assert abs(obj(sol.x.double().numpy()) - obj(x_ref)) <= 5e-2 * (
        1 + abs(obj(x_ref)))
