"""The port's structured SAA QP (packing, bounds, objective, operators and
the Schur-complement KKT solve) against the JAX package on the same float64
problem data, at scp_iter in {0, 1, 2, 3} (gated and live iterations); and
the float32 compensated factorization and the sweep precisions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core.config import SolverConfig as TSolverConfig
from riskaversetrajopt_torch.ops import admm as tadmm
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_torch.ops.rollout import SampleLinearization
from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.ops import admm as jadmm
from riskaversetrajopt_tpu.ops import saa_qp as jqp
from riskaversetrajopt_tpu.ops.rollout import linearize_batch
from tests.test_saa_qp import make_problem

# Everything is float64. Elementwise pieces agree to roundoff; the
# operators sum over K*n or M*K terms in another order, and the KKT solve
# runs through a Cholesky of the (n+2) Schur complement, whose condition
# number (~1e6 here) multiplies that roundoff.
ELEM = dict(rtol=1e-13, atol=0)
SUMS = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def problems():
    cache = {}

    def get(baseline=False):
        if baseline not in cache:
            st, data = make_problem(baseline=baseline)
            cache[baseline] = (st, data, tqp.SAAQPStatic(*st[:14]),
                               interop.saa_qp_data(data))
        return cache[baseline]

    return get


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pack_matches():
    M = 6
    model = DroneModel(DroneScenario(M=M))
    import jax

    om = model.sample(jax.random.PRNGKey(2), M)
    us = np.asarray(model.initial_guess(), np.float64) + 0.01
    lin = linearize_batch(model, jnp.asarray(us), om)
    p_diag_u = np.linspace(0.5, 1.5, us.size)
    j = jqp.pack_saa_qp_data(lin, jnp.asarray(us.reshape(-1)),
                             jnp.asarray(p_diag_u), 0.2)
    t = tqp.pack_saa_qp_data(
        SampleLinearization(*(_t(f) for f in lin)), _t(us.reshape(-1)),
        _t(p_diag_u), 0.2,
    )
    for name, a, b in zip(j._fields, t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14, err_msg=name)


@pytest.mark.parametrize("baseline", [False, True])
@pytest.mark.parametrize("scp_iter", [0, 1, 2, 3])
def test_bounds_and_objective_match(problems, scp_iter, baseline):
    st, data, tst, tdata = problems(baseline)
    l_j, u_j = (np.asarray(v) for v in jqp.build_bounds(st, data, scp_iter))
    l_t, u_t = (v.numpy() for v in tqp.build_bounds(tst, tdata, scp_iter))
    # the same +-inf pattern (the OSQP NaN->-inf gating quirk included)
    np.testing.assert_array_equal(np.isinf(l_t), np.isinf(l_j))
    np.testing.assert_array_equal(np.isinf(u_t), np.isinf(u_j))
    np.testing.assert_allclose(l_t, l_j, **ELEM)
    np.testing.assert_allclose(u_t, u_j, **ELEM)
    for a, b in zip(tqp.build_objective(tst, tdata),
                    jqp.build_objective(st, data)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize(
    "scp_iter,baseline",
    [(0, False), (1, False), (2, False), (3, False), (0, True), (3, True)],
)
def test_operators_match(problems, scp_iter, baseline):
    st, data, tst, tdata = problems(baseline)
    jops = jqp.SAAQPOps(st, data, jnp.asarray(scp_iter))
    tops = tqp.SAAQPOps(tst, tdata, scp_iter)
    nv = st.n + st.M + 2
    m = st.n_fc + 1 + st.M + st.M * st.K + 1 + st.n
    rng = np.random.default_rng(scp_iter)
    z, w = rng.standard_normal(nv), rng.standard_normal(m)
    D, E = rng.uniform(0.5, 2.0, nv), rng.uniform(0.5, 2.0, m)
    for name, arg in [("matvec_A", z), ("rmatvec_A", w), ("matvec_P", z),
                      ("row_inf_norms", D), ("col_inf_norms", E),
                      ("col_inf_norms_P", D)]:
        a = getattr(tops, name)(_t(arg)).numpy()
        b = np.asarray(getattr(jops, name)(jnp.asarray(arg)))
        np.testing.assert_allclose(a, b, err_msg=name, **SUMS)


@pytest.mark.parametrize("chol_inverse", [False, True])
@pytest.mark.parametrize("scp_iter", [0, 1, 2, 3])
def test_factorize_kkt_solve_match(problems, scp_iter, chol_inverse):
    """factorize + kkt_solve (one 'true' refinement pass) on a random
    right-hand side, through the Ruiz-scaled operator as the ADMM loop
    calls it."""
    st, data, tst, tdata = problems()
    jops = jqp.SAAQPOps(st, data, jnp.asarray(scp_iter),
                        kkt_chol_inverse=chol_inverse)
    tops = tqp.SAAQPOps(tst, tdata, scp_iter, kkt_chol_inverse=chol_inverse)
    _, q = jqp.build_objective(st, data)
    l, u = jqp.build_bounds(st, data, jnp.asarray(scp_iter))
    sc_j = jadmm.ruiz_equilibrate(jops, q, l, u)
    sc_t = interop.scaling(sc_j)
    ls, us = sc_j.E * l, sc_j.E * u
    rho_vec = jadmm.rho_vector(ls, us, 0.1)
    sigma = jnp.full(q.shape[0], 1e-6)
    rhs = np.random.default_rng(7).standard_normal(q.shape[0])
    x_j = np.asarray(jadmm.ScaledOps(jops, sc_j).kkt_solve(
        jadmm.ScaledOps(jops, sc_j).factorize(rho_vec, sigma),
        jnp.asarray(rhs), rho_vec, sigma))
    tso = tadmm.ScaledOps(tops, sc_t)
    rv_t, sg_t = _t(rho_vec), _t(sigma)
    x_t = tso.kkt_solve(tso.factorize(rv_t, sg_t), _t(rhs), rv_t, sg_t).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-9,
                               atol=1e-9 * np.max(np.abs(x_j)))


def test_factored_refine_mode_matches(problems):
    st, data, tst, tdata = problems()
    jops = jqp.SAAQPOps(st, data, jnp.asarray(3), kkt_refine_iters=2,
                        kkt_refine_mode="factored")
    tops = tqp.SAAQPOps(tst, tdata, 3, kkt_refine_iters=2,
                        kkt_refine_mode="factored")
    l, u = jqp.build_bounds(st, data, jnp.asarray(3))
    rho_vec = jadmm.rho_vector(l, u, 0.1)
    sigma = jnp.full(st.n + st.M + 2, 1e-6)
    rhs = np.random.default_rng(2).standard_normal(st.n + st.M + 2)
    x_j = np.asarray(jops.kkt_solve(jops.factorize(rho_vec, sigma),
                                    jnp.asarray(rhs), rho_vec, sigma))
    rv_t, sg_t = _t(rho_vec), _t(sigma)
    x_t = tops.kkt_solve(tops.factorize(rv_t, sg_t), _t(rhs), rv_t, sg_t)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-9,
                               atol=1e-9 * np.max(np.abs(x_j)))


def test_unported_options_raise(problems):
    """No quiet fallback: a sweep precision the TPU does not name raises.
    Float32 factorization is compensated (ops/dsjit.py) and runs."""
    _, _, tst, tdata = problems()
    ops32 = tqp.SAAQPOps(tst, type(tdata)(*(x.float() for x in tdata)), 3)
    assert ops32.factorize_compensated
    nv = tst.n + tst.M + 2
    m = tst.n_fc + 1 + tst.M + tst.M * tst.K + 1 + tst.n
    S_op = ops32.factorize(torch.ones(m), torch.ones(nv))[0]
    assert S_op.dtype == torch.float32 and bool(torch.isfinite(S_op).all())
    with pytest.raises(ValueError, match="sweep_precision"):
        tqp.make_ops(tst, tdata, 3, TSolverConfig(sweep_precision="tf32"))


@pytest.fixture(scope="module")
def problem32():
    """The float32 M=12 problem of tests/test_pallas_admm.py on both sides."""
    import jax

    st, data = make_problem(M=12)
    data32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), data)
    return (st, data32, tqp.SAAQPStatic(*st[:14]),
            interop.saa_qp_data(data32, dtype=torch.float32))


@pytest.mark.parametrize("scp_iter", [0, 3])
def test_compensated_factorize_float32_matches(problem32, scp_iter):
    """The float32 compensated factorization (double-single sums over M) and
    kkt_solve through the Ruiz-scaled operator, against the JAX package's on
    the same float32 data, scaling and rho. Both form the per-sample
    contractions over K in plain float32 in their own order, so the Schur
    block S = L L^T agrees to 1e-6 of its largest entry, and the solve of a
    random right-hand side (one 'true' refinement pass) to 1e-4 of scale."""
    st, data32, tst, tdata = problem32
    jops = jqp.SAAQPOps(st, data32, jnp.asarray(scp_iter))
    tops = tqp.SAAQPOps(tst, tdata, scp_iter)
    assert jops.factorize_compensated and tops.factorize_compensated
    _, q = jqp.build_objective(st, data32)
    l, u = jqp.build_bounds(st, data32, jnp.asarray(scp_iter))
    sc_j = jadmm.ruiz_equilibrate(jops, q, l, u)
    rho_vec = jadmm.rho_vector(sc_j.E * l, sc_j.E * u, 0.1).astype(jnp.float32)
    sigma = jnp.full(q.shape[0], 1e-6, jnp.float32)
    sops_j = jadmm.ScaledOps(jops, sc_j)
    sops_t = tadmm.ScaledOps(tops, interop.scaling(sc_j, dtype=torch.float32))
    f_j = sops_j.factorize(rho_vec, sigma)
    rv_t, sg_t = _t(rho_vec), _t(sigma)
    f_t = sops_t.factorize(rv_t, sg_t)
    L_j = np.asarray(f_j[0], np.float64)
    L_t = f_t[0].double().numpy()
    S_j, S_t = L_j @ L_j.T, L_t @ L_t.T
    assert np.max(np.abs(S_t - S_j)) <= 1e-6 * np.max(np.abs(S_j))
    rhs = np.random.default_rng(scp_iter).standard_normal(q.shape[0])
    rhs = rhs.astype(np.float32)
    x_j = np.asarray(sops_j.kkt_solve(f_j, jnp.asarray(rhs), rho_vec, sigma))
    x_t = sops_t.kkt_solve(f_t, _t(rhs), rv_t, sg_t).numpy()
    assert np.max(np.abs(x_t - x_j)) <= 1e-4 * np.max(np.abs(x_j))


def test_sweep_precisions(problem32):
    """The G-sweeps at "high" (bf16x3) lie within 1e-5 of "highest", relative
    to the scale of their terms max(|a| @ |b|) (a sum with cancellation has a
    smaller result than its terms; bf16x3 drops ~3 * 2^-18 of each term), and
    "default" equals "highest" on bf16-rounded operands exactly (the same
    float32 matmul of the same rounded values)."""
    _, _, tst, tdata = problem32
    rng = np.random.default_rng(5)
    nv = tst.n + tst.M + 2
    m = tst.n_fc + 1 + tst.M + tst.M * tst.K + 1 + tst.n
    z = _t(rng.standard_normal(nv).astype(np.float32))
    w = _t(rng.standard_normal(m).astype(np.float32))
    G = tdata.G.reshape(-1, tst.n)
    u, wG = z[: tst.n], w[: G.shape[0]]
    for a, b in ((G, u), (wG, G)):
        ref = tqp.sweep_matmul(a, b, "highest").double()
        high = tqp.sweep_matmul(a, b, "high").double()
        scale = torch.max(a.double().abs() @ b.double().abs())
        assert torch.max(torch.abs(high - ref)) <= 1e-5 * scale
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    ops = {p: tqp.SAAQPOps(tst, tdata, 3, sweep_precision=p)
           for p in tqp.SWEEP_PRECISIONS}
    # "default": bf16 operands, float32 accumulation, in both sweep forms;
    # through matvec_A (u enters the sweep unscaled) with a bf16 z only G is
    # rounded, so "highest" on rounded G matches exactly
    for a, b in ((G, u), (wG, G)):
        assert torch.equal(tqp.sweep_matmul(a, b, "default"), bf(a) @ bf(b))
    ops_bf = tqp.SAAQPOps(tst, tdata._replace(G=bf(tdata.G)), 3)
    assert torch.equal(ops["default"].matvec_A(bf(z)), ops_bf.matvec_A(bf(z)))
    # and the rounded operands differ from "highest" at the bf16 level
    assert not torch.equal(ops["default"].matvec_A(z), ops["highest"].matvec_A(z))
