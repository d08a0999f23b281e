"""The port's structured SAA QP (packing, bounds, objective, operators and
the Schur-complement KKT solve) against the JAX package on the same float64
problem data, at scp_iter in {0, 1, 2, 3} (gated and live iterations)."""

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
    """No quiet fallback: float32 factorization needs the compensated
    reductions of ops/dsjit.py (not ported), and only full-precision
    sweeps exist."""
    _, _, tst, tdata = problems()
    ops32 = tqp.SAAQPOps(tst, type(tdata)(*(x.float() for x in tdata)), 3)
    assert ops32.factorize_compensated
    nv = tst.n + tst.M + 2
    m = tst.n_fc + 1 + tst.M + tst.M * tst.K + 1 + tst.n
    with pytest.raises(NotImplementedError, match="dsjit"):
        ops32.factorize(torch.ones(m), torch.ones(nv))
    with pytest.raises(ValueError, match="sweep_precision"):
        tqp.make_ops(tst, tdata, 3, TSolverConfig(sweep_precision="high"))
