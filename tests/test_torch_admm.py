"""The port's ADMM solver (Ruiz equilibration, the two-level adaptive-rho
loop, termination, polish) and risk estimators against the JAX package on
the same float64 SAA QP at M=12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core.config import SolverConfig as TSolverConfig
from riskaversetrajopt_torch.ops import admm as tadmm
from riskaversetrajopt_torch.ops import cvar as tcvar
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.ops import admm as jadmm
from riskaversetrajopt_tpu.ops import cvar as jcvar
from riskaversetrajopt_tpu.ops import saa_qp as jqp
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)
from tests.test_saa_qp import make_problem


@pytest.fixture(scope="module")
def problem():
    st, data = make_problem(M=12)
    return st, data, tqp.SAAQPStatic(*st[:14]), interop.saa_qp_data(data)


def test_ruiz_equilibrate_matches(problem):
    st, data, tst, tdata = problem
    jops = jqp.SAAQPOps(st, data, jnp.asarray(3))
    _, q = jqp.build_objective(st, data)
    l, u = jqp.build_bounds(st, data, jnp.asarray(3))
    sc_j = jadmm.ruiz_equilibrate(jops, q, l, u, iters=5)
    tops = tqp.SAAQPOps(tst, tdata, 3)
    _, tq = tqp.build_objective(tst, tdata)
    tl, tu = tqp.build_bounds(tst, tdata, 3)
    sc_t = tadmm.ruiz_equilibrate(tops, tq, tl, tu, iters=5)
    # max-norms and square roots of float64 values: identical up to roundoff
    for name, a, b in zip(sc_j._fields, sc_t, sc_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   err_msg=name)


def _both(problem, scp_iter, **cfg):
    st, data, tst, tdata = problem
    j = jqp.solve_saa_qp(st, data, jnp.asarray(scp_iter), SolverConfig(**cfg))
    t = tqp.solve_saa_qp(tst, tdata, scp_iter, TSolverConfig(**cfg))
    return j, t


def _assert_same_solution(j, t, rtol):
    assert t.iters == int(j.iters)
    assert t.solved == bool(j.solved)
    assert t.prim_infeasible == bool(j.prim_infeasible)
    assert t.dual_infeasible == bool(j.dual_infeasible)
    # the adapted rho is sqrt of a ratio of residual norms, each a small
    # difference of O(1) terms: iterates that agree to ~1e-10 of their scale
    # pin it only to ~1e-6 near convergence
    np.testing.assert_allclose(float(t.rho), float(j.rho), rtol=1e-5)
    for name in ("x", "y", "z"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rtol * max(1.0, np.max(np.abs(b))),
                                   err_msg=name)


@pytest.mark.parametrize("variant", ["default", "backoff-period-epoch"])
def test_fixed_iteration_count_iterate_matches(problem, variant):
    """eps 1e-14 never terminates, so both run exactly max_iter iterations
    with the same adaptive-rho epochs; the second variant adds the check
    backoff, the periodic KKT refinement and fixed rho epochs. ADMM
    contracts the roundoff of the two float64 operator implementations, so
    the iterates agree to ~1e-9 of their scale."""
    extra = {} if variant == "default" else dict(
        check_backoff_max=4, kkt_refine_period=2, rho_epoch_every=50)
    j, t = _both(problem, 3, eps_abs=1e-14, eps_rel=1e-14, max_iter=150,
                 polish=False, **extra)
    assert t.iters == 150
    _assert_same_solution(j, t, rtol=1e-9)


@pytest.mark.parametrize("polish", [False, True])
def test_converged_solution_matches(problem, polish):
    """The gated QP certifies at eps 1e-6: same iteration count, flags,
    adapted rho and solution (polish accepted or rejected identically)."""
    j, t = _both(problem, 0, eps_abs=1e-6, eps_rel=1e-6, max_iter=4000,
                 polish=polish)
    assert t.solved
    _assert_same_solution(j, t, rtol=1e-8)


@pytest.mark.parametrize("alpha", [0.05, 0.2, 0.5])
def test_var_and_avar_match(alpha):
    """A sort and a mean: identical up to the mean's summation order."""
    Z = np.random.default_rng(int(alpha * 100)).standard_normal(1001)
    np.testing.assert_array_equal(
        float(tcvar.var_sorted(torch.from_numpy(Z), alpha)),
        float(jcvar.var_sorted(jnp.asarray(Z), alpha)),
    )
    np.testing.assert_allclose(
        float(tcvar.avar(torch.from_numpy(Z), alpha)),
        float(jcvar.avar(jnp.asarray(Z), alpha)), rtol=1e-13,
    )
