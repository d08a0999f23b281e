"""Anderson acceleration in the port's ADMM (ops/admm.py:anderson_step,
SolverConfig.anderson_depth) against the JAX package's (admm.py:379-470) on
the same float64 problems: the drone's structured QP at M=8 — the gated QP
at the initial guess, and the first post-gating QP, linearized where the
JAX solves of the first three SCP iterations leave the controls — and a
dense random QP. Same iteration count, x and y within 1e-8 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core.config import SolverConfig as TSolverConfig
from riskaversetrajopt_torch.ops import admm as tadmm
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_tpu.core.config import DroneScenario, SolverConfig
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.ops import admm as jadmm
from riskaversetrajopt_tpu.ops import saa_qp as jqp
from riskaversetrajopt_tpu.ops.rollout import linearize_batch
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)
from tests.test_saa_qp import make_problem

M = 8
CFG = dict(eps_abs=1e-7, eps_rel=1e-7, max_iter=1500)


@pytest.fixture(scope="module")
def drone():
    st, data = make_problem(M=M)
    return st, data, tqp.SAAQPStatic(*st[:14]), interop.saa_qp_data(data)


@pytest.fixture(scope="module")
def post_gating(drone):
    """The QP of scp_iter 2 (the first past the gating) at the controls
    the JAX solves of scp_iters 0-2 reach (eps 1e-6, the driver's)."""
    st = drone[0]
    scn = DroneScenario(M=M)
    model = DroneModel(scn)
    om = model.sample(jax.random.PRNGKey(0), M=M, method="saa")
    p_diag_u = jnp.tile(2.0 * scn.dt * jnp.diag(scn.R), model.S)
    us = model.initial_guess().astype(jnp.float64)
    cfg = SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000,
                       polish=False)

    def define(us):
        return jqp.pack_saa_qp_data(linearize_batch(model, us, om),
                                    us.reshape(-1), p_diag_u, 0.2)

    for scp_iter in range(3):
        sol = jqp.solve_saa_qp(st, define(us), jnp.asarray(scp_iter), cfg)
        assert bool(sol.solved)
        us = sol.x[:st.n].reshape(model.S, model.n_u)
    data = define(us)
    return st, data, drone[2], interop.saa_qp_data(data)


def _dense(seed=0, n=12, m=20):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    x_feas = rng.standard_normal(n) * 0.1
    l = A @ x_feas - rng.uniform(0.1, 2.0, m)
    u = A @ x_feas + rng.uniform(0.1, 2.0, m)
    return P, q, A, l, u


def _assert_same(t, j, tol=1e-8):
    assert t.iters == int(j.iters)
    assert t.solved == bool(j.solved)
    for name in ("x", "y"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1.0, np.max(np.abs(b))),
                                   err_msg=name)


@pytest.mark.parametrize("depth", [3, 5])
def test_anderson_gated_drone_qp_matches_jax(drone, depth):
    """The gated QP certifies in both with the same iteration count."""
    st, data, tst, tdata = drone
    j = jqp.solve_saa_qp(st, data, jnp.asarray(0),
                         SolverConfig(anderson_depth=depth, **CFG))
    t = tqp.solve_saa_qp(tst, tdata, 0,
                         TSolverConfig(anderson_depth=depth, **CFG))
    assert t.solved
    _assert_same(t, j)


@pytest.mark.parametrize("depth", [3, 5])
def test_anderson_post_gating_drone_qp_matches_jax(post_gating, depth):
    """The post-gating QP over its first termination interval (25
    accelerated iterations, the first check, its rho request): x within
    1e-11 of JAX's. The Anderson steps amplify the two packages' float64
    roundoff (1e-12 on the plain path) about a thousandfold per interval
    on this QP (4e-8 at 50 iterations, 7e-5 at 75; the plain iteration
    stays at 1e-12), so past the first interval the two runs part, and at
    eps 1e-5 one certifies in 2325 iterations, the other in 1900 (host CPU
    runs; ROADMAP, Queue C)."""
    st, data, tst, tdata = post_gating
    kw = dict(eps_abs=1e-14, eps_rel=1e-14, max_iter=25, polish=False,
              anderson_depth=depth)
    j = jqp.solve_saa_qp(st, data, jnp.asarray(2), SolverConfig(**kw))
    t = tqp.solve_saa_qp(tst, tdata, 2, TSolverConfig(**kw))
    assert t.iters == 25
    _assert_same(t, j)
    np.testing.assert_allclose(float(t.rho), float(j.rho), rtol=1e-6)


@pytest.mark.parametrize("depth", [3, 5])
@pytest.mark.parametrize("polish", [False, True])
def test_anderson_dense_qp_matches_jax(depth, polish):
    P, q, A, l, u = _dense()
    kw = dict(anderson_depth=depth, polish=polish, eps_abs=1e-9,
              eps_rel=1e-9, max_iter=4000)
    j = jadmm.solve_dense_qp(*(jnp.asarray(a) for a in (P, q, A, l, u)),
                             SolverConfig(**kw))
    t = tadmm.solve_dense_qp(*(torch.tensor(a) for a in (P, q, A, l, u)),
                             TSolverConfig(**kw))
    assert t.solved
    _assert_same(t, j)


def test_anderson_depth_zero_is_the_plain_iteration(drone, monkeypatch):
    """Depth 0 never enters the Anderson step, and a history of one pair
    reproduces the plain iteration bit for bit (its one coefficient is
    exactly 1), so depth 0 and depth 1 give the same bits: the restructured
    inner loop leaves the plain ADMM iteration as it was."""
    _, _, tst, tdata = drone
    cfg = dict(eps_abs=1e-7, eps_rel=1e-7, max_iter=600, polish=True)
    calls = []
    step = tadmm.anderson_step
    monkeypatch.setattr(tadmm, "anderson_step",
                        lambda *a: calls.append(1) or step(*a))
    plain = tqp.solve_saa_qp(tst, tdata, 3, TSolverConfig(**cfg))
    assert not calls
    one = tqp.solve_saa_qp(tst, tdata, 3,
                           TSolverConfig(anderson_depth=1, **cfg))
    assert len(calls) == one.iters == plain.iters
    for name in ("x", "y", "z", "prim_res", "dual_res", "rho"):
        assert torch.equal(getattr(one, name), getattr(plain, name)), name
