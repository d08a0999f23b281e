"""The port's Gaussian drone baseline (models/drone_gaussian.py) against the
JAX package, in float64, at the warm start the reference prescribes: the
controls of the committed M=50 golden SAA plan
(tests/fixtures/gold_drone_m50_a0.2_seed0_iters15.npy) and alpha 0.2.
Mean and covariance trajectories, obstacle rows, g, f and the bounds
(1e-12), the Lagrangian's Hessian through the covariance recursion (1e-9
of its scale) and a 10-iteration NLP at tol 0 (Z within 1e-6 relative
L2). The full warm solve (tests/test_gaussian.py:124-152) is marked slow.
The float32 drone-Gaussian NLP is an expected failure in JAX
(tests/test_f32_gaussian.py:109), so the port is held to float64 here."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian

from riskaversetrajopt_torch.core.config import DroneScenario as TScenario
from riskaversetrajopt_torch.models.drone_gaussian import (
    GaussianDronePlanner as TPlanner,
)
from riskaversetrajopt_torch.ops.nlp_ipm import NLPConfig as TConfig
from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.models.drone_gaussian import GaussianDronePlanner
from riskaversetrajopt_tpu.ops.nlp_ipm import NLPConfig
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)

ALPHA = 0.2
GOLD = (Path(__file__).parent / "fixtures"
        / "gold_drone_m50_a0.2_seed0_iters15.npy")
TOL = dict(rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def planners():
    us = np.load(GOLD)
    pj = GaussianDronePlanner(DroneScenario(), alpha=ALPHA)
    pt = TPlanner(TScenario(), alpha=ALPHA, device="cpu")
    return pj, pt, us


def test_trajectories_and_constraints_match_jax(planners):
    """At the golden controls and a seeded risk allocation: the mean and
    covariance trajectories, the quantile-padded obstacle rows, the state
    box rows, g, f, the initial guess and the bounds, JAX's to 1e-12."""
    pj, pt, us = planners
    rng = np.random.default_rng(0)
    a_state = rng.uniform(1e-4, 1e-2, size=(pt.S, pt.n_obs))
    a_obs = rng.uniform(1e-4, 1e-2, size=pt.n_obs)
    usj, ust = jnp.asarray(us), torch.from_numpy(us)
    pairs = [
        (pt.mean_trajectory(ust), pj.mean_trajectory(usj)),
        (pt.covariance_trajectory(ust), jax.jit(pj.covariance_trajectory)(usj)),
        (pt.obstacle_constraints(ust, torch.from_numpy(a_state),
                                 torch.from_numpy(a_obs)),
         jax.jit(pj.obstacle_constraints)(usj, jnp.asarray(a_state),
                                          jnp.asarray(a_obs))),
        (pt.state_bound_constraints(ust), pj.state_bound_constraints(usj)),
    ]
    Z = np.concatenate([us.reshape(-1), a_state.reshape(-1), a_obs])
    Zj, Zt = jnp.asarray(Z), torch.from_numpy(Z)
    pairs += [(pt.g(Zt), jax.jit(pj.g)(Zj)), (pt.f(Zt), pj.f(Zj)),
              (pt.initial_guess(ust), pj.initial_guess(usj))]
    for i, (a, b) in enumerate(pairs):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, err_msg=str(i), **TOL)
    for name, a, b in zip(("g_L", "g_U", "n_eq", "x_L", "x_U"), pt.bounds(),
                          pj.bounds()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_lagrangian_hessian_matches_jax(planners):
    """The Hessian of f + lam.g at the warm start with seeded multipliers:
    forward-over-reverse through the covariance recursion and its per-step
    drift Jacobians, JAX's to 1e-9 of its largest entry (measured
    ~1e-15)."""
    pj, pt, us = planners
    Zj = pj.initial_guess(jnp.asarray(us))
    lam = np.random.default_rng(1).standard_normal(pj.g(Zj).shape[0])
    Hj = np.asarray(jax.jit(jax.hessian(
        lambda Z: pj.f(Z) + jnp.dot(jnp.asarray(lam), pj.g(Z))))(Zj))
    lam_t = torch.from_numpy(lam)
    Ht = hessian(lambda Z: pt.f(Z) + torch.dot(lam_t, pt.g(Z)))(
        pt.initial_guess(torch.from_numpy(us))).numpy()
    assert Ht.shape == Hj.shape == (pt.nv, pt.nv)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-9 * np.abs(Hj).max())


def test_ten_iteration_nlp_matches_jax(planners):
    """solve() from the warm start at tol 0 for 10 barrier iterations: Z
    within 1e-6 relative L2 of JAX's (measured ~3e-14)."""
    pj, pt, us = planners
    rj = pj.solve(jnp.asarray(us), NLPConfig(tol=0.0, max_iter=10))
    rt = pt.solve(torch.from_numpy(us), TConfig(tol=0.0, max_iter=10))
    Zj = np.asarray(rj.nlp.Z)
    assert rt.nlp.iters == int(rj.nlp.iters) == 10
    assert np.linalg.norm(rt.nlp.Z.numpy() - Zj) <= 1e-6 * np.linalg.norm(Zj)
    np.testing.assert_allclose(rt.xs.numpy(), np.asarray(rj.xs), rtol=0,
                               atol=1e-6)


@pytest.mark.slow
def test_warm_solve_certifies():
    """tests/test_gaussian.py:124-152 on the port: the SAA plan of a
    10-iteration SCP at alpha 0.1 on JAX's PRNGKey(0) omegas (M=50) warm
    starts the NLP at alpha 0.1, which is solved at tol 1e-6 within 1500
    iterations with dual residual <= 1e-5 and the risk budget
    sum(alphas) <= alpha + 1e-6. (From the golden M=50 plan at alpha 0.2
    neither package certifies within 1500 iterations: prim ~7e-4, dual
    ~7 in both, my CPU runs.)"""
    from riskaversetrajopt_torch import interop
    from riskaversetrajopt_torch.core.config import SCPConfig
    from riskaversetrajopt_torch.models.drone import DroneModel as TDrone
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt as TOpt
    from riskaversetrajopt_tpu.models.drone import DroneModel

    om = DroneModel(DroneScenario()).sample(jax.random.PRNGKey(0), 50)
    opt = TOpt(TDrone(TScenario(), device="cpu"), method="saa",
               scp_cfg=SCPConfig(num_iters=10, gate_iters=2,
                                 gate_row_scale=1e-7, gate_bound_l=-0.1,
                                 gate_bound_u=0.1), device="cpu")
    saa = opt.solve(interop.drone_omega(om), alpha=0.1)
    pt = TPlanner(TScenario(), alpha=0.1, device="cpu")
    res = pt.solve(saa.us)
    assert res.nlp.solved, (float(res.nlp.prim_res), float(res.nlp.dual_res))
    assert float(res.nlp.dual_res) <= 1e-5
    assert float(torch.sum(res.alphas_risk)) <= 0.1 + 1e-6
