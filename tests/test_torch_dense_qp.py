"""The port's dense QP path (ops/admm.py: DenseQPOps, solve_dense_qp) against
the JAX package on the problems of tests/test_admm.py, float64, and against
the native C++ ADMM (riskaversetrajopt_tpu/native/qp.py, no JAX) as a third
oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch.core.config import SolverConfig as TSolverConfig
from riskaversetrajopt_torch.ops import admm as tadmm
from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.native.qp import solve_qp_native
from riskaversetrajopt_tpu.ops import admm as jadmm
from tests.test_admm import check_kkt

CFG = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000)


def _random(seed, n=10, m=16):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    x_feas = rng.standard_normal(n) * 0.1
    l = A @ x_feas - rng.uniform(0.1, 2.0, m)
    u = A @ x_feas + rng.uniform(0.1, 2.0, m)
    return P, q, A, l, u


def _box():
    n = 8
    c = np.linspace(-3, 3, n)
    return 2 * np.eye(n), -2 * c, np.eye(n), -np.ones(n), np.ones(n)


def _equality():
    rng = np.random.default_rng(0)
    n, me = 6, 2
    L = rng.standard_normal((n, n))
    G = rng.standard_normal((me, n))
    b = rng.standard_normal(me)
    return L @ L.T + n * np.eye(n), rng.standard_normal(n), G, b, b


def _loose():
    n = 4
    A = np.vstack([np.eye(n), np.ones((1, n))])
    return (2 * np.eye(n), -2 * np.arange(1.0, n + 1), A,
            np.full(n + 1, -np.inf), np.full(n + 1, np.inf))


def _avar_lp():
    rng = np.random.default_rng(7)
    M, alpha = 200, 0.1
    Z = rng.standard_normal(M)
    A = np.zeros((2 * M, M + 1))
    A[:M, :M] = -np.eye(M)
    A[M:, :M] = -np.eye(M)
    A[M:, -1] = -1.0
    u = np.concatenate([np.zeros(M), -Z])
    q = np.concatenate([np.full(M, 1.0 / (M * alpha)), [1.0]])
    return np.zeros((M + 1, M + 1)), q, A, np.full(2 * M, -np.inf), u


def _wide(seed):
    """tests/test_admm.py:238-285's problem: n=20, m=40, |l|, |u| > 1."""
    rng = np.random.default_rng(seed)
    n, m = 20, 40
    L = rng.standard_normal((n, n))
    P = L @ L.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n))
    q = rng.standard_normal(n)
    return P, q, A, -1.0 - rng.random(m), 1.0 + rng.random(m)


def _prim_infeasible():
    return (np.zeros((1, 1)), np.zeros(1), np.array([[1.0], [1.0]]),
            np.array([1.0, -np.inf]), np.array([np.inf, 0.0]))


def _dual_infeasible():
    return (np.zeros((1, 1)), np.array([-1.0]), np.array([[1.0]]),
            np.array([0.0]), np.array([np.inf]))


CERT = dict(max_iter=4000, polish=False)
CASES = {
    "box": (_box, CFG),
    "equality": (_equality, CFG),
    "random1": (lambda: _random(1), CFG),
    "random2": (lambda: _random(2), CFG),
    "random3": (lambda: _random(3), CFG),
    "loose_rows": (_loose, CFG),
    "avar_lp": (_avar_lp, CFG),
    "backoff": (lambda: _wide(7), dict(eps_abs=1e-6, eps_rel=1e-6,
                                       max_iter=20000, polish=False,
                                       check_backoff_max=8)),
    "rho_epochs": (lambda: _wide(11), dict(eps_abs=1e-6, eps_rel=1e-6,
                                           max_iter=20000, polish=False,
                                           rho_epoch_every=100)),
    "prim_infeasible": (_prim_infeasible, CERT),
    "dual_infeasible": (_dual_infeasible, CERT),
}


def _both(P, q, A, l, u, cfg, **kw):
    j = jadmm.solve_dense_qp(*(jnp.asarray(v) for v in (P, q, A, l, u)),
                             SolverConfig(**cfg),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    t = tadmm.solve_dense_qp(*(torch.tensor(v) for v in (P, q, A, l, u)),
                             TSolverConfig(**cfg),
                             **{k: torch.tensor(v) for k, v in kw.items()})
    return j, t


@pytest.mark.parametrize("name", list(CASES))
def test_solve_dense_qp_matches_jax(name):
    """The same ADMM iterations, flags and certificates as JAX, and x within
    1e-8 of its scale (two float64 implementations of one algorithm); the
    certified solutions also meet tests/test_admm.py:check_kkt."""
    make, cfg = CASES[name]
    P, q, A, l, u = make()
    j, t = _both(P, q, A, l, u, cfg)
    assert t.iters == int(j.iters)
    assert t.solved == bool(j.solved)
    assert t.prim_infeasible == bool(j.prim_infeasible)
    assert t.dual_infeasible == bool(j.dual_infeasible)
    x_j = np.asarray(j.x)
    np.testing.assert_allclose(t.x.numpy(), x_j, rtol=0,
                               atol=1e-8 * max(1.0, np.max(np.abs(x_j))))
    if name == "prim_infeasible":
        assert t.prim_infeasible and not t.solved
    elif name == "dual_infeasible":
        assert t.dual_infeasible and not t.solved
    else:
        assert t.solved
        if cfg is CFG and name != "avar_lp":
            check_kkt(P, q, A, l, u, t, tol=1e-5)


def test_dense_warm_start_matches_jax():
    """A warm start at the cold solution (tests/test_admm.py:125-138): the
    same iterations as JAX, at most one check interval."""
    rng = np.random.default_rng(5)
    n, m = 20, 40
    L = rng.standard_normal((n, n))
    P, q = L @ L.T + np.eye(n), rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    l = np.full(m, -1.0)
    cfg = dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000, adaptive_rho=False)
    j, t = _both(P, q, A, l, -l, cfg)
    jw, tw = _both(P, q, A, l, -l, cfg, x0=np.asarray(j.x), y0=np.asarray(j.y))
    assert (t.iters, tw.iters) == (int(j.iters), int(jw.iters))
    assert tw.iters <= TSolverConfig(**cfg).check_every


def test_dense_qp_matches_native_oracle():
    """The native C++ ADMM (no JAX), a third implementation, on a random
    inequality QP: both certified at 1e-8, x within 1e-5."""
    P, q, A, l, u = _random(1)
    nat = solve_qp_native(P, q, A, l, u, eps_abs=1e-8, eps_rel=1e-8)
    t = tadmm.solve_dense_qp(*(torch.tensor(v) for v in (P, q, A, l, u)),
                             TSolverConfig(**CFG))
    assert nat.solved and t.solved
    np.testing.assert_allclose(t.x.numpy(), nat.x, atol=1e-5)


def test_dense_factor_failure_is_nan():
    """A KKT matrix that is not positive definite gives an all-NaN factor,
    as jnp.linalg.cholesky does, rather than raising."""
    ops = tadmm.DenseQPOps(-torch.eye(3, dtype=torch.float64),
                           torch.eye(3, dtype=torch.float64))
    chol = ops.factorize(torch.zeros(3, dtype=torch.float64),
                         torch.zeros(3, dtype=torch.float64))
    assert bool(torch.isnan(chol).all())
