"""The port's native QP oracle (riskaversetrajopt_torch/native/qp.py, its
own g++ build of native/qp_admm.cpp under build/torch_kernels/) on the four
problems of tests/test_native_qp.py: bit for bit the JAX package's wrapper
on the same inputs (the same C++ and flags), and held to the port's
solve_dense_qp and closed forms."""

import numpy as np
import pytest
import torch

from riskaversetrajopt_torch.core.config import SolverConfig
from riskaversetrajopt_torch.native import qp as tnative
from riskaversetrajopt_torch.ops.admm import solve_dense_qp
from riskaversetrajopt_torch.ops.cvar import avar
from riskaversetrajopt_tpu.native import qp as jnative
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)

TIGHT = dict(eps_abs=1e-9, eps_rel=1e-9)


def _both(P, q, A, l, u, **kw):
    """The port's solve (from tensors) and the JAX package's (arrays),
    identical bit for bit."""
    t = tnative.solve_qp_native(*(torch.tensor(a) for a in (P, q, A, l, u)),
                                **kw)
    j = jnative.solve_qp_native(P, q, A, l, u, **kw)
    assert t.x.dtype == torch.float64
    np.testing.assert_array_equal(t.x.numpy(), j.x)
    np.testing.assert_array_equal(t.y.numpy(), j.y)
    assert (t.iters, t.prim_res, t.dual_res, t.solved) == (
        j.iters, j.prim_res, j.dual_res, j.solved)
    return t


def _dense(P, q, A, l, u):
    return solve_dense_qp(*(torch.tensor(a) for a in (P, q, A, l, u)),
                          SolverConfig(max_iter=20000, **TIGHT))


def test_native_builds_its_own_library():
    assert tnative.LIB_PATH.parent.name == "torch_kernels"
    assert tnative.LIB_PATH != jnative._LIB_PATH
    assert tnative.SRC == jnative._SRC
    tnative._load()
    assert tnative.LIB_PATH.exists()


def test_native_box_qp():
    n = 8
    c = np.linspace(-3, 3, n)
    P, q, A = 2 * np.eye(n), -2 * c, np.eye(n)
    l, u = -np.ones(n), np.ones(n)
    sol = _both(P, q, A, l, u)
    assert sol.solved
    np.testing.assert_allclose(sol.x.numpy(), np.clip(c, -1, 1), atol=1e-6)
    np.testing.assert_allclose(sol.x.numpy(), _dense(P, q, A, l, u).x.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_dense_admm(seed):
    rng = np.random.default_rng(seed)
    n, m = 12, 20
    L = rng.standard_normal((n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    x_feas = rng.standard_normal(n) * 0.1
    l = A @ x_feas - rng.uniform(0.1, 2.0, m)
    u = A @ x_feas + rng.uniform(0.1, 2.0, m)
    nat = _both(P, q, A, l, u, **TIGHT)
    assert nat.solved
    dense = _dense(P, q, A, l, u)
    assert dense.solved
    np.testing.assert_allclose(nat.x.numpy(), dense.x.numpy(), atol=1e-6)


def test_native_equality_rows():
    rng = np.random.default_rng(3)
    n, me = 6, 2
    L = rng.standard_normal((n, n))
    P = L @ L.T + n * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((me, n))
    b = rng.standard_normal(me)
    KKT = np.block([[P, G.T], [G, np.zeros((me, me))]])
    xy = np.linalg.solve(KKT, np.concatenate([-q, b]))
    sol = _both(P, q, G, b, b, **TIGHT)
    assert sol.solved
    np.testing.assert_allclose(sol.x.numpy(), xy[:n], atol=1e-6)
    np.testing.assert_allclose(_dense(P, q, G, b, b).x.numpy(), xy[:n],
                               atol=1e-6)


def test_native_avar_qp_matches_closed_form():
    rng = np.random.default_rng(7)
    M, alpha = 100, 0.1
    Z = rng.standard_normal(M)
    nv = M + 1
    P = np.zeros((nv, nv))
    q = np.concatenate([np.full(M, 1.0 / (M * alpha)), [1.0]])
    A = np.zeros((2 * M, nv))
    A[:M, :M] = -np.eye(M)
    A[M:, :M] = -np.eye(M)
    A[M:, -1] = -1.0
    l = np.full(2 * M, -np.inf)
    u = np.concatenate([np.zeros(M), -Z])
    sol = _both(P, q, A, l, u, **TIGHT)
    t_risk = float(sol.x[-1])
    avar_native = t_risk + np.mean(np.maximum(Z - t_risk, 0.0) / alpha)
    np.testing.assert_allclose(avar_native, float(avar(torch.tensor(Z), alpha)),
                               atol=1e-5)
