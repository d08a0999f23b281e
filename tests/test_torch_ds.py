"""The port's eager double-single arithmetic (ops/ds.py) against the JAX
package's ops/ds.py on the same float32 inputs, and against
tests/test_ds.py's contract: the error-free transforms bit for bit, the
compensated matvec and KKT refinement to float64 ground truth, and the
car-Gaussian QP certified at 1e-8 from float32 data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch.ops import admm as tadmm
from riskaversetrajopt_torch.ops import ds as tds
from riskaversetrajopt_tpu.ops import ds as jds


def _pair(rng, n, scale_b=1e-4):
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * scale_b).astype(np.float32)
    return a, b


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_error_free_transforms_bitwise_match_jax(dtype):
    """two_sum, two_prod (Dekker's multiplicative split, 4097 in float32
    and 134217729 in float64) and ds_add: the same bits as JAX's eager
    transforms; in float32 each pair also sums exactly to its float64
    value."""
    rng = np.random.default_rng(0)
    a, b = (v.astype(dtype) for v in _pair(rng, 1000))
    c, d = (v.astype(dtype) for v in _pair(rng, 1000, scale_b=1e-9))
    ta, tb, tc, td = (torch.from_numpy(v) for v in (a, b, c, d))
    ja, jb, jc, jd = (jnp.asarray(v) for v in (a, b, c, d))
    pairs = [(tds.two_sum(ta, tb), jds.two_sum(ja, jb)),
             (tds.two_prod(ta, tb), jds.two_prod(ja, jb)),
             (tds.ds_add(ta, tc, tb, td), jds.ds_add(ja, jc, jb, jd))]
    for t, j in pairs:
        for x, y in zip(t, j):
            assert x.numpy().dtype == dtype
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    if dtype == np.float64:
        return
    s, e = tds.two_sum(ta, tb)
    np.testing.assert_array_equal(
        s.double().numpy() + e.double().numpy(),
        a.astype(np.float64) + b.astype(np.float64))
    p, e = tds.two_prod(ta, tb)
    np.testing.assert_array_equal(
        p.double().numpy() + e.double().numpy(),
        a.astype(np.float64) * b.astype(np.float64))


def test_ds_matvec_matches_jax_and_float64():
    """ds_matvec of a float32 (200, 200) matrix: bit for bit JAX's, and
    within 5e-12 relative of the float64 product (tests/test_ds.py:37-51;
    plain float32 is ~1e-6 off)."""
    rng = np.random.default_rng(1)
    n = 200
    A = rng.standard_normal((n, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    zero = np.zeros(n, np.float32)
    t = tds.ds_matvec(torch.from_numpy(A), torch.from_numpy(x),
                      torch.from_numpy(zero))
    j = jds.ds_matvec(jnp.asarray(A), jnp.asarray(x), jnp.asarray(zero))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = t[0].double().numpy() + t[1].double().numpy()
    exact = A.astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(got, exact, rtol=5e-12, atol=5e-12)


def test_refine_kkt_ds_reaches_1e10_like_jax():
    """The float32 LU + ds refinement on tests/test_ds.py:54-66's SPD
    system: the float64 residual of the ds solution under 1e-10, for the
    port and for JAX alike, and the two solutions within 1e-12 of scale."""
    rng = np.random.default_rng(2)
    n = 80
    L = rng.standard_normal((n, n)) * 0.3
    K = (L @ L.T + np.eye(n)).astype(np.float32)
    rhs = rng.standard_normal(n).astype(np.float32)
    hi, lo = tds.refine_kkt_ds(torch.from_numpy(K), torch.from_numpy(rhs),
                               num_iters=15)
    x = hi.double().numpy() + lo.double().numpy()
    jhi, jlo = jds.refine_kkt_ds(jnp.asarray(K), jnp.asarray(rhs),
                                 num_iters=15)
    xj = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    for v in (x, xj):
        r = rhs.astype(np.float64) - K.astype(np.float64) @ v
        assert np.abs(r).max() < 1e-10
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-12 * np.abs(xj).max())


@pytest.fixture(scope="module")
def car_gaussian_qp_f32():
    """The car-Gaussian SCP subproblem at scp_iter 2 (JAX's planner at its
    initial guess), its data cast to float32 once."""
    from riskaversetrajopt_tpu.core.config import CarScenario
    from riskaversetrajopt_tpu.models.car_gaussian import GaussianCarPlanner

    p = GaussianCarPlanner(CarScenario(), alpha=0.1)
    us0, alphas0 = p.initial_guess()
    return tuple(np.asarray(v).astype(np.float32)
                 for v in jax.jit(p.build_qp)(us0, alphas0, 2))


def test_car_gaussian_qp_f32_at_1e8(car_gaussian_qp_f32):
    """tests/test_ds.py:68-115 for the port: the ds solve certifies
    prim/dual <= 1e-8, x lies within 1e-6 of a float64 solve of the same
    float32 data and of JAX's ds x on the same active set, and the float64
    KKT residuals of (x, y) hold (dual < 1e-7, violation < 1e-8). To keep
    it cheap both ds solves run their float32 ADMM to 2000 iterations and
    8 refinement rounds per KKT solve (the defaults 100000 and 25 take
    about 30 s in each package and give the same active set); the
    active-set correction of ds.py finishes the job."""
    from riskaversetrajopt_torch.core import config as tconfig
    from riskaversetrajopt_tpu.core.config import SolverConfig

    P, q, A, l, u = car_gaussian_qp_f32
    t32 = [torch.from_numpy(v) for v in (P, q, A, l, u)]
    cfg = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=2000)
    x_hi, x_lo, y, info = tds.solve_dense_qp_ds(
        *t32, cfg=tconfig.SolverConfig(**cfg), refine_iters=8)
    assert x_hi.dtype == torch.float32
    assert info["prim_res"] <= 1e-8, info
    assert info["dual_res"] <= 1e-8, info
    x = x_hi.double().numpy() + x_lo.double().numpy()

    cfg64 = tconfig.SolverConfig(eps_abs=1e-10, eps_rel=1e-10,
                                 max_iter=200000)
    x64 = tadmm.solve_dense_qp(*(v.double() for v in t32), cfg64).x.numpy()
    assert np.abs(x - x64).max() < 1e-6, np.abs(x - x64).max()

    jhi, jlo, _, jinfo = jds.solve_dense_qp_ds(
        *(jnp.asarray(v) for v in (P, q, A, l, u)),
        cfg=SolverConfig(**cfg), refine_iters=8)
    xj = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    assert np.abs(x - xj).max() < 1e-6, np.abs(x - xj).max()
    assert (info["active"] == jinfo["active"]).all()

    P64, A64 = P.astype(np.float64), A.astype(np.float64)
    dual64 = P64 @ x + q.astype(np.float64) + A64.T @ y.numpy()
    assert np.abs(dual64).max() < 1e-7
    Ax = A64 @ x
    assert np.maximum(Ax - u.astype(np.float64),
                      l.astype(np.float64) - Ax).max() < 1e-8
