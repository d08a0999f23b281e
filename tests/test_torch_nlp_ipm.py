"""The port's barrier NLP solver (ops/nlp_ipm.py) against the JAX package on
the small problems of tests/test_nlp_ipm.py: a QP as an NLP, Rosenbrock in
a box (no g rows), HS071, two-sided rows, the Maratos problem with and
without the second-order correction, and the compensated merit against the
plain one. Both packages solve the same problem from the same start in
float64; they must take the same number of barrier iterations and land
within 1e-8 of each other, on the solution test_nlp_ipm.py holds. Also:
classify_rows' permutation, the per-iteration trace, and the float32
options (Ruiz, compensated refinement and merit) on HS071.

Each JAX solve compiles its own while loop (a few seconds each), so the
JAX side of every problem runs once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch.ops import nlp_ipm as tn
from riskaversetrajopt_tpu.ops import nlp_ipm as jn
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)

BIG = 1e15


def _problem(name, xp):
    """(f, g, kwargs, cfg kwargs) of one problem written with `xp` (jnp or
    torch)."""
    stack = xp.stack

    if name == "qp":
        # min (x-1)^2 + (y-2)^2 s.t. x + y = 1  => (0, 1)
        return (lambda Z: (Z[0] - 1.0) ** 2 + (Z[1] - 2.0) ** 2,
                lambda Z: stack([Z[0] + Z[1]]),
                dict(g_L=[1.0], g_U=[1.0], n_eq=1, x_L=[-BIG] * 2,
                     x_U=[BIG] * 2, Z0=[0.0, 0.0]), {})
    if name == "rosenbrock":
        # unconstrained optimum (1, 1) inside the box; no g rows
        return (lambda Z: 100.0 * (Z[1] - Z[0] ** 2) ** 2 + (1 - Z[0]) ** 2,
                lambda Z: Z[:0] * 0.0,
                dict(g_L=np.zeros(0), g_U=np.zeros(0), n_eq=0,
                     x_L=[-2.0, -2.0], x_U=[2.0, 2.0], Z0=[-1.2, 1.0]),
                dict(tol=1e-8, max_iter=200))
    if name == "hs071":
        return (lambda Z: Z[0] * Z[3] * (Z[0] + Z[1] + Z[2]) + Z[2],
                lambda Z: stack([Z[0] ** 2 + Z[1] ** 2 + Z[2] ** 2 + Z[3] ** 2,
                                 Z[0] * Z[1] * Z[2] * Z[3]]),
                dict(g_L=[40.0, 25.0], g_U=[40.0, BIG], n_eq=1,
                     x_L=[1.0] * 4, x_U=[5.0] * 4, Z0=[1.0, 5.0, 5.0, 1.0]),
                dict(tol=1e-8, max_iter=200))
    if name == "two_sided":
        # min -x - 2y s.t. 0 <= x + y <= 1, -1 <= x - y <= 1  => (0, 1)
        return (lambda Z: -Z[0] - 2.0 * Z[1],
                lambda Z: stack([Z[0] + Z[1], Z[0] - Z[1]]),
                dict(g_L=[0.0, -1.0], g_U=[1.0, 1.0], n_eq=0,
                     x_L=[-10.0] * 2, x_U=[10.0] * 2, Z0=[0.0, 0.0]),
                dict(tol=1e-8, max_iter=200))
    if name.startswith("maratos"):
        # min 2(x^2+y^2-1) - x s.t. x^2+y^2 = 1, from a point on the circle
        return (lambda Z: 2.0 * (Z[0] ** 2 + Z[1] ** 2 - 1.0) - Z[0],
                lambda Z: stack([Z[0] ** 2 + Z[1] ** 2]),
                dict(g_L=[1.0], g_U=[1.0], n_eq=1, x_L=[-BIG] * 2,
                     x_U=[BIG] * 2, Z0=[np.cos(0.5), np.sin(0.5)]),
                dict(tol=1e-8, max_iter=100, soc=name == "maratos_soc"))
    if name.startswith("merit"):
        # one convex inequality, solved with the plain and the compensated
        # merit (test_compensated_merit_matches_plain_in_x64)
        return (lambda Z: (Z[0] - 1.0) ** 2 + (Z[1] - 2.0) ** 2,
                lambda Z: stack([Z[0] ** 2 + Z[1] ** 2]),
                dict(g_L=[-BIG], g_U=[1.5], n_eq=0, x_L=[-BIG] * 2,
                     x_U=[BIG] * 2, Z0=[0.0, 0.0]),
                dict(tol=1e-8, max_iter=100,
                     merit_compensated=name == "merit_compensated"))
    raise ValueError(name)


# the solutions tests/test_nlp_ipm.py holds (atol)
SOLUTIONS = {
    "qp": ([0.0, 1.0], 1e-6),
    "rosenbrock": ([1.0, 1.0], 1e-5),
    "hs071": ([1.0, 4.7429994, 3.8211503, 1.3794082], 1e-4),
    "two_sided": ([0.0, 1.0], 1e-5),
    "maratos": ([1.0, 0.0], 1e-6),
    "maratos_soc": ([1.0, 0.0], 1e-6),
    "merit_plain": (None, None),
    "merit_compensated": (None, None),
}


def _jax_solve(name, trace_iters=0):
    f, g, kw, cfg = _problem(name, jnp)
    kw = {k: (v if k == "n_eq" else jnp.asarray(v, jnp.float64))
          for k, v in kw.items()}
    return jn.solve_nlp(f, g, cfg=jn.NLPConfig(**cfg),
                        trace_iters=trace_iters, **kw)


def _torch_solve(name, trace_iters=0, dtype=torch.float64, **over):
    f, g, kw, cfg = _problem(name, torch)
    kw["Z0"] = torch.tensor(kw["Z0"], dtype=dtype)
    return tn.solve_nlp(f, g, cfg=tn.NLPConfig(**{**cfg, **over}),
                        trace_iters=trace_iters, **kw)


@pytest.fixture(scope="module")
def jax_results():
    """Every problem's JAX solve, each run once."""
    return {name: _jax_solve(name) for name in SOLUTIONS}


@pytest.mark.parametrize("name", [n for n in SOLUTIONS if n != "rosenbrock"])
def test_solve_nlp_matches_jax(name, jax_results):
    """Same barrier iterations as JAX, Z within 1e-8, both certified, at
    the solution tests/test_nlp_ipm.py holds. (The residuals at the last
    iterate are roundoff and are not compared.)"""
    rj, rt = jax_results[name], _torch_solve(name)
    assert rt.iters == int(rj.iters)
    assert rt.solved and bool(rj.solved)
    np.testing.assert_allclose(rt.Z.numpy(), np.asarray(rj.Z), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(rt.f_val), float(rj.f_val), rtol=1e-10,
                               atol=1e-12)
    want, atol = SOLUTIONS[name]
    if want is not None:
        np.testing.assert_allclose(rt.Z.numpy(), want, atol=atol)
    if name == "hs071":
        assert float(rt.f_val) == pytest.approx(17.0140173, abs=1e-4)


def test_rosenbrock_box_matches_jax_until_a_roundoff_tie(jax_results):
    """Rosenbrock in a box has only linear (box) rows: the constraint
    violation theta is roundoff, and a trial step that raises the merit is
    accepted when theta <= 0.99 theta0 holds, i.e. when both round to
    exactly 0. Which trials round to 0 depends on the last bits of the
    direction (XLA contracts multiply-adds into FMAs and solves with its
    own triangular solves), so the packages part at the first such tie,
    iteration 4 (JAX accepts the full step, the port halves it): JAX
    certifies in 9 iterations, the port in 14, both at (1, 1). Held: the
    trace of the first three iterations to 1e-8, and the solution of
    tests/test_nlp_ipm.py:29-45 in both packages."""
    rj = jax_results["rosenbrock"]
    _jax_solve("rosenbrock", trace_iters=3)
    trj = jn.solve_nlp.last_trace
    rt = _torch_solve("rosenbrock", trace_iters=3)
    trt = tn.solve_nlp.last_trace
    for name, a, b in zip(tn.TRACE_FIELDS, trt, trj):
        np.testing.assert_allclose(a.numpy().astype(float),
                                   np.asarray(b).astype(float), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    rt = _torch_solve("rosenbrock")
    assert rt.solved and bool(rj.solved)
    for Z in (rt.Z.numpy(), np.asarray(rj.Z)):
        np.testing.assert_allclose(Z, [1.0, 1.0], atol=1e-5)


def test_soc_not_slower_and_compensated_merit_unchanged(jax_results):
    """The second-order correction takes no more iterations on the Maratos
    problem, and in float64 the compensated merit leaves the trajectory as
    the plain one's (tests/test_nlp_ipm.py:86-112 and :173-193)."""
    base, soc = _torch_solve("maratos"), _torch_solve("maratos_soc")
    assert soc.iters <= base.iters
    a, b = _torch_solve("merit_plain"), _torch_solve("merit_compensated")
    assert a.solved and b.solved and a.iters == b.iters
    np.testing.assert_allclose(a.Z.numpy(), b.Z.numpy(), rtol=1e-12)


def test_classify_rows_matches_jax():
    """The zero-gap rows move into the equality block in JAX's order."""
    rng = np.random.default_rng(0)
    g_L = rng.uniform(-1.0, 0.0, 40)
    g_U = g_L + rng.uniform(0.0, 1.0, 40)
    zero_gap = rng.choice(40, 9, replace=False)
    g_U[zero_gap] = g_L[zero_gap]
    g_U[rng.choice(40, 5, replace=False)] = BIG
    for n_eq in (0, 3, 12):
        pj, nj = jn.classify_rows(g_L, g_U, n_eq)
        pt, nt = tn.classify_rows(torch.from_numpy(g_L), torch.from_numpy(g_U),
                                  n_eq)
        np.testing.assert_array_equal(pt, pj)
        assert nt == nj


def test_trace_matches_jax():
    """trace_iters: the per-iteration diagnostics of HS071's first 50
    iterations are JAX's to 1e-8 (measured: 4.6e-12 relative; past
    iteration 55 the residuals are roundoff, converged at 61). Past
    convergence a trace repeats the final state."""
    n = 50
    _jax_solve("hs071", trace_iters=n)
    trj = jn.solve_nlp.last_trace
    _torch_solve("hs071", trace_iters=n)
    trt = tn.solve_nlp.last_trace
    assert len(trt) == len(trj) == len(tn.TRACE_FIELDS)
    for name, a, b in zip(tn.TRACE_FIELDS, trt, trj):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (n,), name
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8,
                                       err_msg=name)
    rt = _torch_solve("hs071", trace_iters=70)
    tail = [v[rt.iters - 1 :] for v in tn.solve_nlp.last_trace]
    assert rt.iters == 61 and rt.solved
    for v in tail:
        assert bool((v == v[0]).all())


def test_float32_options_solve_hs071():
    """Float32 with the three hardening options (Ruiz sweeps, compensated
    KKT refinement, compensated merit) certifies HS071 at tol 1e-5, at the
    float64 solution within float32's reach, in float32 throughout."""
    rt = _torch_solve("hs071", dtype=torch.float32, tol=1e-5,
                      kkt_ruiz_iters=3, kkt_ds_refine_iters=2,
                      merit_compensated=True)
    assert rt.solved and rt.Z.dtype == torch.float32
    assert rt.f_val.dtype == torch.float32
    np.testing.assert_allclose(rt.Z.numpy(), SOLUTIONS["hs071"][0], atol=1e-3)


def test_non_finite_kkt_step_is_rejected_not_raised():
    """An infinite Hessian entry at the start (|z|^1.5 at z = 0) makes the
    KKT matrix non-finite: the LU returns non-finite directions
    (torch.linalg.lu_factor_ex, like jax.scipy.linalg.lu_factor, does not
    raise), the line search rejects every trial and the iterate stays
    where it was, finite."""
    def f(Z):
        return (Z[0] - 1.0) ** 2 + torch.abs(Z[1]) ** 1.5

    Z0 = torch.tensor([0.0, 0.0], dtype=torch.float64)
    res = tn.solve_nlp(f, lambda Z: Z[:0] * 0.0, np.zeros(0), np.zeros(0),
                       0, [-BIG] * 2, [BIG] * 2, Z0, tn.NLPConfig(),
                       trace_iters=2)
    ok = tn.solve_nlp.last_trace[tn.TRACE_FIELDS.index("ok")]
    assert not bool(ok[0])
    np.testing.assert_array_equal(res.Z.numpy(), Z0.numpy())
