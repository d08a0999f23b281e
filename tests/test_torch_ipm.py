"""The port's interior-point QP solver (ops/ipm.py) and the QP-backed AVaR
(ops/cvar.avar_qp) against the JAX package on the same float64 numbers:
the small dense QPs of tests/test_ipm.py, the structured drone SAA QP with
and without polish, avar_qp, and a float32 solve of the car's gated QP."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core import config as tconfig
from riskaversetrajopt_torch.models.car import CarModel as TCarModel
from riskaversetrajopt_torch.ops import admm as tadmm
from riskaversetrajopt_torch.ops import cvar as tcvar
from riskaversetrajopt_torch.ops import ipm as tipm
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_torch.scp import driver as tdriver
from riskaversetrajopt_tpu.ops import admm as jadmm
from riskaversetrajopt_tpu.ops import cvar as jcvar
from riskaversetrajopt_tpu.ops import ipm as jipm
from riskaversetrajopt_tpu.ops import saa_qp as jqp
from tests.test_saa_qp import dense_reference_A, make_problem


def _box():
    n = 8
    c = np.linspace(-3, 3, n)
    sol_x = np.clip(c, -1, 1)
    return (2 * np.eye(n), -2 * c, np.eye(n), -np.ones(n), np.ones(n), 0,
            sol_x)


def _equality():
    rng = np.random.default_rng(0)
    n, me = 6, 2
    L = rng.standard_normal((n, n))
    P = L @ L.T + n * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((me, n))
    b = rng.standard_normal(me)
    KKT = np.block([[P, G.T], [G, np.zeros((me, me))]])
    xy = np.linalg.solve(KKT, np.concatenate([-q, b]))
    A = np.vstack([G, np.eye(n)])
    l = np.concatenate([b, np.full(n, -100.0)])
    u = np.concatenate([b, np.full(n, 100.0)])
    return P, q, A, l, u, me, xy[:n]


def _random(seed):
    rng = np.random.default_rng(seed)
    n, m = 10, 16
    L = rng.standard_normal((n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    x_feas = rng.standard_normal(n) * 0.1
    l = A @ x_feas - rng.uniform(0.1, 2.0, m)
    u = A @ x_feas + rng.uniform(0.1, 2.0, m)
    return P, q, A, l, u, 0, None


def _one_sided():
    # min x^2 s.t. x >= 1 (lower-only) and x <= 10 (upper-only)
    return (np.array([[2.0]]), np.array([0.0]), np.array([[1.0], [1.0]]),
            np.array([1.0, -np.inf]), np.array([np.inf, 10.0]), 0,
            np.array([1.0]))


SMALL = {"box": _box, "equality": _equality, "random1": lambda: _random(1),
         "random2": lambda: _random(2), "random3": lambda: _random(3),
         "one_sided": _one_sided}


@pytest.mark.parametrize("name", list(SMALL))
def test_small_qps_match_closed_forms_and_jax(name):
    """The QPs of tests/test_ipm.py:25-99 through DenseQPOps: the port and
    JAX take the same Mehrotra iterations and land within 1e-9 of each
    other (measured <= 9.8e-13: one float64 algorithm twice); where a closed
    form exists the port meets it as the JAX test does (1e-6 or 1e-7)."""
    P, q, A, l, u, n_eq, x_star = SMALL[name]()
    j = jipm.solve_qp_ipm(jadmm.DenseQPOps(jnp.array(P), jnp.array(A), 1),
                          jnp.array(q), jnp.array(l), jnp.array(u), n_eq)
    t = tipm.solve_qp_ipm(
        tadmm.DenseQPOps(torch.tensor(P), torch.tensor(A), 1),
        torch.tensor(q), torch.tensor(l), torch.tensor(u), n_eq)
    assert t.solved and bool(j.solved)
    assert t.iters == int(j.iters)
    for a, b in ((t.x, j.x), (t.y, j.y), (t.z, j.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    x = t.x.numpy()
    if x_star is not None:
        np.testing.assert_allclose(x, x_star, atol=1e-6)
    if name == "equality":
        # the equality duals are the KKT multipliers
        KKT = np.block([[P, A[:2].T], [A[:2], np.zeros((2, 2))]])
        y_star = np.linalg.solve(KKT, np.concatenate([-q, l[:2]]))[6:]
        np.testing.assert_allclose(t.y[:2].numpy(), y_star, atol=1e-5)
    if name == "one_sided":
        assert float(t.y[0]) < -1.0  # OSQP sign: active lower bound < 0
    Ax = A @ x
    assert np.all(Ax <= u + 1e-6) and np.all(Ax >= l - 1e-6)


@pytest.fixture(scope="module")
def drone_qp():
    """The drone SAA QP at M=16, scp_iter 3, linearized at the initial
    guess (tests/test_saa_qp.py:make_problem)."""
    st, data = make_problem(M=16)
    return st, data, tqp.SAAQPStatic(*st[:14]), interop.saa_qp_data(data)


def _saa_ipm(drone_qp, cfg_kw):
    st, data, tst, tdata = drone_qp
    jops = jqp.SAAQPOps(st, data, jnp.asarray(3))
    _, q = jqp.build_objective(st, data)
    l, u = jqp.build_bounds(st, data, jnp.asarray(3))
    j = jipm.solve_qp_ipm(jops, q, l, u, n_eq=st.n_fc,
                          cfg=jipm.IPMConfig(**cfg_kw))
    tops = tqp.SAAQPOps(tst, tdata, 3)
    _, tq = tqp.build_objective(tst, tdata)
    tl, tu = tqp.build_bounds(tst, tdata, 3)
    t = tipm.solve_qp_ipm(tops, tq, tl, tu, n_eq=tst.n_fc,
                          cfg=tipm.IPMConfig(**cfg_kw))
    return j, t


def _same(j, t, tol):
    assert t.iters == int(j.iters)
    assert t.solved == bool(j.solved)
    for name in ("x", "y"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1.0, np.max(np.abs(b))),
                                   err_msg=name)


def test_saa_qp_ipm_matches_jax(drone_qp):
    """The structured SAA QP at tol 1e-5 (tests/test_ipm.py:101-135): the
    same iteration count as JAX and x, y each within 1e-6 of its own scale
    (measured: x 4.6e-8, y 2.0e-9 of scale, 16 iterations: the interior
    point of a dual-degenerate QP); and the unscaled KKT
    residuals against the dense construction as the JAX test holds them:
    primal <= 1e-6, dual / d_scale < 1e-4."""
    j, t = _saa_ipm(drone_qp, dict(tol=1e-5))
    assert t.solved and t.iters < 50
    _same(j, t, 1e-6)
    st, data, _, tdata = drone_qp
    A, ld, ud = dense_reference_A(st, data, 3)
    p_diag, q = (v.numpy() for v in tqp.build_objective(
        tqp.SAAQPStatic(*st[:14]), tdata))
    x, y = t.x.numpy(), t.y.numpy()
    Ax = A @ x
    assert np.max(Ax - ud) < 1e-6 and np.max(ld - Ax) < 1e-6
    dual = np.max(np.abs(p_diag * x + q + A.T @ y))
    assert dual / max(np.max(np.abs(A.T @ y)), np.max(np.abs(q))) < 1e-4


def test_saa_qp_ipm_polish_matches_jax(drone_qp):
    """IPMConfig(polish=True) runs _polish with the IPM's active set
    (lambda > s) and the equality rows always active: the same result as
    JAX's within 1e-6 of scale (measured: x 8.9e-13, y 2.3e-15)."""
    j, t = _saa_ipm(drone_qp, dict(tol=1e-5, polish=True))
    _same(j, t, 1e-6)


@pytest.mark.parametrize("M", [150, 10000])
def test_avar_qp_matches_jax_and_avar(M):
    """avar_qp (the IPM on AVaRQPOps, from a numpy array) against JAX's
    avar_qp and the sort-based avar, atol 1e-4 (tests/test_cvar.py:52-61;
    measured: 0.0 for both)."""
    Z = np.random.default_rng(M).standard_normal(M)
    t = float(tcvar.avar_qp(Z, 0.1, device="cpu"))
    assert t == pytest.approx(float(jcvar.avar_qp(jnp.asarray(Z), 0.1)),
                              abs=1e-4)
    assert t == pytest.approx(float(tcvar.avar(torch.from_numpy(Z), 0.1)),
                              abs=1e-4)
    # a tensor stays on its device; an array goes to the card by default
    z = torch.from_numpy(Z)
    assert float(tcvar.avar_qp(z, 0.1)) == t
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcvar.avar_qp(Z, 0.1)


def test_ipm_float32_car_gated_qp_finite():
    """The car's gated scp_iter 0 QP at M=50 in float32 (y that meet the
    CVaR row alone: the Sherman-Morrison repair of SAAQPOps) through the
    driver's IPM: every returned value finite and the iterate within the
    control bounds."""
    model = TCarModel(tconfig.CarScenario(), device="cpu")
    scp = dataclasses.replace(model.default_scp_config(), num_iters=1)
    opt = tdriver.SAATrajOpt(model, scp_cfg=scp, qp_backend="ipm",
                             dtype=torch.float32, device="cpu")
    om = opt.sample(torch.Generator().manual_seed(0), 50)
    st = opt._static_for(50)
    data = opt._define(opt.model.initial_guess(), opt._cast_omegas(om),
                       torch.tensor(0.1))
    assert tqp.SAAQPOps(st, data, 0).free_y
    sol = opt._ipm_solve(st, data, 0)
    for name in ("x", "y", "z", "prim_res", "dual_res"):
        assert bool(torch.isfinite(getattr(sol, name)).all()), name
    assert sol.x.dtype == torch.float32
    assert float(sol.x[:st.n].abs().max()) <= model.scn.u_max * (1 + 1e-6)
