"""The port's car model family against the JAX package, on the same numbers
(omegas drawn by the JAX sampler, handed over by interop.car_omega): the
model functions, the define phase, the float64 'admm' SCP, the plain fused
iteration on the car's scaled structure, and both fused backends' SCP on the
CPU. The car differs from the drone in structure: n_fc = 4 < n_x = 8 keeps
the CVaR row live while gated, the gated rows are zeroed with bounds
(-inf, 0), no row scale, slack penalty 1000, K = S = 20, n = 40."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core import config as tconfig
from riskaversetrajopt_torch.models.car import CarModel as TCarModel
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc
from riskaversetrajopt_torch.ops.cuda import saa_admm as tk
from riskaversetrajopt_torch.ops.cvar import avar as tavar
from riskaversetrajopt_torch.ops.rollout import linearize_batch as t_linearize
from riskaversetrajopt_torch.scp import driver as tdriver
from riskaversetrajopt_tpu.core import config as jconfig
from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.models.car import CarModel
from riskaversetrajopt_tpu.ops import admm as jadmm
from riskaversetrajopt_tpu.ops.pallas.experimental import saa_admm as jk
from riskaversetrajopt_tpu.ops.rollout import linearize_batch
from riskaversetrajopt_tpu.ops.saa_qp import (
    SAAQPOps,
    build_bounds,
    build_objective,
)
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

M = 8
# float64 on both sides: the same elementwise formulas, so agreement is at
# the roundoff of a few operations (<= 1e-12 relative to the values)
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def models():
    jm = CarModel(jconfig.CarScenario(M=M))
    om = jm.sample(jax.random.PRNGKey(3), M)
    tm = TCarModel(tconfig.CarScenario(M=M), device="cpu")
    rng = np.random.default_rng(0)
    # states around the scenario's: ego and pedestrian apart
    xs = (np.asarray(jm.scn.state_init)
          + rng.standard_normal((M, jm.S + 1, jm.n_x)))
    us = rng.standard_normal((M, jm.n_u))
    return jm, om, tm, interop.car_omega(om), xs, us


@pytest.mark.parametrize(
    "prop", ["dt", "R", "min_separation_distance", "position_ego_init",
             "position_ped_init", "velocity_ego_init", "velocity_ped_init",
             "position_ego_goal", "velocity_ego_goal", "state_init",
             "variance_ped_initial_state"],
)
def test_car_scenario_constants_match(prop):
    j = getattr(jconfig.CarScenario(), prop)
    t = getattr(tconfig.CarScenario(), prop)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.mark.parametrize(
    "fn", ["drift", "dispersion", "x0", "ineq_constraints",
           "final_constraints"],
)
def test_car_functions_match(models, fn):
    jm, om, tm, tom, xs, us = models
    x = xs[:, 3]
    per_sample = lambda f, *a: np.asarray(jax.vmap(f)(*a))  # noqa: E731
    if fn == "drift":
        j = per_sample(jm.drift, jnp.asarray(x), jnp.asarray(us), om)
        t = tm.drift(torch.from_numpy(x), torch.from_numpy(us), tom)
    elif fn == "dispersion":
        dW = np.array(om.dWs)[:, 4]
        j = per_sample(jm.dispersion, jnp.asarray(x), jnp.asarray(us), om,
                       jnp.asarray(dW))
        t = tm.dispersion(torch.from_numpy(x), torch.from_numpy(us), tom,
                          torch.from_numpy(dW))
    elif fn == "x0":
        j, t = np.asarray(jax.vmap(jm.x0)(om)), tm.x0(tom)
    elif fn == "final_constraints":
        j = per_sample(jm.final_constraints, jnp.asarray(xs))
        t = tm.final_constraints(torch.from_numpy(xs))
    else:
        j = per_sample(jm.ineq_constraints, jnp.asarray(xs), om)
        t = tm.ineq_constraints(torch.from_numpy(xs), tom)
    np.testing.assert_allclose(t.numpy(), j, **TOL)


def test_car_cost_guess_and_scp_config_match(models):
    jm, om, tm, tom, xs, us = models
    us_mat = np.random.default_rng(1).standard_normal((jm.S, jm.n_u))
    np.testing.assert_allclose(
        float(tm.control_cost(torch.from_numpy(us_mat))),
        float(jm.control_cost(jnp.asarray(us_mat))), **TOL,
    )
    np.testing.assert_array_equal(tm.initial_guess().numpy(),
                                  np.asarray(jm.initial_guess()))
    assert dataclasses.asdict(tm.default_scp_config()) == dataclasses.asdict(
        jm.default_scp_config())
    for name in ("n_x", "n_u", "S", "dt", "K", "n_fc", "row_scale",
                 "slack_penalty"):
        assert getattr(tm, name) == getattr(jm, name), name
    t32 = tm.to(dtype=torch.float32)
    assert t32.initial_guess().dtype == torch.float32
    assert t32.control_cost(torch.from_numpy(us_mat).float()).dtype == torch.float32


def test_car_linearize_batch_matches(models):
    """The define phase on the car, M=8, at a control sequence away from
    the initial guess: values, Jacobians and trajectories to 1e-12."""
    jm, om, tm, tom, _, _ = models
    us = 0.3 * np.random.default_rng(2).standard_normal((jm.S, jm.n_u))
    j = linearize_batch(jm, jnp.asarray(us), om)
    t = t_linearize(tm, torch.from_numpy(us), tom)
    for name, a, b in zip(j._fields, t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def test_car_sample_distribution():
    """torch.Generator cannot reproduce jax.random streams, so `sample`
    matches in distribution: the ranges of the gains, the std of the
    pedestrian start, the dW scale (4000 samples: the tolerances are > 5
    standard errors), and the "baseline" zeroes."""
    scn = tconfig.CarScenario()
    tm = TCarModel(scn, device="cpu")
    n = 4000
    om = tm.sample(torch.Generator().manual_seed(0), n)
    assert om.state_init.shape == (n, scn.n_x)
    assert om.omega_speed.shape == om.omega_repulsive.shape == (n,)
    assert om.dWs.shape == (n, scn.S, scn.n_x)
    for v, nom, delta in ((om.omega_speed, scn.omega_speed_nom,
                           scn.omega_speed_del),
                          (om.omega_repulsive, scn.omega_repulsive_nom,
                           scn.omega_repulsive_del)):
        v = v.numpy()
        assert v.min() >= nom - delta and v.max() <= nom + delta
        assert v.min() < nom - 0.9 * delta and v.max() > nom + 0.9 * delta
        assert abs(v.mean() - nom) < 5 * delta / np.sqrt(3 * n)
    x0 = scn.state_init.numpy()
    s0 = om.state_init.numpy()
    np.testing.assert_array_equal(s0[:, :4], np.broadcast_to(x0[:4], (n, 4)))
    std = np.sqrt(np.diag(scn.variance_ped_initial_state.numpy()))
    dev = s0[:, 4:] - x0[4:]
    np.testing.assert_allclose(dev.std(axis=0) / std, 1.0, atol=0.06)
    assert np.all(np.abs(dev.mean(axis=0)) < 5 * std / np.sqrt(n))
    dW = om.dWs.numpy()
    sd = np.sqrt(scn.dt)
    assert abs(dW.mean()) < 5 * sd / np.sqrt(dW.size)
    assert abs(dW.std() / sd - 1.0) < 0.01

    base = tm.sample(torch.Generator().manual_seed(0), 7, method="baseline")
    jb = CarModel(jconfig.CarScenario()).sample(
        jax.random.PRNGKey(0), 7, method="baseline")
    for a, b in zip(base, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tm.sample(torch.Generator(), 3, method="nope")


def _port_opt(num_iters, **kw):
    model = TCarModel(tconfig.CarScenario(M=M), device="cpu")
    scp_cfg = dataclasses.replace(model.default_scp_config(),
                                  num_iters=num_iters)
    return tdriver.SAATrajOpt(model, scp_cfg=scp_cfg, device="cpu", **kw)


def _jax_omegas(m=M, seed=0):
    return CarModel(jconfig.CarScenario(M=m)).sample(
        jax.random.PRNGKey(seed), m)


def test_car_admm_scp_matches_jax_m8():
    """'admm' float64, M=8, 5 SCP iterations through the gating transition
    (scp_iter 0 gated): the same ADMM iteration counts and flags, and the
    controls to 1e-6 relative."""
    om = _jax_omegas()
    jm = CarModel(jconfig.CarScenario(M=M))
    scp = dataclasses.replace(jm.default_scp_config(), num_iters=5)
    res_j = SAATrajOpt(jm, scp_cfg=scp).solve(om, alpha=0.1)
    res_t = _port_opt(5).solve(interop.car_omega(om), alpha=0.1)
    assert res_t.qp_iters.tolist() == np.asarray(res_j.qp_iters).tolist()
    assert res_t.qp_solved.tolist() == np.asarray(res_j.qp_solved).tolist()
    us_j = np.asarray(res_j.us)
    assert (np.linalg.norm(res_t.us.numpy() - us_j)
            <= 1e-6 * np.linalg.norm(us_j))


def _car_scaled(scp_iter, m=12):
    """The JAX and the port's scaled structure of the car's float32 QP at
    scp_iter, formed from the same define phase, Ruiz scaling and rho."""
    jm = CarModel(jconfig.CarScenario(M=m))
    opt = SAATrajOpt(jm)
    om = _jax_omegas(m, seed=1)
    data = opt._define(jm.initial_guess(), om, 0.1, m)
    data32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), data)
    st = opt._static_for(m)
    cfg = SolverConfig()
    it = jnp.asarray(scp_iter)
    ops = SAAQPOps(st, data32, it)
    _, q = build_objective(st, data32)
    l, u = build_bounds(st, data32, it)
    scaling = jadmm.ruiz_equilibrate(ops, q, l, u, iters=5)
    p_j, _ = jk.scaled_structure(st, data32, it, scaling,
                                 jnp.asarray(cfg.rho, jnp.float32), cfg, TM=8)
    d_j = jk.kernel_dims(st, TM=8)
    tst = tqp.SAAQPStatic(*st[:14])
    p_t, _ = tk.scaled_structure(
        tst, interop.saa_qp_data(data32, dtype=torch.float32), scp_iter,
        interop.scaling(scaling, dtype=torch.float32),
        torch.tensor(cfg.rho, dtype=torch.float32), tconfig.SolverConfig())
    return st, p_j, d_j, p_t, tk.kernel_dims(tst)


def _schur_of(p):
    """The y-block coupling that the Schur block subtracts from N_vv,
    Cbar^T (Dbar + beta cy cy^T)^-1 Cbar by Sherman-Morrison, in float64
    from the float32 fields of ScaledSAA."""
    h = lambda x: x.double()  # noqa: E731
    CtwD = h(p.Cbar).T @ h(p.wD)
    return (h(p.Cbar).T @ (h(p.Dinv)[:, None] * h(p.Cbar))
            - (h(p.sm_beta) / h(p.sm_denom)) * torch.outer(CtwD, CtwD))


@pytest.mark.parametrize("scp_iter", [0, 3])
def test_car_scaled_structure_matches(scp_iter):
    """The port's scaled structure of the car's float32 QP against JAX's,
    field by field, to the 2e-6 of test_torch_saa_admm.py: at scp_iter 0
    (gated: zeroed sample rows bounded (-inf, 0), the CVaR row live with
    l = -inf, only the first n_x - n_fc - 1 = 3 y rows live) and at 3.

    Sinv is the deliberate difference at scp_iter 0, where sm_free is set:
    the port forms the Schur block from the float32 Dinv, wD, sm_denom and
    Cbar its iteration applies, JAX from their float64 values. There
    Dinv = 1/sigma = 1e6 on the zeroed y rows and the two Sinv have nothing
    in common (at M=12 JAX's S has cond 2.0e9, the port's 1.7e6);
    test_car_gated_fused_iteration_converges shows why. At scp_iter 3 the
    two agree to 2e-6."""
    _, p_j, d_j, p_t, d_t = _car_scaled(scp_iter)
    ref = interop.scaled_saa(p_j, d_j)
    for name, a, b in zip(p_t._fields, p_t, ref):
        if (name, scp_iter) == ("Sinv", 0):
            continue
        a, b = a.numpy(), b.numpy()
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=name)
        fin = np.isfinite(b)
        np.testing.assert_allclose(
            a[fin], b[fin], rtol=2e-6,
            atol=2e-6 * np.max(np.abs(b[fin]), initial=0), err_msg=name)
    if scp_iter == 0:
        assert float(torch.max(torch.abs(ref.Gs))) == 0.0
        assert ref.lb_small[d_t.n_fc] == -np.inf
        assert ref.lb_y.tolist().count(-np.inf) == d_t.M
        assert int((ref.yd_hat != 0).sum()) == 3
    assert float(p_t.sm_free) == float(scp_iter == 0)


@pytest.mark.parametrize(
    "scp_iter,dtype,tol",
    [(0, "float64", 1e-4), (3, "float64", 1e-4), (0, "float32", 2e-2),
     (3, "float32", 2e-2)],
)
def test_car_one_iter_ref_matches(scp_iter, dtype, tol):
    """The port's plain fused iteration on the car's scaled structure
    against JAX's saa_admm.one_iter_ref, from the JAX structure carried
    over by interop.scaled_saa, five iterations, compared through
    state_to_flat: x, z and yd each to `tol` of its own scale, the
    tolerances of test_torch_saa_admm.py (float64 1e-4, float32 2e-2).

    The n_fc final rows of yd are the exception. They are equality rows
    (rho 100) whose duals take rho alpha F u_t each iteration, and the JAX
    iteration rounds v = r_v Sinv to float32 (preferred_element_type) even
    in float64. In float64 that moves them 1.5e-4 (scp_iter 0) and 2.1e-4
    (scp_iter 3) of yd's scale from the port's, while every other row of x,
    z and yd reads <= 3.5e-5 of its scale; with v rounded as JAX rounds it,
    a copy of the port's solve agrees with JAX to 1e-12. So in float64 they
    are held to 1e-3 of yd's scale. In float32 they carry each side's own
    rounding of v, 2.5e-3 apart at both iterations: 0.44 of yd's scale at
    the gated scp_iter 0, where the duals are 5.8e-3 against an O(1)
    primal. There they are held to `tol` of x's scale, the primal whose
    rounding they carry; the float64 cases hold their logic. At scp_iter 0
    both run with the port's Sinv in the JAX structure: with JAX's own the
    iteration diverges (test_car_gated_fused_iteration_converges)."""
    st, p_j, d_j, p_t, d_t = _car_scaled(scp_iter)
    if scp_iter == 0:
        nv = d_t.n + 2
        p_j = p_j._replace(Sinv=p_j.Sinv.at[:nv, :nv].set(p_t.Sinv.numpy()))
    p_j = jax.tree.map(lambda x: jnp.asarray(x, dtype), p_j)
    p = interop.scaled_saa(p_j, d_j)  # float32 values, exact in float64
    p = type(p)(*(x.to(getattr(torch, dtype)) for x in p))
    s_j = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                       jk.init_scaled_state(p_j, d_j))
    s_t = tk.init_scaled_state(p)
    for _ in range(5):
        s_j = jk.one_iter_ref(p_j, s_j, d_j)
        s_t = tk.one_iter_ref(p, s_t, d_t)
    ours = [a.numpy() for a in tk.state_to_flat(s_t, d_t)]
    theirs = [np.asarray(b) for b in jk.state_to_flat(p_j, s_j, st, d_j)]
    for name, a, b in zip("x z yd".split(), ours, theirs):
        assert np.isfinite(a).all(), name
        atol = tol * np.max(np.abs(b))
        if name == "yd":
            nf = d_t.n_fc
            final_atol = (1e-3 * np.max(np.abs(b)) if dtype == "float64"
                          else tol * np.max(np.abs(theirs[0])))
            np.testing.assert_allclose(a[:nf], b[:nf], rtol=0,
                                       atol=final_atol, err_msg="yd final")
            a, b = a[nf:], b[nf:]
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


def test_car_gated_fused_iteration_converges():
    """A fault of the reference found on the car, and its repair in the
    port. At the car's gated scp_iter 0 (M=50) the JAX fused iteration
    (saa_admm.one_iter_ref on its own scaled structure) reaches non-finite
    values within 200 float32 iterations from a cold start. The y of the
    samples past the third meet the CVaR row alone, so their Dinv is
    1/sigma = 1e6, and (1) the Sherman-Morrison step Dinv r - coef wD
    cancels terms 1e6 times its result, (2) Sinv inverts a Schur block
    formed from float64 values while the iteration applies their float32
    roundings. The port, where sm_free is set, takes the cancellation-free
    form of ops/cuda/saa_admm.py:kkt_solve and forms the Schur block from
    the rounded values. Its float32 iteration then stays within 2e-2 of
    its float64 iteration of the same structure after 200 iterations
    (measured 1.8e-3), every iterate finite; the N_vv its Sinv implies is
    symmetric positive definite."""
    st, p_j, d_j, p_t, d_t = _car_scaled(0, m=50)
    assert bool(p_t.sm_free)
    N_vv = torch.linalg.inv(p_t.Sinv.double()) + _schur_of(p_t)
    assert torch.allclose(N_vv, N_vv.T, rtol=0,
                          atol=1e-6 * float(N_vv.abs().max()))
    assert float(torch.linalg.eigvalsh(N_vv).min()) > 0
    p64 = type(p_t)(*(x.double() for x in p_t))
    s_t, s_64 = tk.init_scaled_state(p_t), tk.init_scaled_state(p64)
    s_j = jk.init_scaled_state(p_j, d_j)
    for _ in range(200):
        s_t = tk.one_iter_ref(p_t, s_t, d_t)
        s_64 = tk.one_iter_ref(p64, s_64, d_t)
        s_j = jk.one_iter_ref(p_j, s_j, d_j)
    err, _ = kc.state_err(s_t, type(s_t)(*(x.float() for x in s_64)))
    assert err <= 2e-2, err
    x_j = np.asarray(jk.state_to_flat(p_j, s_j, st, d_j)[0])
    assert not np.isfinite(x_j).all()


def car_contract(model, res, omegas, alpha):
    """tests/test_scp_car.py's contract, without the L2 line: every iterate
    finite, the sample-mean ego final state within 2e-2 of the goal, the
    training-sample AVaR of the worst separation violation <= 5e-2, and
    |u| <= u_max + 1e-6. Returns (mean-final error, AVaR, max |u|)."""
    for name in ("us", "xs", "l2_errors", "us_history"):
        assert bool(torch.isfinite(getattr(res, name)).all()), name
    goal = torch.cat([model.scn.position_ego_goal,
                      model.scn.velocity_ego_goal]).to(res.xs)
    final_err = float(torch.max(torch.abs(res.xs[:, -1, :4].mean(0) - goal)))
    worst = torch.amax(model.ineq_constraints(res.xs, omegas), dim=1)
    risk = float(tavar(worst, alpha))
    umax = float(torch.max(torch.abs(res.us)))
    assert final_err <= 2e-2, final_err
    assert risk <= 5e-2, risk
    assert umax <= model.scn.u_max + 1e-6, umax
    return final_err, risk, umax


@pytest.mark.parametrize("backend", ["_admm-pallas", "_admm-pallas-f"])
def test_car_fused_backend_scp_m8(backend):
    """Both fused backends' float32 car SCP at M=8, 15 iterations, on the
    CPU (the plain iteration, no kernel launch), held to chip_smoke.py's
    phase 7 float32 checks (car_contract). The solver config is
    chip_smoke.py's phase 3 one, with max_iter cut to 4000."""
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f

    cfg = tconfig.SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=4000,
                               polish=False, rho_warm_start=True)
    opt = _port_opt(15, qp_backend=backend, admm_cfg=cfg, dtype=torch.float32)
    om = interop.car_omega(_jax_omegas(), dtype=torch.float32)
    before = tk.admm_chunk.launches, saa_admm_f.admm_chunk_f.launches
    res = opt.solve(om, alpha=0.1)
    assert (tk.admm_chunk.launches, saa_admm_f.admm_chunk_f.launches) == before
    assert res.us.dtype == torch.float32
    car_contract(opt.model, res, om, 0.1)


def test_car_admm_scp_contract_m8():
    """The float64 'admm' car SCP of the port holds the whole of
    tests/test_scp_car.py's contract at M=8, 15 iterations, on the JAX
    test's omegas: final L2 < 2e-2 besides car_contract."""
    opt = _port_opt(15)
    om = interop.car_omega(_jax_omegas())
    res = opt.solve(om, alpha=0.1)
    assert float(res.l2_errors[-1]) < 2e-2, res.l2_errors
    car_contract(opt.model, res, om, 0.1)


@pytest.mark.parametrize("spb", [5, 1])
def test_three_phase_kernel_algebra_free_rows(spb):
    """The kernel's three phases in their free-row form (the car's gated
    structure sets sm_free), in float64 (test_torch_saa_admm.py's
    `_three_phase_chunk`, blocks of `spb` samples at M=12 plus an empty
    one): ten iterations as one chunk and as two of five equal the port's
    `one_iter_ref` to 1e-10 of each field's scale, as the drone's do."""
    from tests.test_torch_saa_admm import _three_phase_chunk

    _, _, _, p_t, d = _car_scaled(0)
    assert bool(p_t.sm_free)
    p = type(p_t)(*(x.double() for x in p_t))
    blocks = [slice(m0, min(m0 + spb, d.M)) for m0 in range(0, d.M, spb)]
    blocks.append(slice(d.M, d.M))
    s0 = tk.init_scaled_state(p)
    ref = s0
    for _ in range(10):
        ref = tk.one_iter_ref(p, ref, d)
    one = _three_phase_chunk(p, s0, d, 10, blocks)
    two = _three_phase_chunk(p, _three_phase_chunk(p, s0, d, 5, blocks), d,
                             5, blocks)
    for out in (one, two):
        for name, a, b in zip(ref._fields, out, ref):
            scale = max(float(torch.max(torch.abs(b))), 1.0)
            assert float(torch.max(torch.abs(a - b))) <= 1e-10 * scale, name


@pytest.mark.parametrize("scp_iter", [0, 3])
def test_free_row_check_sees_the_free_row_algebra(scp_iter):
    """kernel_checks.free_row_errs, the card's check of the free-row form
    (chip_smoke.py phase 7), on the car's structure at M=12: at scp_iter 0
    and at 3 with the free-row form forced (sm_free set; the form is exact
    for any structure). Its float64 side is the kernel's algebra: one
    float64 `_three_phase_chunk` iteration from each built state equals
    free_row_ref to 1e-10 there. A float32 model of the kernel (the three
    phases in float32) reads under a fifth of FREE_ROW_TOL (5.1e-4 at most
    here), and each planted fault of the free-row branch at least ten
    times it (0.12 at least)."""
    from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc
    from tests.test_torch_saa_admm import _three_phase_chunk

    _, _, _, p, d = _car_scaled(scp_iter)
    p = p._replace(sm_free=torch.tensor(1.0))
    blocks = [slice(m0, min(m0 + 5, d.M)) for m0 in range(0, d.M, 5)]
    p64 = type(p)(*(x.double() for x in p))
    for seed in kc.FREE_ROW_SEEDS:
        s = kc.free_row_state(p, seed)
        ref = kc.free_row_ref(p, s, d)
        out = _three_phase_chunk(p64, type(s)(*(x.double() for x in s)), d,
                                 1, blocks)
        for name, a, b in zip(ref._fields, out, ref):
            scale = max(float(torch.max(torch.abs(b))), 1.0)
            assert float(torch.max(torch.abs(a - b))) <= 1e-10 * scale, name
    model = kc.free_row_errs(
        p, d, lambda s: _three_phase_chunk(p, s, d, 1, blocks))
    assert model <= 0.2 * kc.FREE_ROW_TOL, model
    for fault in ("x1_sign", "kappa2_no_c2", "cv_no_c2"):
        err = kc.free_row_errs(
            p, d, lambda s: _three_phase_chunk(p, s, d, 1, blocks, fault))
        assert err >= 10 * kc.FREE_ROW_TOL, (fault, err)


def test_free_y_marks_only_the_car_gated_structure():
    """SAAQPOps.free_y (the float64 y-block elimination of the float32
    'admm' repair) is set exactly where some y meets the CVaR row alone:
    the car's gated iteration. Every drone structure and the baselines keep
    the plain float32 arithmetic."""
    from riskaversetrajopt_torch.models.drone import DroneModel as TDroneModel
    from tests.test_torch_scp import GOLDEN_SCP

    cases = []
    for method in ("saa", "baseline"):
        car = _port_opt(1, method=method)
        drone = tdriver.SAATrajOpt(
            TDroneModel(tconfig.DroneScenario(M=M), device="cpu"),
            method=method, scp_cfg=tconfig.SCPConfig(num_iters=1, **GOLDEN_SCP),
            device="cpu")
        for opt in (car, drone):
            om = opt.sample(torch.Generator().manual_seed(0), M, method)
            data = opt._define(opt.model.initial_guess(), om, torch.tensor(0.1))
            for scp_iter in range(4):
                free = tqp.SAAQPOps(opt._static_for(M), data, scp_iter).free_y
                cases.append((opt is car, method, scp_iter, free))
    assert [c for c in cases if c[3]] == [(True, "saa", 0, True)]
