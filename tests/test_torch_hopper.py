"""The port's hopper (core/config.HopperScenario, models/hopper.py) and its
barrier solves against the JAX package, at HopperScenario() (M=30, 400
variables) on friction fields drawn by JAX and handed over as arrays
(interop.friction_field): the constraint stack, bounds, objective, initial
guess and RK4 defects (1e-12), the constraint Jacobian and the
Lagrangian's Hessian (1e-10 of their scale), the structural checks of
tests/test_hopper.py:20-69, the port's own sampler, and a 5-iteration
solve at M=2 against JAX's (Z within 1e-6, the same accepted steps).
The damped cold baseline and the float32 warm SAA solve
(tests/test_hopper.py:159-241) are marked slow."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core import config as tconfig
from riskaversetrajopt_torch.models.hopper import HopperModel as THopper
from riskaversetrajopt_torch.ops import nlp_ipm as tn
from riskaversetrajopt_tpu.core import config as jconfig
from riskaversetrajopt_tpu.models.hopper import HopperModel
from riskaversetrajopt_tpu.ops import nlp_ipm as jn

METHODS = ("saa", "baseline")


def _tmodel():
    return THopper(tconfig.HopperScenario(), device="cpu")


def test_scenario_fields_and_constants_match():
    """Field names, order and defaults, and the derived constants (the
    + 2e-7 offset of the states included), equal JAX's."""
    j = [(f.name, f.default) for f in dataclasses.fields(jconfig.HopperScenario)]
    t = [(f.name, f.default) for f in dataclasses.fields(tconfig.HopperScenario)]
    assert t == j
    js, ts = jconfig.HopperScenario(), tconfig.HopperScenario()
    assert ts.dt == js.dt and ts.num_vars == js.num_vars == 400
    for prop in ("state_initial", "state_final"):
        np.testing.assert_array_equal(getattr(ts, prop).numpy(),
                                      np.asarray(getattr(js, prop)))


@pytest.fixture(scope="module")
def models():
    """Both models, JAX-drawn fields at M=30 per method, a seeded point
    near the initial guess and seeded multipliers."""
    jm = HopperModel(jconfig.HopperScenario())
    rng = np.random.default_rng(0)
    Z = np.asarray(jm.initial_guess(jm.M)) + 0.1 * rng.standard_normal(400)
    fields = {m: jm.sample_friction(jax.random.PRNGKey(0), jm.M, m)
              for m in METHODS}
    lams = {m: rng.standard_normal(jm.bounds(m, jm.M)[0].shape[0])
            for m in METHODS}
    return jm, _tmodel(), fields, Z, lams


TOL = dict(rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_constraints_bounds_objective_match_jax(method, models):
    jm, tm, fields, Z, _ = models
    fj = fields[method]
    ft = interop.friction_field(fj)
    Zj, Zt = jnp.asarray(Z), torch.from_numpy(Z)
    np.testing.assert_allclose(tm.g_all(Zt, ft, method, 0.1).numpy(),
                               np.asarray(jm.g_all(Zj, fj, method, 0.1)),
                               **TOL)
    for name, a, b in zip(("g_L", "g_U", "n_eq", "x_L", "x_U"),
                          tm.bounds(method, tm.M), jm.bounds(method, jm.M)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_allclose(float(tm.f(Zt)), float(jm.f(Zj)), rtol=1e-15,
                               atol=1e-12)
    np.testing.assert_array_equal(tm.initial_guess(tm.M).numpy(),
                                  np.asarray(jm.initial_guess(jm.M)))
    xs, us = jm.split_z(Zj)[:2]
    np.testing.assert_allclose(
        tm.dynamics_defects(*(torch.from_numpy(np.asarray(v))
                              for v in (xs, us))).numpy(),
        np.asarray(jm.dynamics_defects(xs, us)), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_jacobian_and_lagrangian_hessian_match_jax(method, models):
    """jacfwd of g_all and the Hessian of f + lam.g at the seeded point:
    JAX's to 1e-10 of each matrix's largest entry (measured ~1e-15)."""
    jm, tm, fields, Z, lams = models
    fj, lam = fields[method], lams[method]

    @jax.jit
    def both(z, lam, fj):
        g = lambda z: jm.g_all(z, fj, method, 0.1)  # noqa: E731
        return jax.jacfwd(g)(z), jax.hessian(
            lambda z: jm.f(z) + jnp.dot(lam, g(z)))(z)

    Jj, Hj = (np.asarray(v) for v in both(jnp.asarray(Z), jnp.asarray(lam),
                                           fj))
    ft = interop.friction_field(fj)
    lam_t = torch.from_numpy(lam)
    g = lambda z: tm.g_all(z, ft, method, 0.1)  # noqa: E731
    Jt = jacfwd(g)(torch.from_numpy(Z)).numpy()
    Ht = hessian(lambda z: tm.f(z) + torch.dot(lam_t, g(z)))(
        torch.from_numpy(Z)).numpy()
    for a, b in ((Jt, Jj), (Ht, Hj)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-10 * np.abs(b).max())


def test_constraint_stack_shapes():
    """tests/test_hopper.py:20-38 on the port: the reference's row count,
    the equality prefix and 400 variables."""
    tm = _tmodel()
    M, s = tm.M, tm.scn
    field = tm.sample_friction(torch.Generator().manual_seed(0), M, "saa")
    g = tm.g_all(tm.initial_guess(M), field, "saa", 0.1)
    g_L, g_U, n_eq, xL, xU = tm.bounds("saa", M)
    assert g.shape == g_L.shape == g_U.shape
    C = tm.num_contacts
    assert g.shape[0] == (s.S * s.n_x + s.n_x + 2 + 21 + 21 + 10
                          + (1 + M + M * C + 1) + s.n_u * s.S + 1 + 3 * s.S)
    assert n_eq == s.S * s.n_x + s.n_x + 2 + 21 + 21
    assert tm.num_vars == xL.shape[0] == 400


def test_initial_guess_dynamics_defect_structure():
    """tests/test_hopper.py:41-53: the phase-structured guess applies the
    nominal force on the leg actuator and the contact force, so every RK4
    defect is g*dt in the velocity block."""
    tm = _tmodel()
    xs, us = tm.split_z(tm.initial_guess(tm.M))[:2]
    per_step = torch.amax(torch.abs(
        tm.dynamics_defects(xs, us).reshape(tm.S, tm.n_x)), dim=1)
    np.testing.assert_allclose(per_step.numpy(), tm.scn.gravity * tm.dt,
                               rtol=1e-6)


def test_friction_field_sampling():
    """tests/test_hopper.py:56-69 on the port's torch.Generator sampler:
    baseline mu == mu_nom everywhere, saa intensities in
    [0, 0.025 sqrt(2/F)], thetas in [0, pi], taus in [0, 2 pi]."""
    tm = _tmodel()
    s = tm.scn
    f_saa = tm.sample_friction(torch.Generator().manual_seed(0), 100, "saa")
    f_base = tm.sample_friction(torch.Generator().manual_seed(0), 100,
                                "baseline")
    px = torch.linspace(-1.0, 3.0, 50, dtype=torch.float64)
    mu = tm.friction_at_px(px[:, None], tuple(v[0] for v in f_base))
    np.testing.assert_allclose(mu.numpy(), s.mu_nom)
    bound = 0.025 * np.sqrt(2.0 / s.num_mu_features)
    assert 0.0 <= float(f_saa.intensities.min())
    assert float(f_saa.intensities.max()) <= bound + 1e-12
    assert 0.0 <= float(f_saa.thetas.min()) <= float(f_saa.thetas.max()) <= np.pi
    assert 0.0 <= float(f_saa.taus.min()) <= float(f_saa.taus.max()) <= 2 * np.pi
    assert f_saa.intensities.shape == (100, s.num_mu_features)


def test_five_iteration_solve_matches_jax():
    """solve_nlp at M=2, saa, alpha 0.1, tol 0, 5 iterations, on the same
    JAX-drawn field: Z within 1e-6 relative L2 of JAX's (measured ~1e-15)
    and the same step lengths and acceptances (trace_iters)."""
    jm, tm, M = HopperModel(jconfig.HopperScenario()), _tmodel(), 2
    fj = jm.sample_friction(jax.random.PRNGKey(3), M, "saa")
    cfg = dict(tol=0.0, max_iter=5)
    f, g, gL, gU, n_eq, xL, xU = jm.make_nlp(fj, "saa", 0.1)
    rj = jn.solve_nlp(f, g, gL, gU, n_eq, xL, xU, jm.initial_guess(M),
                      jn.NLPConfig(**cfg), trace_iters=5)
    trj = jn.solve_nlp.last_trace
    f, g, gL, gU, n_eq, xL, xU = tm.make_nlp(interop.friction_field(fj),
                                             "saa", 0.1)
    rt = tn.solve_nlp(f, g, gL, gU, n_eq, xL, xU, tm.initial_guess(M),
                      tn.NLPConfig(**cfg), trace_iters=5)
    trt = tn.solve_nlp.last_trace
    Zj = np.asarray(rj.Z)
    assert rt.iters == int(rj.iters) == 5
    assert np.linalg.norm(rt.Z.numpy() - Zj) <= 1e-6 * np.linalg.norm(Zj)
    for name in ("ok", "a_p"):
        i = tn.TRACE_FIELDS.index(name)
        np.testing.assert_allclose(trt[i].numpy().astype(float),
                                   np.asarray(trj[i]).astype(float),
                                   rtol=1e-8, err_msg=name)


def test_make_nlp_params_matches_make_nlp():
    """The params path (the field as the callbacks' argument, a
    precomputed row permutation) takes the same steps as the closures,
    bit for bit."""
    tm, M = _tmodel(), 3
    field = tm.sample_friction(torch.Generator().manual_seed(5), M, "saa")
    cfg = tn.NLPConfig(tol=1e-4, max_iter=4)
    Z0 = tm.initial_guess(M)
    f, g, gL, gU, n_eq, xL, xU = tm.make_nlp(field, "saa", 0.1)
    ref = tn.solve_nlp(f, g, gL, gU, n_eq, xL, xU, Z0, cfg)
    fp, gp, params, gL, gU, n_eq, xL, xU = tm.make_nlp_params(field, "saa",
                                                              0.1)
    res = tn.solve_nlp(fp, gp, gL, gU, n_eq, xL, xU, Z0, cfg, params=params,
                       row_perm=tn.classify_rows(gL, gU, n_eq))
    assert res.iters == ref.iters
    np.testing.assert_array_equal(res.Z.numpy(), ref.Z.numpy())


@pytest.mark.slow
def test_cold_baseline_damped_converges():
    """tests/test_hopper.py:159-182 on the port: the damped cold baseline
    (50 / 0.1) certifies at tol 1e-4 within 120 iterations in the
    jump-1.053 basin (jump > 0.9)."""
    tm = _tmodel()
    field = tm.sample_friction(torch.Generator().manual_seed(1), tm.M,
                               "baseline")
    f, g, gL, gU, n_eq, xL, xU = tm.make_nlp(field, "baseline", 0.1)
    res = tn.solve_nlp(f, g, gL, gU, n_eq, xL, xU, tm.initial_guess(tm.M),
                       tn.NLPConfig(tol=1e-4, max_iter=120, damp_iters=50,
                                    damp_max=0.1))
    assert res.solved
    assert float(tm.split_z(res.Z)[0][-1, 0]) > 0.9


@pytest.mark.slow
def test_float32_saa_warm_start():
    """tests/test_hopper.py:214-241 on the port, in float32 throughout: the
    SAA phase at alpha 0.3 warm-started from the committed float64
    baseline (jump 1.053) certifies at tol 1e-3 within 100 iterations with
    three Ruiz sweeps, in the jumping basin (jump > 0.3)."""
    import os

    Zb = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                              "hopper_base_Z.npy"))
    tm = _tmodel()
    assert abs(Zb[tm.S * tm.n_x] - 1.0534) < 1e-2
    jm = HopperModel(jconfig.HopperScenario())
    field = interop.friction_field(
        jm.sample_friction(jax.random.PRNGKey(0), jm.M, "saa"))
    f, g, gL, gU, n_eq, xL, xU = tm.make_nlp(field, "saa", 0.3)
    res = tn.solve_nlp(f, g, gL, gU, n_eq, xL, xU,
                       torch.as_tensor(Zb, dtype=torch.float32),
                       tn.NLPConfig(tol=1e-3, max_iter=100, kkt_ruiz_iters=3))
    assert res.Z.dtype == torch.float32
    assert res.solved
    assert float(tm.split_z(res.Z)[0][-1, 0]) > 0.3
