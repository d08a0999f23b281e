"""The port's configuration and drone model against the JAX package, on the
same numbers (omegas drawn by the JAX sampler, handed over as arrays)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core import config as tconfig
from riskaversetrajopt_torch.models.drone import DroneModel as TDroneModel
from riskaversetrajopt_tpu.core import config as jconfig
from riskaversetrajopt_tpu.models.drone import DroneModel

M = 50


@pytest.mark.parametrize(
    "name", ["DroneScenario", "CarScenario", "SCPConfig", "SolverConfig",
             "PDIPConfig", "MeshConfig"])
def test_config_fields_and_defaults_match(name):
    """Field names, order and defaults equal the JAX dataclasses exactly."""
    j = [(f.name, f.default) for f in dataclasses.fields(getattr(jconfig, name))]
    t = [(f.name, f.default) for f in dataclasses.fields(getattr(tconfig, name))]
    assert t == j


@pytest.mark.parametrize(
    "prop", ["dt", "R", "feedback_gain", "obs_positions", "obs_radii",
             "x_init", "x_final"],
)
def test_scenario_constants_match(prop):
    j = getattr(jconfig.DroneScenario(), prop)
    t = getattr(tconfig.DroneScenario(), prop)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.fixture(scope="module")
def models():
    jm = DroneModel(jconfig.DroneScenario(M=M))
    om = jm.sample(jax.random.PRNGKey(3), M)
    tm = TDroneModel(tconfig.DroneScenario(M=M), device="cpu")
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((M, jm.S + 1, jm.n_x))
    us = rng.standard_normal((M, jm.n_u))
    return jm, om, tm, interop.drone_omega(om), xs, us


def _j_per_sample(fn, *args):
    return np.asarray(jax.vmap(fn)(*args))


# float64 on both sides: the same elementwise formulas, so agreement is at
# the roundoff of a few operations (<= 1e-12 relative to the values)
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "fn", ["drift", "dispersion", "x0", "ineq_constraints",
           "ineq_constraints_euclidean", "final_constraints"],
)
def test_drone_functions_match(models, fn):
    jm, om, tm, tom, xs, us = models
    x = xs[:, 3]
    if fn == "drift":
        j = _j_per_sample(jm.drift, jnp.asarray(x), jnp.asarray(us), om)
        t = tm.drift(torch.from_numpy(x), torch.from_numpy(us), tom)
    elif fn == "dispersion":
        dW = np.array(om.dWs)[:, 4]
        j = _j_per_sample(jm.dispersion, jnp.asarray(x), jnp.asarray(us), om,
                          jnp.asarray(dW))
        t = tm.dispersion(torch.from_numpy(x), torch.from_numpy(us), tom,
                          torch.from_numpy(dW))
    elif fn == "x0":
        j, t = np.asarray(jm.x0(om)), tm.x0(tom)
    elif fn == "final_constraints":
        j = _j_per_sample(jm.final_constraints, jnp.asarray(xs))
        t = tm.final_constraints(torch.from_numpy(xs))
    else:
        j = _j_per_sample(getattr(jm, fn), jnp.asarray(np.abs(xs)), om)
        t = getattr(tm, fn)(torch.from_numpy(np.abs(xs)), tom)
    np.testing.assert_allclose(t.numpy(), j, **TOL)


def test_control_cost_initial_guess_and_scp_config_match(models):
    jm, om, tm, tom, xs, us = models
    us_mat = np.random.default_rng(1).standard_normal((jm.S, jm.n_u))
    np.testing.assert_allclose(
        float(tm.control_cost(torch.from_numpy(us_mat))),
        float(jm.control_cost(jnp.asarray(us_mat))), **TOL,
    )
    # the reference quirk (drone.py:162-166): only the first n_u-1 controls
    # get the 1e-2 offset
    np.testing.assert_array_equal(tm.initial_guess().numpy(),
                                  np.asarray(jm.initial_guess()))
    assert dataclasses.asdict(tm.default_scp_config()) == dataclasses.asdict(
        jm.default_scp_config())


def test_sample_distribution():
    """torch.Generator cannot reproduce jax.random streams, so `sample`
    matches in distribution: ranges, shapes, the diagonal Q structure, and
    the mean and std of the Brownian increments (4000*120 draws: the
    tolerances are > 5 standard errors)."""
    scn = tconfig.DroneScenario()
    tm = TDroneModel(scn, device="cpu")
    n = 4000
    om = tm.sample(torch.Generator().manual_seed(0), n)
    assert om.mass.shape == (n,) and om.obs_Q.shape == (n, scn.n_obs, 3, 3)
    assert om.dWs.shape == (n, scn.S, scn.n_x)
    mass = om.mass.numpy()
    assert mass.min() >= scn.mass_nom - scn.mass_delta
    assert mass.max() <= scn.mass_nom + scn.mass_delta
    assert abs(mass.mean() - scn.mass_nom) < 0.15
    Q = om.obs_Q.numpy()
    diag = np.diagonal(Q, axis1=-2, axis2=-1)
    np.testing.assert_array_equal(Q, np.apply_along_axis(np.diag, -1, diag))
    lengths = 1.0 / np.sqrt(diag)
    dev = lengths - scn.obs_radii.numpy()[None, :, None]
    assert np.all(np.abs(dev) <= scn.obs_radii_deltas + 1e-12)
    dW = om.dWs.numpy()
    sd = np.sqrt(scn.dt)
    assert abs(dW.mean()) < 5 * sd / np.sqrt(dW.size)
    assert abs(dW.std() / sd - 1.0) < 0.01

    base = tm.sample(torch.Generator().manual_seed(0), 7, method="baseline")
    jb = DroneModel(jconfig.DroneScenario()).sample(
        jax.random.PRNGKey(0), 7, method="baseline")
    for a, b in zip(base, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tm.sample(torch.Generator(), 3, method="nope")
