"""The port's rollout and forward-mode linearization against the JAX package
at M=50 on the same omegas and controls (float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core.config import DroneScenario as TScenario
from riskaversetrajopt_torch.models.drone import DroneModel as TDroneModel
from riskaversetrajopt_torch.ops import rollout as trollout
from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.ops import rollout as jrollout
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)

M = 50


@pytest.fixture(scope="module")
def both():
    jm = DroneModel(DroneScenario(M=M))
    om = jm.sample(jax.random.PRNGKey(1), M)
    # a non-trivial control sequence: the initial guess plus a ramp
    us = np.asarray(jm.initial_guess(), np.float64) + 0.02 * np.linspace(
        -1, 1, jm.S * jm.n_u).reshape(jm.S, jm.n_u)
    lin_j = jrollout.linearize_batch(jm, jnp.asarray(us), om)
    tm = TDroneModel(TScenario(M=M), device="cpu")
    tom = interop.drone_omega(om)
    lin_t = trollout.linearize_batch(tm, torch.from_numpy(us), tom)
    return jm, om, us, tm, tom, lin_j, lin_t


def test_rollout_batch_matches(both):
    jm, om, us, tm, tom, _, _ = both
    xs_j = np.asarray(jrollout.rollout_batch(jm, jnp.asarray(us), om))
    xs_t = trollout.rollout_batch(tm, torch.from_numpy(us), tom).numpy()
    # the same float64 step formulas in the same order: roundoff only
    np.testing.assert_allclose(xs_t, xs_j, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("field", ["f_val", "f_jac", "g_val", "g_jac", "xs"])
def test_linearize_batch_matches(both, field):
    """Values and Jacobians in the us_vec[t*n_u+i] layout. Tolerance 1e-12
    relative to the field's largest entry: jacfwd and jax.linearize push the
    same tangents through the same float64 ops, differing only in
    summation order inside the obstacle quadratic forms."""
    *_, lin_j, lin_t = both
    j = np.asarray(getattr(lin_j, field))
    t = getattr(lin_t, field).numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-12 * np.max(np.abs(j)))


def test_single_sample_rollout_matches_batch(both):
    """`rollout` also takes one sample (no leading axis)."""
    _, _, us, tm, tom, _, lin_t = both
    one = type(tom)(*(x[7] for x in tom))
    xs = trollout.rollout(tm, torch.from_numpy(us), one)
    np.testing.assert_allclose(xs.numpy(), lin_t.xs[7].numpy(), rtol=1e-14,
                               atol=1e-14)
