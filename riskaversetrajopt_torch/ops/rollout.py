"""Stochastic rollout and fused linearization.

The counterpart of ``riskaversetrajopt_tpu/ops/rollout.py``. The rollout is a
Python loop over the S steps with the sample axis written out as a batch
dimension, so one call rolls out all M samples.

The Jacobian is built with ``torch.func.jacfwd`` over the batched rollout:
the controls are shared by every sample, so forward mode pushes the S*n_u
basis tangents through one batched rollout and returns all M per-sample
Jacobians at once, with no vmap over samples and no hand-written step
derivatives (the model stays the only place its dynamics are written).

NUMERICAL QUIRK REPRODUCED DELIBERATELY (do not "fix"): the Brownian
increments are sampled already scaled by sqrt(dt)
(car/driving.py:116, drone/drone_utils.py:87-90) and the rollout multiplies by
sqrt(dt) AGAIN (car/driving.py:200, drone/drone_risk.py:151), so the noise
enters at order dt^1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd


def rollout(model, us_mat, omega):
    """Euler-Maruyama rollout.

    x_{t+1} = x_t + dt * b(x_t, u_t, omega) + sqrt(dt) * sigma(x_t, u_t) @ dW_t
    with dW pre-scaled by sqrt(dt) at sampling time (see module docstring).

    us_mat: (S, n_u) controls shared by every sample; omega: one sample
    (dWs (S, n_x)) or M samples (dWs (M, S, n_x)).
    Returns xs: (S+1, n_x) or (M, S+1, n_x)."""
    dt = model.dt
    sqrt_dt = math.sqrt(dt)
    batch = omega.dWs.shape[:-2]
    x = model.x0(omega).to(us_mat.dtype).expand(*batch, model.n_x)
    xs = [x]
    for t in range(model.S):
        u = us_mat[t]
        dW = omega.dWs[..., t, :]
        x = (
            x
            + dt * model.drift(x, u, omega)
            + sqrt_dt * model.dispersion(x, u, omega, dW)
        )
        xs.append(x)
    return torch.stack(xs, dim=-2)


def rollout_batch(model, us_mat, omegas):
    """Rollout of the same controls under every sample of `omegas`
    (us_to_state_trajectories, car/driving.py:206-214). Returns
    (M, S+1, n_x)."""
    return rollout(model, us_mat, omegas)


class SampleLinearization(NamedTuple):
    """Constraint values and Jacobians (leading axis M when produced by
    `linearize_batch`), in the us_vec layout us_vec[t * n_u + i] =
    us_mat[t, i] (reference layout contract, car/driving.py:122-130)."""

    f_val: torch.Tensor  # (n_fc,) final-constraint values
    f_jac: torch.Tensor  # (n_fc, S * n_u)
    g_val: torch.Tensor  # (K,) inequality-constraint values
    g_jac: torch.Tensor  # (K, S * n_u)
    xs: torch.Tensor  # (S+1, n_x) primal trajectory


def linearize(model, us_mat, omega) -> SampleLinearization:
    """Values + Jacobians of (final, ineq) constraints w.r.t. the controls,
    by forward mode through the rollout (get_all_constraints_coeffs,
    car/driving.py:260-298, drone/drone_risk.py:239-280).

    The tangent basis of jacfwd is eye(S*n_u) reshaped C-order to (S, n_u),
    so the flattened Jacobian columns follow the us_vec layout
    (car/driving.py:284-286)."""
    n = model.S * model.n_u

    def constraints_of_us(us):
        xs = rollout(model, us, omega)
        f = model.final_constraints(xs)
        g = model.ineq_constraints(xs, omega)
        return (f, g), (f, g, xs)

    (f_jac, g_jac), (f_val, g_val, xs) = jacfwd(
        constraints_of_us, has_aux=True
    )(us_mat)
    return SampleLinearization(
        f_val=f_val,
        f_jac=f_jac.reshape(*f_val.shape, n),
        g_val=g_val,
        g_jac=g_jac.reshape(*g_val.shape, n),
        xs=xs,
    )


def linearize_batch(model, us_mat, omegas) -> SampleLinearization:
    """`linearize` over all samples of `omegas` at once (the define phase).
    Fields carry a leading M axis."""
    return linearize(model, us_mat, omegas)
