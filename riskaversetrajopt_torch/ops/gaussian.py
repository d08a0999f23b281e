"""Gaussian-linearization uncertainty propagation and quantile back-off.

The counterpart of ``riskaversetrajopt_tpu/ops/gaussian.py`` (the machinery
of the Gaussian baselines, car/driving_gaussian.py:188-258): the state
covariance follows the linearized dynamics

    Sigma_{t+1} = A_t Sigma_t A_t^T + dt * sigma sigma^T + Sigma_param,
    A_t = I + dt * db/dx(x_t, u_t),

and a chance constraint becomes the quantile back-off
distance - ndtri(1 - alpha_t) * sqrt(n^T Sigma n) - radius >= 0. The
recursion is a Python loop over the S steps; the Jacobians come from
torch.func.
"""

from __future__ import annotations

import torch


def normal_quantile(p):
    """norm.ppf(p) (car/driving_utils.py:6-7); a Python float is taken as
    float64."""
    if not torch.is_tensor(p):
        p = torch.tensor(p, dtype=torch.float64)
    return torch.special.ndtri(p)


def propagate_covariance(
    xs, us, Sigma0, drift_jac_x, disp_cols, param_jacs, param_vars, dt
):
    """The covariance recursion along a nominal trajectory.

    Args:
      xs: (S+1, n_x) nominal (mean) trajectory.
      us: (S, n_u) controls.
      Sigma0: (n_x, n_x) initial covariance.
      drift_jac_x: (x, u) -> (n_x, n_x) Jacobian of the drift at the nominal
        parameters.
      disp_cols: (x, u) -> (n_x, n_x) diffusion matrix sigma(x, u).
      param_jacs: list of (x, u) -> (n_x,) drift Jacobians with respect to
        each scalar uncertain parameter at its nominal value.
      param_vars: list of the matching scalar variances.
      dt: step.

    Returns:
      Sigmas: (S+1, n_x, n_x).
    """
    eye = torch.eye(xs.shape[1], dtype=xs.dtype, device=xs.device)
    Sigma = Sigma0
    out = [Sigma0]
    for x, u in zip(xs[:-1], us):
        A = eye + dt * drift_jac_x(x, u)
        sig = disp_cols(x, u)
        Sigma_next = A @ Sigma @ A.T + dt * sig @ sig.T
        for jac, var in zip(param_jacs, param_vars):
            b_d = dt * jac(x, u)
            # the reference's quirk, reproduced (gaussian.py:62-72): it
            # writes var * b @ b.T with b 1-D, a dot product, so the scalar
            # var * |b|^2 is added to every entry of Sigma
            Sigma_next = Sigma_next + var * torch.dot(b_d, b_d)
        Sigma = Sigma_next
        out.append(Sigma)
    return torch.stack(out)
