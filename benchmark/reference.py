"""Plain reference of the drone SAA problem, and the comparison that
decides a run's `correct`.

Plain PyTorch in float64. It imports nothing of the program and takes
nothing that the program made: its constants come from the configuration
file, its samples from the benchmark's own sampler, and the program's
outputs (the plan `us`, the trajectories `xs`, the plan of every SCP
iteration and the last QP's CVaR epigraph t that a solve returns) are read
only to be judged. `control_xs` is the control of the define phase: this
module's rollout in float32 with TF32 products. The QP's control is the
program's own lower-precision path (calibrate.py --controls).

What a solve is held to (each number beside its limit, limits from the
cell's file under limits/):
  rollout_gap   the program's trajectories against this module's rollout of
                the program's plan on the same samples,
                max |xs - xs_ref| / (1 + |xs_ref|): the define phase's
                rollout and the state the plan was linearized at;
  unsafe_share  share of the instance's samples whose largest obstacle
                constraint, on this module's rollout, exceeds the
                configuration's osqp_tol (the upstream's safety test,
                drone_risk.py:660); the SAA guarantee is that at most a
                share alpha does;
  goal_gap      the sample-mean final state's largest distance from
                x_final: the final (equality) rows that every QP carries;
  cvar_gap      |AVaR_alpha| of the samples' largest obstacle constraint
                on this module's rollout: the plan keeps the CVaR row
                feasible and, since the obstacles block the unconstrained
                optimum, active (a plan that leaves it slack pays for
                distance it did not need);
  qp_residual   the primal residual of every QP of the SCP at the iterate
                the QP solver returned (the plan of that SCP iteration, and
                for the last QP its CVaR epigraph t), on this module's own
                float64 linearization at the plan before it: the mean final
                state's rows, the CVaR row with each sample's epigraph
                variable at its least feasible value, the control bounds.
                QP 0 is linearized at the upstream's initial guess, which
                this module makes itself.
"""

from __future__ import annotations

import math

import torch


def tf32(x):
    """x (float32) rounded to TF32's 10 explicit mantissa bits (round to
    nearest, ties away), as a tensor-core product reads its operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def feedback_gain(cfg, dtype, device):
    """The drone's state feedback (n_u, n_x): -k_p I on the position and
    -k_v I on the velocity (drone_params.py)."""
    n_u, n_x = cfg["n_u"], cfg["n_x"]
    K = torch.zeros(n_u, n_x, dtype=dtype, device=device)
    K[:, :3] = -cfg["feedback_gain_pos"] * torch.eye(n_u, dtype=dtype, device=device)
    K[:, 3:] = -cfg["feedback_gain_vel"] * torch.eye(n_u, dtype=dtype, device=device)
    return K


def rollout(cfg, us, mass, dWs, dtype=torch.float64, product=None):
    """Euler-Maruyama rollout of the plan `us` (S, n_u) under every sample:
    x+ = x + dt b(x, u) + sqrt(dt) sigma dW, with b the velocity and the
    feedback-corrected thrust less |v| v drag over the mass, sigma =
    (beta / mass) I on the velocity, and dW already scaled by sqrt(dt) at
    sampling (the upstream applies sqrt(dt) twice, drone_risk.py:151).
    `product(x, K)` forms x @ K^T (the control puts a lower precision
    there). Returns (M, S+1, n_x)."""
    product = product or (lambda x, K: x @ K.T)
    dev = mass.device
    dt = cfg["T"] / cfg["S"]
    us, mass, dWs = us.to(dtype), mass.to(dtype), dWs.to(dtype)
    K = feedback_gain(cfg, dtype, dev)
    x = torch.tensor(cfg["x_init"], dtype=dtype, device=dev).expand(
        mass.shape[0], cfg["n_x"])
    xs = [x]
    for t in range(cfg["S"]):
        v = x[:, 3:6]
        thrust = us[t] + product(x, K)
        acc = (thrust - cfg["drag_coefficient"] * torch.abs(v) * v) / mass[:, None]
        noise = (cfg["beta"] / mass)[:, None] * dWs[:, t, 3:6]
        x = x + dt * torch.cat([v, acc], dim=1) + math.sqrt(dt) * torch.cat(
            [torch.zeros_like(noise), noise], dim=1)
        xs.append(x)
    return torch.stack(xs, dim=1)


def tf32_product(x, K):
    """x @ K^T with both operands rounded to TF32 and float32 sums."""
    return tf32(x.float()) @ tf32(K.float()).T


def obstacle_constraints(cfg, xs, obs_Q):
    """1 - (p - o_j)^T Q_j (p - o_j) on the planar position p of steps
    1..S, obstacle-major: column j * S + t is obstacle j at step t + 1
    (drone_risk.py:169-213). Returns (M, n_obs * S)."""
    p = xs[:, 1:, :2]
    o = torch.tensor(cfg["obs_positions"], dtype=xs.dtype, device=xs.device)[:, :2]
    d = p[:, None, :, :] - o[None, :, None, :]  # (M, n_obs, S, 2)
    Q2 = obs_Q.to(xs.dtype)[:, :, :2, :2]
    quad = torch.einsum("mjti,mjik,mjtk->mjt", d, Q2, d)
    return (1.0 - quad).reshape(xs.shape[0], -1)


def avar(Z, alpha):
    """Empirical AVaR_alpha: t + mean(max(Z - t, 0)) / alpha, t the
    (floor(alpha M) + 1)-th largest value (drone_main_plot.py:640-652)."""
    M = Z.shape[0]
    t = torch.sort(Z).values[M - int(math.floor(alpha * M)) - 1]
    return t + torch.mean(torch.clamp(Z - t, min=0.0)) / alpha


def initial_guess(cfg, device):
    """The plan QP 0 is linearized at: zeros, with 1e-2 on the first
    n_u - 1 controls (drone_risk.py:108-120)."""
    us = torch.zeros(cfg["S"], cfg["n_u"], dtype=torch.float64, device=device)
    us[:, :cfg["n_u"] - 1] = 1e-2
    return us


def linearize(cfg, inst, us):
    """Values and Jacobians, with respect to the plan `us` (S, n_u)
    flattened, of each sample's final-state gap x_S - x_final and obstacle
    constraints, in float64: (M, n_x + K) and (M, n_x + K, S * n_u)."""
    mass, obs_Q, dWs = (x.double() for x in inst)
    x_final = torch.tensor(cfg["x_final"], dtype=torch.float64, device=mass.device)
    shape = (cfg["S"], cfg["n_u"])

    def rows(u):
        xs = rollout(cfg, u.reshape(shape), mass, dWs)
        return torch.cat([xs[:, -1, :] - x_final,
                          obstacle_constraints(cfg, xs, obs_Q)], dim=1)

    u = us.double().reshape(-1)
    return rows(u), torch.func.jacfwd(rows)(u)


def qp_residuals(cfg, inst, us_history, t_last):
    """The primal residual of each QP of the SCP (see the module
    docstring): QP i linearized at the plan before it, evaluated at the
    plan it returned, us_history[i]. Returns a list, one per QP. The CVaR
    row counts from the first ungated QP on (the gated ones bound it by
    +-0.1 at row scale 1e-7, which no plan can violate); the last QP's uses
    its returned t, the others the best t."""
    n_x, alpha = cfg["n_x"], cfg["alpha"]
    gate = cfg["scp"]["gate_iters"]
    u0 = initial_guess(cfg, inst[0].device)
    out = []
    for i, u1 in enumerate(us_history):
        u1 = u1.double()
        val, jac = linearize(cfg, inst, u0)
        lin = val + jac @ (u1 - u0).reshape(-1)
        res = float(torch.amax(torch.abs(torch.mean(lin[:, :n_x], dim=0))))
        res = max(res, float(torch.amax(torch.abs(u1))) - cfg["u_max"])
        if i >= gate:
            worst = torch.amax(lin[:, n_x:], dim=1)
            if i == len(us_history) - 1:
                risk = t_last + torch.mean(torch.clamp(worst - t_last, min=0.0)) / alpha
            else:
                risk = avar(worst, alpha)
            res = max(res, float(risk))
        out.append(res)
        u0 = u1
    return out


def judge(cfg, inst, us, xs, us_history, t_last):
    """The numbers of one solve: the plan `us` (S, n_u), trajectories
    `xs` (M, S+1, n_x), the plan of every SCP iteration `us_history`
    (num_iters, S, n_u) and the last QP's CVaR epigraph `t_last`, on
    instance `inst` = (mass, obs_Q, dWs), the values the program was
    given."""
    xs_ref = rollout(cfg, us, inst[0], inst[2])
    gap = torch.abs(xs.double() - xs_ref) / (1.0 + torch.abs(xs_ref))
    worst = torch.amax(obstacle_constraints(cfg, xs_ref, inst[1]), dim=1)
    unsafe = torch.mean(((worst - cfg["osqp_tol"]) > 1e-6).double())
    x_final = torch.tensor(cfg["x_final"], dtype=torch.float64, device=xs_ref.device)
    goal = torch.amax(torch.abs(torch.mean(xs_ref[:, -1, :], dim=0) - x_final))
    risk = float(avar(worst, cfg["alpha"]))
    qp = qp_residuals(cfg, inst, us_history, float(t_last))
    return {
        "rollout_gap": float(torch.amax(gap)),
        "unsafe_share": float(unsafe),
        "goal_gap": float(goal),
        "cvar_gap": abs(risk),
        "qp_residual": max(qp),
        # reported beside the numbers, not compared
        "avar": risk,
        "qp_residuals": qp,
        "cost": float(cfg["T"] / cfg["S"] * torch.sum(us.double() ** 2)),
        "finite": bool(torch.isfinite(xs).all() and torch.isfinite(us).all()),
    }


def control_xs(cfg, inst, us):
    """The control put in the program's place: this module's rollout of the
    program's plan in the nearest precision below float32 with TF32 off,
    float32 with TF32 products."""
    return rollout(cfg, us.float(), inst[0], inst[2], torch.float32, tf32_product)
