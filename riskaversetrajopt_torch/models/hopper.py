"""2-D single-leg hopper: contact-implicit direct transcription with a
random-Fourier-feature friction field and no-slip CVaR constraints.

The counterpart of ``riskaversetrajopt_tpu/models/hopper.py`` (reference
hopper/hopper.py:43-453, dynamics credited there to
dojo-sim/ContactImplicitMPC.jl). The decision vector and the constraint
stack are the reference's:

  Z = [xs ((S+1)*n_x, time-major) | us (S*n_u) | ys (M) | slack | t_risk]

  g(Z) = [dyn RK4 defects | x0 | xf | no-slip eq | contact eq      <- equalities
          | flight clearance | slip-CVaR rows | control rows
          | slack row | length/speed/omega rows]

Every function broadcasts over leading dimensions where the JAX package
vmaps, and is functional (``torch.func`` differentiates the stack in
``ops/nlp_ipm.py``). Array constants are cast to Z's dtype. The JAX
package's `ConstBind` (problem arrays passed as jit arguments for the TPU
runtime) has no counterpart: `make_nlp_params` only moves the friction
field into `params`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from riskaversetrajopt_torch.core.config import HopperScenario
from riskaversetrajopt_torch.models.base import resolve_device


class FrictionField(NamedTuple):
    """Random-Fourier-feature friction field samples (leading axis M):
    mu(px) = mu_nom + sum_j intensity_j * cos(theta_j * px + tau_j)
    (hopper/hopper.py:69-81)."""

    intensities: torch.Tensor  # (M, F)
    thetas: torch.Tensor  # (M, F)
    taus: torch.Tensor  # (M, F)


class HopperModel:
    """The hopper transcription on `device` (the card unless the caller
    passes another, e.g. ``device="cpu"``)."""

    def __init__(self, scn: HopperScenario = HopperScenario(), device=None):
        self.scn = scn
        s = scn
        self.n_x, self.n_u, self.S, self.M = s.n_x, s.n_u, s.S, s.M
        self.dt = s.dt
        self.num_vars = s.num_vars
        self.device = resolve_device(device)
        # contact schedule: stance [0, time_jump), flight [time_jump,
        # time_land), stance [time_land, S] (hopper.py:48-49); the slip rows
        # use xs[0..S-1] (hopper.py:305-308)
        self.contact_x_idx = np.concatenate(
            [np.arange(0, s.time_jump), np.arange(s.time_land, s.S)])
        self.contact_u_idx = self.contact_x_idx.copy()
        self.num_contacts = len(self.contact_u_idx)
        # the equality-row schedule of contact/no-slip over xs[0..S]
        # (hopper.py:266-298)
        self.eq_phase_idx = np.concatenate(
            [np.arange(0, s.time_jump), np.arange(s.time_land, s.S + 1)])
        self.flight_idx = np.arange(s.time_jump, s.time_land)
        self._state_initial = s.state_initial.to(self.device)
        self._state_final = s.state_final.to(self.device)
        self._M_inv = torch.tensor(
            [1.0 / (s.mass_body + s.mass_leg), 1.0 / (s.mass_body + s.mass_leg),
             1.0 / (s.inertia_body + s.inertia_leg), 1.0 / s.mass_leg],
            dtype=torch.float64, device=self.device)
        self._minus_C = torch.tensor(
            [0.0, -(s.mass_body + s.mass_leg) * s.gravity, 0.0, 0.0],
            dtype=torch.float64, device=self.device)

    # -- Z layout ----------------------------------------------------------
    def split_z(self, Z):
        s = self.scn
        nxs = (s.S + 1) * s.n_x
        nus = s.S * s.n_u
        xs = Z[:nxs].reshape(s.S + 1, s.n_x)
        us = Z[nxs : nxs + nus].reshape(s.S, s.n_u)
        ys = Z[nxs + nus : -2]
        return xs, us, ys, Z[-2], Z[-1]

    # -- kinematics and manipulator terms (hopper.py:166-231) ---------------
    def end_effector_position(self, x):
        """(..., n_x) -> (..., 2)."""
        return torch.stack([x[..., 0] + x[..., 3] * torch.sin(x[..., 2]),
                            x[..., 1] - x[..., 3] * torch.cos(x[..., 2])], -1)

    def jacobian_end_effector_position(self, x):
        """(..., n_x) -> (..., 2, 4)."""
        one, zero = torch.ones_like(x[..., 0]), torch.zeros_like(x[..., 0])
        s, c = torch.sin(x[..., 2]), torch.cos(x[..., 2])
        return torch.stack([
            torch.stack([one, zero, x[..., 3] * c, s], -1),
            torch.stack([zero, one, x[..., 3] * s, -c], -1),
        ], -2)

    def b(self, x, u):
        """Manipulator-equation drift (hopper.py:217-231): (..., n_x),
        (..., n_u) -> (..., n_x)."""
        s = self.scn
        u_robot, f = u[..., :2], u[..., 2:]
        sin, cos = torch.sin(x[..., 2]), torch.cos(x[..., 2])
        # -C + B u_robot + J^T f, with C = [0, (m_b + m_l) g, 0, 0] and
        # B = [[0, 0, 1, 0], [-sin, cos, 0, 1]]^T
        Bu = torch.stack([-sin * u_robot[..., 1], cos * u_robot[..., 1],
                          u_robot[..., 0], u_robot[..., 1]], -1)
        JTf = torch.einsum("...ij,...i->...j",
                           self.jacobian_end_effector_position(x), f)
        q_ddot = self._M_inv.to(x.dtype) * (
            (self._minus_C.to(x.dtype) + Bu) + JTf)
        return torch.cat([x[..., 4:], q_ddot], -1)

    def friction_at_px(self, px, field_row):
        """mu(px) for one friction-field sample (hopper.py:75-81)."""
        i, th, ta = field_row
        return self.scn.mu_nom + torch.sum(i * torch.cos(th * px + ta), -1)

    # -- constraint families (reference order) -----------------------------
    def dynamics_defects(self, xs, us):
        """RK4 defects x_{t+1} - RK4(x_t, u_t) (hopper.py:239-254),
        flattened time-major."""
        dt = self.dt
        x, xn = xs[:-1], xs[1:]
        k1 = self.b(x, us)
        k2 = self.b(x + 0.5 * dt * k1, us)
        k3 = self.b(x + 0.5 * dt * k2, us)
        k4 = self.b(x + dt * k3, us)
        return (xn - (x + (k1 + 2 * k2 + 2 * k3 + k4) * dt / 6.0)).reshape(-1)

    def slip(self, px, forces, field: FrictionField):
        """The no-slip constraint values f_t - mu(px_t) f_n at the contact
        steps for each sample: px (C,), forces (C, 2) -> (M, C)."""
        i, th, ta = (v.to(px.dtype)[:, None, :] for v in field)
        mu = self.scn.mu_nom + torch.sum(
            i * torch.cos(th * px[None, :, None] + ta), -1)
        return forces[:, 0] - mu * forces[:, 1]

    def g_all(self, Z, field: FrictionField, method: str, alpha: float = 0.1):
        """The full constraint stack in the reference's order
        (hopper.py:486-514)."""
        s = self.scn
        tj, tl = s.time_jump, s.time_land
        xs, us, ys = self.split_z(Z)[:3]
        # slack and t_risk as (1,) slices: forward-mode AD of a 0-dim
        # tensor times a Python float yields a float64 tangent in torch,
        # which would promote a float32 stack
        slack, t_risk = Z[-2:-1], Z[-1:]
        ee = self.end_effector_position(xs)  # (S+1, 2)

        gs_dyn = self.dynamics_defects(xs, us)
        gs_x0 = xs[0] - self._state_initial.to(Z.dtype)
        gs_xf = (xs[-1] - self._state_final.to(Z.dtype))[4:6]
        # no-slip equality: J_row0 . q_dot = 0 on the contact phases
        J_rows = self.jacobian_end_effector_position(xs)[:, 0, :]
        no_slip = torch.sum(J_rows * xs[:, 4:], dim=1)  # (S+1,)
        gs_slip = torch.cat([no_slip[:tj], no_slip[tl:]])
        gs_contact = torch.cat([ee[:tj, 1], ee[tl:, 1]])
        gs_over = -ee[tj:tl, 1]

        # slip-risk family (hopper.py:300-367)
        px_c = torch.cat([ee[:tj, 0], ee[tl:-1, 0]])  # (C,)
        forces = torch.cat([us[:tj, 2:], us[tl:, 2:]])  # (C, 2)
        cons = self.slip(px_c, forces, field)  # (M, C)
        M = field.intensities.shape[0]
        if method == "baseline":
            gs_risk = (cons - slack).reshape(-1)
        else:
            head = (M * alpha) * t_risk + torch.sum(ys)
            gs_risk = torch.cat([
                head, -ys, (cons - t_risk - ys[:, None] - slack).reshape(-1),
                torch.zeros(1, dtype=Z.dtype, device=Z.device),  # the
                # reference's trailing zero row
            ])

        gs_len = torch.cat([xs[1:, 3], xs[1:, 7], xs[1:, 6]])
        return torch.cat([gs_dyn, gs_x0, gs_xf, gs_slip, gs_contact, gs_over,
                          gs_risk, us.reshape(-1), slack, gs_len])

    def bounds(self, method: str, M: int, dtype=torch.float64):
        """(g_L, g_U, n_eq, x_L, x_U): gL_gU (hopper.py:515-562) and the
        variable box (hopper.py:599-620), on the model's device."""
        s = self.scn
        n_eqp = len(self.eq_phase_idx)
        n_eq = s.S * s.n_x + s.n_x + 2 + n_eqp + n_eqp
        n_over = len(self.flight_idx)
        n_risk = (M * self.num_contacts if method == "baseline"
                  else 1 + M + M * self.num_contacts + 1)
        big = 1e15

        gL = [np.zeros(n_eq), np.full(n_over + n_risk, -big)]
        gU = [np.zeros(n_eq), np.zeros(n_over + n_risk)]
        # control rows (hopper.py:393-428): motors +/-u_max; contact forces
        # in [0, max_contact_force] in stance, pinned to 0 in flight
        cl = np.zeros((s.S, s.n_u))
        cu = np.zeros((s.S, s.n_u))
        cl[:, :2], cu[:, :2] = -s.u_max, s.u_max
        for t in range(s.S):
            if not s.time_jump <= t < s.time_land:
                cu[t, 2:] = s.max_contact_force
        gL.append(cl.reshape(-1))
        gU.append(cu.reshape(-1))
        # slack in [0, 1e6]
        gL.append(np.zeros(1))
        gU.append(np.full(1, 1e6))
        # length / leg speed / omega (hopper.py:369-390)
        gL.append(np.concatenate([np.full(s.S, 0.25), np.full(s.S, -4.0),
                                  np.full(s.S, -2.5)]))
        gU.append(np.concatenate([np.full(s.S, 1.0), np.full(s.S, 4.0),
                                  np.full(s.S, 2.5)]))

        nv = (s.S + 1) * s.n_x + s.S * s.n_u + M + 2
        xL = np.full(nv, -1000.0)
        xU = np.full(nv, 1000.0)
        for t in range(s.S + 1):
            i = t * s.n_x
            xL[i], xU[i] = -3.0, 3.0  # px
            xL[i + 1], xU[i + 1] = 0.5, 10.0  # pz
            xL[i + 2], xU[i + 2] = -np.pi / 2, np.pi / 2  # phi
            xL[i + 3], xU[i + 3] = 0.1, 3.0  # r
            xL[i + 4 : i + 8] = -500.0
            xU[i + 4 : i + 8] = 500.0
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        return (t(np.concatenate(gL)), t(np.concatenate(gU)), n_eq, t(xL),
                t(xU))

    # -- objective (hopper.py:441-453) -------------------------------------
    def f(self, Z):
        xs, us = self.split_z(Z)[:2]
        # (1,) slices, as in g_all, then the 0-dim value
        obj = torch.sum(us[:, 0] ** 2) + torch.sum(us[:, 1] ** 2)
        obj = obj - 10000.0 * xs[-1, :1]
        return (obj + 1e7 * Z[-2:-1])[0]

    # -- sampling (hopper.py:69-74, the MC draw at 974-979) ----------------
    def sample_friction(self, generator: torch.Generator, M: int,
                        method: str = "saa") -> FrictionField:
        """intensities ~ scale sqrt(2/F) U(0, 1), thetas ~ U(0, pi),
        taus ~ U(0, 2 pi); 'baseline' zeroes all three (mu = mu_nom).
        Drawn in float64 on the generator's device, then moved to the
        model's."""
        s = self.scn
        F = s.num_mu_features
        kw = dict(generator=generator, device=generator.device,
                  dtype=torch.float64)
        intensities = (s.mu_intensity_scale * math.sqrt(2.0 / F)
                       * torch.rand(M, F, **kw))
        thetas = math.pi * torch.rand(M, F, **kw)
        taus = 2 * math.pi * torch.rand(M, F, **kw)
        if method == "baseline":
            intensities, thetas, taus = (torch.zeros_like(v) for v in
                                         (intensities, thetas, taus))
        elif method != "saa":
            raise ValueError(f"unknown sampling method: {method}")
        return FrictionField(*(v.to(self.device)
                               for v in (intensities, thetas, taus)))

    # -- initial guess (hopper.py:136-164) ---------------------------------
    def initial_guess(self, M: int, dtype=torch.float64):
        s = self.scn
        Zp = np.zeros((s.S + 1) * s.n_x + s.S * s.n_u + M + 2)
        x0 = s.state_initial.numpy()
        xf = s.state_final.numpy()
        for t in range(s.time_land):
            Zp[t * s.n_x : (t + 1) * s.n_x] = x0
        for t in range(s.time_land, s.S + 1):
            Zp[t * s.n_x : (t + 1) * s.n_x] = xf
        nominal_force = (s.mass_body + s.mass_leg) * s.gravity
        off = (s.S + 1) * s.n_x
        for t in list(range(0, s.time_jump)) + list(range(s.time_land, s.S)):
            Zp[off + t * s.n_u + 1] = nominal_force
            Zp[off + t * s.n_u + 3] = nominal_force
        return torch.as_tensor(Zp, dtype=dtype, device=self.device)

    # -- solver plumbing ---------------------------------------------------
    def make_nlp(self, field: FrictionField, method: str, alpha: float):
        """(f, g, g_L, g_U, n_eq, x_L, x_U) for ops/nlp_ipm.solve_nlp."""
        M = field.intensities.shape[0]

        def g_fn(Z):
            return self.g_all(Z, field, method, alpha)

        return (self.f, g_fn) + self.bounds(method, M)

    def make_nlp_params(self, field: FrictionField, method: str, alpha: float):
        """(f(Z, p), g(Z, p), params, g_L, g_U, n_eq, x_L, x_U) with
        params = {"field": field}: the field travels as the callbacks'
        argument rather than in their closure."""
        M = field.intensities.shape[0]

        def f_fn(Z, p):
            return self.f(Z)

        def g_fn(Z, p):
            return self.g_all(Z, p["field"], method, alpha)

        return (f_fn, g_fn, {"field": field}) + self.bounds(method, M)
