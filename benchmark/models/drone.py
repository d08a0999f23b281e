"""The drone SAA SCP solve as the benchmark drives it: the program under
test (`riskaversetrajopt_torch`, imported only here and only when a run
builds it), the instances it is given and the judge of what it returns."""

from __future__ import annotations

import dataclasses

import torch

import reference
import sampler

SCENARIO_KEYS = ("n_x", "n_u", "S", "M", "T", "u_max", "mass_nom",
                 "mass_delta", "beta", "drag_coefficient", "n_obs",
                 "obs_radii_deltas", "osqp_tol")


def dims(cfg):
    n = cfg["S"] * cfg["n_u"]
    return {"M": cfg["M"], "K": cfg["n_obs"] * cfg["S"], "n": n,
            "n_fc": cfg["n_x"]}


def instance(cfg, seed, k, device):
    """Instance k of the run seeded `seed`, in the program's dtype: the
    values both the program and the reference are given."""
    dtype = getattr(torch, cfg["dtype"])
    return tuple(x.to(dtype) for x in
                 sampler.drone_instance(cfg, seed, k, cfg["M"], device))


class Program:
    """SAATrajOpt on the configuration's drone, solver and backend."""

    def __init__(self, cfg, device):
        from riskaversetrajopt_torch.core.config import (
            DroneScenario, SCPConfig, SolverConfig)
        from riskaversetrajopt_torch.models.drone import DroneModel, DroneOmega
        from riskaversetrajopt_torch.scp.driver import SAATrajOpt

        self.cfg, self.omega = cfg, DroneOmega
        scn = DroneScenario(**{k: cfg[k] for k in SCENARIO_KEYS})
        _same_problem(cfg, scn)
        dtype = getattr(torch, cfg["dtype"])
        scp, solver = SCPConfig(**cfg["scp"]), SolverConfig(**cfg["solver"])

        def make(scp, solver):
            return SAATrajOpt(DroneModel(scn, device=device), scp_cfg=scp,
                              qp_backend=cfg["qp_backend"], admm_cfg=solver,
                              dtype=dtype, device=device)

        self.opt = make(scp, solver)
        # set-up: the gated SCP iterations and one ungated one, each QP cut
        # to one kernel call, so every operation of the solve has run once
        self._warm = make(dataclasses.replace(scp, num_iters=scp.gate_iters + 1),
                          dataclasses.replace(solver, max_iter=1))

    def _om(self, inst):
        return self.omega(*inst)

    def warm_up(self, inst):
        self._warm.solve(self._om(inst), self.cfg["alpha"])

    def solve(self, inst):
        res = self.opt.solve(self._om(inst), self.cfg["alpha"])
        return {"us": res.us, "xs": res.xs, "us_history": res.us_history,
                "t_risk": float(res.t_risk),
                "qp_iters": [int(i) for i in res.qp_iters],
                "qp_solved": [bool(s) for s in res.qp_solved]}

    def instrumented(self, inst):
        r = self.opt.solve_instrumented(self._om(inst), self.cfg["alpha"])
        return {"us": r["us"], "define_s": [float(t) for t in r["define_times"]],
                "solve_s": [float(t) for t in r["solve_times"]]}


def _same_problem(cfg, scn):
    """Refuse a program whose drone differs from the configuration's in a
    constant the scenario does not take as an argument."""
    f64 = dict(dtype=torch.float64)
    want = {
        "feedback_gain": reference.feedback_gain(cfg, torch.float64, "cpu"),
        "obs_positions": torch.tensor(cfg["obs_positions"], **f64),
        "obs_radii": torch.tensor(cfg["obs_radii"], **f64),
        "x_init": torch.tensor(cfg["x_init"], **f64),
        "x_final": torch.tensor(cfg["x_final"], **f64),
        "R": torch.eye(cfg["n_u"], **f64),
    }
    for name, value in want.items():
        if not torch.equal(getattr(scn, name).to(**f64), value):
            raise RuntimeError(f"the program's drone {name} is not the "
                               f"configuration's")


def judge(cfg, inst, out):
    return reference.judge(cfg, inst, out["us"], out["xs"], out["us_history"],
                           out["t_risk"])


def rollout_control(cfg, inst, out):
    """The numbers the define phase's control gives: the reference's own
    rollout of the program's plan in the precision below the
    configuration's, put where the program's trajectories go."""
    xs = reference.control_xs(cfg, inst, out["us"])
    return reference.judge(cfg, inst, out["us"], xs, out["us_history"],
                           out["t_risk"])
