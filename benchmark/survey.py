#!/usr/bin/env python3
"""How long the card waits on paths that have no cell yet.

    python3 benchmark/survey.py [candidate ...]

For each candidate: one untraced solve timed on the host's clock
(synchronized), then one traced run under the profiler (timeline.py): the
device's idle share of the traced window, its busy seconds, its device
operations and the top five by time. Where a full solve would put millions
of launches on the timeline, the traced run is cut and says how. One JSON
line per candidate. A measuring tool for choosing the next cells; the
benchmark's runs never run it.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import run  # noqa: E402
import timeline  # noqa: E402

DEV = "cuda:0"


def config_file(name):
    return json.loads((run.HERE / "configs" / f"{name}.json").read_text())


def drone(config, seed=0, **changes):
    """The drone of benchmark/configs/<config>.json through the benchmark's
    own driver (models/drone.py), with `changes` merged in (run.merged);
    instance 0 of `seed` from the benchmark's sampler."""
    cfg = run.merged(config_file(config), changes)
    model = run.load_module(run.HERE / "models" / f"{cfg['model']}.py",
                            f"bench_model_{cfg['model']}")
    prog = model.Program(cfg, DEV)
    inst = model.instance(cfg, seed, 0, DEV)
    return lambda: prog.solve(inst)


def car(backend, dtype, solver, scp_iters=15):
    from riskaversetrajopt_torch.core.config import CarScenario, SolverConfig
    from riskaversetrajopt_torch.models.car import CarModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    model = CarModel(CarScenario(), device=DEV)
    scp = dataclasses.replace(model.default_scp_config(), num_iters=scp_iters)
    kw = {} if solver is None else {"admm_cfg": SolverConfig(**solver)}
    opt = SAATrajOpt(model, scp_cfg=scp, qp_backend=backend, dtype=dtype,
                     device=DEV, **kw)
    om = opt.sample(torch.Generator().manual_seed(0), CarScenario().M)
    return lambda: opt.solve(om, alpha=0.1)


def hopper_saa():
    """The hopper CLI's SAA phase at alpha 0.3, warm from its damped cold
    baseline (experiments/hopper.py, float64, tol 1e-3)."""
    from riskaversetrajopt_torch.core.config import HopperScenario
    from riskaversetrajopt_torch.experiments import common, hopper
    from riskaversetrajopt_torch.models.hopper import HopperModel

    model = HopperModel(HopperScenario(), device=DEV)
    M, s = model.M, model.scn
    field = model.sample_friction(common.generator(1), M, "saa")
    base = model.sample_friction(common.generator(1), M, "baseline")
    _, xs, us = hopper.solve_phase(model, base, "baseline", 0.1,
                                   model.initial_guess(M, torch.float64),
                                   1e-4, 3000, damp_iters=50, damp_max=0.1)
    Z0 = torch.zeros(model.num_vars, dtype=torch.float64, device=xs.device)
    nx = (s.S + 1) * s.n_x
    Z0[:nx] = xs.reshape(-1)
    Z0[nx:nx + s.S * s.n_u] = us.reshape(-1)
    return lambda: hopper.solve_phase(model, field, "saa", 0.3, Z0, 1e-3, 3000)


# bench.py's headline solver (bench.py:57-141), through the plain 'admm'
BENCH_ADMM = dict(qp_backend="admm", solver=dict(
    polish=True, kkt_refine_iters=1, kkt_refine_mode="factored",
    rho_update_factor=1.5, kkt_chol_inverse=True))
# the fused cell's solver block, for the car
FUSED = config_file("drone_m1000")["solver"]

# name: (full solve, traced solve, how the traced one is cut)
CANDIDATES = {
    "drone_m1000.admm32": (
        lambda: drone("drone_m1000", **BENCH_ADMM),
        lambda: drone("drone_m1000", qp_backend="admm", scp={"num_iters": 3},
                      solver=dict(BENCH_ADMM["solver"], max_iter=1000)),
        "3 SCP iterations, ADMM cap 1000"),
    "drone_m1000.ipm64": (
        lambda: drone("drone_m1000", qp_backend="ipm", dtype="float64"),
        None, ""),
    "car_m50.fused": (
        lambda: car("_admm-pallas", torch.float32, FUSED), None, ""),
    "car_m50.admm64": (
        lambda: car("admm", torch.float64, None),
        lambda: car("admm", torch.float64, None, scp_iters=3),
        "3 SCP iterations"),
    "hopper_m30.saa": (hopper_saa, None, ""),
}


def measure(name):
    full, cut, how = CANDIDATES[name]
    solve = full()
    solve()  # warm: kernel builds, library handles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traced = cut() if cut else solve
    if cut:
        traced()
    torch.cuda.synchronize()
    with timeline.Capture(True) as cap:
        t0 = time.perf_counter()
        traced()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    s = timeline.summarize(cap.events, window)
    return {"candidate": name, "solve_s": wall, "traced_window_s": window,
            "traced_cut": how or "none", "busy_s": s["busy_s"],
            "idle_pct": 100.0 * (1 - s["busy_s"] / window),
            "device_ops": s["device_ops"],
            "top_ops": s["breakdown"]["device_ops"][:5],
            "idle_gaps": s["breakdown"]["idle_gaps"][:3]}


def main(argv):
    if not torch.cuda.is_available():
        print("survey.py reads the card; no CUDA device here", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in argv or list(CANDIDATES):
        print(json.dumps(measure(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
