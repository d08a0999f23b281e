"""Entry points of the PyTorch/CUDA port (riskaversetrajopt_torch): a
one-step run and a multi-process dry run, the counterparts of
__graft_entry__.py.

entry() returns one full SCP step (define + structured QP solve) of the
drone SAA workload at M=64. dryrun_multichip(n) runs that step on an n-rank
(batch x samples) grid: a batch of independent problems, each with its
samples split over the ranks of its row (parallel/mesh.py), gloo processes
on the CPU and one NCCL rank per card on the GPU.

    python torch_entry.py              # on the card: entry, then the dry
                                       # run over every card of the host
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
DRYRUN_TIMEOUT = 600  # seconds per worker process


def _make_opt(num_iters=1, device=None, dtype=torch.float64, group=None):
    """__graft_entry__.py:_make_opt: the drone at DroneScenario(), the
    golden gating, IPMConfig(tol 1e-5 in float64, 1e-4 in float32,
    max_iter 30); the QP backend is the driver's default, 'admm', as there
    (JAX's _make_opt sets none, so its ipm_cfg goes unused)."""
    from riskaversetrajopt_torch.core.config import DroneScenario, SCPConfig
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.ops.ipm import IPMConfig
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    tol = 1e-4 if dtype == torch.float32 else 1e-5
    return SAATrajOpt(
        DroneModel(DroneScenario(), device=device),
        method="saa",
        scp_cfg=SCPConfig(num_iters=num_iters, gate_iters=2,
                          gate_row_scale=1e-7, gate_bound_l=-0.1,
                          gate_bound_u=0.1),
        ipm_cfg=IPMConfig(tol=tol, max_iter=30),
        dtype=dtype, device=device, group=group,
    )


def entry(device=None, dtype=torch.float64):
    """(fn, example_args): fn(omegas, alpha) runs one SCP step on the
    drone at M=64 and returns the controls (S, n_u). Runs on the card
    unless `device` names another; the omegas come from a CPU generator
    seeded 0."""
    opt = _make_opt(num_iters=1, device=device, dtype=dtype)
    omegas = opt.sample(torch.Generator().manual_seed(0), 64)
    alpha = torch.tensor(0.1, dtype=dtype, device=opt.device)

    def fn(omegas, alpha):
        return opt.solve(omegas, alpha).us

    return fn, (omegas, alpha)


def _dryrun_step(n_devices: int, device, dtype=torch.float64):
    """One SCP step of the batch on this rank's part of the grid; returns
    the (n_batch, S, n_u) controls of every problem, on every rank."""
    from riskaversetrajopt_torch.parallel.mesh import make_mesh, shard_samples

    # two independent problems when n is even
    n_batch = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_samp = n_devices // n_batch
    mesh = make_mesh(n_sample_devices=n_samp, n_batch_devices=n_batch,
                     device=device)
    opt = _make_opt(num_iters=1, device=mesh.device, dtype=dtype,
                    group=mesh.sample_group if n_samp > 1 else None)
    M = 2 * n_samp  # two samples per rank
    omegas = opt.sample(torch.Generator().manual_seed(mesh.batch_index), M)
    alphas = torch.linspace(0.1, 0.3, n_batch, dtype=dtype)
    us = opt.solve(shard_samples(omegas, mesh),
                   alphas[mesh.batch_index].item()).us
    us_all = mesh.gather_batch(us)
    if us_all.shape != (n_batch, opt.model.S, opt.model.n_u):
        raise AssertionError(f"dry run controls {tuple(us_all.shape)}")
    if not bool(torch.isfinite(us_all).all()):
        raise AssertionError("dry run controls are not finite")
    return us_all


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dryrun_multichip(n_devices: int, device=None):
    """Run one SCP step of a batch of problems on an n-rank (batch x
    samples) grid and return every problem's controls (n_batch, S, n_u) on
    the CPU. One rank runs in this process; more are worker processes of
    this file (gloo on the CPU, `device="cpu"`; NCCL on the card, one rank
    per card, so n may not exceed the cards), each killed if it outlives
    DRYRUN_TIMEOUT."""
    from riskaversetrajopt_torch.models.base import resolve_device

    dev = resolve_device(device)
    if n_devices == 1:
        return _dryrun_step(1, dev).cpu()
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} NCCL ranks need as many cards; this "
                         f"host has {torch.cuda.device_count()}")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    init = f"tcp://localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "torch_entry.py"), "--dryrun-worker",
         "--init-method", init, "--world-size", str(n_devices), "--rank",
         str(r), "--device", dev.type],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DRYRUN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dry-run rank {r} failed:\n{out[-3000:]}")
    line = [ln for ln in outs[0].splitlines() if ln.startswith("DRYRUN_OK ")]
    if not line:
        raise RuntimeError(f"dry-run rank 0 printed no result:\n{outs[0]}")
    return torch.tensor(json.loads(line[-1][len("DRYRUN_OK "):]),
                        dtype=torch.float64)


def _dryrun_worker(argv) -> int:
    import argparse

    from riskaversetrajopt_torch.parallel import distributed

    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-worker", action="store_true")
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = distributed.initialize(args.init_method, args.world_size, args.rank,
                                 device=args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    us_all = _dryrun_step(args.world_size, dev)
    if args.rank == 0:
        print("DRYRUN_OK " + json.dumps(us_all.cpu().tolist()), flush=True)
    distributed.shutdown()
    return 0


def main() -> int:
    """entry() on the card, then dryrun_multichip over every card, each of
    its problems held to the one-process step of the same problem."""
    import time

    torch.backends.cuda.matmul.allow_tf32 = False
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    us_all = dryrun_multichip(n)
    wall = time.perf_counter() - t0
    n_batch, n_samp = us_all.shape[0], n // us_all.shape[0]
    opt = _make_opt(num_iters=1)
    for b in range(n_batch):
        om = opt.sample(torch.Generator().manual_seed(b), 2 * n_samp)
        alpha = torch.linspace(0.1, 0.3, n_batch, dtype=torch.float64)[b]
        ref = opt.solve(om, alpha.item()).us.cpu()
        diff = float(torch.max(torch.abs(us_all[b] - ref)))
        print(f"dryrun_multichip({n}) problem {b} ({n_samp} sample ranks): "
              f"max |us - one-process us| {diff:.3e}")
        if diff > 1e-6:
            raise AssertionError(f"problem {b} {diff:.3e} from one process")
    print(f"dryrun_multichip({n}) ok in {wall:.2f} s")
    return 0


if __name__ == "__main__":
    if "--dryrun-worker" in sys.argv:
        sys.exit(_dryrun_worker(sys.argv[1:]))
    sys.exit(main())
