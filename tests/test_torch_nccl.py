"""The sample-sharded solve with one NCCL process per card (skips without
two cards; imports no jax, so it runs on the card with --noconftest): the
selftest worker of riskaversetrajopt_torch/parallel/distributed.py on
cuda:0, cuda:1, ... A sharded solve checkpointed one SCP iteration short
of its end and resumed is the uninterrupted run bit for bit, which needs
every process to wait on the host for process 0's file before it reads it
(SampleShard.barrier; with NCCL an all-reduce alone only queues on the
stream). The same solve resumed from an unsharded solve's file lands within
the sharded bound of the unsharded run.

    python -m pytest --noconftest -m gpu tests/test_torch_nccl.py -q
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from riskaversetrajopt_torch.parallel import distributed as tdist

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 600  # seconds per worker
ITERS = 3


def run_workers(n, tmp, device=None):
    """`n` selftest workers of the scp mode (one per card unless `device`
    names another), each solving CHECKPOINT_BACKEND and its checkpointed
    and resumed runs in `tmp`: their payloads, rank 0 first."""
    s = socket.socket()
    s.bind(("localhost", 0))
    init = f"tcp://localhost:{s.getsockname()[1]}"
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    dev = ("--device", device) if device else ()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "riskaversetrajopt_torch.parallel.distributed",
         "--selftest", "--init-method", init, "--world-size", str(n),
         "--rank", str(r), *dev, "--mode", "scp", "--scp-iters", str(ITERS),
         "--backends", tdist.CHECKPOINT_BACKEND, "--checkpoint", str(tmp)],
        env=env, stdout=open(Path(tmp) / f"rank{r}.log", "w"),
        stderr=subprocess.STDOUT) for r in range(n)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, p in enumerate(procs):
        log = (Path(tmp) / f"rank{r}.log").read_text()
        line = [ln for ln in log.splitlines() if ln.startswith("SELFTEST_OK ")]
        assert p.returncode == 0 and line, f"rank {r} failed:\n{log[-3000:]}"
        out.append(json.loads(line[-1][len("SELFTEST_OK "):]))
    return out


def check_resumes(payloads, ref):
    """Every process alike bit for bit; the resume from the sharded file is
    the uninterrupted run's last iteration bit for bit; the resume from
    the unsharded file (iterations 1-2 unsharded, 3 sharded) has the
    unsharded run `ref`'s QP iterations and flags, and its controls within
    rtol 1e-8 / atol 1e-10."""
    b = tdist.CHECKPOINT_BACKEND
    keys = (b, "checkpoint", "from_unsharded")
    for p in payloads[1:]:
        assert all(p[k] == payloads[0][k] for k in keys)
    full, ck, flat = (payloads[0][k] for k in keys)
    n = len(full["us_history"]) // ITERS
    assert ck["qp_iters"] == full["qp_iters"][-1:]
    assert ck["qp_solved"] == full["qp_solved"][-1:]
    assert ck["us_history"] == full["us_history"][-n:]
    assert flat["qp_iters"] == ref.qp_iters[-1:].tolist()
    assert flat["qp_solved"] == ref.qp_solved[-1:].tolist()
    np.testing.assert_allclose(flat["us_history"],
                               ref.us_history[-1].reshape(-1).cpu().numpy(),
                               rtol=1e-8, atol=1e-10)


def unsharded_run(device):
    """The workers' solve, unsharded, in this process."""
    return tdist.selftest_scp_opt(device, ITERS,
                                  backend=tdist.CHECKPOINT_BACKEND).solve(
        tdist.selftest_scp_omegas(), alpha=0.2)


@pytest.mark.gpu
@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two cards: one NCCL process on each")
def test_nccl_sharded_checkpoint_resumes(tmp_path):
    """Up to four cards, M=16 (the port's seed-0 omegas), 3 SCP
    iterations, float64."""
    n = min(torch.cuda.device_count(), 4)
    payloads = run_workers(n, tmp_path)
    assert [p["nproc"] for p in payloads] == [n] * n
    check_resumes(payloads, unsharded_run("cuda:0"))
