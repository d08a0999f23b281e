"""The port's hand-written CUDA kernels against their plain PyTorch versions on
the card. Every test here needs a CUDA device and skips without one.

This file imports neither jax nor the JAX package, so it also runs where JAX
is not installed; tests/conftest.py imports jax, so run it there as
    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py
"""

import pathlib

import numpy as np
import pytest
import torch

from riskaversetrajopt_torch.core.config import (
    DroneScenario,
    SCPConfig,
    SolverConfig,
)
from riskaversetrajopt_torch.models.drone import DroneModel, DroneOmega
from riskaversetrajopt_torch.ops import admm
from riskaversetrajopt_torch.ops.cuda import saa_admm as tk
from riskaversetrajopt_torch.ops.saa_qp import (
    SAAQPOps,
    build_bounds,
    build_objective,
)
from riskaversetrajopt_torch.scp.driver import SAATrajOpt

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "omegas_drone_m1000_seed0.npz")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scaled_problem(dev, M=50, scp_iter=3):
    """The float32 scaled structure of a real define phase (the first M
    fixture omegas at the initial guess), on `dev`."""
    opt = SAATrajOpt(DroneModel(DroneScenario(M=M)),
                     scp_cfg=SCPConfig(num_iters=1), device=dev)
    with np.load(FIXTURE) as f:
        om = DroneOmega(*(torch.from_numpy(f[k][:M]).to(dev)
                          for k in DroneOmega._fields))
    data = opt._define(opt.model.initial_guess(), om, 0.2)
    data = type(data)(*(x.float() for x in data))
    st = opt._static_for(M)
    ops = SAAQPOps(st, data, scp_iter)
    _, q = build_objective(st, data)
    l, u = build_bounds(st, data, scp_iter)
    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=5)
    cfg = SolverConfig()
    p, _ = tk.scaled_structure(st, data, scp_iter, scaling,
                               torch.tensor(cfg.rho, device=dev), cfg)
    return p, tk.kernel_dims(st)


@pytest.mark.gpu
def test_saa_admm_kernel_matches_plain():
    """csrc/saa_admm.cu against one_iter_ref on the card, 20 iterations at
    M=50, to chip_smoke.py's tolerance (float32 sums in another order,
    amplified by the 1e3 rho of the equality rows); two runs from one state
    agree bit for bit (no float atomics); each call counts one launch."""
    p, d = _scaled_problem(_cuda())
    s0 = tk.init_scaled_state(p)
    ref = s0
    for _ in range(20):
        ref = tk.one_iter_ref(p, ref, d)
    before = tk.admm_chunk.launches
    out = tk.admm_chunk(p, s0, d, 20)
    again = tk.admm_chunk(p, s0, d, 20)
    torch.cuda.synchronize()
    assert tk.admm_chunk.launches == before + 2
    for name, a, b, c in zip(ref._fields, out, ref, again):
        assert torch.equal(a, c), name
        err = float(torch.max(torch.abs(a - b) / (1 + torch.abs(b))))
        assert err <= 2e-2, (name, err)


@pytest.mark.gpu
def test_saa_admm_kernel_refuses_bad_inputs():
    """A CUDA tensor the kernel does not take raises; it never falls back to
    the plain version."""
    p, d = _scaled_problem(_cuda())
    s0 = tk.init_scaled_state(p)
    before = tk.admm_chunk.launches
    with pytest.raises(ValueError, match="float32"):
        tk.admm_chunk(p._replace(Gs=p.Gs.double()), s0, d, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tk.admm_chunk(p._replace(Sinv=p.Sinv.T), s0, d, 1)
    assert tk.admm_chunk.launches == before
