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
    CarScenario,
    DroneScenario,
    SCPConfig,
    SolverConfig,
)
from riskaversetrajopt_torch.models.car import CarModel
from riskaversetrajopt_torch.models.drone import DroneModel, DroneOmega
from riskaversetrajopt_torch.ops import admm
from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc
from riskaversetrajopt_torch.ops.cuda import saa_admm as tk
from riskaversetrajopt_torch.ops.cuda import saa_admm_f as tkf
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


def _scaled_problem(dev, M=50, scp_iter=3, sampled=False, car=False):
    """The float32 scaled structure of a real define phase at the initial
    guess, on `dev`: the first M fixture omegas, or (`sampled`) M omegas of
    the port's own DroneModel.sample from a seeded generator; with `car`,
    the car's (its own SCP config: scp_iter 0 gated) on M omegas of
    CarModel.sample, seed 0."""
    if car:
        model = CarModel(CarScenario(M=M), device=dev)
        opt = SAATrajOpt(model, device=dev)
    else:
        opt = SAATrajOpt(DroneModel(DroneScenario(M=M), device=dev),
                         scp_cfg=SCPConfig(num_iters=1), device=dev)
    if sampled or car:
        om = opt.sample(torch.Generator().manual_seed(0), M)
    else:
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


def _rel_err(a, b):
    return float(torch.max(torch.abs(a - b) / (1 + torch.abs(b))))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_saa_admm_f_kernel_matches_plain(precision):
    """csrc/saa_admm_f.cu against one_iter_ref_f on the card at each sweep
    precision, 20 iterations at M=50, to chip_smoke.py's tolerance; two runs
    from one state agree bit for bit; each call counts one launch.

    "highest" and "high" compare a 20-iteration chunk with 20 plain
    iterations. At "default" (bf16 operands) the iteration amplifies any
    change of summation order into O(1e-2..1) after tens of iterations, for
    two plain versions as much as for kernel and plain. So there each of
    the 20 kernel iterations is held to one plain iteration from the same
    state (kernel_checks.step_err_f)."""
    p, d = _scaled_problem(_cuda())
    pf = tkf.to_f(p, d)
    s0 = tkf.state_to_f(tk.init_scaled_state(p), d)
    before = tkf.admm_chunk_f.launches
    out = tkf.admm_chunk_f(pf, s0, d, 20, precision)
    again = tkf.admm_chunk_f(pf, s0, d, 20, precision)
    torch.cuda.synchronize()
    assert tkf.admm_chunk_f.launches == before + 2
    for name, a, c in zip(out._fields, out, again):
        assert torch.equal(a, c), name
    if precision != "default":
        ref = s0
        for _ in range(20):
            ref = tkf.one_iter_ref_f(pf, ref, d, precision)
        for name, a, b in zip(out._fields, out, ref):
            assert _rel_err(a, b) <= 2e-2, (name, _rel_err(a, b))
        return
    s = s0
    for it in range(20):
        step = tkf.admm_step_f(pf, s, d, precision)
        err, _ = kc.step_err_f(pf, s, step, d, precision)
        assert err <= 2e-2, (it, err)
        s = step.state


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_saa_admm_f_kernel_sweeps_hold_their_precision(precision):
    """From the states of a 20-iteration kernel run, each kernel iteration's
    two sweeps hold at their own precision's arithmetic and fail at each
    other precision's (kernel_checks.check_sweeps_f): a kernel that rounded
    where it should not, or did not where it should, fails here."""
    p, d = _scaled_problem(_cuda())
    pf = tkf.to_f(p, d)
    s = tkf.state_to_f(tk.init_scaled_state(p), d)
    for _ in range(20):
        step = tkf.admm_step_f(pf, s, d, precision)
        errs = kc.sweep_errs_f(pf, s, step, d)
        kc.check_sweeps_f(errs, precision)
        for other in errs:
            if other != precision:
                with pytest.raises(AssertionError, match="sweep"):
                    kc.check_sweeps_f(errs, other)
        s = step.state


@pytest.mark.gpu
def test_saa_admm_f_kernel_matches_b1():
    """Kernel B2 at "highest" and kernel B1 run the same iteration in two
    layouts: 20 iterations at M=50 agree through f_to_state to 2e-2."""
    p, d = _scaled_problem(_cuda())
    s0 = tk.init_scaled_state(p)
    b1 = tk.admm_chunk(p, s0, d, 20)
    b2 = tkf.f_to_state(
        tkf.admm_chunk_f(tkf.to_f(p, d), tkf.state_to_f(s0, d), d, 20), d)
    torch.cuda.synchronize()
    for name, a, b in zip(b1._fields, b2, b1):
        assert _rel_err(a, b) <= 2e-2, (name, _rel_err(a, b))


@pytest.mark.gpu
def test_saa_admm_f_kernel_refuses_bad_inputs():
    """A CUDA tensor kernel B2 does not take raises before any launch: a
    float64 field, a non-contiguous one, a wrong shape."""
    p, d = _scaled_problem(_cuda())
    pf = tkf.to_f(p, d)
    s0 = tkf.state_to_f(tk.init_scaled_state(p), d)
    before = tkf.admm_chunk_f.launches
    with pytest.raises(ValueError, match="float32"):
        tkf.admm_chunk_f(pf._replace(G2=pf.G2.double()), s0, d, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tkf.admm_chunk_f(pf._replace(Sinv=pf.Sinv.T), s0, d, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tkf.admm_chunk_f(pf, s0._replace(zG_f=s0.zG_f[:-1]), d, 1)
    assert tkf.admm_chunk_f.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("M", [263, 2000, 12000])
@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_kernel_matches_plain_beyond_one_block_per_sample(kernel, M):
    """Kernel B1, and B2 at "highest", against their plain versions over 20
    iterations at a ragged M (263 fixture omegas: 2 samples per block, the
    last block one), at an M beyond shared-memory residency of the G slab
    (2000 sampled omegas: each sweep reads it from global memory) and at an
    M where the sample rows no longer fit either (12000: they are updated
    in place in global memory), to chip_smoke.py's 2e-2; two runs from one
    state agree bit for bit; each call counts one launch."""
    dev = _cuda()
    p, d = _scaled_problem(dev, M=M, sampled=M != 263)
    s0 = tk.init_scaled_state(p)
    if kernel == "b1":
        shape = tk.launch_shape(d, dev)
        run, counter, plain = tk.admm_chunk, tk.admm_chunk, tk.one_iter_ref
    else:
        shape = tkf.launch_shape_f(d, dev)
        p, s0 = tkf.to_f(p, d), tkf.state_to_f(s0, d)
        run, counter, plain = tkf.admm_chunk_f, tkf.admm_chunk_f, tkf.one_iter_ref_f
    assert shape.samples_per_block * shape.grid_blocks >= M
    assert (shape.resident, shape.rows_resident) == (M == 263, M < 12000), shape
    ref = s0
    for _ in range(20):
        ref = plain(p, ref, d)
    before = counter.launches
    out = run(p, s0, d, 20)
    assert counter.launches == before + 1
    again = run(p, s0, d, 20)
    assert counter.launches == before + 2
    torch.cuda.synchronize()
    for name, a, b, c in zip(ref._fields, out, ref, again):
        assert torch.equal(a, c), name
        assert _rel_err(a, b) <= 2e-2, (name, _rel_err(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("scp_iter", [0, 3])
@pytest.mark.parametrize("kernel", ["b1", "highest", "high", "default"])
def test_kernel_matches_plain_on_the_car(kernel, scp_iter):
    """Kernel B1, and B2 at each sweep precision, against their plain
    versions on the car's scaled structure at M=50 (K=20, n=40, n_fc=4; one
    sample per block): at scp_iter 0, gated (zeroed sample rows bounded
    (-inf, 0), the CVaR row live with l = -inf, 3 y rows live), and at 3.
    20 iterations to chip_smoke.py's 2e-2 ("default" per iteration from the
    kernel's state, kernel_checks.step_err_f), and s, t and y each to
    kernel_checks.EPIGRAPH_TOL of its own scale (the fields the free-row KKT
    form computes; "default" runs the same code); two runs from one state
    agree bit for bit; each call counts one launch."""
    dev = _cuda()
    p, d = _scaled_problem(dev, M=50, scp_iter=scp_iter, car=True)
    s0 = tk.init_scaled_state(p)
    if kernel == "b1":
        run = lambda s: tk.admm_chunk(p, s, d, 20)  # noqa: E731
        plain = lambda s: tk.one_iter_ref(p, s, d)  # noqa: E731
        counter = tk.admm_chunk
    else:
        p, s0 = tkf.to_f(p, d), tkf.state_to_f(s0, d)
        run = lambda s: tkf.admm_chunk_f(p, s, d, 20, kernel)  # noqa: E731
        plain = lambda s: tkf.one_iter_ref_f(p, s, d, kernel)  # noqa: E731
        counter = tkf.admm_chunk_f
    before = counter.launches
    out, again = run(s0), run(s0)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    for name, a, c in zip(out._fields, out, again):
        assert torch.equal(a, c), name
    if kernel == "default":
        s = s0
        for it in range(20):
            step = tkf.admm_step_f(p, s, d, kernel)
            err, _ = kc.step_err_f(p, s, step, d, kernel)
            assert err <= 2e-2, (it, err)
            s = step.state
        return
    ref = s0
    for _ in range(20):
        ref = plain(ref)
    err, _ = kc.state_err(out, ref)
    assert err <= 2e-2, err
    err = kc.epigraph_err(out, ref)
    assert err <= kc.EPIGRAPH_TOL, err


@pytest.mark.gpu
@pytest.mark.parametrize("scp_iter", [0, 3])
@pytest.mark.parametrize("kernel", ["b1", "highest", "high"])
def test_free_row_form_on_the_car(kernel, scp_iter):
    """The free-row form of B1 and of B2 ("highest", "high") on the car's
    structure at M=50, at scp_iter 0 and at 3 with the form forced
    (sm_free set): one kernel iteration from each of
    kernel_checks.free_row_state's states against the float64 plain
    iteration, on the CVaR row, to kernel_checks.FREE_ROW_TOL
    (kernel_checks.free_row_errs; planted faults of the branch read
    tenfold and more above it, PERF.md)."""
    dev = _cuda()
    p, d = _scaled_problem(dev, M=50, scp_iter=scp_iter, car=True)
    p = p._replace(sm_free=torch.tensor(1.0))
    if kernel == "b1":
        step = lambda s: tk.admm_chunk(p, s, d, 1)  # noqa: E731
    else:
        pf = tkf.to_f(p, d)
        step = lambda s: tkf.f_to_state(  # noqa: E731
            tkf.admm_chunk_f(pf, tkf.state_to_f(s, d), d, 1, kernel), d)
    err = kc.free_row_errs(p, d, step)
    assert err <= kc.FREE_ROW_TOL, err


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["hopper", "drone_gaussian"])
def test_nlp_cuda_graph_replay_is_the_eager_solve(model):
    """ops/nlp_ipm.solve_nlp on the card replays CUDA graphs of its
    evaluations (no hand-written kernel: the same torch.func kernels): 8
    barrier iterations with the graphs equal the eager ones bit for bit,
    and the host's float64 solve within 1e-9 relative."""
    from riskaversetrajopt_torch.core.config import HopperScenario
    from riskaversetrajopt_torch.models.drone_gaussian import (
        GaussianDronePlanner,
    )
    from riskaversetrajopt_torch.models.hopper import HopperModel
    from riskaversetrajopt_torch.ops.nlp_ipm import NLPConfig, solve_nlp

    dev = _cuda()

    def problem(device):
        if model == "hopper":
            m = HopperModel(HopperScenario(), device=device)
            field = m.sample_friction(torch.Generator().manual_seed(0), 4)
            return m.make_nlp(field, "saa", 0.1) + (m.initial_guess(4),)
        p = GaussianDronePlanner(DroneScenario(), alpha=0.1, device=device)
        us = torch.full((p.S, p.n_u), 1e-2, dtype=torch.float64)
        return (p.f, p.g) + p.bounds() + (p.initial_guess(us),)

    cfg = NLPConfig(tol=0.0, max_iter=8)
    eager, graphed = (solve_nlp(*problem(dev), cfg, cuda_graphs=g)
                      for g in (False, True))
    host = solve_nlp(*problem("cpu"), cfg)
    assert eager.iters == graphed.iters == host.iters == 8
    assert torch.equal(eager.Z, graphed.Z)
    Zh = host.Z.to(dev)
    assert float(torch.linalg.norm(graphed.Z - Zh)) <= 1e-9 * float(
        torch.linalg.norm(Zh))
