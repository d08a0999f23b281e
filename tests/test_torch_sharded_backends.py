"""Every QP backend that the reference runs on sharded omegas runs
sample-sharded in the port ('ipm', 'hybrid', 'admm-ir', '_hybrid-prox',
'admm-ds'): two gloo processes of the selftest worker
(riskaversetrajopt_torch/parallel/distributed.py, `--backends`), each
holding half of tests/test_sharding.py's omegas (JAX's sampler,
PRNGKey(0), M=16), 3 SCP iterations, float64, against the port's unsharded
run (tests/test_sharding.py's rtol 1e-8 / atol 1e-10) and the JAX
package's run on shard_samples(om, make_mesh()) (for 'admm-ds' its
unsharded run: the reference's sharded 'admm-ds' returns NaN controls).
One process is the unsharded arithmetic bit for bit; a sharded solve
checkpoints and resumes; the car's gated structure runs sharded.

One spawn of the worker pair serves the drone's backends and the
checkpoint, one 'admm-ds' (as long as the others together), one the car;
all three run while this process computes the references (the `runs`
fixture)."""

import shutil
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from riskaversetrajopt_torch.ops import admm, dsjit, qp_refine
from riskaversetrajopt_torch.ops.saa_qp import SAAQPOps
from riskaversetrajopt_torch.parallel import distributed as tdist
from riskaversetrajopt_torch.scp.driver import st_total_rows
from riskaversetrajopt_torch.utils import checkpoint as ckpt
from tests.test_torch_distributed import (  # noqa: F401 (fixtures)
    _cap,
    _free_port,
    _join_pair,
    _start_pair,
    jax_omegas,
    one_thread,
)

BACKENDS = ("ipm", "hybrid", "admm-ir", "_hybrid-prox", "admm-ds")
ITERS = 3
# the JAX runs that stay in tier-1: one per family (the IPM, the refinement,
# the ds ADMM); 'hybrid' and 'admm-ir' are compared with JAX in slow cases
JAX_TIER1 = ("ipm", "_hybrid-prox", "admm-ds")
CKPT_BACKEND = tdist.CHECKPOINT_BACKEND
CAR_BACKENDS = ("admm", "ipm")
CAR_ITERS = 2  # the gated scp_iter 0 and the first live one


def _jax_run(backend):
    """The JAX package's drone SCP of the selftest config on
    shard_samples(om, make_mesh()) (the 8-device virtual CPU mesh), or on
    the unsharded omegas for 'admm-ds'."""
    import jax

    from riskaversetrajopt_tpu.core.config import DroneScenario, SCPConfig
    from riskaversetrajopt_tpu.models.drone import DroneModel
    from riskaversetrajopt_tpu.parallel.mesh import make_mesh, shard_samples
    from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

    prox = backend == "_hybrid-prox"
    cfg = tdist.HYBRID_PROX_SELFTEST
    opt = SAATrajOpt(
        DroneModel(DroneScenario()), method="saa", qp_backend=backend,
        scp_cfg=SCPConfig(num_iters=ITERS,
                          gate_iters=cfg["gate_iters"] if prox else 2,
                          gate_row_scale=1e-7, gate_bound_l=-0.1,
                          gate_bound_u=0.1),
        **(dict(hybrid_cap=cfg["hybrid_cap"]) if prox else {}))
    om = opt.sample(jax.random.PRNGKey(0), M=tdist.SELFTEST_M)
    if backend != "admm-ds":
        om = shard_samples(om, make_mesh())
    return jax.block_until_ready(opt.solve(om, alpha=0.2))


@pytest.fixture(scope="module")
def runs(jax_omegas, tmp_path_factory):
    """The three worker pairs (the drone's backends but 'admm-ds' and the
    checkpoint; 'admm-ds'; the car's), started first; while they run, the
    port's unsharded runs (the correction rounds of 'admm-ir' counted);
    then the pairs' payloads (the drone's merged) and the tier-1 JAX runs.""" 
    ck = tmp_path_factory.mktemp("ckpt")
    common = ("--omegas", jax_omegas, "--scp-iters", str(ITERS))
    drone = _start_pair("scp", common + (
        "--backends", ",".join(BACKENDS[:-1]), "--checkpoint", str(ck)))
    ds = _start_pair("scp", common + ("--backends", BACKENDS[-1]))
    car = _start_pair("scp", ("--model", "car", "--backends",
                              ",".join(CAR_BACKENDS), "--scp-iters",
                              str(CAR_ITERS)))
    om = tdist.selftest_scp_omegas(path=jax_omegas)
    ref, corrections = {}, None
    for b in BACKENDS:
        with mock.patch.object(qp_refine, "_correction_data",
                               wraps=qp_refine._correction_data) as corr:
            ref[b] = tdist.selftest_scp_opt("cpu", ITERS, backend=b).solve(
                om, alpha=0.2)
        if b == "admm-ir":
            corrections = corr.call_count
    car_om = tdist.selftest_car_omegas()
    car_ref = {b: tdist.selftest_car_opt("cpu", CAR_ITERS, backend=b).solve(
        car_om, alpha=0.2) for b in CAR_BACKENDS}
    drone = [dict(a, **b) for a, b in zip(_join_pair(drone), _join_pair(ds))]
    car = _join_pair(car)
    # after the workers: XLA's thread pool beside six busy processes runs
    # several times slower
    jax_ref = {b: _jax_run(b) for b in JAX_TIER1}
    return {"drone": drone, "car": car, "ref": ref, "car_ref": car_ref,
            "jax": jax_ref, "om": om, "ckpt_dir": ck,
            "ir_corrections": corrections}


@pytest.fixture(scope="module")
def one_rank():
    """This process as a one-process gloo group (left at the end)."""
    tdist.initialize(f"tcp://localhost:{_free_port()}", 1, 0, device="cpu")
    yield dist.group.WORLD
    tdist.shutdown()


def _assert_sharded_matches(pair, backend, ref, n, K, M):
    """Both processes alike bit for bit; the unsharded run's QP iteration
    counts and flags; the control history within rtol 1e-8 / atol 1e-10;
    no collective in the class of a G shard."""
    a, b = (p[backend] for p in pair)
    assert a == b
    assert a["qp_iters"] == ref.qp_iters.tolist()
    assert a["qp_solved"] == ref.qp_solved.tolist()
    np.testing.assert_allclose(np.array(a["us_history"]),
                               ref.us_history.reshape(-1).numpy(),
                               rtol=1e-8, atol=1e-10)
    cap, g_shard = _cap(n, K, M)
    c = a["collectives"]
    assert c["calls"] > 0 and set(c["ops"]) <= {"sum", "max", "min"}
    assert c["max_elements"] <= cap < g_shard


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_backend_matches_unsharded(runs, backend):
    """Two processes against the unsharded port on the same omegas. Measured
    (my CPU runs) as a share of the rtol 1e-8 / atol 1e-10 bound: 'ipm'
    1.8e-4, 'hybrid' 1.0e-2, 'admm-ir' 0.42, '_hybrid-prox' 0.13,
    'admm-ds' 9.1e-6; all-reduces per iteration (IPM: per Mehrotra
    iteration): 87, 11.4, 10.5, 10.8, 18.2, the largest the (n+2)^2 Schur
    block. Under a second each, after the fixture."""
    _assert_sharded_matches(runs["drone"], backend, runs["ref"][backend],
                            60, 60, tdist.SELFTEST_M)


@pytest.mark.parametrize("backend", [
    pytest.param(b, marks=() if b in JAX_TIER1 else pytest.mark.slow)
    for b in BACKENDS])
def test_sharded_backend_matches_jax(runs, backend):
    """The sharded run against the JAX package's on the 8-device mesh (for
    'admm-ds' its unsharded run): JAX's QP iteration counts and flags, the
    controls within 1e-6 relative (the bound of tests/test_torch_scp.py::
    test_ipm_family_scp_matches_jax_m8). JAX's runs: [4, 4, 11], [25, 25,
    1550], [75, 25, 1100], [75, 1864, 2010] (the third uncertified),
    [75, 25, 1550]; the slow cases compile their JAX run here ('hybrid'
    8 s, 'admm-ir' 18 s on one worker)."""
    j = runs["jax"].get(backend) or _jax_run(backend)
    a = runs["drone"][0][backend]
    assert a["qp_iters"] == np.asarray(j.qp_iters).tolist()
    assert a["qp_solved"] == np.asarray(j.qp_solved).tolist()
    us = np.array(a["us_history"]).reshape(ITERS, -1)[-1]
    us_j = np.asarray(j.us).reshape(-1)
    assert np.all(np.isfinite(us_j))
    assert np.linalg.norm(us - us_j) <= 1e-6 * np.linalg.norm(us_j)


def test_sharded_hybrid_prox_goes_through_the_rescue(runs):
    """'_hybrid-prox''s second QP does not certify within the capped ADMM
    leg (hybrid_cap 1000 iterations): its count is the capped leg's plus
    the proximal IPM's and the final leg's, on both processes as
    unsharded (1864)."""
    cap = tdist.HYBRID_PROX_SELFTEST["hybrid_cap"]
    iters = runs["drone"][0]["_hybrid-prox"]["qp_iters"]
    assert iters[1] > cap
    assert iters == runs["ref"]["_hybrid-prox"].qp_iters.tolist()


def test_sharded_admm_ir_runs_correction_rounds(runs):
    """'admm-ir''s base solve stops at IRConfig.work_eps (3e-4) and the
    correction rounds refine it to eps 1e-6: the unsharded run takes some,
    and the sharded run repeats its iteration counts, which count the
    rounds' ADMM iterations."""
    assert runs["ir_corrections"] > 0
    assert (runs["drone"][0]["admm-ir"]["qp_iters"]
            == runs["ref"]["admm-ir"].qp_iters.tolist())


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_rank_is_the_unsharded_run_bit_for_bit(runs, one_rank, backend):
    """On a one-process group every backend is the unsharded arithmetic bit
    for bit: the first two SCP iterations (the '_hybrid-prox' rescue
    included) against the unsharded run's. 0.5-3 s each on one worker."""
    res = tdist.selftest_scp_opt("cpu", 2, one_rank, backend=backend).solve(
        runs["om"], alpha=0.2)
    ref = runs["ref"][backend]
    assert res.qp_iters.tolist() == ref.qp_iters[:2].tolist()
    assert torch.equal(res.us_history, ref.us_history[:2])


def test_prox_ops_carries_the_operator_reductions(one_rank):
    """_ProxOps forwards its operator's reductions and shard: without them
    admm.reductions falls back to LOCAL and a sharded '_hybrid-prox' or
    'admm-ir' would take each process's partial residuals for global
    ones. Unsharded, the reductions are LOCAL."""
    st, data = tdist.selftest_problem(tdist.SELFTEST_M)
    tdata = tdist._to(data, "cpu")
    sig = torch.tensor(1e-3, dtype=torch.float64)
    shard = tdist.SampleShard(tdist.SELFTEST_M, one_rank)
    ops = SAAQPOps(st, tdata, 3, shard=shard)
    prox = qp_refine._ProxOps(ops, sig)
    assert prox.reductions is ops.reductions
    assert prox.shard is shard
    assert isinstance(admm.reductions(prox), tdist.ShardedReductions)
    assert admm.reductions(qp_refine._ProxOps(SAAQPOps(st, tdata, 3),
                                              sig)) is admm.LOCAL


def test_compensated_cross_process_sum(runs, one_rank):
    """SampleShard.ds_sum: on one process the compensated sum
    (dsjit.sum1_ds) comes back bit for bit; on two (each process's half of
    a float32 vector of 1024 values, summed in ds and added in rank order)
    it lies within roundoff of the exact sum, as the unsharded ds sum does,
    far below a float32 sum's error (measured: 2.2e-14, 5.5e-15 and
    4.6e-10 of sum |v|)."""
    v = tdist.selftest_ds_vector()
    whole = dsjit.sum1_ds(v)
    ((h, lo),) = tdist.SampleShard(v.numel(), one_rank).ds_sum(whole)
    assert torch.equal(h, whole[0]) and torch.equal(lo, whole[1])
    a, b = (p["ds_sum"] for p in runs["drone"])
    assert a == b
    v64 = v.double().numpy()
    exact, scale = float(np.sum(v64)), float(np.sum(np.abs(v64)))

    def err(pair):
        return abs(float(pair[0]) + float(pair[1]) - exact) / scale

    assert err(a) <= 1e-12 and err(whole) <= 1e-12
    assert err((torch.sum(v), 0.0)) > 1e3 * err(a)


def test_sharded_checkpoint_resumes_bit_for_bit(runs, tmp_path):
    """A two-process 'admm-ir' solve checkpointed at iteration 2 and resumed
    to 3 is the uninterrupted two-process run bit for bit; its file has the
    unsharded layout (process 0 writes the gathered warm starts), within
    the sharded bound of an unsharded solve's file at iteration 2; an
    unsharded solve resumes from it to the unsharded run's count and
    within that bound of its controls. About 2 s on one worker."""
    a, b = (p["checkpoint"] for p in runs["drone"])
    assert a == b and a["backend"] == CKPT_BACKEND
    full = runs["drone"][0][CKPT_BACKEND]
    n = len(full["us_history"]) // ITERS
    assert a["qp_iters"] == full["qp_iters"][-1:]
    assert a["us_history"] == full["us_history"][-n:]
    cap, _ = _cap(60, 60, tdist.SELFTEST_M)
    assert a["collectives"]["max_elements"] <= cap

    saved = ckpt.load(runs["ckpt_dir"] / f"sharded_iter{ITERS - 1}.npz")
    path = tmp_path / "unsharded.npz"
    part = tdist.selftest_scp_opt("cpu", ITERS - 1, backend=CKPT_BACKEND)
    part.solve(runs["om"], alpha=0.2, checkpoint_path=path)
    mine = ckpt.load(path)
    st = part._static_for(tdist.SELFTEST_M)
    assert saved.scp_iter == mine.scp_iter == ITERS - 1
    assert saved.warm_x.shape == mine.warm_x.shape == (st.n + st.M + 2,)
    assert saved.warm_y.shape == mine.warm_y.shape == (st_total_rows(st),)
    for x, y in ((saved.us, mine.us), (saved.warm_x, mine.warm_x)):
        np.testing.assert_allclose(x, y, rtol=1e-8, atol=1e-10)

    resumed = tmp_path / "from_sharded.npz"
    shutil.copy(runs["ckpt_dir"] / f"sharded_iter{ITERS - 1}.npz", resumed)
    res = tdist.selftest_scp_opt("cpu", ITERS, backend=CKPT_BACKEND).solve(
        runs["om"], alpha=0.2, checkpoint_path=resumed)
    ref = runs["ref"][CKPT_BACKEND]
    assert res.qp_iters.tolist() == ref.qp_iters[-1:].tolist()
    np.testing.assert_allclose(res.us.numpy(), ref.us.numpy(), rtol=1e-8,
                               atol=1e-10)


def test_sharded_solve_resumes_from_an_unsharded_file(runs):
    """The two processes resume from an unsharded solve's file at iteration
    2 (written by process 0; process 1 keeps the samples past its offset of
    it) to 3: alike bit for bit; the unsharded run's QP iterations and
    flags and its controls within the sharded bound (iterations 1-2 are
    unsharded, 3 sharded); the file has the unsharded layout and this
    process's unsharded controls. About 1 s on one worker, after the
    fixture."""
    a, b = (p["from_unsharded"] for p in runs["drone"])
    assert a == b and a["backend"] == CKPT_BACKEND
    ref = runs["ref"][CKPT_BACKEND]
    assert a["qp_iters"] == ref.qp_iters[-1:].tolist()
    assert a["qp_solved"] == ref.qp_solved[-1:].tolist()
    np.testing.assert_allclose(a["us_history"], ref.us.reshape(-1).numpy(),
                               rtol=1e-8, atol=1e-10)
    cap, _ = _cap(60, 60, tdist.SELFTEST_M)
    assert a["collectives"]["max_elements"] <= cap

    saved = ckpt.load(runs["ckpt_dir"] / f"unsharded_iter{ITERS - 1}.npz")
    part = tdist.selftest_scp_opt("cpu", ITERS - 1, backend=CKPT_BACKEND)
    st = part._static_for(tdist.SELFTEST_M)
    assert saved.scp_iter == ITERS - 1
    assert saved.warm_x.shape == (st.n + st.M + 2,)
    assert saved.warm_y.shape == (st_total_rows(st),)
    assert np.array_equal(saved.us, ref.us_history[ITERS - 2].numpy())


@pytest.mark.parametrize("backend", CAR_BACKENDS)
def test_car_gated_structure_sharded(runs, backend):
    """The car (CarScenario(M=8), the port's seed-0 omegas) on two
    processes through its gated scp_iter 0, whose y rows and sample rows
    are zeroed while the CVaR row is live (SAAQPOps.free_y: the y-block
    elimination of _schur_free), and the first live iteration: float64
    'admm' and 'ipm' against the unsharded run at the drone's bound
    (measured 3.7e-4 and 9.9e-5 of it)."""
    opt = tdist.selftest_car_opt("cpu", CAR_ITERS)
    om = tdist.selftest_car_omegas()
    alpha = torch.tensor(0.2, dtype=torch.float64)
    data = opt._define(opt.model.initial_guess(), om, alpha)
    assert SAAQPOps(opt._static_for(tdist.SELFTEST_CAR_M), data, 0).free_y
    st = opt.static
    _assert_sharded_matches(runs["car"], backend, runs["car_ref"][backend],
                            st.n, st.K, tdist.SELFTEST_CAR_M)
