"""Every QP backend that the reference runs on sharded omegas runs
sample-sharded in the port ('ipm', 'hybrid', 'admm-ir' here;
'_hybrid-prox' and 'admm-ds' in tests/test_torch_sharded_hybrid_prox.py
and tests/test_torch_sharded_admm_ds.py): two gloo processes of the
selftest worker
(riskaversetrajopt_torch/parallel/distributed.py, `--backends`), each
holding half of tests/test_sharding.py's omegas (JAX's sampler,
PRNGKey(0), M=16), 3 SCP iterations, float64, against the port's unsharded
run (tests/test_sharding.py's rtol 1e-8 / atol 1e-10) and the JAX
package's run on shard_samples(om, make_mesh()) (for '_hybrid-prox' and
'admm-ds' its unsharded run). A sharded solve
checkpoints and resumes. The car's gated structure sharded is in
tests/test_torch_sharded_car.py, the one-process group in
tests/test_torch_sharded_one_rank.py; each file starts only the worker
pair and builds only the references that it compares.

One spawn of the worker pair serves the drone's backends and the
checkpoint; it runs while this process computes the references (the
`runs` fixture)."""

import shutil
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from riskaversetrajopt_torch.ops import dsjit, qp_refine
from riskaversetrajopt_torch.parallel import distributed as tdist
from riskaversetrajopt_torch.scp.driver import st_total_rows
from riskaversetrajopt_torch.utils import checkpoint as ckpt
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)
from tests.test_torch_distributed import (  # noqa: F401 (fixtures)
    _cap,
    _free_port,
    _join_pair,
    _start_pair,
    jax_omegas,
)

BACKENDS = ("ipm", "hybrid", "admm-ir", "_hybrid-prox", "admm-ds")
# this file's worker pair; '_hybrid-prox' and 'admm-ds' have pairs and
# files of their own, so that the three pairs run on three test workers
PAIR_BACKENDS = ("ipm", "hybrid", "admm-ir")
ITERS = 3
# the JAX runs that stay in tier-1: one per family (the IPM, the
# refinement, the ds ADMM); 'hybrid' and 'admm-ir' are compared with JAX in
# slow cases
JAX_TIER1 = ("ipm", "_hybrid-prox", "admm-ds")
# the JAX runs made on the unsharded omegas: the reference's sharded
# 'admm-ds' returns NaN controls, and its '_hybrid-prox' on the 8-device
# mesh takes ~90 s alone on an 8-core host against 10 s unsharded, with
# the same QP iteration counts and controls within 6e-11 relative
JAX_UNSHARDED = ("_hybrid-prox", "admm-ds")
CKPT_BACKEND = tdist.CHECKPOINT_BACKEND


def _jax_run(backend):
    """The JAX package's drone SCP of the selftest config on
    shard_samples(om, make_mesh()) (the 8-device virtual CPU mesh), or on
    the unsharded omegas for JAX_UNSHARDED."""
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
    if backend not in JAX_UNSHARDED:
        om = shard_samples(om, make_mesh())
    return jax.block_until_ready(opt.solve(om, alpha=0.2))


def unsharded_runs(om, backends):
    """The port's unsharded runs of `backends` on `om`, and the number of
    correction rounds of 'admm-ir' (None without it)."""
    ref, corrections = {}, None
    for b in backends:
        with mock.patch.object(qp_refine, "_correction_data",
                               wraps=qp_refine._correction_data) as corr:
            ref[b] = tdist.selftest_scp_opt("cpu", ITERS, backend=b).solve(
                om, alpha=0.2)
        if b == "admm-ir":
            corrections = corr.call_count
    return ref, corrections


def pair_runs(jax_omegas, backends, ckpt_dir=None):
    """The worker pair on `backends` (with the checkpointed solves when
    `ckpt_dir` is given), started first; while it runs, the port's
    unsharded runs and the tier-1 JAX runs among `backends`; then the
    pair's payloads."""
    extra = ("--checkpoint", str(ckpt_dir)) if ckpt_dir is not None else ()
    pair = _start_pair("scp", ("--omegas", jax_omegas, "--scp-iters",
                               str(ITERS), "--backends", ",".join(backends))
                       + extra)
    om = tdist.selftest_scp_omegas(path=jax_omegas)
    ref, corrections = unsharded_runs(om, backends)
    jax_ref = {b: _jax_run(b) for b in JAX_TIER1 if b in backends}
    drone = _join_pair(pair)
    return {"drone": drone, "ref": ref, "jax": jax_ref, "om": om,
            "ckpt_dir": ckpt_dir, "ir_corrections": corrections}


@pytest.fixture(scope="module")
def runs(jax_omegas, tmp_path_factory):
    """The worker pair of the drone's 'ipm', 'hybrid', 'admm-ir' and the
    checkpoint, the unsharded runs, the JAX run of 'ipm'."""
    return pair_runs(jax_omegas, PAIR_BACKENDS,
                     ckpt_dir=tmp_path_factory.mktemp("ckpt"))


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


def _assert_sharded_matches_jax(runs, backend):
    """Process 0's run against the JAX package's: its QP iteration counts
    and flags, the last controls within 1e-6 relative."""
    j = runs["jax"].get(backend) or _jax_run(backend)
    a = runs["drone"][0][backend]
    assert a["qp_iters"] == np.asarray(j.qp_iters).tolist()
    assert a["qp_solved"] == np.asarray(j.qp_solved).tolist()
    us = np.array(a["us_history"]).reshape(ITERS, -1)[-1]
    us_j = np.asarray(j.us).reshape(-1)
    assert np.all(np.isfinite(us_j))
    assert np.linalg.norm(us - us_j) <= 1e-6 * np.linalg.norm(us_j)


@pytest.mark.parametrize("backend", PAIR_BACKENDS)
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
    for b in PAIR_BACKENDS])
def test_sharded_backend_matches_jax(runs, backend):
    """The sharded run against the JAX package's on the 8-device mesh (for
    JAX_UNSHARDED its unsharded run): JAX's QP iteration counts and flags, the
    controls within 1e-6 relative (the bound of tests/test_torch_scp.py::
    test_ipm_family_scp_matches_jax_m8). JAX's runs: [4, 4, 11], [25, 25,
    1550], [75, 25, 1100], [75, 1864, 2010] (the third uncertified),
    [75, 25, 1550]; the slow cases compile their JAX run here ('hybrid'
    8 s, 'admm-ir' 18 s on one worker)."""
    _assert_sharded_matches_jax(runs, backend)


def test_sharded_admm_ir_runs_correction_rounds(runs):
    """'admm-ir''s base solve stops at IRConfig.work_eps (3e-4) and the
    correction rounds refine it to eps 1e-6: the unsharded run takes some,
    and the sharded run repeats its iteration counts, which count the
    rounds' ADMM iterations."""
    assert runs["ir_corrections"] > 0
    assert (runs["drone"][0]["admm-ir"]["qp_iters"]
            == runs["ref"]["admm-ir"].qp_iters.tolist())


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
