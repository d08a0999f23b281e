"""The port's sample-sharded solve on torch.distributed
(riskaversetrajopt_torch/parallel/): two gloo processes on the CPU, each
holding half of the samples, run the selftest worker of
parallel/distributed.py. The port's counterpart of tests/test_distributed.py
(the structured QP, the batch axis) and of tests/test_sharding.py (the
sharded SCP against the unsharded one, the collective audit). Every worker
is killed if it outlives its timeout."""

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch.core.config import SolverConfig as TSolverConfig
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_torch.parallel import distributed as tdist
from riskaversetrajopt_torch.parallel.mesh import make_mesh, shard_samples
from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.ops import saa_qp as jqp
from riskaversetrajopt_tpu.parallel.distributed import selftest_problem

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 600  # seconds per worker; each takes 5-50 s alone


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The in-process references run on one thread, as the workers do: the
    M=16 solves are many small ops, which threads only slow down when
    other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_pair(mode, extra=()):
    """Start two selftest workers of `mode` (gloo, one thread each; `extra`
    arguments appended), each writing to a temporary file; _join_pair
    collects them."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    init = f"tcp://localhost:{_free_port()}"
    pair = []
    for r in range(2):
        out = tempfile.TemporaryFile("w+")
        pair.append((subprocess.Popen(
            [sys.executable, "-m",
             "riskaversetrajopt_torch.parallel.distributed", "--selftest",
             "--init-method", init, "--world-size", "2", "--rank", str(r),
             "--device", "cpu", "--mode", mode, *extra],
            env=env, stdout=out, stderr=subprocess.STDOUT, text=True), out))
    return pair


def _join_pair(pair):
    """Wait for the workers of _start_pair (each killed if it outlives
    TIMEOUT) and return their SELFTEST_OK payloads, rank 0 first."""
    try:
        for p, _ in pair:
            p.wait(timeout=TIMEOUT)
    finally:
        for p, _ in pair:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for _, f in pair:
        f.seek(0)
        outs.append(f.read())
        f.close()
    payloads = []
    for r, ((p, _), out) in enumerate(zip(pair, outs)):
        assert p.returncode == 0, f"worker {r} failed:\n{out[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("SELFTEST_OK ")]
        assert line, f"worker {r} printed no result:\n{out[-3000:]}"
        payloads.append(json.loads(line[-1][len("SELFTEST_OK "):]))
    assert [p["rank"] for p in payloads] == [0, 1]
    assert all(p["nproc"] == 2 for p in payloads)
    return payloads


def _run_pair(mode, extra=()):
    """Two selftest workers of `mode` run to their end: their payloads."""
    return _join_pair(_start_pair(mode, extra))


@pytest.fixture(scope="module")
def qp_pair():
    return _run_pair("qp")


@pytest.fixture(scope="module")
def jax_omegas(tmp_path_factory):
    """tests/test_sharding.py's omegas (the JAX sampler, PRNGKey(0), M=16)
    in an .npz of the DroneOmega fields."""
    import jax

    from riskaversetrajopt_tpu.core.config import DroneScenario
    from riskaversetrajopt_tpu.models.drone import DroneModel
    from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

    om = SAATrajOpt(DroneModel(DroneScenario()), method="saa").sample(
        jax.random.PRNGKey(0), M=tdist.SELFTEST_M)
    path = tmp_path_factory.mktemp("omegas") / "omegas.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in om._asdict().items()})
    return str(path)


@pytest.fixture(scope="module")
def scp_pair(jax_omegas):
    return _run_pair("scp", ("--omegas", jax_omegas))


def _cap(n, K, M):
    """The audit's bound (tests/test_sharding.py:150-191): nothing larger
    than the (n+2)^2 Schur block or an M x max(K, n) block, nothing in the
    class of one process's G shard."""
    return max((n + 2) ** 2, M * max(K, n)), (M // 2) * K * n


def test_two_process_qp_matches_single_process(qp_pair):
    """Both processes hold the same solution bit for bit; it matches the
    port's unsharded solve and the JAX package's solve_saa_qp on the same
    numbers."""
    a, b = (p["f64"] for p in qp_pair)
    assert a["x"] == b["x"] and a["iters"] == b["iters"]
    assert a["solved"]
    x = np.array(a["x"])
    st, data = selftest_problem(tdist.SELFTEST_M)
    tst, tdata = tdist.selftest_problem(tdist.SELFTEST_M)
    assert tuple(tst) == tuple(st)[:len(tst)]
    t = tqp.solve_saa_qp(tst, tdist._to(tdata, "cpu"), 3,
                         TSolverConfig(**tdist.SELFTEST_CFG))
    assert t.solved and t.iters == a["iters"]
    np.testing.assert_allclose(x, t.x.numpy(), rtol=1e-6, atol=1e-9)
    jdata = type(data)(*(jnp.asarray(v) for v in data))
    j = jqp.solve_saa_qp(st, jdata, jnp.asarray(3),
                         SolverConfig(**tdist.SELFTEST_CFG))
    assert bool(j.solved)
    np.testing.assert_allclose(x, np.asarray(j.x), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.sum(x[:st.n]), float(np.sum(j.x[:st.n])),
                               rtol=1e-6)


def test_two_process_qp_float32(qp_pair):
    """The float32 sharded solve (the compensated factorization: each
    process's sums compensated, then all-reduced): both processes alike
    bit for bit, certified at eps 1e-4 in the unsharded float32 solve's
    iterations and within 1e-4 of its scale of it (1.6e-5 measured: the
    order of float32 sums differs). (On this synthetic QP
    any float32 solve certified at 1e-4 lies ~0.1 from the float64
    solution, 0.04 at 1e-6: the comparison is float32 with float32.)"""
    a, b = (p["f32"] for p in qp_pair)
    assert a["x"] == b["x"] and a["iters"] == b["iters"]
    assert a["solved"]
    tst, tdata = tdist.selftest_problem(tdist.SELFTEST_M)
    t = tqp.solve_saa_qp(tst, tdist._to(tdata, "cpu", torch.float32), 3,
                         TSolverConfig(**tdist.SELFTEST_CFG_F32))
    assert t.solved and t.iters == a["iters"]
    x, ref = np.array(a["x"]), t.x.double().numpy()
    np.testing.assert_allclose(x, ref, rtol=0,
                               atol=1e-4 * np.max(np.abs(ref)))


def test_two_process_batch_axis_matches_each_instance():
    """The batch axis spans the processes (a 2 x 1 grid): each process
    solves its own instance whole, both recover the full set, and each
    instance is its unsharded solve."""
    a, b = _run_pair("batch")
    assert a["xs"] == b["xs"]
    st, inst = tdist.selftest_batch_instances(2)
    cfg = TSolverConfig(rho_epoch_every=50, **tdist.SELFTEST_CFG)
    for k, data in enumerate(inst):
        t = tqp.solve_saa_qp(st, tdist._to(data, "cpu"), 3, cfg)
        np.testing.assert_allclose(a["xs"][k], t.x.numpy(), rtol=1e-10,
                                   atol=1e-12)
    assert not np.allclose(a["xs"][0], a["xs"][1])


def test_sharded_scp_matches_unsharded(scp_pair, jax_omegas):
    """The drone SCP (M=16, 6 iterations) on sample-sharded omegas against
    the unsharded port on the same omegas, those of tests/test_sharding.py
    (JAX's sampler, PRNGKey(0)): the same QP iteration counts, both
    processes bit for bit alike, Monte Carlo included; the controls within
    rtol 1e-8 / atol 1e-10 and the L2 errors within rtol 1e-6, the
    contract of tests/test_sharding.py:45-54."""
    a, b = scp_pair
    for key in ("us", "l2", "qp_iters", "mc_safe", "mc_avar"):
        assert a[key] == b[key], key
    opt = tdist.selftest_scp_opt("cpu")
    om = tdist.selftest_scp_omegas(path=jax_omegas)
    res = opt.solve(om, alpha=0.2)
    assert a["qp_iters"] == res.qp_iters.tolist()
    np.testing.assert_allclose(np.array(a["us"]),
                               res.us.reshape(-1).numpy(), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(np.array(a["l2"]), res.l2_errors.numpy(),
                               rtol=1e-6, atol=1e-10)
    mc = opt.monte_carlo(res.us, om, 0.2)
    assert a["mc_safe"] == float(mc["safe_frac"])
    np.testing.assert_allclose(a["mc_avar"], float(mc["avar"]), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("mode", ["qp", "scp"])
def test_collective_audit_no_jacobian_communication(request, mode):
    """Every collective of the sharded QP and of the sharded SCP (with its
    Monte Carlo) is recorded (parallel/distributed.audit): the only
    traffic is all-reduces of at most max((n+2)^2, M max(K, n)) entries —
    the Schur block, the CVaR couplings, O(M)-wide vectors — and nothing
    near a G shard (M/2 K n)."""
    a, _ = request.getfixturevalue(f"{mode}_pair")
    c = a["f64"]["collectives"] if mode == "qp" else a["collectives"]
    if mode == "qp":
        st, _ = tdist.selftest_problem(tdist.SELFTEST_M)
        n, K, M = st.n, st.K, st.M
    else:
        n, K, M = 60, 60, tdist.SELFTEST_M
    cap, g_shard = _cap(n, K, M)
    assert c["calls"] > 0 and set(c["ops"]) <= {"sum", "max"}
    assert c["max_elements"] <= cap < g_shard
    # the factorization's (n+2)^2 Schur block is the largest
    assert c["max_elements"] == (n + 2) ** 2


def test_mesh_and_shard_helpers_single_process():
    """One process is the 1 x 1 grid: no group, the whole sample axis, no
    shard; the sharded driver refuses what it cannot run sharded: the two
    fused backends, whose kernels the reference never splits over the
    sample axis (every other backend runs sharded,
    tests/test_torch_sharded_backends.py)."""
    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    mesh = make_mesh(device="cpu")
    assert (mesh.n_batch, mesh.n_samples) == (1, 1)
    assert mesh.sample_shard(16) is None
    om = tdist.selftest_scp_omegas()
    local = shard_samples(om, mesh)
    assert all(torch.equal(x, y) for x, y in zip(local, om))
    assert tdist.process_sample_slice(16) == slice(0, 16)
    model = DroneModel(DroneScenario(), device="cpu")
    for backend in ("_admm-pallas", "_admm-pallas-f"):
        with pytest.raises(ValueError, match="sample-sharded.*no sharded "
                                             "form.*collective inside"):
            SAATrajOpt(model, qp_backend=backend, device="cpu",
                       group=object())
