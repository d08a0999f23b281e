"""The port's user entry points against its own `solve` and the JAX
package: solve_many, solve_instrumented, checkpoint and resume (within the
port and across the packages), the experiment CLIs' result files, and
utils.profiling. Drone unless a test says otherwise, float64, small M."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core import config as tconfig
from riskaversetrajopt_torch.experiments import common as tcommon
from riskaversetrajopt_torch.models.drone import DroneModel as TDroneModel
from riskaversetrajopt_torch.scp import driver as tdriver
from riskaversetrajopt_torch.utils import checkpoint as tckpt
from riskaversetrajopt_torch.utils import profiling
from riskaversetrajopt_tpu.core.config import DroneScenario, SCPConfig
from riskaversetrajopt_tpu.experiments import common as jcommon
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt
from riskaversetrajopt_tpu.utils import checkpoint as jckpt

# the golden SCP config (test_reference_parity.py:224-227)
GOLDEN_SCP = dict(gate_iters=2, gate_row_scale=1e-7, gate_bound_l=-0.1,
                  gate_bound_u=0.1)


def _port(num_iters, **kw):
    return tdriver.SAATrajOpt(
        TDroneModel(tconfig.DroneScenario(), device="cpu"),
        scp_cfg=tconfig.SCPConfig(num_iters=num_iters, **GOLDEN_SCP),
        device="cpu", **kw)


def _jax(num_iters):
    return SAATrajOpt(DroneModel(DroneScenario()),
                      scp_cfg=SCPConfig(num_iters=num_iters, **GOLDEN_SCP))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_solve_many_matches_solve_and_jax():
    """solve_many over B=3 instances (M=10, 5 SCP iterations, alphas 0.1,
    0.2, 0.3), as tests/test_scp_drone.py:204 holds the JAX one: every
    field of each instance bit for bit its own `solve`; against JAX
    solve_many on the same omegas the same ADMM iteration counts and flags
    and the controls to 1e-6 relative."""
    B, M, alphas = 3, 10, [0.1, 0.2, 0.3]
    jopt = _jax(5)
    oms = [jopt.sample(jax.random.PRNGKey(i), M=M) for i in range(B)]
    res_j = jopt.solve_many(jax.tree.map(lambda *x: jnp.stack(x), *oms),
                            alphas)
    topt = _port(5)
    toms = [interop.drone_omega(om) for om in oms]
    res_t = topt.solve_many(
        type(toms[0])(*(torch.stack(f) for f in zip(*toms))), alphas)
    assert res_t.us.shape == (B, 20, 3) and res_t.qp_iters.shape == (B, 5)
    assert res_t.xs.shape == (B, M, 21, 6)
    for i in range(B):
        one = topt.solve(toms[i], alphas[i])
        for name, a, b in zip(one._fields, res_t, one):
            assert torch.equal(a[i], b), name
    assert res_t.qp_iters.tolist() == np.asarray(res_j.qp_iters).tolist()
    assert res_t.qp_solved.tolist() == np.asarray(res_j.qp_solved).tolist()
    for i in range(B):
        assert _rel(res_t.us[i], res_j.us[i]) <= 1e-6


def test_solve_instrumented_matches_solve_and_resumes(tmp_path):
    """solve_instrumented runs the SCP of `solve`: the same controls and
    trajectories bit for bit, the same L2 errors, and per iteration a
    positive define and solve time whose running sum is cum_times. A run
    of 4 iterations with a checkpoint, resumed to 8, reaches the
    uninterrupted run's controls (as tests/test_utils.py:22-47 holds the
    JAX one); the resumed run times only the remaining 4 iterations."""
    M = 6
    om = interop.drone_omega(_jax(1).sample(jax.random.PRNGKey(0), M=M))
    opt = _port(8)
    full = opt.solve_instrumented(om, 0.2)
    ref = opt.solve(om, 0.2)
    assert torch.equal(full["us"], ref.us) and torch.equal(full["xs"], ref.xs)
    np.testing.assert_array_equal(full["l2_errors"], ref.l2_errors.numpy())
    for key in ("define_times", "solve_times", "cum_times"):
        assert full[key].shape == (8,) and np.all(full[key] > 0), key
    np.testing.assert_allclose(
        full["cum_times"], np.cumsum(full["define_times"] + full["solve_times"]))

    p = tmp_path / "state.npz"
    _port(4).solve_instrumented(om, 0.2, checkpoint_path=p)
    saved = tckpt.load(p)
    assert saved.scp_iter == 4 and saved.warm_rho is not None
    resumed = opt.solve_instrumented(om, 0.2, checkpoint_path=p)
    assert resumed["solve_times"].shape == (4,)
    np.testing.assert_allclose(resumed["us"].numpy(), full["us"].numpy(),
                               rtol=1e-6, atol=1e-9)
    assert tckpt.load(p).scp_iter == 8


def test_solve_checkpoint_resume(tmp_path, monkeypatch):
    """`solve(checkpoint_path=...)`: a 4-iteration solve leaves its last
    snapshot; the 8-iteration solve resumes from it to the uninterrupted
    run's controls, its per-iteration arrays covering the remaining 4, and
    advances the snapshot to 8 (tests/test_utils.py:50-82). With
    checkpoint_every=3 snapshots are written at 3, 6 and the last, 8."""
    M = 6
    om = interop.drone_omega(_jax(1).sample(jax.random.PRNGKey(0), M=M))
    opt = _port(8)
    full = opt.solve(om, 0.2)
    p = tmp_path / "fused_state.npz"
    _port(4).solve(om, 0.2, checkpoint_path=p)
    assert tckpt.load(p).scp_iter == 4
    resumed = opt.solve(om, 0.2, checkpoint_path=p)
    assert resumed.us_history.shape[0] == 4 and resumed.qp_iters.shape == (4,)
    np.testing.assert_allclose(resumed.us.numpy(), full.us.numpy(),
                               rtol=1e-6, atol=1e-9)
    assert tckpt.load(p).scp_iter == 8

    seen = []
    real_save = tckpt.save

    def spy(path, scp_iter, *a, **kw):
        seen.append(scp_iter)
        return real_save(path, scp_iter, *a, **kw)

    monkeypatch.setattr(tckpt, "save", spy)
    again = opt.solve(om, 0.2, checkpoint_path=tmp_path / "every3.npz",
                      checkpoint_every=3)
    assert seen == [3, 6, 8]
    assert torch.equal(again.us, full.us)


def test_snapshot_resumes_across_packages(tmp_path):
    """A snapshot written by the JAX `solve` after 4 of 8 iterations
    resumes in the port's `solve` to the controls of JAX's own resume from
    the same file (1e-6 relative); the two packages read each other's
    files field for field, a missing warm_rho included."""
    M = 6
    jopt, jopt4 = _jax(8), _jax(4)
    om = jopt.sample(jax.random.PRNGKey(0), M=M)
    p_j = tmp_path / "jax.npz"
    jopt4.solve(om, 0.2, checkpoint_path=str(p_j))
    p_t = tmp_path / "port.npz"
    shutil.copy(p_j, p_t)
    res_j = jopt.solve(om, 0.2, checkpoint_path=str(p_j))
    res_t = _port(8).solve(interop.drone_omega(om), 0.2, checkpoint_path=p_t)
    assert res_t.us_history.shape[0] == 4
    assert _rel(res_t.us, res_j.us) <= 1e-6

    rng = np.random.default_rng(0)
    us, wx, wy = (rng.standard_normal(s) for s in ((20, 3), 112, 500))
    for save, load in ((tckpt.save, jckpt.load), (jckpt.save, tckpt.load)):
        for rho in (None, 0.37):
            path = tmp_path / "cross.npz"
            save(path, 7, us, wx, wy, warm_rho=rho)
            got = load(path)
            assert got.scp_iter == 7 and got.warm_rho == rho
            for a, b in zip(got[1:4], (us, wx, wy)):
                np.testing.assert_array_equal(a, b)


def _layout(rdir):
    """{file name: [shape of each array in it]} of a results directory."""
    out = {}
    for f in sorted(rdir.iterdir()):
        with open(f, "rb") as fh:
            shapes = []
            while True:
                try:
                    shapes.append(np.load(fh).shape)
                except (EOFError, ValueError):
                    break
        out[f.name] = shapes
    return out


CLI_ARGS = {
    "drone_risk": ["--alphas", "0.2", "--repeats", "2", "--M", "4",
                   "--mc-M", "50", "--scp-iters", "3", "--batch-chunk", "1"],
    "driving": ["--alphas", "0.1", "--repeats", "1", "--M", "4",
                "--mc-M", "50", "--scp-iters", "3"],
    "drone_times": ["--Ms", "4", "--repeats", "1", "--scp-iters", "3"],
    "drone_main_plot": ["--M", "4", "--mc-M", "50", "--scp-iters", "3"],
}


@pytest.mark.parametrize("name", sorted(CLI_ARGS))
def test_cli_writes_the_jax_layout(name, tmp_path, capsys):
    """Each CLI's main([...], device="cpu") at M=4 and 1-2 repeats writes
    the files the JAX CLI writes with the same flags, each holding arrays
    of the same shapes (us (S, n_u) and xs (M, S+1, n_x) per trajectory
    file, the timing file's five arrays), and prints each stage."""
    import importlib

    jmod = importlib.import_module(f"riskaversetrajopt_tpu.experiments.{name}")
    tmod = importlib.import_module(f"riskaversetrajopt_torch.experiments.{name}")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jmod.main(CLI_ARGS[name] + ["--results", str(jdir)])
    tmod.main(CLI_ARGS[name] + ["--results", str(tdir)], device="cpu")
    out = capsys.readouterr().out
    assert _layout(tdir) == _layout(jdir)
    assert len(_layout(tdir)) >= 2
    for f in tdir.iterdir():
        if "alpha=" in f.name or "baseline" in f.name or "traj" in f.name:
            us, xs = tcommon.load_traj(f)
            assert np.isfinite(us).all() and np.isfinite(xs).all(), f.name
    if name in ("drone_risk", "driving"):
        assert out.count("stage wall time") == 3
    if name == "driving":
        assert "run the driving_gaussian experiment first" in out
        t = tcommon.load_timing(tdir / "driving_computation_times.npy")
        assert np.all(t[1] > 0) and np.all(t[2] > 0)
        assert jcommon.load_timing(tdir / "driving_computation_times.npy")


def test_cli_runs_on_the_card_by_default():
    """Without `device` a CLI runs on the card: with no card it raises the
    error that says to pass device='cpu', before it writes anything."""
    from riskaversetrajopt_torch.experiments import drone_risk

    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU refusal cannot be seen")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drone_risk.main(["--results", "/nonexistent/never-written"])


def test_profiling_trace_writes_spans(tmp_path):
    """utils.profiling.trace writes a Chrome trace of the block, and
    solve_instrumented marks its define and solve phases in it."""
    om = interop.drone_omega(_jax(1).sample(jax.random.PRNGKey(0), M=4))
    with profiling.trace(str(tmp_path / "tr")) as where:
        _port(2).solve_instrumented(om, 0.2)
        with profiling.annotate("unit-test-span"):
            pass
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert where == str(tmp_path / "tr")
    assert {"define", "solve", "unit-test-span"} <= names
