"""The port's SCP driver end to end against the JAX package and the committed
goldens, the omegas fixture behind the M=1000 golden, and the rule that the
port never imports jax."""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core import config as tconfig
from riskaversetrajopt_torch.models.drone import DroneModel as TDroneModel
from riskaversetrajopt_torch.scp import driver as tdriver
from riskaversetrajopt_tpu.core.config import DroneScenario, SCPConfig
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
# the golden SCP config (test_reference_parity.py:224-227)
GOLDEN_SCP = dict(gate_iters=2, gate_row_scale=1e-7, gate_bound_l=-0.1,
                  gate_bound_u=0.1)


def _jax_omegas(M, seed=0):
    return DroneModel(DroneScenario(M=M)).sample(jax.random.PRNGKey(seed), M)


def _port(M, num_iters, **kw):
    return tdriver.SAATrajOpt(
        TDroneModel(tconfig.DroneScenario(M=M), device="cpu"),
        scp_cfg=tconfig.SCPConfig(num_iters=num_iters, **GOLDEN_SCP),
        device="cpu", **kw)


def test_admm_scp_matches_jax_m8():
    """'admm' float64, M=8, 5 SCP iterations through the gating transition:
    the same ADMM iteration counts and controls to 1e-6 relative (measured
    ~1e-10: two float64 implementations of one algorithm, whose warm-started
    QPs contract their roundoff)."""
    om = _jax_omegas(8)
    res_j = SAATrajOpt(DroneModel(DroneScenario(M=8)),
                       scp_cfg=SCPConfig(num_iters=5, **GOLDEN_SCP)
                       ).solve(om, alpha=0.2)
    res_t = _port(8, 5).solve(interop.drone_omega(om), alpha=0.2)
    assert res_t.qp_iters.tolist() == np.asarray(res_j.qp_iters).tolist()
    assert res_t.qp_solved.tolist() == np.asarray(res_j.qp_solved).tolist()
    us_j = np.asarray(res_j.us)
    assert (np.linalg.norm(res_t.us.numpy() - us_j)
            <= 1e-6 * np.linalg.norm(us_j))
    np.testing.assert_allclose(res_t.l2_errors.numpy(),
                               np.asarray(res_j.l2_errors), rtol=1e-6)
    np.testing.assert_allclose(res_t.xs.numpy(), np.asarray(res_j.xs),
                               rtol=0, atol=1e-6)


def test_admm_scp_golden_m50():
    """The north-star contract of test_reference_parity.py:184-190 for the
    port: M=50, 15 iterations, within 1e-3 relative L2 of the committed
    golden (the JAX x64 path lands 2.2e-4 there)."""
    res = _port(50, 15).solve(interop.drone_omega(_jax_omegas(50)), alpha=0.2)
    gold = torch.from_numpy(
        np.load(FIXTURES / "gold_drone_m50_a0.2_seed0_iters15.npy"))
    err = float(tdriver.l2_error_us(gold, res.us))
    assert err <= 1e-3, f"relative L2 vs golden = {err:.3e}"


def _fused_scp_m8(backend):
    """A float32 fused-backend SCP, M=8, 10 iterations on the CPU (plain
    iteration): returns the result and whether any kernel launched."""
    from riskaversetrajopt_torch.ops.cuda import saa_admm, saa_admm_f

    cfg = tconfig.SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=2000,
                               polish=False, rho_warm_start=True)
    opt = _port(8, 10, qp_backend=backend, admm_cfg=cfg, dtype=torch.float32)
    before = saa_admm.admm_chunk.launches, saa_admm_f.admm_chunk_f.launches
    res = opt.solve(interop.drone_omega(_jax_omegas(8), dtype=torch.float32),
                    alpha=0.2)
    launched = (saa_admm.admm_chunk.launches,
                saa_admm_f.admm_chunk_f.launches) != before
    return res, launched


def test_pallas_backend_scp_m8():
    """'_admm-pallas' float32, M=8, 10 SCP iterations on the CPU (plain
    iteration, no kernel launch): the last control update below 5e-2, as
    test_pallas_admm.py:173-200 asks of the JAX backend. The port's solver
    config is chip_smoke.py's, with max_iter cut to 2000 to keep this cheap."""
    res, launched = _fused_scp_m8("_admm-pallas")
    assert not launched
    l2 = res.l2_errors.numpy()
    assert res.us.dtype == torch.float32 and np.isfinite(l2).all()
    assert l2[-1] < 5e-2, f"L2 errors: {l2}"


def test_pallas_f_backend_scp_m8():
    """'_admm-pallas-f', the same contract: the lane-flat plain iteration
    on the CPU, no kernel launch, the last control update below 5e-2."""
    res, launched = _fused_scp_m8("_admm-pallas-f")
    assert not launched
    l2 = res.l2_errors.numpy()
    assert res.us.dtype == torch.float32 and np.isfinite(l2).all()
    assert l2[-1] < 5e-2, f"L2 errors: {l2}"


def test_admm_scp_float32_m8():
    """The float32 'admm' backend runs now that its factorization is
    compensated (ops/dsjit.py): M=8, 3 SCP iterations with polish, every
    iterate finite."""
    cfg = tconfig.SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=500)
    res = _port(8, 3, admm_cfg=cfg, dtype=torch.float32).solve(
        interop.drone_omega(_jax_omegas(8), dtype=torch.float32), alpha=0.2)
    assert res.us.dtype == torch.float32
    for name in ("us", "xs", "l2_errors", "us_history"):
        assert bool(torch.isfinite(getattr(res, name)).all()), name


def test_backend_choices_raise():
    """Deliberate differences from the JAX driver: the fused backends
    refuse a dtype other than float32 instead of running the XLA ADMM, and
    the backends not ported yet raise."""
    for name in ("_admm-pallas", "_admm-pallas-f"):
        with pytest.raises(ValueError, match="float32"):
            _port(8, 1, qp_backend=name)
    for name in ("ipm", "hybrid", "admm-ir", "admm-ds"):
        with pytest.raises(ValueError, match="not ported"):
            _port(8, 1, qp_backend=name)


def test_card_is_the_default_device():
    """With no device given the model and the driver run on the card; with
    no card they raise and say to pass device='cpu', rather than running on
    the host. Decided here, when the test runs."""
    if torch.cuda.is_available():
        opt = tdriver.SAATrajOpt(TDroneModel())
        assert opt.device.type == "cuda" and opt.model.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDroneModel()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdriver.SAATrajOpt(TDroneModel(device="cpu"))


def test_monte_carlo_matches_jax():
    """Rollout, max constraint, safe fraction, AVaR and cost of the m50
    golden controls on 300 fresh JAX samples, float64: roundoff only."""
    gold = np.load(FIXTURES / "gold_drone_m50_a0.2_seed0_iters15.npy")
    om = _jax_omegas(300, seed=99)
    j = SAATrajOpt(DroneModel(DroneScenario(M=300))).monte_carlo(
        jax.numpy.asarray(gold), om, 0.2)
    t = _port(300, 1).monte_carlo(torch.from_numpy(gold),
                                  interop.drone_omega(om), 0.2)
    np.testing.assert_allclose(t["max_constraints"].numpy(),
                               np.asarray(j["max_constraints"]), rtol=0,
                               atol=1e-12)
    assert float(t["safe_frac"]) == float(j["safe_frac"])
    for key in ("avar", "cost"):
        np.testing.assert_allclose(float(t[key]), float(j[key]), rtol=1e-12)


def test_omegas_fixture_is_the_jax_sample():
    """tests/fixtures/omegas_drone_m1000_seed0.npz holds the omegas behind
    the m1000 golden (tools/make_goldens.py:52-53), so chip_smoke.py can
    drive the port there without JAX. It was written with:

        om = DroneModel(DroneScenario(M=1000)).sample(PRNGKey(0), 1000)
        np.savez(path, **{k: np.asarray(v) for k, v in om._asdict().items()})
    """
    om = _jax_omegas(1000)
    with np.load(FIXTURES / "omegas_drone_m1000_seed0.npz") as f:
        assert sorted(f.files) == sorted(om._fields)
        for name, v in om._asdict().items():
            assert f[name].dtype == np.float64
            np.testing.assert_array_equal(f[name], np.asarray(v))


def test_port_never_imports_jax():
    """Import every module of the port with jax made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import riskaversetrajopt_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m.startswith(('jax', 'riskaversetrajopt_tpu')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 12
