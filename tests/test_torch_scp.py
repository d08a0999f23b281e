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
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)

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
    """A deliberate difference from the JAX driver: the fused backends
    refuse a dtype other than float32 instead of running the XLA ADMM."""
    for name in ("_admm-pallas", "_admm-pallas-f"):
        with pytest.raises(ValueError, match="float32"):
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


@pytest.mark.parametrize("name,pointer", [("hybrid-prox", "admm-ir"),
                                          ("admm-pallas", "_admm-pallas"),
                                          ("admm-pallas-f", "_admm-pallas-f")])
def test_public_experimental_names_raise(name, pointer):
    """The JAX public names that refuse (driver.py:281-292, 338-347) raise
    ValueError pointing to the opt-in name ('hybrid-prox' to 'admm-ir', as
    tests/test_scp_drone.py:238-261 asks); the port raises when the driver
    is built, JAX when it solves. An unknown name raises too."""
    with pytest.raises(ValueError, match=pointer):
        _port(8, 1, qp_backend=name)
    with pytest.raises(ValueError, match="unknown"):
        _port(8, 1, qp_backend="nope")


@pytest.fixture(scope="module")
def hybrid_m8():
    """The port's float64 'hybrid' SCP at M=8, 7 iterations, on the JAX
    omegas (shared by the parity and the resume test)."""
    return _port(8, 7, qp_backend="hybrid").solve(
        interop.drone_omega(_jax_omegas(8)), alpha=0.2)


@pytest.mark.parametrize("backend,num_iters", [("ipm", 5), ("hybrid", 7),
                                               ("admm-ir", 5)])
def test_ipm_family_scp_matches_jax_m8(backend, num_iters, request):
    """float64, M=8, through the gating transition ('hybrid': IPM + ADMM for
    the first gate_iters + 3 = 5 iterations, ADMM from cfg.rho after): the
    same QP iteration counts and flags as JAX and the controls within 1e-6
    relative (measured 1.9e-14 'ipm', 4.7e-11 'hybrid' at 5 iterations,
    3.4e-11 'admm-ir')."""
    om = _jax_omegas(8)
    res_j = SAATrajOpt(DroneModel(DroneScenario(M=8)), qp_backend=backend,
                       scp_cfg=SCPConfig(num_iters=num_iters, **GOLDEN_SCP)
                       ).solve(om, alpha=0.2)
    res_t = (request.getfixturevalue("hybrid_m8") if backend == "hybrid"
             else _port(8, num_iters, qp_backend=backend).solve(
                 interop.drone_omega(om), alpha=0.2))
    assert res_t.qp_iters.tolist() == np.asarray(res_j.qp_iters).tolist()
    assert res_t.qp_solved.tolist() == np.asarray(res_j.qp_solved).tolist()
    us_j = np.asarray(res_j.us)
    assert (np.linalg.norm(res_t.us.numpy() - us_j)
            <= 1e-6 * np.linalg.norm(us_j))


@pytest.mark.parametrize("hybrid_cap", [3000, 1000])
def test_hybrid_prox_scp_m6(hybrid_cap):
    """'_hybrid-prox' at M=6, 3 iterations, gate_iters 1
    (tests/test_scp_drone.py:238-261): every QP certified. With the ADMM leg
    capped at 1000 iterations the second QP goes through the proximal IPM
    rescue (measured: 1510 iterations over the capped leg, the IPM and the
    final leg); the port takes JAX's QP iterations there and lands within
    1e-6 relative of its controls."""
    scp = dict(GOLDEN_SCP, gate_iters=1)
    om = _jax_omegas(6)
    res_t = tdriver.SAATrajOpt(
        TDroneModel(tconfig.DroneScenario(M=6), device="cpu"),
        scp_cfg=tconfig.SCPConfig(num_iters=3, **scp), device="cpu",
        qp_backend="_hybrid-prox", hybrid_cap=hybrid_cap,
    ).solve(interop.drone_omega(om), alpha=0.2)
    assert bool(res_t.qp_solved.all()), res_t.qp_solved
    if hybrid_cap == 3000:
        return
    res_j = SAATrajOpt(DroneModel(DroneScenario(M=6)),
                       scp_cfg=SCPConfig(num_iters=3, **scp),
                       qp_backend="_hybrid-prox", hybrid_cap=hybrid_cap
                       ).solve(om, alpha=0.2)
    assert res_t.qp_iters.tolist() == np.asarray(res_j.qp_iters).tolist()
    us_j = np.asarray(res_j.us)
    assert (np.linalg.norm(res_t.us.numpy() - us_j)
            <= 1e-6 * np.linalg.norm(us_j))


def test_hybrid_instrumented_resume_keeps_cfg_rho(tmp_path, hybrid_m8):
    """The rho carry through 'hybrid' (driver.py:548-562, 698-702): only the
    ADMM family carries its adapted rho into the next QP; 'hybrid' carries
    the previous one on, so its ADMM legs after gate_iters + 3 start from
    cfg.rho. solve_instrumented to iteration 6 snapshots cfg.rho, and
    resuming it to 7 reproduces the uninterrupted solve (itself JAX's
    iteration counts, test_ipm_family_scp_matches_jax_m8)."""
    om = interop.drone_omega(_jax_omegas(8))
    full = hybrid_m8
    path = tmp_path / "hybrid.npz"
    part = _port(8, 6, qp_backend="hybrid")
    part.solve_instrumented(om, 0.2, checkpoint_path=path)
    from riskaversetrajopt_torch.utils import checkpoint as ckpt

    saved = ckpt.load(path)
    assert saved.scp_iter == 6
    assert float(saved.warm_rho) == part.admm_cfg.rho
    out = _port(8, 7, qp_backend="hybrid").solve_instrumented(
        om, 0.2, checkpoint_path=path)
    assert len(out["solve_times"]) == 1
    torch.testing.assert_close(out["us"], full.us, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out["l2_errors"], full.l2_errors[-1:].numpy(),
                               rtol=1e-8)


def test_car_admm_scp_float32_m50_contract():
    """The repair of the car's gated QP in float32 (SAAQPOps.free_y): the
    float32 'admm' car SCP at M=50, 15 iterations, chip_smoke.py's fused
    solver config (eps 1e-4, rho warm start), on the JAX omegas of
    PRNGKey(0), holds tests/test_scp_car.py:14-44's contract, final
    L2 < 2e-2 included, with every QP certified. Before the repair the
    first QP reached NaN (both packages)."""
    import dataclasses

    from riskaversetrajopt_torch.models.car import CarModel as TCarModel
    from riskaversetrajopt_tpu.core.config import CarScenario
    from riskaversetrajopt_tpu.models.car import CarModel
    from tests.test_torch_car import car_contract

    model = TCarModel(tconfig.CarScenario(M=50), device="cpu")
    cfg = tconfig.SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=20000,
                               polish=False, rho_warm_start=True)
    opt = tdriver.SAATrajOpt(
        model, scp_cfg=dataclasses.replace(model.default_scp_config(),
                                           num_iters=15),
        admm_cfg=cfg, dtype=torch.float32, device="cpu")
    om = interop.car_omega(
        CarModel(CarScenario(M=50)).sample(jax.random.PRNGKey(0), 50),
        dtype=torch.float32)
    res = opt.solve(om, alpha=0.1)
    assert res.us.dtype == torch.float32
    assert bool(res.qp_solved.all()), res.qp_iters
    assert float(res.l2_errors[-1]) < 2e-2, res.l2_errors
    car_contract(opt.model, res, om, 0.1)
