"""The port's Gaussian car baseline (ops/gaussian.py, models/car_gaussian.py,
experiments/driving_gaussian.py) against the JAX package and against
tests/test_gaussian.py's contract: the normal quantile, the covariance
recursion (closed form and JAX's car), build_qp at the initial guess and
at scp_iter 2, the float64 'ipm' SCP, a short float32 'admm-ir' SCP, and
the CLI's result file read by the port's driving CLI and by JAX's loader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch.core.config import CarScenario as TCarScenario
from riskaversetrajopt_torch.models.car_gaussian import (
    GaussianCarPlanner as TPlanner,
)
from riskaversetrajopt_torch.ops.gaussian import (
    normal_quantile,
    propagate_covariance,
)
from riskaversetrajopt_tpu.core.config import CarScenario
from riskaversetrajopt_tpu.models.car_gaussian import GaussianCarPlanner
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)


def _planner(**kw):
    return TPlanner(TCarScenario(), device="cpu", **kw)


def test_normal_quantile_matches_scipy():
    from scipy.stats import norm

    for p in [0.5, 0.9, 0.95, 0.99, 1 - 1e-6]:
        np.testing.assert_allclose(float(normal_quantile(p)), norm.ppf(p),
                                   rtol=1e-10)
    a = torch.tensor([0.01, 0.05, 0.1], dtype=torch.float64)
    np.testing.assert_allclose(normal_quantile(1 - a).numpy(),
                               norm.ppf(1 - a.numpy()), rtol=1e-10)


def test_covariance_propagation_linear_system():
    """tests/test_gaussian.py:22-44: for b = A0 x the recursion is
    Sigma_{t+1} = (I + dt A0) Sigma_t (I + dt A0)^T + dt sig sig^T."""
    n, dt, S = 3, 0.1, 5
    A0 = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -0.5]],
                      dtype=torch.float64)
    sig = 0.1 * torch.eye(n, dtype=torch.float64)
    Sigma0 = 0.01 * torch.eye(n, dtype=torch.float64)
    Sigmas = propagate_covariance(
        torch.zeros(S + 1, n, dtype=torch.float64),
        torch.zeros(S, 1, dtype=torch.float64), Sigma0,
        drift_jac_x=lambda x, u: A0, disp_cols=lambda x, u: sig,
        param_jacs=[], param_vars=[], dt=dt)
    expected = Sigma0.numpy()
    A = np.eye(n) + dt * A0.numpy()
    Q = dt * sig.numpy() @ sig.numpy().T
    for t in range(S):
        expected = A @ expected @ A.T + Q
        np.testing.assert_allclose(Sigmas[t + 1].numpy(), expected,
                                   rtol=1e-10)


def test_car_covariance_trajectory_matches_jax():
    """The car's mean and covariance trajectories along one control
    sequence (seeded numpy, float64), the parameter-variance quirk
    included: JAX's to 1e-12."""
    us = np.random.default_rng(0).uniform(-0.5, 0.5, size=(20, 2))
    pj = GaussianCarPlanner(CarScenario(), alpha=0.1)
    pt = _planner(alpha=0.1)
    us_t = torch.from_numpy(us)
    np.testing.assert_allclose(pt.mean_trajectory(us_t).numpy(),
                               np.asarray(pj.mean_trajectory(jnp.asarray(us))),
                               rtol=0, atol=1e-12)
    Sj = np.asarray(jax.jit(pj.covariance_trajectory)(jnp.asarray(us)))
    np.testing.assert_allclose(pt.covariance_trajectory(us_t).numpy(), Sj,
                               rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def jax_planner():
    """JAX's planner at alpha 0.1 and its jitted build_qp (scp_iter traced,
    one compile for every test)."""
    pj = GaussianCarPlanner(CarScenario(), alpha=0.1)
    return pj, jax.jit(pj.build_qp)


@pytest.mark.parametrize("scp_iter", [0, 2])
def test_build_qp_matches_jax(scp_iter, jax_planner):
    """P, q, A, l, u at the initial guess, gated (scp_iter 0) and not
    (scp_iter 2): JAX's to 1e-12, the infinite bounds the same."""
    pj, build = jax_planner
    pt = _planner(alpha=0.1)
    j = build(*pj.initial_guess(), scp_iter)
    t = pt.build_qp(*pt.initial_guess(), scp_iter)
    for name, a, b in zip("PqAlu", t, j):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        fin = np.isfinite(b)
        np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=name)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-12,
                                   err_msg=name)


def test_constraints_match_jax(jax_planner):
    """The quantile-padded separation constraints and the final-state rows
    at a seeded control sequence and risk allocation: JAX's to 1e-12."""
    pj, _ = jax_planner
    rng = np.random.default_rng(1)
    us = rng.uniform(-0.5, 0.5, size=(20, 2))
    alphas = rng.uniform(1e-4, 1e-2, size=20)
    pt = _planner(alpha=0.1)
    sep = jax.jit(pj.separation_constraints)(jnp.asarray(us),
                                             jnp.asarray(alphas))
    np.testing.assert_allclose(
        pt.separation_constraints(torch.from_numpy(us),
                                  torch.from_numpy(alphas)).numpy(),
        np.asarray(sep), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        pt.final_constraints(torch.from_numpy(us)).numpy(),
        np.asarray(pj.final_constraints(jnp.asarray(us))), rtol=0,
        atol=1e-12)


def test_covariance_parameter_term_adds_a_scalar():
    """The reference's quirk kept by propagate_covariance
    (gaussian.py:62-72): a parameter Jacobian b with variance v adds the
    scalar v * dt^2 * |b|^2 to every entry of Sigma, not v * b b^T."""
    n, dt, S, v = 3, 0.5, 4, 0.2
    b = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    zero = torch.zeros(n, n, dtype=torch.float64)
    Sigma0 = torch.eye(n, dtype=torch.float64)
    Sigmas = propagate_covariance(
        torch.zeros(S + 1, n, dtype=torch.float64),
        torch.zeros(S, 1, dtype=torch.float64), Sigma0,
        drift_jac_x=lambda x, u: zero, disp_cols=lambda x, u: zero,
        param_jacs=[lambda x, u: b], param_vars=[v], dt=dt)
    step = v * dt**2 * float(b @ b)
    for t in range(S + 1):
        np.testing.assert_allclose(Sigmas[t].numpy(),
                                   np.eye(n) + t * step, rtol=1e-14)


def test_planner_runs_on_the_card_by_default():
    """With no device the planner is built on the card; with no card it
    raises and says to pass device='cpu'. Decided when the test runs."""
    if torch.cuda.is_available():
        assert TPlanner(TCarScenario()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPlanner(TCarScenario())
    assert _planner().Sigma0.device.type == "cpu"


def test_gaussian_car_planner_float64_ipm():
    """tests/test_gaussian.py:47-70 for the port: 25 SCP iterations
    through the float64 IPM, every QP converged, the last L2 update under
    1e-4, the risk budget and the 100*OSQP_TOL floor held, the padded
    separation constraints <= 1e-6, the mean final state at the ego goal
    (atol 1e-5), a non-uniform allocation (max/min > 10); and the controls
    within 1e-9 of JAX's (measured 4e-16)."""
    p = _planner(alpha=0.1, num_scp_iters=25)
    res = p.solve()
    assert res.us.dtype == torch.float64
    assert all(res.qp_solved.tolist())
    assert float(res.l2_errors[-1]) < 1e-4
    assert float(torch.sum(res.alphas_risk)) <= 0.1 + 1e-6
    assert float(torch.min(res.alphas_risk)) >= 100 * p.OSQP_TOL - 1e-12
    assert float(torch.max(p.separation_constraints(res.us,
                                                    res.alphas_risk))) <= 1e-6
    goal = np.concatenate([p.scn.position_ego_goal.numpy(),
                           p.scn.velocity_ego_goal.numpy()])
    np.testing.assert_allclose(res.xs[-1, :4].numpy(), goal, atol=1e-5)
    a = res.alphas_risk.numpy()
    assert a.max() / max(a.min(), 1e-12) > 10.0
    rj = jax.jit(GaussianCarPlanner(CarScenario(), alpha=0.1,
                                    num_scp_iters=25).solve)()
    np.testing.assert_allclose(res.us.numpy(), np.asarray(rj.us), rtol=0,
                               atol=1e-9)


def _rel(a, b):
    return float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))


def test_gaussian_car_planner_float32_admm_ir_short():
    """The float32 default ('admm-ir', 1e-8 certified by compensated
    residuals), 3 SCP iterations at alpha 0.05: every QP certified, the
    budget spent, the controls within 1e-3 relative L2 of the float64
    'admm-ir' run's (measured 1.5e-4). The float64 IPM lands elsewhere
    after 3 iterations (the risk allocations of the first QPs are not
    unique); the converged comparison is the slow test below."""
    p = _planner(alpha=0.05, num_scp_iters=3, dtype=torch.float32)
    res = p.solve()
    assert res.us.dtype == torch.float32
    assert all(res.qp_solved.tolist()), res.qp_solved
    assert abs(float(torch.sum(res.alphas_risk)) - 0.05) < 1e-3
    r64 = _planner(alpha=0.05, num_scp_iters=3).solve(qp_backend="admm-ir")
    assert _rel(res.us, r64.us) <= 1e-3


@pytest.mark.slow
def test_gaussian_car_planner_float32_matches_float64():
    """tests/test_f32_gaussian.py:92-117 for the port: float32 'admm-ir',
    alpha 0.05, 20 SCP iterations, every QP certified, within 1e-3
    relative L2 of the float64 IPM (measured 1.1e-6, 34 s on the host)."""
    res = _planner(alpha=0.05, num_scp_iters=20, dtype=torch.float32).solve()
    assert all(res.qp_solved.tolist()), res.qp_solved
    assert abs(float(torch.sum(res.alphas_risk)) - 0.05) < 1e-3
    r64 = _planner(alpha=0.05, num_scp_iters=20).solve()
    assert _rel(res.us, r64.us) <= 1e-3


def test_driving_gaussian_cli_file_read_by_both_packages(tmp_path, capsys):
    """driving_gaussian.main at alpha 0.1, 3 SCP iterations, on the host:
    it writes results/driving_gaussian_alpha=0.1.npy in the JAX layout (us
    (S, n_u), xs (S+1, n_x)), JAX's common.load_traj reads it, and the
    port's driving CLI (Monte Carlo only, 200 samples) prints the Gaussian
    baseline's safe fraction and cost instead of the run-it-first
    message."""
    from riskaversetrajopt_torch.experiments import driving, driving_gaussian
    from riskaversetrajopt_tpu.experiments import common as jcommon

    rdir = tmp_path / "results"
    driving_gaussian.main(["--alphas", "0.1", "--scp-iters", "3",
                           "--results", str(rdir)], device="cpu")
    us, xs = jcommon.load_traj(rdir / "driving_gaussian_alpha=0.1.npy")
    assert us.shape == (20, 2) and xs.shape == (21, 8)
    assert us.dtype == np.float64 and np.isfinite(xs).all()
    capsys.readouterr()
    driving.main(["--alphas", "0.1", "--repeats", "1", "--skip-saa",
                  "--skip-baseline", "--mc-M", "200", "--results",
                  str(rdir)], device="cpu")
    out = capsys.readouterr().out
    assert "run the driving_gaussian experiment first" not in out
    line = [ln for ln in out.splitlines() if "alpha=0.1: safe=" in ln]
    assert len(line) == 1, out
    safe = float(line[0].split("safe=")[1].split()[0])
    assert 0.0 <= safe <= 1.0
