"""The port's double-single ADMM (ops/admm_ds.py) and the driver's 'admm-ds'
backend against the JAX package on the same numbers: one define-phase QP
(drone, M=8, the gated scp_iter 0, built with JAX and carried across with
interop.py) and the SCP at M=8, in float64 (the same algebra in
double-double: the same iterations, x to roundoff) and in float32 (the
intended use: two float32 ds iterations, held to each other and to the
float64 path on the controls); and the rho carry of solve vs
solve_instrumented. JAX's solve runs under jit, as its driver runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core import config as tconfig
from riskaversetrajopt_torch.models.drone import DroneModel as TDroneModel
from riskaversetrajopt_torch.ops import admm as tadmm
from riskaversetrajopt_torch.ops import admm_ds as tads
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_torch.scp import driver as tdriver
from riskaversetrajopt_tpu.core.config import (
    DroneScenario,
    SCPConfig,
    SolverConfig,
)
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.ops import admm_ds as jads
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

M = 8
GOLDEN_SCP = dict(gate_iters=2, gate_row_scale=1e-7, gate_bound_l=-0.1,
                  gate_bound_u=0.1)
# eps 1e-6, polish off (the JAX bench's ds mode, bench.py:625-626)
CFG = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=3000, polish=False,
           kkt_refine_iters=1)


@pytest.fixture(scope="module")
def gated_qp():
    """The drone's gated scp_iter 0 QP at the initial guess (JAX x64
    define, PRNGKey(0) omegas), its data rounded to float32 once; the
    float64 copy holds the same values."""
    model = DroneModel(DroneScenario(M=M))
    om = model.sample(jax.random.PRNGKey(0), M)
    opt = SAATrajOpt(model, scp_cfg=SCPConfig(num_iters=1, **GOLDEN_SCP))
    st = opt._static_for(M)
    data = jax.jit(opt._define, static_argnums=3)(
        model.initial_guess(), om, jnp.asarray(0.2), M)
    d32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), data)
    d64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x), jnp.float64), d32)
    return st, d32, d64


def _solve_both(st, data, tdtype):
    cfg = SolverConfig(**CFG)
    j = jax.jit(lambda d: jads.solve_saa_qp_ds(st, d, 0, cfg))(data)
    t = tads.solve_saa_qp_ds(tqp.SAAQPStatic(*st[:14]),
                             interop.saa_qp_data(data, dtype=tdtype), 0,
                             tconfig.SolverConfig(**CFG))
    return t, j


def test_ds_qp_float64_matches_jax(gated_qp):
    """In float64 (double-double arithmetic) the port's ds ADMM is JAX's:
    the same iterations (75), both certified, x to 1e-8 of scale (measured
    1e-10: the two differ only in the rounding of the Schur
    factorization), and the final rho to 1e-4 (measured 7.5e-6: its ratio
    is formed from primal residuals of ~1e-12)."""
    st, _, d64 = gated_qp
    t, j = _solve_both(st, d64, torch.float64)
    assert t.x.dtype == torch.float64
    assert t.iters == int(j.iters) and t.solved and bool(j.solved)
    assert not (t.prim_infeasible or t.dual_infeasible)
    np.testing.assert_allclose(float(t.rho), float(j.rho), rtol=1e-4)
    x_j = np.asarray(j.x)
    np.testing.assert_allclose(t.x.numpy(), x_j, rtol=0,
                               atol=1e-8 * np.abs(x_j).max())


def test_ds_qp_float32_tracks_jax_and_float64(gated_qp):
    """In float32 the port certifies at eps 1e-6 in the float64 path's 75
    iterations, and its controls lie within 1e-5 of their scale of JAX's
    float32 ds controls (measured 4.0e-6) and of the float64 path's
    (measured 1.3e-7). JAX's float32 run strays further from the map (its
    first check reads a dual residual 30 % off the float64 path's) and
    takes other rho decisions: under jit it stops uncertified at the cap,
    eagerly it certifies in 125 iterations. The epigraph variables (y, s,
    t) sit on a degenerate face and are not compared."""
    st, d32, d64 = gated_qp
    t, j = _solve_both(st, d32, torch.float32)
    t64 = tads.solve_saa_qp_ds(tqp.SAAQPStatic(*st[:14]),
                               interop.saa_qp_data(d64), 0,
                               tconfig.SolverConfig(**CFG))
    assert t.x.dtype == torch.float32
    assert t.solved and t.iters == t64.iters
    n = st.n
    u64 = t64.x[:n].numpy()
    scale = np.abs(u64).max()
    u = t.x[:n].double().numpy()
    assert np.abs(u - u64).max() <= 1e-5 * scale
    assert np.abs(u - np.asarray(j.x, np.float64)[:n]).max() <= 1e-5 * scale


def _port_scp(dtype, om, num_iters=2):
    return tdriver.SAATrajOpt(
        TDroneModel(tconfig.DroneScenario(M=M), device="cpu"),
        scp_cfg=tconfig.SCPConfig(num_iters=num_iters, **GOLDEN_SCP),
        qp_backend="admm-ds", admm_cfg=tconfig.SolverConfig(**CFG),
        dtype=dtype, device="cpu",
    ).solve(interop.drone_omega(om, dtype=dtype), alpha=0.2)


@pytest.fixture(scope="module")
def jax_ds_scp():
    """JAX's float64 'admm-ds' SCP at M=8 over the two gated iterations
    (PRNGKey(0) omegas, alpha 0.2), and its omegas."""
    om = DroneModel(DroneScenario(M=M)).sample(jax.random.PRNGKey(0), M)
    res = SAATrajOpt(DroneModel(DroneScenario(M=M)),
                     scp_cfg=SCPConfig(num_iters=2, **GOLDEN_SCP),
                     qp_backend="admm-ds", admm_cfg=SolverConfig(**CFG),
                     ).solve(om, alpha=0.2)
    return om, res


def _rel(a, b):
    a, b = (np.asarray(v, np.float64) for v in (a, b))
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_admm_ds_scp_matches_jax_m8(dtype, jax_ds_scp):
    """SAATrajOpt(qp_backend='admm-ds') at M=8, the two gated SCP
    iterations, alpha 0.2, against JAX's float64 run: JAX's QP iterations
    (75, 25) and every QP certified in both dtypes; the controls to 1e-9
    relative L2 in float64 (measured 3e-12) and 1e-5 in float32. (JAX's
    own float32 run takes 100 and 50 iterations and lands 3.8e-3 from the
    port's float32 controls, measured on the CPU.)"""
    om, j = jax_ds_scp
    t = _port_scp(dtype, om)
    assert t.us.dtype == dtype
    assert all(t.qp_solved.tolist()) and all(np.asarray(j.qp_solved))
    assert t.qp_iters.tolist() == np.asarray(j.qp_iters).tolist()
    assert _rel(t.us, j.us) <= (1e-9 if dtype == torch.float64 else 1e-5)


def test_ds_helpers_match_jax():
    """The scaled-bound pairs (inf rows passed through), the lexicographic
    ds clip and the ds constants of the relaxation map: bit for bit JAX's
    in float32."""
    rng = np.random.default_rng(3)
    b = rng.standard_normal(64).astype(np.float32)
    b[::7] = np.inf
    b[3::11] = -np.inf
    scale = rng.uniform(0.1, 10.0, 64).astype(np.float32)
    pairs = zip(tads._ds_bounds(torch.from_numpy(b), torch.from_numpy(scale)),
                jads._ds_bounds(jnp.asarray(b), jnp.asarray(scale)))
    for t, j in pairs:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    h, lo, lh, ll, uh, ul = (rng.standard_normal(64).astype(np.float32)
                             for _ in range(6))
    lh[:8], uh[8:16] = h[:8], h[8:16]  # ties decided by the low parts
    lo, ll, ul = lo * 1e-8, ll * 1e-8, ul * 1e-8
    lh, uh = np.minimum(lh, uh), np.maximum(lh, uh)
    args = (h, lo, lh, ll, uh, ul)
    for t, j in zip(tads._ds_clip(*(torch.from_numpy(a) for a in args)),
                    jads._ds_clip(*(jnp.asarray(a) for a in args))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    like = torch.zeros((), dtype=torch.float32)
    for v in (1.6, 1.0 - 1.6, 0.1):
        t = tads._ds_const(v, like)
        j = jads._ds_const(v, jnp.float32)
        assert [float(x) for x in t] == [float(x) for x in j], v


class _RhoSpy:
    """A stand-in for solve_saa_qp_ds that records the rho0 each QP is
    given and returns a zero solution with an adapted rho of 0.37."""

    def __init__(self):
        self.rho0 = []

    def __call__(self, st, data, scp_iter, cfg, x0=None, y0=None, rho0=None,
                 ds_kkt_passes=1, shard=None):
        self.rho0.append(None if rho0 is None else float(rho0))
        return tadmm.QPSolution(
            x=torch.zeros_like(x0), y=torch.zeros_like(y0),
            z=torch.zeros_like(y0), iters=25,
            prim_res=torch.zeros((), dtype=x0.dtype),
            dual_res=torch.zeros((), dtype=x0.dtype), solved=True,
            rho=torch.tensor(0.37, dtype=x0.dtype))


def test_admm_ds_rho_carry_solve_vs_instrumented(monkeypatch):
    """With rho_warm_start, solve (and solve_many) carry the adapted rho of
    an 'admm-ds' QP into the next one, as the JAX _solve_core does
    (driver.py:550), except at the gating transition (cfg.rho);
    solve_instrumented carries cfg.rho on, as its JAX loop does
    (driver.py:698). The QP solve is a stand-in: only the carry is
    exercised."""
    spy = _RhoSpy()
    monkeypatch.setattr(tdriver, "solve_saa_qp_ds", spy)
    cfg = tconfig.SolverConfig(rho=0.1, rho_warm_start=True)
    opt = tdriver.SAATrajOpt(
        TDroneModel(tconfig.DroneScenario(M=4), device="cpu"),
        scp_cfg=tconfig.SCPConfig(num_iters=4, **GOLDEN_SCP),
        qp_backend="admm-ds", admm_cfg=cfg, device="cpu")
    om = opt.sample(torch.Generator().manual_seed(0), 4)
    opt.solve(om, alpha=0.2)
    assert spy.rho0 == pytest.approx([0.1, 0.37, 0.1, 0.37])
    spy.rho0.clear()
    opt.solve_many(type(om)(*(x[None] for x in om)), [0.2])
    assert spy.rho0 == pytest.approx([0.1, 0.37, 0.1, 0.37])
    spy.rho0.clear()
    opt.solve_instrumented(om, alpha=0.2)
    # the warm-up QP, then the loop: cfg.rho throughout
    assert spy.rho0 == pytest.approx([0.1] * 5)
