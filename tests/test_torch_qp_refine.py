"""The port's iterative refinement (ops/qp_refine.py) against the JAX package
and against tests/test_qp_refine.py's contract: the M=16 drone transition
QP (built once with JAX x64, cast to float32) certified at 1e-6 by float64
residuals, under the plain float32 floor at a 1e-8 target, and at 1e-9 in
float64; the dense refinement against JAX's."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch import interop
from riskaversetrajopt_torch.core.config import SolverConfig as TSolverConfig
from riskaversetrajopt_torch.ops import qp_refine as tir
from riskaversetrajopt_torch.ops import saa_qp as tqp
from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.ops import qp_refine as jir
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)
from tests.test_qp_refine import _f64_residuals
from tests.test_qp_refine import transition_qp_f32  # noqa: F401 (fixture)
from tests.test_torch_dense_qp import _random


def _port_qp(st, data, dtype):
    return tqp.SAAQPStatic(*st[:14]), interop.saa_qp_data(data, dtype=dtype)


def _cfg(eps, max_iter=20000):
    return dict(eps_abs=eps, eps_rel=eps, max_iter=max_iter, polish=False,
                kkt_refine_iters=1)


def test_ir_certifies_1e6_in_f32(transition_qp_f32):
    """float32 data, target 1e-6: certified, and the float64 residuals of
    the returned point (_f64_residuals) meet the target as the JAX test
    holds them; the compensated certificate agrees with them."""
    st, data32 = transition_qp_f32
    tst, tdata = _port_qp(st, data32, torch.float32)
    eps = 1e-6
    sol = tir.solve_saa_qp_ir(tst, tdata, 3, TSolverConfig(**_cfg(eps)))
    assert sol.x.dtype == torch.float32
    assert sol.solved, f"prim={float(sol.prim_res):.2e} dual={float(sol.dual_res):.2e}"
    prim, dual, pr, dr = _f64_residuals(st, data32, 3, sol.x.numpy(),
                                        sol.y.numpy())
    assert prim <= eps + eps * pr * 1.05
    assert dual <= eps + eps * dr * 1.05
    np.testing.assert_allclose(float(sol.prim_res), prim, rtol=0.2, atol=3e-8)


def test_ir_beats_f32_floor(transition_qp_f32):
    """Target 1e-8, five rounds: the float64 residuals sit far under the
    plain float32 stall (~1e-5): prim <= 3e-7, dual <= 3e-6."""
    st, data32 = transition_qp_f32
    tst, tdata = _port_qp(st, data32, torch.float32)
    sol = tir.solve_saa_qp_ir(tst, tdata, 3, TSolverConfig(**_cfg(1e-8)),
                              tir.IRConfig(rounds=5))
    prim, dual, _, _ = _f64_residuals(st, data32, 3, sol.x.numpy(),
                                      sol.y.numpy())
    assert prim <= 3e-7, prim
    assert dual <= 3e-6, dual


def test_ir_x64_reaches_1e9_and_matches_jax(transition_qp_f32):
    """The same path in float64 certifies at 1e-9 with the same ADMM
    iterations as JAX's and x within 1e-8 of its scale."""
    st, data32 = transition_qp_f32
    data64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                          data32)
    tst, tdata = _port_qp(st, data64, torch.float64)
    cfg = _cfg(1e-9, max_iter=50000)
    sol = tir.solve_saa_qp_ir(tst, tdata, 3, TSolverConfig(**cfg),
                              tir.IRConfig(rounds=4))
    assert sol.solved, f"prim={float(sol.prim_res):.2e} dual={float(sol.dual_res):.2e}"
    j = jir.solve_saa_qp_ir(st, data64, 3, SolverConfig(**cfg),
                            jir.IRConfig(rounds=4))
    assert sol.iters == int(j.iters)
    x_j = np.asarray(j.x)
    np.testing.assert_allclose(sol.x.numpy(), x_j, rtol=0,
                               atol=1e-8 * np.max(np.abs(x_j)))


@pytest.mark.parametrize("dtype,eps", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-8)])
def test_dense_ir_matches_jax(dtype, eps):
    """solve_dense_qp_ir on a random inequality QP: certified at eps far
    under the float32 floor, with JAX's iterations and x within 1e-7 of
    scale in float64, and 1e-5 in float32, where two float32 ADMM bases
    round differently."""
    P, q, A, l, u = _random(4)
    cfg = dict(eps_abs=eps, eps_rel=eps, max_iter=20000)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = jir.solve_dense_qp_ir(*(jnp.asarray(v, jdt) for v in (P, q, A, l, u)),
                              SolverConfig(**cfg))
    t = tir.solve_dense_qp_ir(*(torch.tensor(v, dtype=dtype)
                                for v in (P, q, A, l, u)),
                              TSolverConfig(**cfg))
    assert t.solved and bool(j.solved)
    assert t.x.dtype == dtype
    x_j = np.asarray(j.x)
    tol = 1e-7 if dtype == torch.float64 else 1e-5
    if dtype == torch.float64:
        assert t.iters == int(j.iters)
    np.testing.assert_allclose(t.x.numpy(), x_j, rtol=0,
                               atol=tol * max(1.0, np.max(np.abs(x_j))))


@pytest.mark.parametrize("x", [1.0, 0.7, 0.75, 3e-9, 6.1e5, 1e10])
def test_pow2_is_an_exact_power_of_two(x):
    """_pow2 (frexp/ldexp) is 2^round(log2 x) exactly. JAX's exp2 on the
    CPU is not exact there (it reads 8589934591.999979 for 2^33), so the
    port's Delta differs from JAX's by that rounding."""
    for dtype in (torch.float32, torch.float64):
        p = tir._pow2(torch.tensor(x, dtype=dtype))
        assert float(p) == 2.0 ** round(math.log2(x))
        assert float(torch.frexp(p).mantissa) == 0.5


def test_ds_residual_operators_match_jax(transition_qp_f32):
    """The compensated matvec_A / rmatvec_A of the refinement in float32
    against JAX's on the same double-single inputs: both error-free
    transforms run unfused, so the (hi, lo) pairs agree bit for bit."""
    st, data32 = transition_qp_f32
    tst, tdata = _port_qp(st, data32, torch.float32)
    jops = jir.SAAQPOps(st, data32, 3)
    tops = tqp.SAAQPOps(tst, tdata, 3)
    rng = np.random.default_rng(0)
    nv = tst.n + tst.M + 2
    m = tst.n_fc + 1 + tst.M + tst.M * tst.K + 1 + tst.n
    x = rng.standard_normal(nv).astype(np.float32)
    xl = (rng.standard_normal(nv) * 1e-8).astype(np.float32)
    w = rng.standard_normal(m).astype(np.float32)
    pairs = [
        (jir._ds_matvec_A(jops, jnp.asarray(x), jnp.asarray(xl)),
         tir._ds_matvec_A(tops, torch.from_numpy(x), torch.from_numpy(xl))),
        (jir._ds_rmatvec_A(jops, jnp.asarray(w)),
         tir._ds_rmatvec_A(tops, torch.from_numpy(w))),
    ]
    for j, t in pairs:
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
