"""Fused ADMM iterations of the structured SAA QP in the lane-flat ("F")
layout: host code and wrapper of the hand-written Hopper kernel
``csrc/saa_admm_f.cu``.

The counterpart of ``riskaversetrajopt_tpu/ops/pallas/experimental/
saa_admm_f.py`` in the port's natural flat layout: every sample-row array is
flat, F = K*M, with index f = k*M + i (k-major), and the scaled Jacobian
stack is kept twice, as G2 (F, n) with row f = Gs[i, k, :] and as its
transpose G2T (n, F), so that each sweep is one matrix product that reads
memory in order:

  sweep 1 (A^T w over the sample rows) = w_f @ G2        -> (n,)
  sweep 2 (G u)                         = u_t @ G2T       -> (F,)

The per-sample sums over k are strided sums (stride M) and the per-sample ->
sample-row broadcast is a repeat over k. The TPU padding (Mp, Kp, 128 lanes)
and the packed colpF/colyF slots are gone; `interop.scaled_saa_f` maps the
JAX layout onto this one for the tests. The iteration is B1's
(`saa_admm.one_iter_ref`); only the layout and the sweep precision differ.
The kernel itself reads G2 only: it keeps each block's slab of G in shared
memory, so one copy serves both sweeps; G2T stays a field for the plain
version and the interop.

`sweep_precision` is the precision of the two sweeps, with the TPU meanings
(`ops/saa_qp.py:sweep_matmul`): "highest" exact float32, "high" bf16x3,
"default" bf16 operands with float32 accumulation.

`one_iter_ref_f` is the plain PyTorch iteration; `admm_chunk_f` launches the
kernel for CUDA tensors and runs `one_iter_ref_f` only for CPU tensors.
`admm_step_f` runs one iteration the same way and also returns what its
sweeps worked on, which `kernel_checks` holds to each sweep precision.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from riskaversetrajopt_torch.ops import admm as admm_mod
from riskaversetrajopt_torch.ops.cuda.saa_admm import (
    KernelDims,
    LaunchShape,
    ScaledSAA,
    ScaledState,
    _row_update,
    _small,
    check_tensors,
    cuda_error,
    declare,
    kernel_scratch,
    kkt_solve,
    query_shape,
    solve_chunked,
)
from riskaversetrajopt_torch.ops.saa_qp import (
    SWEEP_PRECISIONS,
    SAAQPData,
    SAAQPStatic,
    check_sweep_precision,
    sweep_matmul,
)


class ScaledSAAF(NamedTuple):
    """Kernel-ready F-layout problem data, all float32: ScaledSAA with Gs
    replaced by G2/G2T and the (M, K) fields flattened to (F,). The field
    order is the kernel's pointer order (csrc/saa_admm_f.cu ProbF)."""

    G2: torch.Tensor  # (F, n), row f = k*M + i holds Gs[i, k, :]
    G2T: torch.Tensor  # (n, F)
    eGy_f: torch.Tensor  # (F,)
    eGt_f: torch.Tensor  # (F,)
    rvG_f: torch.Tensor  # (F,)
    lbG_f: torch.Tensor  # (F,), -inf where unbounded
    ubG_f: torch.Tensor  # (F,)
    rv_y: torch.Tensor  # (M,)
    lb_y: torch.Tensor  # (M,)
    ub_y: torch.Tensor  # (M,)
    cy_hat: torch.Tensor  # (M,)
    yd_hat: torch.Tensor  # (M,)
    ys_hat: torch.Tensor  # (M,)
    Dinv: torch.Tensor  # (M,)
    wD: torch.Tensor  # (M,)
    rv_small: torch.Tensor  # (n_fc+2+n,)
    lb_small: torch.Tensor  # (n_fc+2+n,)
    ub_small: torch.Tensor  # (n_fc+2+n,)
    Fs: torch.Tensor  # (n_fc, n)
    cu: torch.Tensor  # (n,)
    q_hat_u: torch.Tensor  # (n,)
    Sinv: torch.Tensor  # (n+2, n+2)
    Cbar: torch.Tensor  # (M, n+2)
    ct_hat: torch.Tensor  # ()
    cs_hat: torch.Tensor  # ()
    ss_hat: torch.Tensor  # ()
    q_hat_s: torch.Tensor  # ()
    sm_beta: torch.Tensor  # ()
    sm_denom: torch.Tensor  # ()
    sigma: torch.Tensor  # ()
    alpha_relax: torch.Tensor  # ()
    sm_free: torch.Tensor  # () on the host, as ScaledSAA's


class ScaledStateF(NamedTuple):
    """Scaled ADMM iterate in the F layout, all float32 (kernel pointer
    order, the same as ScaledState's)."""

    u: torch.Tensor  # (n,)
    s: torch.Tensor  # ()
    t: torch.Tensor  # ()
    y: torch.Tensor  # (M,)
    z_y: torch.Tensor  # (M,)
    yd_y: torch.Tensor  # (M,)
    zG_f: torch.Tensor  # (F,)
    ydG_f: torch.Tensor  # (F,)
    z_small: torch.Tensor  # (n_fc+2+n,)
    yd_small: torch.Tensor  # (n_fc+2+n,)


def _mk_to_f(x):
    """(M, K) -> (F,) with f = k*M + i."""
    return x.T.reshape(-1).contiguous()


def _f_to_mk(x, d: KernelDims):
    return x.reshape(d.K, d.M).T.contiguous()


def to_f(p: ScaledSAA, d: KernelDims, G2=None, G2T=None) -> ScaledSAAF:
    """Natural-layout structure -> F layout (saa_admm_f.py:153-194). Pass
    G2/G2T to skip the two (F, n) copies when only the rho-dependent fields
    changed (the adaptive-rho refactorization)."""
    if G2 is None:
        G2 = p.Gs.transpose(0, 1).reshape(d.K * d.M, d.n).contiguous()
    if G2T is None:
        G2T = G2.T.contiguous()
    return ScaledSAAF(
        G2, G2T, _mk_to_f(p.eGy), _mk_to_f(p.eGt), _mk_to_f(p.rv_G),
        _mk_to_f(p.lb_G), _mk_to_f(p.ub_G), *p[6:],
    )


def state_to_f(s: ScaledState, d: KernelDims) -> ScaledStateF:
    return ScaledStateF(
        *s[:6], zG_f=_mk_to_f(s.z_G), ydG_f=_mk_to_f(s.yd_G),
        z_small=s.z_small, yd_small=s.yd_small,
    )


def f_to_state(sf: ScaledStateF, d: KernelDims) -> ScaledState:
    return ScaledState(
        *sf[:6], z_G=_f_to_mk(sf.zG_f, d), yd_G=_f_to_mk(sf.ydG_f, d),
        z_small=sf.z_small, yd_small=sf.yd_small,
    )


class StepF(NamedTuple):
    """One ADMM iteration and what its two sweeps worked on: the state after
    it, sweep 1's partial sums of w_f @ G2 (rows that add up to it: the
    kernel's per-block partials, the plain version's one row), and the KKT
    solution sweep 2 multiplies, v = [u_t | s_t | t_t] and y_t."""

    state: ScaledStateF
    u_part: torch.Tensor  # (rows, n)
    v: torch.Tensor  # (n+2,)
    y_t: torch.Tensor  # (M,)


def one_iter_ref_f(pf: ScaledSAAF, s: ScaledStateF, d: KernelDims,
                   sweep_precision: str = "highest") -> ScaledStateF:
    """One scaled ADMM iteration in plain PyTorch, F layout (the kernel's
    plain version; saa_admm_f.py:306-404). The sweeps are one matmul each
    at `sweep_precision`; everything else is B1's iteration."""
    return step_ref_f(pf, s, d, sweep_precision).state


def step_ref_f(pf: ScaledSAAF, s: ScaledStateF, d: KernelDims,
               sweep_precision: str = "highest") -> StepF:
    """`one_iter_ref_f` with what its sweeps worked on (the plain version of
    `admm_step_f`)."""
    n, n_fc, M, K = d.n, d.n_fc, d.M, d.K
    al, sig = pf.alpha_relax, pf.sigma

    # sweep 1 + per-sample reductions over k (stride M)
    w_f = pf.rvG_f * s.zG_f - s.ydG_f
    u_sweep = sweep_matmul(w_f[None, :], pf.G2, sweep_precision)
    u_part = u_sweep[0]
    rowsum_y = torch.sum((pf.eGy_f * w_f).reshape(K, M), dim=0)
    eGtw_sum = torch.sum(pf.eGt_f * w_f)

    # KKT solve: Sherman-Morrison on the y block + explicit Schur inverse
    w_small = pf.rv_small * s.z_small - s.yd_small
    w_y = pf.rv_y * s.z_y - s.yd_y
    w_c, w_s = w_small[n_fc], w_small[n_fc + 1]
    for j in range(n_fc):
        u_part = u_part + w_small[j] * pf.Fs[j]
    u_part = u_part + pf.cu * w_small[n_fc + 2 :]
    rhs_u = sig * s.u - pf.q_hat_u + u_part
    rhs_s = (sig * s.s - pf.q_hat_s + pf.cs_hat * w_c
             - torch.sum(pf.ys_hat * w_y) - pf.ss_hat * w_s)
    rhs_t = sig * s.t + pf.ct_hat * w_c - eGtw_sum
    v, y_t = kkt_solve(pf, s.y, w_c, w_y, rowsum_y,
                       torch.cat([rhs_u, rhs_s[None], rhs_t[None]]))
    u_t, s_t, t_t = v[:n], v[n], v[n + 1]

    # sweep 2 + sample-row update
    zt_f = (sweep_matmul(u_t[None, :], pf.G2T, sweep_precision)[0]
            - pf.eGy_f * y_t.repeat(K) - pf.eGt_f * t_t)
    zG_f, ydG_f = _row_update(al, s.zG_f, s.ydG_f, zt_f, pf.rvG_f, pf.lbG_f,
                              pf.ubG_f)

    # small rows, y rows and the coupled variables
    zt_y = -pf.yd_hat * y_t - pf.ys_hat * s_t
    zt_c = torch.sum(pf.cy_hat * y_t) + pf.cs_hat * s_t + pf.ct_hat * t_t
    zt_s = -pf.ss_hat * s_t
    zt_small = _small(pf.Fs @ u_t, zt_c, zt_s, pf.cu * u_t)
    z_y, yd_y = _row_update(al, s.z_y, s.yd_y, zt_y, pf.rv_y, pf.lb_y, pf.ub_y)
    z_small, yd_small = _row_update(
        al, s.z_small, s.yd_small, zt_small, pf.rv_small, pf.lb_small,
        pf.ub_small,
    )
    state = ScaledStateF(
        u=al * u_t + (1 - al) * s.u,
        s=al * s_t + (1 - al) * s.s,
        t=al * t_t + (1 - al) * s.t,
        y=al * y_t + (1 - al) * s.y,
        z_y=z_y,
        yd_y=yd_y,
        zG_f=zG_f,
        ydG_f=ydG_f,
        z_small=z_small,
        yd_small=yd_small,
    )
    return StepF(state, u_sweep, v, y_t)


def _check_kernel_inputs(pf: ScaledSAAF, state: ScaledStateF, d: KernelDims):
    F = (d.M * d.K,)
    check_tensors("admm_chunk_f", pf, state, d, {
        "G2": (*F, d.n), "G2T": (d.n, *F), "eGy_f": F, "eGt_f": F,
        "rvG_f": F, "lbG_f": F, "ubG_f": F, "zG_f": F, "ydG_f": F,
    })


def _library():
    """The kernel library with its C signatures declared (built on first
    use)."""
    from riskaversetrajopt_torch.ops.cuda import build

    return declare(build.load("saa_admm_f"), "saa_admm_f", 7, 5)


def launch_shape_f(d: KernelDims, device,
                   sweep_precision: str = "highest") -> LaunchShape:
    """How kernel B2 runs a chunk call of these dims at `sweep_precision`
    on `device` ("default" stores G in half the bytes, so it stays resident
    to a larger M)."""
    check_sweep_precision(sweep_precision)
    return query_shape(_library(), "saa_admm_f", device, d.M, d.K, d.n,
                       d.n_fc, SWEEP_PRECISIONS.index(sweep_precision))


def _kernel_chunk(pf: ScaledSAAF, state: ScaledStateF, d: KernelDims,
                  chunk: int, sweep_precision: str):
    """Launch the kernel; returns the output state, the scratch (which
    holds the last iteration's partial rows, y_t and v) and the launch
    shape."""
    lib = _library()
    if d.n > lib.saa_admm_f_max_n():
        raise ValueError(f"admm_chunk_f: n={d.n} exceeds the kernel's "
                         f"{lib.saa_admm_f_max_n()} columns")
    _check_kernel_inputs(pf, state, d)
    dev = pf.G2.device
    with torch.cuda.device(dev):
        out = ScaledStateF(*(torch.empty_like(x) for x in state))
        shape = launch_shape_f(d, dev, sweep_precision)
        scratch = kernel_scratch(shape, d, dev)
        # every field but sm_free (the last), which picks the kernel
        tensors = list(pf[:-1]) + list(state) + list(out) + scratch
        ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.saa_admm_f_chunk(
            ptrs, len(tensors), d.M, d.K, d.n, d.n_fc, chunk,
            SWEEP_PRECISIONS.index(sweep_precision), int(bool(pf.sm_free)),
            stream,
        )
        if err != 0:
            raise cuda_error(lib, "saa_admm_f", err)
        admm_chunk_f.launches += 1
    return out, scratch, shape


def _on_kernel_device(pf: ScaledSAAF, sweep_precision: str) -> bool:
    """True for CUDA tensors (the kernel), False for CPU tensors (the plain
    version); any other device raises."""
    check_sweep_precision(sweep_precision)
    if pf.G2.device.type not in ("cuda", "cpu"):
        raise ValueError(f"admm_chunk_f: no kernel for device {pf.G2.device}")
    return pf.G2.device.type == "cuda"


def admm_chunk_f(pf: ScaledSAAF, state: ScaledStateF, d: KernelDims,
                 chunk: int, sweep_precision: str = "highest") -> ScaledStateF:
    """Run `chunk` scaled ADMM iterations in the F layout
    (saa_admm_f.py:admm_chunk_pallas_f).

    CUDA tensors launch the hand-written kernel (csrc/saa_admm_f.cu) and
    count one launch; a CPU tensor runs `one_iter_ref_f`; any other device
    raises."""
    if _on_kernel_device(pf, sweep_precision):
        return _kernel_chunk(pf, state, d, chunk, sweep_precision)[0]
    for _ in range(chunk):
        state = one_iter_ref_f(pf, state, d, sweep_precision)
    return state


admm_chunk_f.launches = 0


def admm_step_f(pf: ScaledSAAF, state: ScaledStateF, d: KernelDims,
                sweep_precision: str = "highest") -> StepF:
    """One iteration as `admm_chunk_f` runs it (a CUDA tensor launches the
    kernel and counts it in admm_chunk_f.launches), with what its sweeps
    worked on, read from the kernel's scratch (`kernel_checks.sweep_errs_f`
    holds them to each precision's arithmetic)."""
    if not _on_kernel_device(pf, sweep_precision):
        return step_ref_f(pf, state, d, sweep_precision)
    out, scratch, shape = _kernel_chunk(pf, state, d, 1, sweep_precision)
    partials, y_t, v = scratch[0], scratch[3], scratch[4]
    return StepF(out, partials.view(-1, shape.partial_width)[:, : d.n], v, y_t)


class _Flat:
    """How the chunked solve talks to kernel B2: the F layout, keeping G2
    and G2T across rho refactorizations (saa_admm_f.py:552-559)."""

    @staticmethod
    def problem(p: ScaledSAA, d: KernelDims, prev=None) -> ScaledSAAF:
        if prev is None:
            return to_f(p, d)
        return to_f(p, d, G2=prev.G2, G2T=prev.G2T)

    state_in = staticmethod(state_to_f)
    state_out = staticmethod(f_to_state)

    @staticmethod
    def run(pf, s, d, chunk, cfg):
        return admm_chunk_f(pf, s, d, chunk, cfg.sweep_precision)


def solve_saa_qp_pallas_f(
    st: SAAQPStatic,
    data: SAAQPData,
    scp_iter: int,
    cfg,
    x0=None,
    y0=None,
    ruiz_iters: int = 5,
    chunk: int = 25,
    rho0=None,
) -> admm_mod.QPSolution:
    """The '_admm-pallas-f' solve (saa_admm_f.py:443-593): the chunked
    solve of ops/cuda/saa_admm.py with kernel B2, 25 iterations per call,
    the sweeps (and the residual checks and polish) at cfg.sweep_precision.
    Float32 only."""
    return solve_chunked(st, data, scp_iter, cfg, _Flat, x0=x0, y0=y0,
                         ruiz_iters=ruiz_iters, chunk=chunk, rho0=rho0)
