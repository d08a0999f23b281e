"""SCP driver: the sequential-convex-programming loop.

The counterpart of ``riskaversetrajopt_tpu/scp/driver.py``. One SCP
iteration = linearize (batched rollout + forward-mode Jacobians) + pack
(structured epigraph) + QP solve, warm-started from the previous QP. The
loop is a Python loop over iterations; the iterates stay on the device.

Backends: 'admm' (the structured ADMM of ops/admm.py), 'ipm' (the
interior-point method of ops/ipm.py), 'hybrid' (IPM then warm ADMM on the
first post-gating QPs, ADMM after), 'admm-ir' (ADMM + iterative refinement,
ops/qp_refine.py), '_hybrid-prox' (a capped ADMM leg, rescued by a proximal
IPM), '_admm-pallas' (the fused-kernel ADMM of ops/cuda/saa_admm.py) and
'_admm-pallas-f' (the lane-flat fused-kernel ADMM of
ops/cuda/saa_admm_f.py); the two fused backends are float32 only. 'admm-ds'
runs the ADMM with double-single iterates of ops/admm_ds.py.

Entry points: `solve` (with mid-solve checkpoint and resume), `solve_many`
(independent instances one after another) and `solve_instrumented` (the
reference's define/solve timing harness).

Sample-sharded runs (`group`, a torch.distributed process group): each
process passes its slice of the omegas (parallel/distributed.py), the
define phase stays local, the QP is solved sample-sharded
(ops/saa_qp.py) and the controls, t, the L2 errors and the Monte-Carlo
statistics come out the same on every process; `xs` holds this process's
samples. Every backend runs sharded but the two fused ones, whose kernels
the reference never splits over the sample axis (`_FUSED_UNSHARDED`). A
sharded solve's checkpoint has the unsharded file layout: process 0 writes
the gathered warm starts, and every process resumes from its slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from riskaversetrajopt_torch.core.config import SCPConfig, SolverConfig
from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.ops.admm_ds import solve_saa_qp_ds
from riskaversetrajopt_torch.ops.cvar import avar
from riskaversetrajopt_torch.ops.ipm import IPMConfig, solve_qp_ipm
from riskaversetrajopt_torch.ops.qp_refine import (
    IRConfig,
    _ProxOps,
    solve_saa_qp_ir,
)
from riskaversetrajopt_torch.ops.rollout import linearize_batch, rollout_batch
from riskaversetrajopt_torch.ops.saa_qp import (
    SAAQPOps,
    SAAQPStatic,
    build_bounds,
    build_objective,
    gather_warm,
    local_warm,
    pack_saa_qp_data,
    solve_saa_qp,
)
from riskaversetrajopt_torch.parallel.distributed import SampleShard, group_size
from riskaversetrajopt_torch.utils import checkpoint as ckpt
from riskaversetrajopt_torch.utils.profiling import annotate

_BACKENDS = ("admm", "ipm", "hybrid", "admm-ir", "admm-ds", "_hybrid-prox",
             "_admm-pallas", "_admm-pallas-f")
_FUSED = ("_admm-pallas", "_admm-pallas-f")
_FUSED_UNSHARDED = (
    "{!r} does not run sample-sharded: the reference has no sharded form of "
    "its fused kernel (the pallas_call sits under no shard_map, so GSPMD "
    "cannot split it over the sample axis), and a sharded chunk would need "
    "a collective inside the kernel; drop `group`, or shard with 'admm', "
    "'ipm', 'hybrid', 'admm-ir', 'admm-ds' or '_hybrid-prox'")
# the backends whose QPSolution.rho is an adapted ADMM rho, carried into the
# next QP; the others carry the previous rho on. The JAX driver keeps two
# lists: solve and solve_many carry 'admm-ds''s rho (driver.py:550),
# solve_instrumented does not (driver.py:698)
_RHO_BACKENDS = ("admm", "admm-ds", "_admm-pallas", "_admm-pallas-f")
_RHO_BACKENDS_INSTRUMENTED = ("admm", "_admm-pallas", "_admm-pallas-f")
# public JAX names that refuse with a pointer to the opt-in name
# (driver.py:281-292, 338-347)
_REFUSED = {
    "hybrid-prox": "'hybrid-prox' is experimental and fails at "
                   "M=1000/f32; use qp_backend='admm-ir' for certified tight "
                   "tolerances, or opt into the experimental backend as "
                   "'_hybrid-prox'",
    "admm-pallas": "'admm-pallas' is experimental; opt in explicitly with "
                   "qp_backend='_admm-pallas', or use 'admm'",
    "admm-pallas-f": "'admm-pallas-f' is experimental; opt in explicitly "
                     "with qp_backend='_admm-pallas-f', or use 'admm'",
}


class SCPResult(NamedTuple):
    us: torch.Tensor  # (S, n_u) final controls
    xs: torch.Tensor  # (M, S+1, n_x) trajectories under the final controls
    t_risk: torch.Tensor  # CVaR epigraph t at the last iteration
    l2_errors: torch.Tensor  # (num_iters,) relative control-update errors
    qp_iters: torch.Tensor  # (num_iters,) solver iterations per SCP step
    qp_solved: torch.Tensor  # (num_iters,) solver convergence flags
    us_history: torch.Tensor  # (num_iters, S, n_u)


def l2_error_us(us_mat, us_mat_prev):
    """Relative L2 control-update error (car/driving.py:459-464)."""
    err = torch.mean(torch.linalg.norm(us_mat - us_mat_prev, dim=-1))
    return err / torch.mean(torch.linalg.norm(us_mat, dim=-1))


class SAATrajOpt:
    """User-facing facade bundling a model with solver/SCP configuration.

    It runs on the card unless `device` names another (``device="cpu"``);
    the model is moved there. Typical use:
        opt = SAATrajOpt(DroneModel())
        omegas = opt.sample(torch.Generator("cuda").manual_seed(0), M=1000)
        res = opt.solve(omegas, alpha=0.2)
    """

    def __init__(
        self,
        model,
        method: str = "saa",
        scp_cfg: Optional[SCPConfig] = None,
        qp_backend: str = "admm",
        ipm_cfg: Optional[IPMConfig] = None,
        admm_cfg: Optional[SolverConfig] = None,
        ir_cfg: Optional[IRConfig] = None,
        hybrid_cap: int = 3000,
        hybrid_prox: float = 1e-3,
        slack_penalty: Optional[float] = None,
        baseline_pad: float = 0.0,
        dtype=torch.float64,
        device=None,
        group=None,
    ):
        if qp_backend in _REFUSED:
            raise ValueError(_REFUSED[qp_backend])
        if qp_backend not in _BACKENDS:
            raise ValueError(f"unknown qp backend {qp_backend!r}")
        if group is not None and qp_backend in _FUSED:
            raise ValueError(_FUSED_UNSHARDED.format(qp_backend))
        if qp_backend in _FUSED and dtype != torch.float32:
            raise ValueError(
                f"{qp_backend!r} runs a float32 fused kernel; pass "
                f"dtype=torch.float32 (got {dtype})"
            )
        self.method = method
        self.qp_backend = qp_backend
        # tol 1e-5 (relative merit): ~100x tighter than the reference's
        # OSQP_TOL and reliably attainable on the degenerate epigraph QPs
        self.ipm_cfg = ipm_cfg or IPMConfig(tol=1e-5, max_iter=40)
        # eps 1e-6, polish off, one KKT refinement pass: the golden-tracking
        # defaults of the JAX driver (driver.py:99-129 gives the measurements)
        self.admm_cfg = admm_cfg or SolverConfig(
            eps_abs=1e-6, eps_rel=1e-6, max_iter=20000,
            polish=False, kkt_refine_iters=1,
        )
        self.ir_cfg = IRConfig() if ir_cfg is None else ir_cfg
        # '_hybrid-prox': the ADMM legs' iteration cap and the proximal
        # weight of the rescue IPM
        self.hybrid_cap = hybrid_cap
        self.hybrid_prox = hybrid_prox
        if self.admm_cfg.eps_sched_iters > 0 and qp_backend != "admm":
            raise ValueError(
                "SolverConfig.eps_sched_iters is only implemented for the "
                f"'admm' backend (got {qp_backend!r})"
            )
        self.dtype = dtype
        self.device = resolve_device(device)
        # the process group over which the samples are split (None: this
        # process holds them all)
        self.group = group
        self.model = model.to(self.device, dtype)
        scn = model.scn
        n = model.S * model.n_u
        if scp_cfg is None:
            scp_cfg = model.default_scp_config()
        self.scp_cfg = scp_cfg
        # objective diagonal: 2*dt*R per step (car/driving.py:375-389)
        self.p_diag_u = (2.0 * model.dt * torch.diagonal(scn.R)).repeat(
            model.S).to(self.device, dtype)
        self.static = SAAQPStatic(
            n=n,
            M=-1,  # filled in per solve (depends on the sample count)
            K=model.K,
            n_fc=model.n_fc,
            n_x=model.n_x,
            row_scale=model.row_scale,
            slack_penalty=(
                slack_penalty if slack_penalty is not None
                else model.slack_penalty
            ),
            u_max=float(scn.u_max),
            baseline=(method == "baseline"),
            baseline_pad=baseline_pad,
            gate_iters=scp_cfg.gate_iters,
            gate_scale=scp_cfg.gate_row_scale,
            gate_l=scp_cfg.gate_bound_l,
            gate_u=scp_cfg.gate_bound_u,
        )

    # -- sampling ----------------------------------------------------------
    def sample(self, generator: torch.Generator, M: int,
               method: Optional[str] = None):
        return self.model.sample(generator, M, method or self.method)

    # -- one SCP iteration (define + solve) --------------------------------
    def _static_for(self, M: int) -> SAAQPStatic:
        return self.static._replace(M=M)

    def _shard(self, M_local: int):
        """This process's SampleShard of a sharded solve whose omegas hold
        M_local samples here, or None."""
        if self.group is None:
            return None
        return SampleShard(M_local * group_size(self.group), self.group)

    def _define(self, us_prev, omegas, alpha, shard=None):
        lin = linearize_batch(self.model, us_prev, omegas)
        return pack_saa_qp_data(lin, us_prev.reshape(-1), self.p_diag_u, alpha,
                                shard)

    def _warm_rho(self, warm, scp_iter: int):
        """The previous QP's adapted rho (OSQP keeps rho in its workspace
        across the reference's SCP loop, drone_risk.py:443-452), except at
        the gating transition, where the subproblem changes structurally and
        the solve restarts from cfg.rho (driver.py:203-220)."""
        if warm is None or not self.admm_cfg.rho_warm_start:
            return None
        if scp_iter == self.scp_cfg.gate_iters:
            return torch.tensor(self.admm_cfg.rho, dtype=self.dtype,
                                device=self.device)
        return warm[2]

    def _solve_qp(self, st, data, scp_iter: int, warm=None, shard=None):
        x0 = warm[0] if warm is not None else None
        y0 = warm[1] if warm is not None else None
        rho0 = self._warm_rho(warm, scp_iter)
        if self.qp_backend == "_admm-pallas":
            from riskaversetrajopt_torch.ops.cuda import saa_admm

            return saa_admm.solve_saa_qp_pallas(
                st, data, scp_iter, self.admm_cfg, x0=x0, y0=y0, rho0=rho0,
            )
        if self.qp_backend == "_admm-pallas-f":
            from riskaversetrajopt_torch.ops.cuda import saa_admm_f

            return saa_admm_f.solve_saa_qp_pallas_f(
                st, data, scp_iter, self.admm_cfg, x0=x0, y0=y0, rho0=rho0,
            )
        if self.qp_backend == "ipm":
            return self._ipm_solve(st, data, scp_iter, shard)
        if self.qp_backend == "admm-ir":
            return solve_saa_qp_ir(st, data, scp_iter, self.admm_cfg,
                                   ir=self.ir_cfg, x0=x0, y0=y0, shard=shard)
        if self.qp_backend == "_hybrid-prox":
            return self._hybrid_prox_solve(st, data, scp_iter, x0, y0, shard)
        if self.qp_backend == "admm-ds":
            # double-single iterates, which track the float64 solution
            # branch through the degenerate post-gating QPs; the eps
            # schedule does not apply (driver.py:265-280)
            return solve_saa_qp_ds(st, data, scp_iter, self.admm_cfg, x0=x0,
                                   y0=y0, rho0=rho0,
                                   ds_kkt_passes=self.admm_cfg.ds_kkt_passes,
                                   shard=shard)
        if (self.qp_backend == "hybrid"
                and scp_iter < self.scp_cfg.gate_iters + 3):
            # the first post-gating QPs: Mehrotra reaches the solution's
            # basin in a few dozen iterations, and ADMM warm-started from
            # its point (with cfg.rho) certifies it and keeps the
            # prox-to-previous-iterate behavior (driver.py:402-422)
            si = self._ipm_solve(st, data, scp_iter, shard)
            return solve_saa_qp(st, data, scp_iter, self.admm_cfg, x0=si.x,
                                y0=si.y, shard=shard)
        eps_scale = None
        if self.admm_cfg.eps_sched_iters > 0:
            # inexact-SCP tolerance schedule: early subproblems terminate at
            # factor * eps (they only seed the next linearization)
            eps_scale = (self.admm_cfg.eps_sched_factor
                         if scp_iter < self.admm_cfg.eps_sched_iters else 1.0)
        return solve_saa_qp(st, data, scp_iter, self.admm_cfg, x0=x0, y0=y0,
                            rho0=rho0, eps_scale=eps_scale, shard=shard)

    def _ipm_solve(self, st, data, scp_iter: int, shard=None):
        """The interior-point solve of one SCP subproblem."""
        _, q = build_objective(st, data)
        l, u = build_bounds(st, data, scp_iter, shard)
        return solve_qp_ipm(SAAQPOps(st, data, scp_iter, shard=shard), q, l, u,
                            n_eq=st.n_fc, cfg=self.ipm_cfg)

    def _hybrid_prox_solve(self, st, data, scp_iter: int, x0, y0,
                           shard=None):
        """'_hybrid-prox' (driver.py:348-400): an ADMM leg capped at
        hybrid_cap iterations keeps the warm path; if it does not certify, a
        proximal IPM centered at its iterate finds (about) the projection of
        that iterate onto the optimal face, and a second capped ADMM leg
        certifies the result. Validated in JAX at small M only."""
        quick_cfg = dataclasses.replace(self.admm_cfg, max_iter=self.hybrid_cap,
                                        polish=False)
        s1 = solve_saa_qp(st, data, scp_iter, quick_cfg, x0=x0, y0=y0,
                          shard=shard)
        if s1.solved:
            return s1
        ops = SAAQPOps(st, data, scp_iter,
                       kkt_refine_iters=self.admm_cfg.kkt_refine_iters,
                       shard=shard)
        _, q = build_objective(st, data)
        l, u = build_bounds(st, data, scp_iter, shard)
        sig = torch.tensor(self.hybrid_prox, dtype=self.dtype,
                           device=self.device)
        si = solve_qp_ipm(_ProxOps(ops, sig), q - sig * s1.x, l, u,
                          n_eq=st.n_fc, cfg=self.ipm_cfg)
        fin_cfg = dataclasses.replace(self.admm_cfg, max_iter=self.hybrid_cap)
        s2 = solve_saa_qp(st, data, scp_iter, fin_cfg, x0=si.x, y0=si.y,
                          shard=shard)
        return s2._replace(iters=s1.iters + si.iters + s2.iters)

    # -- full SCP solve ----------------------------------------------------
    def solve(
        self,
        omegas,
        alpha,
        M: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 1,
    ) -> SCPResult:
        """Run the full SCP loop (fixed iteration count, reference semantics:
        convergence is monitored but not used for termination,
        car/driving.py:500-513).

        `checkpoint_path` enables mid-solve checkpoint and resume
        (driver.py:426-477): every `checkpoint_every`-th SCP iteration, and
        the last, snapshots (iteration, us, ADMM warm starts, adapted rho)
        to the file, and a call with an existing file resumes at the
        recorded iteration from the saved iterate. The resumed result's
        per-iteration arrays (l2_errors, qp_iters, ...) cover only the
        remaining iterations. Sharded (`group`), the file has the unsharded
        layout (process 0 writes it, every process waits for the write)
        and every process resumes from its samples' slice of it, so a
        sharded solve resumes from an unsharded one's file and the other
        way round."""
        if M is None:
            M = omegas[0].shape[0]
        if checkpoint_path is None:
            return self._solve_core(omegas, alpha, M)
        start_iter, resume = self._load_checkpoint(checkpoint_path)
        return self._solve_core(
            omegas, alpha, M, start_iter=start_iter,
            ckpt=(checkpoint_path, int(checkpoint_every)), resume=resume,
        )

    def _load_checkpoint(self, path):
        """(iteration to resume at, (us, warm)) from a snapshot file, or
        (0, None) when there is none; the saved arrays are cast to the
        driver's dtype and device."""
        saved = ckpt.load(path)
        if saved is None:
            return 0, None
        kw = dict(dtype=self.dtype, device=self.device)
        rho = self.admm_cfg.rho if saved.warm_rho is None else saved.warm_rho
        return saved.scp_iter, (
            torch.as_tensor(saved.us).to(**kw),
            (torch.as_tensor(saved.warm_x).to(**kw),
             torch.as_tensor(saved.warm_y).to(**kw),
             torch.tensor(rho, **kw)),
        )

    def _save_checkpoint(self, path, scp_iter: int, us, warm, st, shard):
        """Snapshot the SCP state; sharded, process 0 writes the global
        warm starts and every process waits on the host for the file
        (SampleShard.barrier: an all-reduce alone would not wait with
        NCCL)."""
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        x, y = warm[0], warm[1]
        if shard is not None:
            x, y = gather_warm(st, shard, x, y)
        if shard is None or shard.rank == 0:
            ckpt.save(path, scp_iter, host(us), host(x), host(y),
                      warm_rho=host(warm[2]))
        if shard is not None:
            # no process goes on (and may read the file) before it is in
            # place: process 0 joins this host-side wait after the rename
            shard.barrier(x.device)

    def _cold_warm(self, st: SAAQPStatic):
        kw = dict(dtype=self.dtype, device=self.device)
        return (
            torch.zeros(st.n + st.M + 2, **kw),
            torch.zeros(st_total_rows(st), **kw),
            torch.tensor(self.admm_cfg.rho, **kw),
        )

    def _cast_omegas(self, omegas):
        kw = dict(dtype=self.dtype, device=self.device)
        return type(omegas)(*(torch.as_tensor(x).to(**kw) for x in omegas))

    # -- many independent instances -----------------------------------------
    def solve_many(self, omegas, alphas, M: Optional[int] = None) -> SCPResult:
        """Solve B independent problem instances one after another, each at
        its own convergence schedule (driver.py:480-511, the reference's
        alpha x repeat sweep axis, drone_risk.py:498-503). `omegas` fields
        carry a leading (B, ...) axis and `alphas` is (B,). Returns an
        SCPResult with a leading (B, ...) axis on every field, each instance
        bit for bit its own `solve`."""
        if M is None:
            M = omegas[0].shape[1]
        alphas = torch.as_tensor(alphas, dtype=self.dtype).tolist()
        results = [
            self._solve_core(type(omegas)(*(x[i] for x in omegas)), a, M)
            for i, a in enumerate(alphas)
        ]
        return SCPResult(*(torch.stack(f) for f in zip(*results)))

    def _solve_core(self, omegas, alpha, M: int, start_iter: int = 0,
                    ckpt=None, resume=None, phase=None,
                    rho_backends=_RHO_BACKENDS) -> SCPResult:
        """The SCP loop over omegas of M samples (this process's, sharded).
        `phase(name)`, where given, is a context manager around each
        iteration's "define" and "solve" (solve_instrumented's timer);
        `rho_backends` lists the backends whose adapted rho is carried into
        the next QP."""
        phase = phase or (lambda name: contextlib.nullcontext())
        omegas = self._cast_omegas(omegas)
        alpha = torch.as_tensor(alpha, dtype=self.dtype, device=self.device)
        shard = self._shard(M)
        st = self._static_for(M if shard is None else shard.M)
        n = st.n
        us_prev = self.model.initial_guess()
        warm = self._cold_warm(st._replace(M=M))
        if resume is not None:
            us_prev, warm = resume
            if shard is not None:
                warm = (*local_warm(st, shard, warm[0], warm[1]), warm[2])
        t_risk = warm[0][-1]
        l2s, qp_iters, qp_solved, us_hist = [], [], [], []
        for scp_iter in range(start_iter, self.scp_cfg.num_iters):
            with phase("define"):
                data = self._define(us_prev, omegas, alpha, shard)
            with phase("solve"):
                sol = self._solve_qp(st, data, scp_iter, warm, shard)
            us = sol.x[:n].reshape(self.model.S, self.model.n_u).to(self.dtype)
            l2s.append(l2_error_us(us, us_prev))
            t_risk = sol.x[-1]
            qp_iters.append(sol.iters)
            qp_solved.append(sol.solved)
            us_hist.append(us)
            rho = (sol.rho.to(self.dtype) if self.qp_backend in rho_backends
                   else warm[2])
            warm = (sol.x, sol.y, rho)
            us_prev = us
            if ckpt is not None:
                path, every = ckpt
                done = scp_iter + 1
                if done % every == 0 or done == self.scp_cfg.num_iters:
                    self._save_checkpoint(path, done, us, warm, st, shard)
        xs = rollout_batch(self.model, us_prev, omegas)
        kw = dict(dtype=self.dtype, device=self.device)
        return SCPResult(
            us=us_prev,
            xs=xs,
            t_risk=t_risk,
            l2_errors=torch.stack(l2s) if l2s else torch.zeros(0, **kw),
            qp_iters=torch.tensor(qp_iters, dtype=torch.int64),
            qp_solved=torch.tensor(qp_solved, dtype=torch.bool),
            us_history=(torch.stack(us_hist) if us_hist else
                        torch.zeros(0, self.model.S, self.model.n_u, **kw)),
        )

    # -- instrumented solve: define/solve timing split ----------------------
    def solve_instrumented(self, omegas, alpha, M: Optional[int] = None,
                           checkpoint_path: Optional[str] = None):
        """SCP loop with the define and solve phases timed apart, the
        reference's timing harness (car/driving.py:482-513, driver.py:612-719):
        per SCP iteration a define time and a solve time, each closed by a
        device synchronize on the card, the cumulative time and the L2
        error. One warm-up define and solve run first (car/driving.py:
        474-480; here they build the kernel library). The phases are marked
        `define` and `solve` for utils.profiling.trace. With
        `checkpoint_path` it resumes from an existing snapshot and saves one
        after every iteration. The loop is `solve`'s (_solve_core)."""
        if M is None:
            M = omegas[0].shape[0]
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda device: None)
        # warm-up pass (reference: car/driving.py:474-480)
        shard = self._shard(M)
        st = self._static_for(M if shard is None else shard.M)
        us0 = self.model.initial_guess()
        om = self._cast_omegas(omegas)
        a = torch.as_tensor(alpha, dtype=self.dtype, device=self.device)
        self._define(us0, om, a, shard)
        sync(self.device)
        self._solve_qp(st, self._define(us0, om, a, shard), 0,
                       self._cold_warm(st._replace(M=M)), shard)
        sync(self.device)

        times = {"define": [], "solve": []}

        @contextlib.contextmanager
        def phase(name):
            t0 = time.perf_counter()
            with annotate(name):
                yield
                sync(self.device)
            times[name].append(time.perf_counter() - t0)

        start_iter, resume, ckpt = 0, None, None
        if checkpoint_path is not None:
            start_iter, resume = self._load_checkpoint(checkpoint_path)
            ckpt = (checkpoint_path, 1)
        res = self._solve_core(omegas, alpha, M, start_iter, ckpt, resume,
                               phase, rho_backends=_RHO_BACKENDS_INSTRUMENTED)
        define_times = np.array(times["define"])
        solve_times = np.array(times["solve"])
        return {
            "us": res.us,
            "xs": res.xs,
            "define_times": define_times,
            "solve_times": solve_times,
            "cum_times": np.cumsum(define_times + solve_times),
            "l2_errors": res.l2_errors.double().cpu().numpy(),
        }

    # -- Monte-Carlo validation oracle -------------------------------------
    def monte_carlo(self, us, omegas, alpha, tol: Optional[float] = None):
        """Out-of-sample validation (driver.py:721-762): per-sample max
        constraint minus tol <= 1e-6 => safe; returns the safe fraction, the
        AVaR of the max-constraint statistic and the control cost. The
        default tol is OSQP_TOL, as car/driving.py:636 and
        drone/drone_risk.py:660 feed `max(g) - OSQP_TOL` to both tests.
        Sharded (`group`), `omegas` are this process's slice and the M
        constraint values are gathered on every process."""
        model = self.model
        us = torch.as_tensor(us).to(dtype=self.dtype, device=self.device)
        omegas = self._cast_omegas(omegas)
        tol = model.scn.osqp_tol if tol is None else tol
        xs = rollout_batch(model, us, omegas)
        max_cons = torch.amax(model.ineq_constraints(xs, omegas), dim=-1) - tol
        shard = self._shard(max_cons.shape[0])
        if shard is not None:
            max_cons = shard.gather(max_cons)
        safe = torch.mean((max_cons <= 1e-6).to(self.dtype))
        return {
            "safe_frac": safe,
            "avar": avar(max_cons, alpha),
            "cost": model.control_cost(us),
            "max_constraints": max_cons,
        }


def st_total_rows(st: SAAQPStatic) -> int:
    return st.n_fc + 1 + st.M + st.M * st.K + 1 + st.n
