"""How the hand-written kernels are held to their plain PyTorch versions;
shared by chip_smoke.py and tests/test_torch_cuda_kernels.py.

- `state_err`: max over the fields of two iterates of |a - b| / (1 + |b|),
  the measure every kernel-vs-plain comparison of whole iterations is held
  to (2e-2: float32 sums in another order, amplified by the 1e3 rho of the
  equality rows).
- `step_err_f`: one iteration of kernel B2 against one plain iteration from
  the same state, in that measure. At sweep precision "default" both round
  u_t to bf16 for sweep 2, but each computes u_t in float32 with its own
  order of sums; where the two round to different bf16 values (and only
  there) the sample rows may move by that bf16 step, and that much is
  allowed for.
- `epigraph_err`: the CVaR-epigraph variables s and t and the y, each
  against its own scale. On the car's gated structure (sm_free) the state
  measure is set by the float32 noise of the equality-row duals, and reads
  the same for a kernel whose free-row KKT form is wrong; these fields,
  which that form computes, are where a fault shows.
- `free_row_errs`: one kernel iteration of the free-row (sm_free) form from
  built states against one float64 plain iteration from the same states,
  on the CVaR row. `epigraph_err` cannot see the beta c2 terms of that
  form: on the car's gated structure they move s, t and y by 1e-5 of
  their scale over 25-100 iterations, under the float32 noise of two
  orders of sums (1.7e-4). Here states with large s and t make c2 =
  cs_hat s_t + ct_hat t_t large, the reference carries no float32 noise,
  and the CVaR row is where the y-block solve's c2 terms land.
- `sweep_errs_f` / `check_sweeps_f`: the two sweeps of one B2 iteration
  against float64 arithmetic of each sweep precision on the kernel's own
  operands. The state measure cannot tell the precisions apart: the
  solve's float32 noise, amplified by rho, reads up to ~1e-2 from one state
  whatever the precision. This one can: each sweep must lie within
  SWEEP_TOL of its own precision's arithmetic, and at most SWEEP_RATIO as
  far from it as from any other precision's, so a kernel that computes
  another precision than it was asked for fails.
"""

from __future__ import annotations

import torch

from riskaversetrajopt_torch.ops.cuda.saa_admm import (
    KernelDims,
    ScaledSAA,
    ScaledState,
    init_scaled_state,
    one_iter_ref,
)
from riskaversetrajopt_torch.ops.cuda.saa_admm_f import (
    ScaledSAAF,
    ScaledStateF,
    StepF,
    step_ref_f,
)
from riskaversetrajopt_torch.ops.saa_qp import SWEEP_PRECISIONS, _bf16

# `sweep_errs_f` of a step at its own precision: at most SWEEP_TOL, and at
# most SWEEP_RATIO times its error at any other precision. Float32 rounding
# of the sums reads 1e-8 (sweep 2) to 1e-6 (sweep 1 of a plain float32
# matmul); "high" and "highest" differ by ~1e-6 (sweep 2) and ~3e-6 (sweep
# 1), "default" and the others by ~1e-3.
SWEEP_TOL, SWEEP_RATIO = 1e-5, 0.5


def state_err(a, b, allow=None):
    """Max over fields of |a - b| / (1 + |b|), and of |a - b|, after taking
    `allow[name]` (elementwise) off the difference of the fields it names.
    Raises if a field of `a` is not finite."""
    rel = abs_ = 0.0
    for name, x, y in zip(b._fields, a, b):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"field {name} is not finite")
        diff = torch.abs(x - y)
        if allow and name in allow:
            diff = torch.clamp(diff - allow[name], min=0.0)
        rel = max(rel, float(torch.max(diff / (1.0 + torch.abs(y)))))
        abs_ = max(abs_, float(torch.max(diff)))
    return rel, abs_


# `epigraph_err` of a kernel against its plain version on the car's
# structure (chip_smoke.py phase 7, the GPU tests). Two correct float32
# orders of sums read <= 1.7e-4 there (B1 and B2 "highest"/"high", scp_iter
# 0 and 3, 25-100 iterations); a kernel with the sign of wD B1 in X1
# flipped reads 2.8e-3-3.4e-3 (PERF.md).
EPIGRAPH_TOL = 1e-3


def epigraph_err(a, b):
    """Max over the fields s, t and y of two iterates of
    max |a - b| / max |b|: inf where a is not finite, or b is 0 and a is
    not."""
    err = 0.0
    for name in ("s", "t", "y"):
        x, y = getattr(a, name), getattr(b, name)
        if not bool(torch.isfinite(x).all()):
            return float("inf")
        diff = float(torch.max(torch.abs(x - y)))
        scale = float(torch.max(torch.abs(y)))
        err = max(err, diff / scale if scale > 0 else
                  (float("inf") if diff > 0 else 0.0))
    return err


# `free_row_errs` of a correct kernel is at most FREE_ROW_TOL. On the
# car's structure (M=12 and 50) at scp_iter 0 and, with the free-row form
# forced, at 3, the float32 plain iteration reads <= 3.1e-4 and a float32
# model of the kernel's three phases <= 5.1e-4; with a planted fault (the
# sign of wD B1 in X1, beta c2 dropped from kappa2 or from cv) that model
# reads >= 6.5e-2 (CPU runs; the card's readings in PERF.md).
FREE_ROW_TOL = 5e-3
# the states: normal entries from CPU generators with these seeds, s and t
# scaled by FREE_ROW_ST so that the beta c2 terms dominate
FREE_ROW_SEEDS, FREE_ROW_ST = (0, 1, 2), 1e3


def free_row_state(p: ScaledSAA, seed: int) -> ScaledState:
    """A float32 state of p's shapes on p's device: standard normal entries
    (CPU generator seeded `seed`), s and t times FREE_ROW_ST."""
    g = torch.Generator().manual_seed(seed)
    s = type(init_scaled_state(p))(*(
        torch.randn(x.shape, generator=g, dtype=torch.float32).to(x.device)
        for x in init_scaled_state(p)))
    return s._replace(s=s.s * FREE_ROW_ST, t=s.t * FREE_ROW_ST)


def free_row_ref(p: ScaledSAA, s: ScaledState, d: KernelDims) -> ScaledState:
    """One plain iteration from `s` in float64 (p's float32 values, exact
    in float64): the free-row form's algebra without float32 rounding."""
    f64 = lambda nt: type(nt)(*(x.double() for x in nt))  # noqa: E731
    return one_iter_ref(f64(p), f64(s), d)


def free_row_err(a: ScaledState, b: ScaledState, d: KernelDims) -> float:
    """max |a - b| / (1 + |b|) over the CVaR row's z and yd."""
    c = d.n_fc
    return max(float(torch.abs(x[c].double() - y[c]) / (1 + torch.abs(y[c])))
               for x, y in ((a.z_small, b.z_small), (a.yd_small, b.yd_small)))


def free_row_errs(p: ScaledSAA, d: KernelDims, step) -> float:
    """The largest free_row_err of `step` (one kernel iteration, ScaledState
    in and out) over the states of FREE_ROW_SEEDS, each against
    free_row_ref from the same state."""
    err = 0.0
    for seed in FREE_ROW_SEEDS:
        s = free_row_state(p, seed)
        err = max(err, free_row_err(step(s), free_row_ref(p, s, d), d))
    return err


def step_err_f(pf: ScaledSAAF, s: ScaledStateF, step: StepF, d,
               precision: str):
    """`state_err` of one iteration `step` from state `s` (admm_step_f)
    against one plain iteration from `s` at `precision`. At "default" a
    sample row f may differ by alpha sum_j |G2[f, j]| |bf16(u_k[j]) -
    bf16(u_p[j])| in z (2 rv times that in yd), u_k and u_p the two u_t:
    zero wherever both round u_t alike."""
    ref = step_ref_f(pf, s, d, precision)
    allow = None
    if precision == "default":
        du = torch.abs(_bf16(step.v[: d.n]) - _bf16(ref.v[: d.n]))
        dzt = pf.alpha_relax * (torch.abs(pf.G2) @ du)
        allow = {"zG_f": dzt, "ydG_f": 2 * pf.rvG_f * dzt}
    return state_err(step.state, ref.state, allow)


def _parts(x, precision):
    """x (float32) as `precision` splits it for its products, in float64:
    [x] at "highest", [bf16 hi] at "default", [hi, bf16 lo] at "high"."""
    if precision == "highest":
        return [x.double()]
    hi = _bf16(x)
    if precision == "default":
        return [hi.double()]
    return [hi.double(), _bf16(x - hi).double()]


def _product(a, b, precision):
    """a @ b as `precision` forms it, exactly (float64): the products of the
    parts, hi*hi + hi*lo + lo*hi at "high"."""
    pa, pb = _parts(a, precision), _parts(b, precision)
    return sum(x @ y for i, x in enumerate(pa) for j, y in enumerate(pb)
               if i + j < 2)


def _rms(x):
    return float(torch.sqrt(torch.mean(x * x)))


def sweep_errs_f(pf: ScaledSAAF, s: ScaledStateF, step: StepF, d):
    """For each sweep precision Q, the errors (sweep 1, sweep 2) of one B2
    iteration `step` from state `s` against Q's arithmetic, in float64, on
    the operands the step itself used:
      sweep 1: the sum of step.u_part against w_f @ G2 at Q, w_f = rv z - yd
        of `s` (bit for bit the kernel's), per column over the root sum of
        squares of the terms w_f G2[f, j]; RMS over the columns;
      sweep 2: the sample rows of step.state against the relax/clip/dual
        update of zt = G2 u_t at Q - eGy y_t - eGt t_t, with the step's own
        u_t, y_t, t_t; z over the sum of the magnitudes that enter it, yd
        over rv times that plus |yd|; RMS over the rows."""
    f64 = torch.float64
    n, K = d.n, d.K
    w = pf.rvG_f * s.zG_f - s.ydG_f
    G = pf.G2
    rss1 = torch.sqrt((w.to(f64) ** 2) @ (G.to(f64) ** 2))
    u1 = step.u_part.to(f64).sum(0)

    u_t, t_t = step.v[:n], step.v[n + 1].to(f64)
    y_rows = step.y_t.repeat(K).to(f64)
    eGy, eGt = pf.eGy_f.to(f64), pf.eGt_f.to(f64)
    al = pf.alpha_relax.to(f64)
    z, yd = s.zG_f.to(f64), s.ydG_f.to(f64)
    rv, lb, ub = (x.to(f64) for x in (pf.rvG_f, pf.lbG_f, pf.ubG_f))
    scale_z = (al * (torch.abs(G.to(f64)) @ torch.abs(u_t.to(f64))
                     + torch.abs(eGy * y_rows) + torch.abs(eGt * t_t))
               + torch.abs((1 - al) * z) + torch.abs(yd / rv))
    scale_yd = rv * scale_z + torch.abs(yd)
    # a zero scale means zero terms, which every arithmetic sums to 0
    rss1, scale_z, scale_yd = (torch.clamp(x, min=1e-300)
                               for x in (rss1, scale_z, scale_yd))
    z_k, yd_k = step.state.zG_f.to(f64), step.state.ydG_f.to(f64)

    errs = {}
    for q in SWEEP_PRECISIONS:
        e1 = (u1 - _product(w, G, q)) / rss1
        zt = _product(G, u_t, q) - eGy * y_rows - eGt * t_t
        z_relax = al * zt + (1 - al) * z
        z_q = torch.clamp(z_relax + yd / rv, lb, ub)
        yd_q = yd + rv * (z_relax - z_q)
        e2 = torch.cat([(z_k - z_q) / scale_z, (yd_k - yd_q) / scale_yd])
        errs[q] = (_rms(e1), _rms(e2))
    return errs


def check_sweeps_f(errs, precision: str):
    """Raise unless each sweep of `errs` (sweep_errs_f of a step at
    `precision`) is within SWEEP_TOL of `precision`'s arithmetic and at most
    SWEEP_RATIO as far from it as from every other precision's."""
    for i, sweep in enumerate(("sweep 1", "sweep 2")):
        own = errs[precision][i]
        other = min(e[i] for q, e in errs.items() if q != precision)
        if not (own <= SWEEP_TOL and own <= SWEEP_RATIO * other):
            raise AssertionError(
                f"{sweep} at {precision!r} reads {own:.3e} from its own "
                f"arithmetic and {other:.3e} from the nearest other "
                f"precision's (limits {SWEEP_TOL:.0e}, ratio {SWEEP_RATIO})")
