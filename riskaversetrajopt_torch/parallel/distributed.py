"""Multi-process runtime on torch.distributed: process groups, the
sample-sharded layout and its collectives.

The counterpart of ``riskaversetrajopt_tpu/parallel/distributed.py``. The
sample axis is the data-parallel axis: each process holds M / P of the M
samples (its slice of the omegas, hence of the Jacobian stack G (M, K, n)),
and the structured solver (ops/saa_qp.py under a `SampleShard`) exchanges
only the (n+2)^2 Schur block, the CVaR couplings and O(M)-wide vectors,
never G. JAX gets this split from GSPMD; here every sum and max over the
sample axis is an explicit all-reduce over the shard's process group.

Gathers (a value over all M samples on every process: `replicate_global`,
the Monte-Carlo constraint values) are all-reduces of a zero-padded buffer,
each process writing its own slice: gloo has all-reduce for CUDA tensors
but not all-gather, and the one collective serves gloo and NCCL alike.

`initialize` uses NCCL on the card and gloo on the CPU (gloo also when
several processes share one card, which NCCL refuses). Run

    python -m riskaversetrajopt_torch.parallel.distributed --selftest \\
        --init-method tcp://localhost:PORT --world-size 2 --rank R \\
        [--device cpu] [--mode qp|batch|scp] [--omegas FILE.npz] \\
        [--backends ipm,hybrid,...] [--scp-iters N] [--model drone|car] \\
        [--checkpoint DIR]

as one worker of such a group (tests/test_torch_distributed.py and
tests/test_torch_sharded_backends.py spawn two). `--omegas` gives the scp
mode its samples (an .npz of the DroneOmega fields, M=16) in place of the
port's own sampler. `--backends` makes the scp mode solve with each of the
listed backends in turn (`--scp-iters` SCP iterations, default 3; the car
of `selftest_car_opt` with `--model car`), and `--checkpoint` adds solves
of CHECKPOINT_BACKEND checkpointed one iteration short of the end, in DIR,
and resumed to it: sharded from a sharded file and from an unsharded one.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from riskaversetrajopt_torch.models.base import resolve_device
from riskaversetrajopt_torch.ops.admm import _amax0, _amin_inf

_state = {"initialized": False, "device": None}
# collectives recorded by `audit`: (op, elements, bytes) per call
_audit_log: Optional[list] = None


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device=None) -> torch.device:
    """Join the process group (idempotent) and return this process's
    device. Arguments not given come from the standard MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK variables. The device is the card
    (cuda:<rank mod cards>) unless `device` names another; the backend is
    NCCL on the card and gloo on the CPU unless `backend` names one (gloo
    for processes that share a card). A single process (world size 1 and
    no address) joins no group. A failure to join is not caught."""
    if _state["initialized"]:
        return _state["device"]
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (rank or 0) % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is not None or world_size not in (None, 1):
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    _state.update(initialized=True, device=dev)
    return dev


def current_device() -> torch.device:
    """The device `initialize` chose, else the card (resolve_device)."""
    return _state["device"] or resolve_device(None)


def shutdown() -> None:
    """Leave the process group (if one was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(initialized=False, device=None)


def group_size(group=None) -> int:
    """Processes in `group` (the default group if None); 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def process_sample_slice(M: int, group=None) -> slice:
    """The [start, stop) range of the M samples this process owns when they
    are split in rank order over `group`."""
    size, r = group_size(group), group_rank(group)
    per = M // size
    if per * size != M:
        raise ValueError(f"M={M} not divisible by {size} processes")
    return slice(r * per, (r + 1) * per)


@contextlib.contextmanager
def audit():
    """Record every collective of the sample-sharded layout made inside the
    block: yields a list of (op, elements, bytes), one per call."""
    global _audit_log
    prev, _audit_log = _audit_log, []
    try:
        yield _audit_log
    finally:
        _audit_log = prev


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _all_reduce(t, op: str, group):
    """All-reduce `t` in place over `group` (op "sum", "max" or "min")."""
    if _audit_log is not None:
        _audit_log.append((op, t.numel(), t.numel() * t.element_size()))
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


class SampleShard:
    """This process's share of the sample axis: samples
    [offset, offset + M_local) of M, split in rank order over `group` (a
    torch.distributed process group; None, the default group), and the
    collectives over it."""

    def __init__(self, M: int, group=None):
        sl = process_sample_slice(M, group)
        self.group = group
        self.M = M
        self.offset = sl.start
        self.M_local = sl.stop - sl.start
        self.rank = group_rank(group)
        self.size = group_size(group)

    def _reduce(self, ts, op):
        flat = torch.cat([t.reshape(-1) for t in ts])
        flat = _all_reduce(flat, op, self.group)
        out, o = [], 0
        for t in ts:
            out.append(flat[o:o + t.numel()].reshape(t.shape))
            o += t.numel()
        return tuple(out)

    def sum(self, *ts):
        """Each tensor summed over the processes (one all-reduce)."""
        return self._reduce(ts, "sum")

    def max(self, *ts):
        return self._reduce(ts, "max")

    def min(self, *ts):
        return self._reduce(ts, "min")

    def ds_sum(self, *pairs):
        """Each double-single (hi, lo) pair (ops/dsjit.py) summed over the
        processes, compensated: every process writes its pairs into its own
        row of a zero-padded (P, ...) buffer, whose all-reduce is exact (one
        non-zero contributor per entry), and every process adds the P rows
        in rank order with ds_add. All-reducing hi and lo apart would lose
        the compensation. With one process the pairs come back as given."""
        from riskaversetrajopt_torch.ops.dsjit import ds_add

        flat = torch.cat([t.reshape(-1) for pair in pairs for t in pair])
        buf = torch.zeros((self.size, flat.numel()), dtype=flat.dtype,
                          device=flat.device)
        buf[self.rank] = flat
        buf = _all_reduce(buf, "sum", self.group)
        h, lo = _split_pairs(buf[0], pairs)
        for r in range(1, self.size):
            hr, lr = _split_pairs(buf[r], pairs)
            h, lo = ds_add(h, lo, hr, lr)
        out, o = [], 0
        for ph, _ in pairs:
            k = ph.numel()
            out.append((h[o:o + k].reshape(ph.shape),
                        lo[o:o + k].reshape(ph.shape)))
            o += k
        return tuple(out)

    def barrier(self, device) -> None:
        """Return once every process has called this: an all-reduce (of a
        tensor on `device`) whose value is read back on the host. The read
        is the wait: with NCCL an all-reduce only queues on the stream."""
        (t,) = self.sum(torch.ones(1, device=device))
        float(t[0])

    def gather(self, local):
        """The (M, ...) value on every process from each one's
        (M_local, ...) slice: an all-reduce of a zero-padded buffer."""
        full = torch.zeros((self.M,) + tuple(local.shape[1:]),
                           dtype=local.dtype, device=local.device)
        full[self.offset:self.offset + self.M_local] = local
        return _all_reduce(full, "sum", self.group)

    def reductions(self, n: int, n_fc: int, K: int) -> "ShardedReductions":
        """The ADMM's global reductions over the vectors of the structured
        SAA QP (ops/saa_qp.py's layout) with this process's samples."""
        return ShardedReductions(self, n, n_fc, K)


def _split_pairs(flat, pairs):
    """The hi parts and the lo parts of `pairs` as packed (hi, lo, hi, lo,
    ...) in `flat`, each concatenated."""
    his, los, o = [], [], 0
    for h, _ in pairs:
        k = h.numel()
        his.append(flat[o:o + k])
        los.append(flat[o + k:o + 2 * k])
        o += 2 * k
    return torch.cat(his), torch.cat(los)


class ShardedReductions:
    """ops/admm.LocalReductions' methods over sample-sharded vectors.
    Variables x = [u (n) | y (M_local) | s | t]; rows w = [final (n_fc) |
    CVaR | y rows (M_local) | sample rows (M_local*K) | slack | u (n)];
    "w_in" is w past its n_fc final rows. The replicated entries (u, s, t,
    the final, CVaR, slack and control rows) enter the sums on process 0
    only, so each counts once; the maxima and minima need no such care.
    Each call is one all-reduce."""

    def __init__(self, shard: SampleShard, n: int, n_fc: int, K: int):
        self.shard = shard
        Ml, first = shard.M_local, shard.rank == 0

        def mask(parts):
            return torch.cat([torch.full((k,), sharded or first)
                              for k, sharded in parts])

        keep_x = mask([(n, False), (Ml, True), (2, False)])
        keep_w = mask([(n_fc + 1, False), (Ml + Ml * K, True),
                       (1 + n, False)])
        self._keep = {"x": keep_x, "w": keep_w, "w_in": keep_w[n_fc:],
                      "xww": torch.cat([keep_x, keep_w, keep_w])}
        M = shard.M
        self._count = {"x": n + M + 2, "w": n_fc + 2 + M + M * K + n}
        self._on = {}

    def keep(self, layout, device):
        key = (layout, device)
        if key not in self._on:
            self._on[key] = self._keep[layout].to(device)
        return self._on[key]

    def _kept(self, t, layout):
        return torch.where(self.keep(layout, t.device), t,
                           torch.zeros((), dtype=t.dtype, device=t.device))

    def amax(self, *ts):
        return self.shard.max(torch.stack([_amax0(t) for t in ts]))[0]

    def amin(self, *ts):
        return self.shard.min(torch.stack([_amin_inf(t) for t in ts]))[0]

    def sum(self, *pairs):
        return self.shard.sum(torch.stack(
            [torch.sum(self._kept(t, layout)) for t, layout in pairs]))[0]

    def mean(self, t, layout):
        # the local mean weighted by its share of the global count: on one
        # process exactly torch.mean
        w = t.numel() / self._count[layout]
        return self.shard.sum(torch.mean(self._kept(t, layout)) * w)[0]

    def dots(self, *triples):
        return self.shard.sum(torch.stack(
            [torch.dot(self._kept(a, layout), b) for a, b, layout in triples]
        ))[0]

    def cross(self, A, B, layout):
        return self.shard.sum(
            torch.where(self.keep(layout, A.device), A, 0.0) @ B)[0]

    def all(self, b):
        return self.shard.max((~torch.all(b)).to(torch.int32))[0] == 0

    def any(self, b):
        return self.shard.max(torch.any(b).to(torch.int32))[0] != 0

    def gram(self, F, layout):
        return self.shard.sum(
            torch.where(self.keep(layout, F.device)[None, :], F, 0.0)
            @ F.T)[0]


def shard_samples_global(tree, M: Optional[int] = None, group=None):
    """This process's slice of the leading sample axis of every tensor or
    array of `tree` (a NamedTuple such as the omegas): every process holds
    the full value and keeps only its samples."""
    M = M if M is not None else tree[0].shape[0]
    sl = process_sample_slice(M, group)
    return type(tree)(*(torch.as_tensor(x)[sl] for x in tree))


def replicate_global(tree, M: int, group=None):
    """The full (M, ...) value of every tensor of `tree` on every process,
    from each process's slice (SampleShard.gather)."""
    shard = SampleShard(M, group)
    if isinstance(tree, torch.Tensor):
        return shard.gather(tree)
    return type(tree)(*(shard.gather(x) for x in tree))


# ---------------------------------------------------------------------------
# selftest worker (spawned by tests/test_torch_distributed.py)
# ---------------------------------------------------------------------------


def selftest_problem(M: int = 16):
    """The deterministic synthetic structured SAA QP of the JAX package's
    selftest (numpy RNG, the same numbers on every process): (static,
    data as float64 numpy arrays)."""
    from riskaversetrajopt_torch.ops.saa_qp import SAAQPData, SAAQPStatic

    n, K, n_fc = 12, 6, 4
    rng = np.random.default_rng(42)
    st = SAAQPStatic(
        n=n, M=M, K=K, n_fc=n_fc, n_x=3, row_scale=0.01,
        slack_penalty=1e4, u_max=1.0, baseline=False, baseline_pad=0.0,
        gate_iters=2, gate_scale=1e-7, gate_l=-0.1, gate_u=0.1,
    )
    data = SAAQPData(
        F=rng.standard_normal((n_fc, n)) * 0.3,
        f_rhs=rng.standard_normal(n_fc) * 0.1,
        G=rng.standard_normal((M, K, n)),
        g_up=rng.uniform(0.5, 1.5, (M, K)),
        p_diag_u=rng.uniform(0.2, 1.0, n),
        alpha=np.float64(0.2),
    )
    return st, data


SELFTEST_CFG = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=8000)
# float32 certifies at 1e-4, not at 1e-8
SELFTEST_CFG_F32 = dict(eps_abs=1e-4, eps_rel=1e-4, max_iter=8000)
SELFTEST_M = 16


def selftest_batch_instances(B: int, M: int = SELFTEST_M):
    """The batch mode's B independent instances of selftest_problem: alpha
    0.1 + 0.2 b and g_up scaled by 1 + 0.1 b (the JAX selftest's)."""
    st, data = selftest_problem(M)
    return st, [data._replace(g_up=data.g_up * (1.0 + 0.1 * b),
                              alpha=np.float64(0.1 + 0.2 * b))
                for b in range(B)]


# '_hybrid-prox' as tests/test_scp_drone.py:238-261 runs it: gate_iters 1,
# the ADMM legs capped at 1000 iterations; on the selftest omegas its second
# QP goes through the proximal IPM rescue
HYBRID_PROX_SELFTEST = dict(gate_iters=1, hybrid_cap=1000)
# the backend of the worker's checkpointed solves: warm-started from the
# saved x and y
CHECKPOINT_BACKEND = "admm-ir"


def selftest_scp_opt(device, num_iters: int = 6, group=None,
                     backend: str = "admm"):
    """The drone SCP of the scp mode (the JAX selftest's full-SCP config;
    HYBRID_PROX_SELFTEST's for '_hybrid-prox')."""
    from riskaversetrajopt_torch.core.config import DroneScenario, SCPConfig
    from riskaversetrajopt_torch.models.drone import DroneModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    prox = backend == "_hybrid-prox"
    kw = dict(hybrid_cap=HYBRID_PROX_SELFTEST["hybrid_cap"]) if prox else {}
    return SAATrajOpt(
        DroneModel(DroneScenario(), device=device), method="saa",
        scp_cfg=SCPConfig(
            num_iters=num_iters,
            gate_iters=HYBRID_PROX_SELFTEST["gate_iters"] if prox else 2,
            gate_row_scale=1e-7, gate_bound_l=-0.1, gate_bound_u=0.1),
        qp_backend=backend, device=device, group=group, **kw)


SELFTEST_CAR_M = 8


def selftest_car_opt(device, num_iters: int = 2, group=None,
                     backend: str = "admm"):
    """The car SCP of `--model car`: CarScenario(M=SELFTEST_CAR_M), its
    reference config (the first iteration gated) cut to `num_iters`."""
    import dataclasses

    from riskaversetrajopt_torch.core.config import CarScenario
    from riskaversetrajopt_torch.models.car import CarModel
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    model = CarModel(CarScenario(M=SELFTEST_CAR_M), device=device)
    return SAATrajOpt(model, scp_cfg=dataclasses.replace(
        model.default_scp_config(), num_iters=num_iters),
        qp_backend=backend, device=device, group=group)


def selftest_car_omegas(M: int = SELFTEST_CAR_M):
    """The car's omegas: the port's sampler on a CPU generator seeded 0
    (the same numbers on every process)."""
    from riskaversetrajopt_torch.core.config import CarScenario
    from riskaversetrajopt_torch.models.car import CarModel

    model = CarModel(CarScenario(M=M), device="cpu")
    return model.sample(torch.Generator().manual_seed(0), M, "saa")


def selftest_scp_omegas(M: int = SELFTEST_M, path: Optional[str] = None):
    """The scp mode's omegas: the DroneOmega fields of the .npz at `path`,
    else DroneModel.sample of the port on a CPU generator seeded 0 (the
    same numbers on every process)."""
    from riskaversetrajopt_torch.core.config import DroneScenario
    from riskaversetrajopt_torch.models.drone import DroneModel, DroneOmega

    if path is not None:
        f = np.load(path)
        return DroneOmega(*(torch.from_numpy(f[k]).to(torch.float64)
                            for k in DroneOmega._fields))
    model = DroneModel(DroneScenario(M=M), device="cpu")
    return model.sample(torch.Generator().manual_seed(0), M, "saa")


def _to(data, device, dtype=torch.float64):
    return type(data)(*(torch.as_tensor(np.asarray(x), dtype=dtype,
                                        device=device) for x in data))


def _selftest_qp(device):
    """One sample-sharded structured SAA QP of selftest_problem, in float64
    and in float32 (the compensated factorization)."""
    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.ops.saa_qp import solve_saa_qp

    st, data = selftest_problem(SELFTEST_M)
    shard = SampleShard(SELFTEST_M)
    sl = slice(shard.offset, shard.offset + shard.M_local)
    local = data._replace(G=data.G[sl], g_up=data.g_up[sl])
    out, n = {}, st.n
    for name, dtype, cfg in (("f64", torch.float64, SELFTEST_CFG),
                             ("f32", torch.float32, SELFTEST_CFG_F32)):
        with audit() as log:
            sol = solve_saa_qp(st, _to(local, device, dtype), 3,
                               SolverConfig(**cfg), shard=shard)
        y = replicate_global(sol.x[n:n + shard.M_local], SELFTEST_M)
        x = torch.cat([sol.x[:n], y, sol.x[n + shard.M_local:]])
        out[name] = {"x": x.double().cpu().tolist(), "iters": sol.iters,
                     "solved": sol.solved,
                     "collectives": collective_summary(log, sol.iters)}
    return out


def _selftest_batch(device):
    """Independent instances over the `batch` axis of a (batch = P,
    samples = 1) mesh: each process solves its instance whole, and every
    process recovers the full set (one all-reduce over the batch axis)."""
    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.ops.saa_qp import solve_saa_qp
    from riskaversetrajopt_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_sample_devices=1, n_batch_devices=group_size(),
                     device=device)
    st, inst = selftest_batch_instances(mesh.n_batch)
    cfg = SolverConfig(rho_epoch_every=50, **SELFTEST_CFG)
    sol = solve_saa_qp(st, _to(inst[mesh.batch_index], device), 3, cfg,
                       shard=mesh.sample_shard(SELFTEST_M))
    xs = mesh.gather_batch(sol.x)
    return {"xs": xs.cpu().tolist(), "iters": sol.iters}


def _selftest_scp(device, omegas=None):
    """The drone SCP (6 iterations, M=16) on sample-sharded omegas (those
    of the .npz at `omegas`, else the port's sampler's), with the
    Monte-Carlo oracle on the training samples."""
    om = selftest_scp_omegas(path=omegas)
    opt = selftest_scp_opt(device, group=dist.group.WORLD)
    local = shard_samples_global(om)
    with audit() as log:
        res = opt.solve(local, alpha=0.2)
        mc = opt.monte_carlo(res.us, local, 0.2)
    return {"us": res.us.cpu().reshape(-1).tolist(),
            "l2": res.l2_errors.cpu().tolist(),
            "qp_iters": res.qp_iters.tolist(),
            "mc_safe": float(mc["safe_frac"]), "mc_avar": float(mc["avar"]),
            "collectives": collective_summary(log, int(res.qp_iters.sum()))}


def _scp_payload(res, log):
    return {"us_history": res.us_history.cpu().reshape(-1).tolist(),
            "qp_iters": res.qp_iters.tolist(),
            "qp_solved": res.qp_solved.tolist(),
            "collectives": collective_summary(log, int(res.qp_iters.sum()))}


def selftest_ds_vector(n: int = 1024):
    """The float32 vector of the worker's compensated-sum check (numpy
    seed 7; the same numbers on every process)."""
    return torch.from_numpy(
        np.random.default_rng(7).standard_normal(n).astype(np.float32))


def _selftest_backends(device, backends, num_iters, omegas=None,
                       model="drone", checkpoint=None):
    """The SCP with each of `backends` on sample-sharded omegas (the
    drone's of scp mode, or the car's); one payload per backend: the
    control history, the QP iterations and flags, the collectives. With
    `checkpoint` (a directory) also two solves of CHECKPOINT_BACKEND
    resumed at num_iters - 1 to num_iters: "checkpoint" from a sharded
    solve's file, "from_unsharded" from the file of process 0's unsharded
    solve (each file copied aside by process 0 before the resume).
    "ds_sum" holds the compensated cross-process sum of
    selftest_ds_vector."""
    import shutil
    from pathlib import Path

    from riskaversetrajopt_torch.ops.dsjit import sum1_ds

    group = dist.group.WORLD
    if model == "car":
        om, make = selftest_car_omegas(), selftest_car_opt
    else:
        om, make = selftest_scp_omegas(path=omegas), selftest_scp_opt
    local = shard_samples_global(om)
    out = {}
    for b in backends:
        opt = make(device, num_iters, group, backend=b)
        with audit() as log:
            res = opt.solve(local, alpha=0.2)
        out[b] = _scp_payload(res, log)
    if checkpoint is not None:
        b = CHECKPOINT_BACKEND
        path = Path(checkpoint) / "sharded.npz"
        with audit() as log:
            make(device, num_iters - 1, group, backend=b).solve(
                local, alpha=0.2, checkpoint_path=path)
            if group_rank() == 0:
                shutil.copy(path, path.with_name(
                    f"sharded_iter{num_iters - 1}.npz"))
            res = make(device, num_iters, group, backend=b).solve(
                local, alpha=0.2, checkpoint_path=path)
        out["checkpoint"] = dict(_scp_payload(res, log), backend=b)
        path = Path(checkpoint) / "unsharded.npz"
        if group_rank() == 0:
            make(device, num_iters - 1, backend=b).solve(
                om, alpha=0.2, checkpoint_path=path)
            shutil.copy(path, path.with_name(
                f"unsharded_iter{num_iters - 1}.npz"))
        SampleShard(om[0].shape[0], group).barrier(device)
        with audit() as log:
            res = make(device, num_iters, group, backend=b).solve(
                local, alpha=0.2, checkpoint_path=path)
        out["from_unsharded"] = dict(_scp_payload(res, log), backend=b)
    v = selftest_ds_vector().to(device)
    shard = SampleShard(v.numel())
    ((h, lo),) = shard.ds_sum(sum1_ds(v[shard.offset:shard.offset
                                         + shard.M_local]))
    out["ds_sum"] = [float(h), float(lo)]
    return out


def collective_summary(log, iters):
    """Calls, elements and bytes of the collectives in `log` (an `audit`
    list): in all, per ADMM iteration over `iters`, the largest."""
    return {"calls": len(log), "bytes": sum(b for _, _, b in log),
            "max_elements": max((e for _, e, _ in log), default=0),
            "calls_per_iter": len(log) / max(iters, 1),
            "bytes_per_iter": sum(b for _, _, b in log) / max(iters, 1),
            "ops": sorted({op for op, _, _ in log})}


def _selftest(init_method: str, world_size: int, rank: int, device: str,
              mode: str, omegas: Optional[str] = None, backends=None,
              **kw) -> None:
    dev = initialize(init_method, world_size, rank, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if mode == "scp" and backends:
        out = _selftest_backends(dev, backends, omegas=omegas, **kw)
    elif mode == "scp":
        out = _selftest_scp(dev, omegas)
    else:
        out = {"qp": _selftest_qp, "batch": _selftest_batch}[mode](dev)
    out.update(rank=group_rank(), nproc=group_size(), mode=mode)
    print("SELFTEST_OK " + json.dumps(out), flush=True)
    shutdown()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    # unset: initialize reads MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK (as
    # torchrun sets them)
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo on the host; default the card")
    ap.add_argument("--mode", choices=("qp", "batch", "scp"), default="qp")
    ap.add_argument("--omegas", default=None,
                    help="scp mode: an .npz of the DroneOmega fields")
    ap.add_argument("--backends", default=None,
                    help="scp mode: comma-separated backends, each solved")
    ap.add_argument("--scp-iters", type=int, default=3)
    ap.add_argument("--model", choices=("drone", "car"), default="drone")
    ap.add_argument("--checkpoint", default=None,
                    help="with --backends: a directory for the checkpoint")
    args = ap.parse_args()
    if args.selftest:
        # run the package's module, not this __main__ copy of it: the solver
        # records its collectives in the package module's audit log
        from riskaversetrajopt_torch.parallel import distributed

        distributed._selftest(
            args.init_method, args.world_size, args.rank, args.device,
            args.mode, args.omegas,
            backends=args.backends.split(",") if args.backends else None,
            num_iters=args.scp_iters, model=args.model,
            checkpoint=args.checkpoint)
