#!/usr/bin/env python3
"""Compare builds of the port's kernels B1 and B2 on one GPU.

Two questions, each answered from source trees side by side:
- the time per ADMM iteration of B1 and B2 at the drone's M=1000 for a
  parent revision, this tree, and this tree with the free-row branch taken
  on a runtime kernel argument instead of the template flag FREE;
- how planted faults in the free-row branch read, on the car's gated
  structure (M=50, scp_iter 0), against the checks of chip_smoke.py
  phase 7: the 2e-2 state measure and kernel_checks.epigraph_err.

    python3 kernel_ab.py prepare DIR [--parent REV]   # needs git
    python3 kernel_ab.py run DIR                      # needs the card
    python3 kernel_ab.py free DIR                     # needs the card

`prepare` writes one tree per variant into DIR (riskaversetrajopt_torch/,
chip_smoke.py and tests/fixtures/ each): `parent` (REV, by git archive),
`new` (the working tree), `runtime_flag`, and one tree per fault of FAULTS.
`run` builds every tree's kernels at once (one process per tree), times
the trees in the order parent, runtime_flag, new, new, runtime_flag,
parent, runs the car probe on `new` and each fault tree, and the car SCP
probe (iteration counts and digests) on `runtime_flag` and `new`. Each
probe is a process of its own (`python3 kernel_ab.py probe TREE MODE`);
its JSON line is printed and appended to DIR/results.jsonl. `free` builds
`new` and the fault trees only and reads kernel_checks.free_row_errs (the
check of chip_smoke.py phase 7 that sees the free-row branch) on each,
B1 and B2 "highest"/"high", at the car's scp_iter 0 and, forced, 3.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
CUH = "riskaversetrajopt_torch/csrc/saa_admm_common.cuh"
TIMED = ("parent", "runtime_flag", "new", "new", "runtime_flag", "parent")
# planted faults of the free-row branch: (text of saa_admm_common.cuh, its
# replacement)
FAULTS = {
    "branch_off": (
        "const void* fn = free_y ? chunk_kernel<P, PREC, true>(sh) "
        ": chunk_kernel<P, PREC, false>(sh);",
        "const void* fn = chunk_kernel<P, PREC, false>(sh);"),
    "x1_sign": (
        "wdr += SA(kCy)[s] * (SA(kDinv)[s] * sig) * SA(kY)[s] - SA(kWd)[s] * b1;",
        "wdr += SA(kCy)[s] * (SA(kDinv)[s] * sig) * SA(kY)[s] + SA(kWd)[s] * b1;"),
    "kappa2_no_c2": (
        "FREE ? -((wsm[n_fc] - beta * c2 - beta * (pr[n + 2] - swq)) / denom)",
        "FREE ? -((wsm[n_fc] - beta * (pr[n + 2] - swq)) / denom)"),
    "cv_no_c2": (
        "const float cv = a - beta * SA(kCy)[s] * c2;",
        "const float cv = a;"),
}
# the free-row branch on a kernel argument: one instantiation per shape
RUNTIME_FLAG = (
    ("template <class P, int PREC, bool GRES, bool RRES, bool FREE>\n"
     "__global__ void __launch_bounds__(kThreads, 1)\n"
     "admm_chunk_kernel(P p, State in, State out, Scratch sc, Dims d, Shape sh, "
     "int chunk) {",
     "template <class P, int PREC, bool GRES, bool RRES, bool UNUSED>\n"
     "__global__ void __launch_bounds__(kThreads, 1)\n"
     "admm_chunk_kernel(P p, State in, State out, Scratch sc, Dims d, Shape sh, "
     "int chunk, bool FREE) {"),
    ("if constexpr (FREE)", "if (FREE)"),
    ("const void* fn = free_y ? chunk_kernel<P, PREC, true>(sh) "
     ": chunk_kernel<P, PREC, false>(sh);",
     "const void* fn = chunk_kernel<P, PREC, false>(sh);"),
    ("void* args[] = {&p, &in, &out, &sc, &d, &sh, &chunk};",
     "void* args[] = {&p, &in, &out, &sc, &d, &sh, &chunk, &free_y};"),
)
FILES = ("riskaversetrajopt_torch", "chip_smoke.py", "tests/fixtures")


def _patch(tree: Path, edits) -> None:
    f = tree / CUH
    src = f.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{tree.name}: {old!r} not in {CUH}")
        src = src.replace(old, new)
    f.write_text(src)


def prepare(out: Path, parent: str) -> None:
    out.mkdir(parents=True, exist_ok=True)
    tar = subprocess.run(["git", "archive", parent, *FILES], cwd=REPO,
                         check=True, capture_output=True).stdout
    (out / "parent").mkdir(exist_ok=True)
    subprocess.run(["tar", "-x", "-C", str(out / "parent")], input=tar,
                   check=True)
    new = out / "new"
    for f in FILES:
        dst = new / f
        dst.parent.mkdir(parents=True, exist_ok=True)
        if (REPO / f).is_dir():
            shutil.copytree(REPO / f, dst, dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(REPO / f, dst)
    variants = {"runtime_flag": RUNTIME_FLAG,
                **{k: (v,) for k, v in FAULTS.items()}}
    for name, edits in variants.items():
        shutil.copytree(new, out / name, dirs_exist_ok=True)
        _patch(out / name, edits)
    print("prepared", sorted(p.name for p in out.iterdir() if p.is_dir()))


def probe(tree: Path, mode: str) -> dict:
    """One probe, run in a process whose import path starts at `tree`."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from riskaversetrajopt_torch.ops.cuda import build
    from riskaversetrajopt_torch.ops.cuda import saa_admm as sk
    from riskaversetrajopt_torch.ops.cuda import saa_admm_f as fk

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": tree.name, "mode": mode}
    if mode == "build":
        for name in ("saa_admm", "saa_admm_f"):
            _, secs, log = build.build(name)
            out[name] = {"seconds": secs, "ptxas": [
                line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]}
    elif mode == "time":
        p, d, _, _ = cs.scaled_problem(
            torch, dev, 1000,
            lambda opt: cs.load_omegas(torch, torch.float64, dev))
        s0 = sk.init_scaled_state(p)
        sk.admm_chunk(p, s0, d, 100)  # warm
        out["b1_us"] = [cs.cuda_time(
            torch, lambda: sk.admm_chunk(p, s0, d, 100), 20) * 1e4
            for _ in range(3)]
        pf, sf0 = fk.to_f(p, d), fk.state_to_f(s0, d)
        for prec in ("highest", "high", "default"):
            fk.admm_chunk_f(pf, sf0, d, 25, prec)  # warm
            out[f"b2_{prec}_us"] = [cs.cuda_time(
                torch, lambda: fk.admm_chunk_f(pf, sf0, d, 25, prec), 40) * 4e4
                for _ in range(3)]
    elif mode == "car_scp":
        out.update(car_scp_probe(torch, cs, sk, dev))
    elif mode == "free":
        out.update(free_probe(torch, cs, dev))
    else:  # car
        out.update(car_probe(torch, cs, sk, fk, dev))
    return out


def car_scp_probe(torch, cs, sk, dev) -> dict:
    """The car SCP through both fused backends (chip_smoke.py phase 7's
    omegas and solver config): its ADMM iteration counts and a digest of
    its controls; and a digest of 100 iterations of B1 on the car's gated
    structure at rho 0.1 and 1 from the plain state after 300 iterations."""
    import hashlib

    def digest(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    opt = cs.car_opt(torch)
    om = opt.sample(torch.Generator().manual_seed(0), cs.CAR_M)
    for backend in ("_admm-pallas", "_admm-pallas-f"):
        res = cs.car_opt(torch, qp_backend=backend, admm_cfg=cs.fused_config(),
                         dtype=torch.float32).solve(om, alpha=cs.CAR_ALPHA)
        out[backend] = {"qp_iters": res.qp_iters.tolist(),
                        "us": digest([res.us])}
    from riskaversetrajopt_torch.core.config import SolverConfig
    from riskaversetrajopt_torch.ops import admm
    from riskaversetrajopt_torch.ops.saa_qp import (
        SAAQPOps, build_bounds, build_objective,
    )

    data = opt._define(opt.model.initial_guess(), om, cs.CAR_ALPHA)
    data32 = type(data)(*(x.to(torch.float32) for x in data))
    st, cfg = opt._static_for(cs.CAR_M), SolverConfig()
    ops = SAAQPOps(st, data32, 0)
    _, q = build_objective(st, data32)
    lo, up = build_bounds(st, data32, 0)
    scaling = admm.ruiz_equilibrate(ops, q, lo, up, iters=5)
    d = sk.kernel_dims(st)
    for rho in (0.1, 1.0):
        p, _ = sk.scaled_structure(st, data32, 0, scaling,
                                   torch.tensor(rho, device=dev), cfg)
        s = sk.init_scaled_state(p)
        for _ in range(300):
            s = sk.one_iter_ref(p, s, d)
        out[f"b1_gated_rho_{rho}"] = digest(sk.admm_chunk(p, s, d, 100))
    return out


def free_probe(torch, cs, dev) -> dict:
    """kernel_checks.free_row_errs of B1 and B2 "highest"/"high" on the
    car's structure at scp_iter 0 and, with the free-row form forced, 3
    (chip_smoke.free_row_check's readings, without its limit)."""
    from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc

    opt = cs.car_opt(torch)
    om = opt.sample(torch.Generator().manual_seed(0), cs.CAR_M)
    out = {}
    for scp_iter in (0, 3):
        p, d, _, _ = cs.scaled_of(torch, dev, opt, om, cs.CAR_ALPHA, scp_iter)
        try:
            out[f"scp_iter_{scp_iter}"] = cs.free_row_check(
                torch, p, d, f"scp_iter {scp_iter}")
        except AssertionError:  # a fault: read without the limit
            lim, kc.FREE_ROW_TOL = kc.FREE_ROW_TOL, float("inf")
            out[f"scp_iter_{scp_iter}"] = cs.free_row_check(
                torch, p, d, f"scp_iter {scp_iter}")
            kc.FREE_ROW_TOL = lim
    return out


def car_probe(torch, cs, sk, fk, dev) -> dict:
    """B1 (100 iterations) and B2 "highest"/"high" (25) against their plain
    versions on the car's structure: the state measure, epigraph_err, and
    every field against its own scale."""
    from riskaversetrajopt_torch.ops.cuda import kernel_checks as kc

    def fields(a, b):
        r = {}
        for name, x, y in zip(b._fields, a, b):
            diff = float(torch.max(torch.abs(x - y)))
            scale = float(torch.max(torch.abs(y)))
            r[name] = diff / scale if scale > 0 else (
                float("inf") if diff > 0 else 0.0)
        return r

    def measure(k, ref):
        try:
            state = kc.state_err(k, ref)[0]
        except AssertionError as e:  # a field is not finite
            state = str(e)
        return {"state_err": state, "epigraph_err": kc.epigraph_err(k, ref),
                "fields": fields(k, ref)}

    opt = cs.car_opt(torch)
    om = opt.sample(torch.Generator().manual_seed(0), cs.CAR_M)
    out = {}
    for scp_iter in (0, 3):
        p, d, _, _ = cs.scaled_of(torch, dev, opt, om, cs.CAR_ALPHA, scp_iter)
        s0 = sk.init_scaled_state(p)
        ref = s0
        for _ in range(100):
            ref = sk.one_iter_ref(p, ref, d)
        res = {"b1": measure(sk.admm_chunk(p, s0, d, 100), ref)}
        pf, sf0 = fk.to_f(p, d), fk.state_to_f(s0, d)
        for prec in ("highest", "high"):
            ref = sf0
            for _ in range(25):
                ref = fk.one_iter_ref_f(pf, ref, d, prec)
            res[f"b2_{prec}"] = measure(fk.admm_chunk_f(pf, sf0, d, 25, prec), ref)
        out[f"scp_iter_{scp_iter}"] = res
    return out


def run(out: Path) -> int:
    trees = ["parent", "runtime_flag", "new", *FAULTS]
    with ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(lambda t: _call(out, t, "build"), trees))
    for tree in TIMED:
        _call(out, tree, "time")
    for tree in ("new", *FAULTS):
        _call(out, tree, "car")
    for tree in ("runtime_flag", "new"):
        _call(out, tree, "car_scp")
    return 0


def run_free(out: Path) -> int:
    trees = ["new", *FAULTS]
    with ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(lambda t: _call(out, t, "build"), trees))
    for tree in trees:
        _call(out, tree, "free")
    return 0


def _call(out: Path, tree: str, mode: str) -> None:
    proc = subprocess.run(
        [sys.executable, __file__, "probe", str(out / tree), mode],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} {tree}:\n{proc.stdout}\n{proc.stderr}")
    line = proc.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    with open(out / "results.jsonl", "a") as f:
        f.write(line + "\n")


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "prepare":
        parent = argv[argv.index("--parent") + 1] if "--parent" in argv else "HEAD"
        prepare(Path(argv[1]).resolve(), parent)
        return 0
    if len(argv) == 2 and argv[0] == "run":
        return run(Path(argv[1]).resolve())
    if len(argv) == 2 and argv[0] == "free":
        return run_free(Path(argv[1]).resolve())
    if len(argv) == 3 and argv[0] == "probe":
        print(json.dumps(probe(Path(argv[1]), argv[2])), flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
