#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 101-112 \
        [--controls bf16_sweeps,bf16x3_sweeps] [--fault NAME]

Solves one fresh instance per seed (instance 0 of that seed, not the
traffic's pool) in one process and prints, per seed, the numbers of the
comparison for the program's output (sound runs: the lower readings);
for the reference's rollout of that plan in the precision below the
configuration's, put in the place of the program's trajectories
(`rollout_control`); and for each control named by --controls: the
program run on the same instance with its own lower-precision path, as
the configuration's `controls` entry of that name switches it on (the
upper readings). Then, per number, the largest sound reading and each
control's smallest. With --fault NAME (faults.py) the program runs with
that fault planted, and the "sound" readings are the fault's. The
benchmark's own runs never run a control or a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import faults
import run


def seeds_of(text):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def with_control(cfg, name):
    """The configuration with its control `name` switched on: the entry's
    keys replace the configuration's, a nested group key by key."""
    return run.merged(cfg, cfg["controls"][name])


def solve(model, cfg, prog, inst):
    import torch

    tf32 = bool(cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    t0 = time.perf_counter()
    out = prog.solve(inst)
    if inst[0].is_cuda:
        torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0,
                 "admm_iters": sum(out["qp_iters"]),
                 "qp_solved": sum(out["qp_solved"]),
                 **model.judge(cfg, inst, out)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112,200")
    ap.add_argument("--controls", default="",
                    help="names in the configuration's `controls`, comma-separated")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--device", default="cuda:0",
                    help="readings for a limit come from the card; 'cpu' "
                         "rehearses at a small size")
    ap.add_argument("--bench", default=str(run.ROOT / "BENCHMARK.json"))
    args = ap.parse_args(argv)
    import torch

    dev = args.device
    if dev.startswith("cuda") and not torch.cuda.is_available():
        print("calibrate.py reads the card; no CUDA device here", file=sys.stderr)
        return 2
    bench = run.Path(args.bench)
    c = run.load_cell(args.workload, bench, bench.parent)
    cfg, model = c["config"], c["model"]
    controls = [n for n in args.controls.split(",") if n]
    prog = model.Program(cfg, dev)
    others = {}
    for n in controls:
        ccfg = with_control(cfg, n)
        others[n] = (ccfg, model.Program(ccfg, dev))
    if args.fault:
        faults.FAULTS[args.fault]()
    rows = []
    for seed in seeds_of(args.seeds):
        inst = model.instance(cfg, seed, 0, dev)
        out, sound = solve(model, cfg, prog, inst)
        row = {"seed": seed, "sound": sound,
               "rollout_control": model.rollout_control(cfg, inst, out)}
        for n, (ccfg, cprog) in others.items():
            row[n] = solve(model, ccfg, cprog, inst)[1]
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in c["limits"]:
        summary[name] = {"lower": max(r["sound"][name] for r in rows)}
        for ctl in ["rollout_control"] + controls:
            summary[name][ctl] = min(r[ctl][name] for r in rows)
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "seeds": len(rows), "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
