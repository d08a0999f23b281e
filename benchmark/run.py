#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (riskaversetrajopt_torch).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for. Everything is found by name: the cell in BENCHMARK.json, its
configuration in the file that BENCHMARK.json gives it, the traffic mix in
traffic/<traffic>.json, the model's driver in models/<model>.py, the limits
of its comparison in limits/<cell>.json and each per-layer metric's reader
in metrics/<metric>.py. A cell is added by adding those files.

A run builds the program and its instances (set-up), then solves them one
after another, closed loop, in passes over the traffic's pool of instances
in an order drawn from --seed, until --seconds have passed at the end of a
pass (the window): every seed does the same work, so runs of different
seeds time the same thing. With --trace 0 it prints the cell's
end-to-end metrics; with --trace 1 the window is one pass over the pool,
under torch.profiler (timeline.py), followed by the program's instrumented
solve of the pool's first instance, and it prints the cell's per-layer
metrics. Every run then holds every solve
of the window to the plain reference (reference.py) and prints the numbers
it compared beside their limits, last on standard error and last in the
result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# top-level module names that no benchmark run may hold once its window has
# closed: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "riskaversetrajopt_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json",
              root: Path = ROOT) -> dict:
    """The cell `workload` with everything it names, read from its files."""
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_file}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    bdir = root / "benchmark"
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and reports(m, workload)]
    cfg = json.loads((root / entry["file"]).read_text())
    return {
        "cell": cell,
        "config": cfg,
        "traffic": json.loads((bdir / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((bdir / "limits" / f"{workload}.json").read_text()),
        "model": load_module(bdir / "models" / f"{cfg['model']}.py",
                             f"bench_model_{cfg['model']}"),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "readers": {m["name"]: load_module(bdir / "metrics" / f"{m['name']}.py",
                                           f"bench_metric_{m['name']}")
                    for m in per_layer},
    }


def merged(cfg: dict, changes: dict) -> dict:
    """`cfg` with `changes` in its place: a nested group key by key."""
    out = dict(cfg)
    for k, v in changes.items():
        out[k] = dict(cfg[k], **v) if isinstance(v, dict) else v
    return out


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def read_counter(spec: str) -> int:
    """A program counter named 'module:attr.attr'."""
    mod, attrs = spec.split(":")
    obj = sys.modules.get(mod) or importlib.import_module(mod)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float = T_START) -> dict:
    """One run of cell `c` (load_cell's dict) on `device`: set-up, the
    window, the comparison; returns the result line's object."""
    import torch

    cfg, model, traffic = c["config"], c["model"], c["traffic"]
    cuda = device.startswith("cuda")
    tf32 = bool(cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_num_threads(1)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---- set-up: the program, its instances, one pass over every shape
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prog = model.Program(cfg, device)
    insts = [model.instance(cfg, traffic["pool_seed"], k, device)
             for k in range(traffic["pool"])]
    order = list(range(len(insts)))
    random.Random(seed).shuffle(order)
    prog.warm_up(insts[0])
    sync()
    counters = sorted({s for r in c["readers"].values()
                       for s in getattr(r, "COUNTERS", ())})
    setup_s = time.perf_counter() - t_start

    # ---- the window: closed loop, one caller
    cap = None
    if trace:
        import timeline as tl

        cap = tl.Capture(cuda).__enter__()
    solves = []
    t0 = time.perf_counter()
    while not solves or (not trace and time.perf_counter() - t0 < seconds):
        for k in order:
            before = {s: read_counter(s) for s in counters}
            ts = time.perf_counter()
            out = prog.solve(insts[k])
            sync()
            out["wall_s"] = time.perf_counter() - ts
            out["instance"] = k
            out["counters"] = {s: read_counter(s) - before[s]
                               for s in counters}
            solves.append(out)
    window_s = time.perf_counter() - t0
    timeline = None
    if cap is not None:
        cap.__exit__(None, None, None)
        tp = time.perf_counter()
        timeline = tl.summarize(cap.events, window_s)
        timeline["read_s"] = time.perf_counter() - tp
        del cap
    leaked = forbidden_modules()
    if leaked:
        raise RuntimeError(f"the window loaded {leaked}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    instrumented = None
    if trace:
        # the pool's first instance, whatever the seed's order
        first = next(o for o in solves if o["instance"] == 0)
        instrumented = prog.instrumented(insts[0])
        instrumented["same_plan"] = bool(torch.equal(instrumented.pop("us"),
                                                     first["us"]))
    del prog
    if cuda:
        torch.cuda.empty_cache()

    # ---- the comparison, after the window, every solve of it
    numbers = [model.judge(cfg, insts[o["instance"]], o) for o in solves]
    failed = sum(not n["finite"] for n in numbers)
    checks = {}
    for name, lim in c["limits"].items():
        value = max(n[name] for n in numbers)
        checks[name] = {"value": value, "limit": lim["limit"]}
    correct = failed == 0 and all(v["value"] <= v["limit"]
                                  for v in checks.values())

    rec = {
        "dims": model.dims(cfg), "window_s": window_s,
        "solves": [{k: v for k, v in o.items()
                    if k not in ("us", "xs", "us_history")}
                   for o in solves],
        "instrumented": instrumented, "timeline": timeline,
    }
    metrics = {}
    if trace:
        for m in c["per_layer"]:
            v = c["readers"][m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        measured = {"solve_s": window_s / len(solves), "setup_s": setup_s}
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name() if cuda else device,
           "count": c["cell"]["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(solves), "failed": failed,
              "metrics": metrics, "device": dev}
    if timeline is not None:
        dev["busy_s"] = timeline["busy_s"]
        dev["window_s"] = timeline["window_s"]
        result["breakdown"] = timeline["breakdown"]
    result["info"] = {
        "solve_wall_s": [o["wall_s"] for o in solves],
        "admm_iters": [sum(o["qp_iters"]) for o in solves],
        "qp_solved": [sum(o["qp_solved"]) for o in solves],
        "avar": [n["avar"] for n in numbers],
        "qp_residuals": [n["qp_residuals"] for n in numbers],
        "setup_s": setup_s,
        "trace_read_s": timeline["read_s"] if timeline else None,
    }
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = load_cell(args.workload)
    import torch

    chips = c["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda:0")
    leaked = forbidden_modules()
    if leaked:
        print(f"loaded in the process that reports: {leaked}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
