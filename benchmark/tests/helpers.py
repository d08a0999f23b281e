"""Shared set-up of the benchmark's CPU tests: the benchmark's directory on
sys.path, and a copy of the benchmark with a tiny drone cell added as files
alone, for runs on the host."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = "drone_tiny.fused"


def tiny_checkout(tmp: Path, M=16, max_iter=2000, pool=1) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under `tmp` with one more
    cell, `drone_tiny.fused`, added only as files: the drone at M samples,
    ADMM capped at max_iter, the cell's traffic a pool of `pool` instances,
    and drone_m1000.fused's limits but for cvar_gap, which is set from this
    size's readings on the host (sound 6e-5 to 3.6e-4, the half_samples
    fault 0.064 to 0.26, M=16). qp_residual keeps its limit: at M=16 the
    sound runs read 9.7e-4 to 9.9e-4 and the program's bf16 G-sweeps 0.052
    to 0.117."""
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((BENCH / "configs" / "drone_m1000.json").read_text())
    cfg.update(name="drone_tiny", M=M)
    cfg["solver"] = dict(cfg["solver"], max_iter=max_iter)
    (tmp / "benchmark" / "configs" / "drone_tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "fused_solves.json").read_text())
    traffic.update(name="tiny_solves", pool=pool)
    (tmp / "benchmark" / "traffic" / "tiny_solves.json").write_text(json.dumps(traffic))
    limits = json.loads((BENCH / "limits" / "drone_m1000.fused.json").read_text())
    limits["cvar_gap"] = dict(limits["cvar_gap"], limit=5e-3)
    (tmp / "benchmark" / "limits" / f"{TINY}.json").write_text(json.dumps(limits))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="drone_tiny",
                                 file="benchmark/configs/drone_tiny.json"))
    bench["workloads"].append({"name": TINY, "config": "drone_tiny",
                               "traffic": "tiny_solves", "chips": 1,
                               "why": "host test cell"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
