"""Profiling utilities.

The reference's profiling model is wall-clock define/solve pairs
(car/driving.py:482-498), kept as first-class metrics in
SAATrajOpt.solve_instrumented. This module adds device traces: a
``torch.profiler`` trace of a block, viewable in Perfetto or
chrome://tracing, and named spans on its timeline.
"""

from __future__ import annotations

import contextlib
import pathlib

import torch


@contextlib.contextmanager
def trace(log_dir: str = "trace"):
    """Capture a torch.profiler trace (host and, on the card, CUDA
    activity) of the enclosed block and write it as
    ``<log_dir>/trace.json``.

    Usage:
        with trace("tr"):
            res = opt.solve(omegas, alpha)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)
