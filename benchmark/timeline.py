"""What a `--trace 1` run reads from the profiler's timeline.

Device operations (kernels, copies, fills) are the events that ran on the
card; the union of their intervals is the busy time. On the card only CUDA
activity is recorded: a solve launches millions of operations, and torch's
host operators would triple the events and slow the host between kernels.
The host events that remain (CUDA runtime calls: launches, copies,
synchronizations) label the idle gaps by what the host was doing at each
gap's midpoint; "no host event" means Python between runtime calls.
"""

from __future__ import annotations

import numpy as np
import torch

TOP = 10
NAME_CHARS = 160


class Capture:
    """The profiler's raw timeline of the enclosed block (host and, on the
    card, device activity): `events` after the block. It drives the
    autograd profiler's start and stop calls itself, because the profiler
    objects turn every event into a Python object when they stop, which
    takes minutes on a solve's millions of launches."""

    def __init__(self, cuda: bool):
        prof = torch.autograd.profiler.profile(
            use_device="cuda" if cuda else None, use_kineto=True)
        try:
            self._config = prof.config(create_trace_id=True)
        except TypeError:  # a torch without trace ids
            self._config = prof.config()
        self._activities = ({torch.autograd.ProfilerActivity.CUDA} if cuda
                            else prof.kineto_activities)
        self._cuda = cuda
        self.events = None

    def __enter__(self):
        torch.autograd._prepare_profiler(self._config, self._activities)
        torch.autograd._enable_profiler(self._config, self._activities)
        return self

    def __exit__(self, *exc):
        if self._cuda:
            torch.cuda.synchronize()
        self.events = torch.autograd._disable_profiler().events()
        return False


def _span(e):
    if hasattr(e, "start_ns"):
        return e.start_ns() * 1e-9, e.duration_ns() * 1e-9
    return e.start_us() * 1e-6, e.duration_us() * 1e-6


def _short(name):
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS] + "..."


def summarize(events, window_s):
    """Busy seconds, every device operation's seconds and count by name, the
    top device operations and the longest idle gaps of the traced window
    (`window_s` long, on the host's clock)."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host_i, host_s, host_e = [], [], [], []
    for i, e in enumerate(events):
        start, dur = _span(e)
        if e.device_type() == cuda:
            device.append((start, start + dur, e.name()))
        elif dur > 0:
            host_i.append(i)
            host_s.append(start)
            host_e.append(start + dur)
    device.sort()
    kernels: dict = {}
    for s, t, name in device:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += t - s
        k[1] += 1
    busy, gaps = 0.0, []
    cur_s = cur_t = None
    for s, t, _ in device:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                gaps.append((s - cur_t, cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    gaps.sort(reverse=True)
    hs, he = np.array(host_s), np.array(host_e)

    def host_label(t):
        """The innermost host event running at time t."""
        inside = np.nonzero((hs <= t) & (he >= t))[0]
        if not inside.size:
            return "no host event"
        return _short(events[host_i[inside[np.argmax(hs[inside])]]].name())

    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "window_s": window_s,
        "busy_s": busy,
        "device_ops": len(device),
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[_short(n), v[0]] for n, v in top_ops],
            "idle_gaps": [[host_label((a + b) / 2), g]
                          for g, a, b in gaps[:TOP]],
        },
    }
