"""Kernel B1 in the traced timeline: the device seconds and launches of
the kernels whose names say they are B1 (csrc/saa_admm.cu's instantiations
of admm_chunk_kernel on its problem type `Prob`; B2's is `ProbF`). Shared
by the B1 readers; not itself a metric."""

import re

NAME = re.compile(r"admm_chunk_kernel<[^,<>]*\bProb\b")


def seconds_and_launches(rec):
    tl = rec["timeline"]
    if not tl:
        return None
    secs = n = 0
    for name, (s, count) in tl["kernels"].items():
        if NAME.search(name):
            secs += s
            n += count
    return (secs, n) if n else None
