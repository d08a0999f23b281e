"""Faults planted under the timed path, to show that `correct` sees them.

Each `plant_<fault>()` patches the program in this process and returns a
function that takes the patch out. Neither the benchmark's runs nor its
readings of sound runs plant anything: tests/test_bench_correct.py plants
them on the host, and calibrate.py --fault reads them on the card at a
cell's own size.
  unchanged     kernel B1's chunk call returns the state it was given;
  half_samples  B1's chunk iterates only the first half of the samples:
                the others' rows, duals and epigraph variables keep the
                values they came in with;
  altered       the plan a solve returns has one control moved by 1e-4.
"""

from __future__ import annotations

import torch

PER_SAMPLE = ("y", "z_y", "yd_y", "z_G", "yd_G")


def _patch(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def plant_unchanged():
    from riskaversetrajopt_torch.ops.cuda import saa_admm

    def chunk(p, state, d, n):
        return state

    chunk.launches = 0
    return _patch(saa_admm, "admm_chunk", chunk)


def plant_half_samples():
    from riskaversetrajopt_torch.ops.cuda import saa_admm

    real = saa_admm.admm_chunk

    def chunk(p, state, d, n):
        out = real(p, state, d, n)
        h = d.M // 2
        return out._replace(**{
            f: torch.cat([getattr(out, f)[:h], getattr(state, f)[h:]])
            for f in PER_SAMPLE})

    chunk.launches = 0
    return _patch(saa_admm, "admm_chunk", chunk)


def plant_altered():
    from riskaversetrajopt_torch.scp.driver import SAATrajOpt

    real = SAATrajOpt.solve

    def solve(self, *a, **kw):
        res = real(self, *a, **kw)
        us = res.us.clone()
        us[us.shape[0] // 2, 0] += 1e-4
        return res._replace(us=us)

    return _patch(SAATrajOpt, "solve", solve)


FAULTS = {"unchanged": plant_unchanged, "half_samples": plant_half_samples,
          "altered": plant_altered}
