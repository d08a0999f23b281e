"""Kernel B1's device time per ADMM iteration, us: its seconds in the
traced window over the window's ADMM iterations (SCPResult.qp_iters)."""

from metrics import b1_kernel as b1


def read(rec):
    got = b1.seconds_and_launches(rec)
    iters = sum(sum(s["qp_iters"]) for s in rec["solves"])
    if got is None or not iters:
        return None
    return 1e6 * got[0] / iters
