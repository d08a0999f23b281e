"""Kernel B1's share of its roofline, %: the least time of the window's
ADMM iterations (roofline.py: each QP's operations at the float32 peak
against its bytes once at the HBM rate, from the shapes and the iteration
counts alone) over B1's device seconds in the traced window."""

import roofline
from metrics import b1_kernel as b1


def read(rec):
    got = b1.seconds_and_launches(rec)
    if got is None:
        return None
    d = rec["dims"]
    least = sum(roofline.least_seconds(d["M"], d["K"], d["n"], d["n_fc"], it)[0]
                for s in rec["solves"] for it in s["qp_iters"] if it)
    return 100.0 * least / got[0]
