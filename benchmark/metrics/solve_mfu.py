"""The whole solve's share of the card's float32 peak, %: the float32
operations of the traced window's ADMM iterations (roofline.py, from the
shapes and SCPResult.qp_iters) over the window's seconds at 67 TFLOP/s.
The define phase's and the factorizations' operations are not counted, so
it reads low, never high."""

import roofline


def read(rec):
    tl = rec["timeline"]
    if not tl or not tl["device_ops"] or tl["window_s"] <= 0:
        return None
    d = rec["dims"]
    ops = sum(roofline.iteration_flops(d["M"], d["K"], d["n"], d["n_fc"]))
    iters = sum(sum(s["qp_iters"]) for s in rec["solves"])
    return 100.0 * iters * ops / tl["window_s"] / roofline.PEAK_F32
