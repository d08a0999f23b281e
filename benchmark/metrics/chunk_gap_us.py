"""The host's share of the fused ADMM loop per kernel call, us: the
instrumented solve's QP phase time less B1's device time, over B1's
launches (the program's counter saa_admm.admm_chunk.launches). The
instrumented solve repeats the window's first solve (same_plan says it
returned the same plan, bit for bit), so its launches are that solve's and
B1's device time is that many launches at the window's mean."""

from metrics import b1_kernel as b1

COUNTERS = ("riskaversetrajopt_torch.ops.cuda.saa_admm:admm_chunk.launches",)


def read(rec):
    inst, got = rec["instrumented"], b1.seconds_and_launches(rec)
    if not inst or not inst["same_plan"] or got is None:
        return None
    first = next(s for s in rec["solves"] if s["instance"] == 0)
    launches = first["counters"][COUNTERS[0]]
    if not launches:
        return None
    per_launch = got[0] / got[1]
    return 1e6 * (sum(inst["solve_s"]) / launches - per_launch)
