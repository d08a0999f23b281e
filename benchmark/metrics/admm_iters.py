"""ADMM iterations per solve: the sum of SCPResult.qp_iters, averaged over
the traced window's solves."""


def read(rec):
    solves = rec["solves"]
    if not solves:
        return None
    return sum(sum(s["qp_iters"]) for s in solves) / len(solves)
