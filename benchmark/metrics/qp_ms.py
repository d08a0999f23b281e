"""Mean QP solve phase per SCP iteration (the fused ADMM loop with its
host checks), ms, as the program's instrumented solve times it."""


def read(rec):
    inst = rec["instrumented"]
    if not inst or not inst["solve_s"]:
        return None
    return 1e3 * sum(inst["solve_s"]) / len(inst["solve_s"])
