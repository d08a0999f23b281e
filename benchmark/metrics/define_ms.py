"""Mean define phase per SCP iteration (linearize + pack), ms, as the
program's instrumented solve times it (synchronized on the card)."""


def read(rec):
    inst = rec["instrumented"]
    if not inst or not inst["define_s"]:
        return None
    return 1e3 * sum(inst["define_s"]) / len(inst["define_s"])
