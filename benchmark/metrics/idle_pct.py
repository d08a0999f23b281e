"""Share of the traced window in which no operation ran on the card, %
(the union of the device operations' intervals in the profiler's
timeline)."""


def read(rec):
    tl = rec["timeline"]
    if not tl or not tl["device_ops"] or tl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
