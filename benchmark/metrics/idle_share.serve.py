"""Idle share of the device in the traced slice of a serving window:
the share of the slice's wall time in which no operation ran on the
card (an upper bound: the profiler widens host gaps)."""


def read(rec):
    sl = rec.get("slice")
    if not sl or sl["trace"]["busy_s"] <= 0:
        return None
    tr = sl["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
