"""Kernel #9 (the certificate's count, `csrc/count_above.cu`, with its
band re-score) against its roofline in the traced slice. Each request
counts over the whole table once for its batch; counts beyond one a
request (the escalation's) are taken at the least time of any count,
the table read once. Over the kernel's device time in the trace."""

from benchmark import yardstick


def read(rec):
    sl = rec.get("slice")
    if not sl:
        return None
    cls = sl["trace"]["classes"].get("count_above")
    counts = sl["launches"][1]
    if not cls or cls["seconds"] <= 0 or counts < sl["requests"]:
        return None
    b, m, r, t = rec["b"], rec["m"], rec["r"], rec["table_dtype"]
    main = yardstick.count_above_bound(b, m, r, t)
    extra = yardstick.count_above_bound(0, m, r, t)
    least = sl["requests"] * main + (counts - sl["requests"]) * extra
    return 100.0 * least / cls["seconds"]
