"""The whole iALS update against its roofline in the traced slice: the
iterations the program solved in the slice (its counter
`ials.rows_solved` over the n + m rows of one iteration), each at the
least time its work needs (`kinds/train_ials.ials_work`: operations at
the float32 peak or bytes at the HBM rate, the larger), over the device
time of the program's `nmftpu.ials.grams` and `nmftpu.ials.solve` spans.
The work is counted from the algorithm, whatever carries it out: a
route that never writes the per-row Grams reads no higher for it. None
where the program keeps no such counter or spans."""

from benchmark import tracing, yardstick


def read(rec):
    spans = tracing.slice_spans(rec)
    counters = rec["slice"]["trace"].get("counters") if spans else None
    work = rec.get("ials_work")
    if not counters or work is None:
        return None
    rows = counters.get("ials.rows_solved", 0)
    device_s = sum(spans[s]["device_s"] for s in
                   ("nmftpu.ials.grams", "nmftpu.ials.solve") if s in spans)
    if rows <= 0 or device_s <= 0:
        return None
    least = yardstick.bound_s(*work, yardstick.F32_PEAK)[0]
    return 100.0 * rows / (rec["n"] + rec["m"]) * least / device_s
