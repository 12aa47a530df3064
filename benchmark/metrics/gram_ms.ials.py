"""Device milliseconds an iALS iteration spends building its per-row
Grams: the device operations launched inside the program's
`nmftpu.ials.grams` spans of the traced slice (both half-steps' base
Gram, gathers, batched products and `index_add_`), per
`nmftpu.loop.update`. None where the program marks no such span."""

from benchmark import tracing


def read(rec):
    spans = tracing.slice_spans(rec)
    if not spans or "nmftpu.ials.grams" not in spans:
        return None
    return tracing.per_span(spans, ["nmftpu.ials.grams"], "device_s",
                            "nmftpu.loop.update")
