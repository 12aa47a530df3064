"""Device milliseconds an iALS iteration spends in its conjugate-gradient
steps: the device operations launched inside the program's
`nmftpu.ials.cg` spans of the traced slice (both half-steps: each
product of the rows' systems with a vector, #11's CG rule and the base
Gram's product, and the vector updates), per `nmftpu.loop.update`. None
where the program marks no such span."""

from benchmark import tracing


def read(rec):
    spans = tracing.slice_spans(rec)
    if not spans or "nmftpu.ials.cg" not in spans:
        return None
    return tracing.per_span(spans, ["nmftpu.ials.cg"], "device_s",
                            "nmftpu.loop.update")
