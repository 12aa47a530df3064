"""Device milliseconds an iALS iteration spends solving its rows' normal
equations: the device operations launched inside the program's
`nmftpu.ials.solve` spans of the traced slice (both half-steps, every
panel), per `nmftpu.loop.update`. None where the program marks no such
span."""

from benchmark import tracing


def read(rec):
    spans = tracing.slice_spans(rec)
    if not spans or "nmftpu.ials.solve" not in spans:
        return None
    return tracing.per_span(spans, ["nmftpu.ials.solve"], "device_s",
                            "nmftpu.loop.update")
