"""Device milliseconds an iALS iteration spends on what its
conjugate-gradient steps start from: the device operations launched
inside the program's `nmftpu.ials.rhs` spans of the traced slice (both
half-steps' base Gram, right-hand sides and system diagonals), per
`nmftpu.loop.update`. None where the program marks no such span."""

from benchmark import tracing


def read(rec):
    spans = tracing.slice_spans(rec)
    if not spans or "nmftpu.ials.rhs" not in spans:
        return None
    return tracing.per_span(spans, ["nmftpu.ials.rhs"], "device_s",
                            "nmftpu.loop.update")
