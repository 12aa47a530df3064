"""Device milliseconds of a convergence check: the device operations
launched inside the program's `nmftpu.loop.check` spans of the traced
slice, per check (the check's Wᵀ·V and error terms)."""

from benchmark import tracing


def read(rec):
    return tracing.per_span(tracing.slice_spans(rec), ["nmftpu.loop.check"],
                            "device_s", "nmftpu.loop.check")
