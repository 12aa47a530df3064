"""Idle milliseconds of the device per request inside the program: the
gaps of the traced slice that open in any of the program's
`nmftpu.serve.*` spans, per `nmftpu.serve.request`."""

from benchmark import tracing


def read(rec):
    spans = tracing.slice_spans(rec)
    if not spans:
        return None
    return tracing.per_span(
        spans, [s for s in spans if s.startswith("nmftpu.serve.")],
        "idle_s", "nmftpu.serve.request")
