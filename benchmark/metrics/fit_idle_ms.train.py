"""Idle milliseconds of the device per fit outside the updates: the gaps
of the traced slice that open in the program's fit and loop spans
(`nmftpu.fit*`, `nmftpu.loop.*` but `nmftpu.loop.update`: set-up,
checks and their host syncs, finish, result), per `nmftpu.fit`."""

from benchmark import tracing


def read(rec):
    spans = tracing.slice_spans(rec)
    if not spans:
        return None
    names = [s for s in spans if s != "nmftpu.loop.update"
             and s.startswith(("nmftpu.fit", "nmftpu.loop."))]
    return tracing.per_span(spans, names, "idle_s", "nmftpu.fit")
