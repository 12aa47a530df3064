"""Idle milliseconds of the device per MU iteration inside the update:
the gaps of the traced slice that open in the program's
`nmftpu.loop.update` spans, per update."""

from benchmark import tracing


def read(rec):
    return tracing.per_span(tracing.slice_spans(rec), ["nmftpu.loop.update"],
                            "idle_s", "nmftpu.loop.update")
