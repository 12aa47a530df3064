"""Host milliseconds a request spends building its seen-item exclusion:
the self time of the program's `nmftpu.serve.exclusion` spans of the
traced slice, per `nmftpu.serve.request`."""

from benchmark import tracing


def read(rec):
    return tracing.per_span(tracing.slice_spans(rec),
                            ["nmftpu.serve.exclusion"], "host_s",
                            "nmftpu.serve.request")
