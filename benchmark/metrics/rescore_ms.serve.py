"""Device milliseconds a request spends re-scoring its candidates: the
device operations launched inside the program's `nmftpu.serve.rescore`
spans of the traced slice, per `nmftpu.serve.request`."""

from benchmark import tracing


def read(rec):
    return tracing.per_span(tracing.slice_spans(rec),
                            ["nmftpu.serve.rescore"], "device_s",
                            "nmftpu.serve.request")
