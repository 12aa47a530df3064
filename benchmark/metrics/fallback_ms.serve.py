"""Device milliseconds a request spends in the exact fallback for the
rows the certificate did not certify: the device operations launched
inside the program's `nmftpu.serve.fallback` spans of the traced slice,
per `nmftpu.serve.request`."""

from benchmark import tracing


def read(rec):
    return tracing.per_span(tracing.slice_spans(rec),
                            ["nmftpu.serve.fallback"], "device_s",
                            "nmftpu.serve.request")
