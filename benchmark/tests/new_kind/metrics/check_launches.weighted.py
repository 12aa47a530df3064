"""Launches of kernel #10 per convergence check in the traced slice:
the program's counter `launches.ell_rowsums` over its
`nmftpu.loop.check` spans (the weighted update itself runs no custom
kernel, so under `use_pallas` the checks' Wᵀ·V is what #10 runs)."""

from benchmark import tracing


def read(rec):
    spans = tracing.slice_spans(rec)
    counters = rec["slice"]["trace"].get("counters") if spans else None
    checks = spans.get("nmftpu.loop.check", {}).get("count", 0) \
        if spans else 0
    if counters is None or checks <= 0:
        return None
    return counters.get("launches.ell_rowsums", 0) / checks
