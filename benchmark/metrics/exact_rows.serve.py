"""Rows per certified request that the exact re-scan answered: the
program's own count of them over its count of certified requests
(`nmftpu_torch.utils.counters()`, `serve.exact_rows` over
`serve.certified_requests`), read after the window, so over every
certified request of the process: the run's warm-up and its window.
None where the program keeps no such counter."""


def read(rec):
    try:
        from nmftpu_torch.utils.metrics import counters
    except ImportError:
        return None
    c = counters()
    n = c.get("serve.certified_requests", 0)
    if n <= 0:
        return None
    return c["serve.exact_rows"] / n
