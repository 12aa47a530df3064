"""The traced slice of a run: `torch.profiler` over a bounded stretch of
the steady window, reduced to device seconds by kernel class, the busy
and idle time of the device, the idle gaps named by what the host was
doing (the benchmark's own `record_function` spans around each call
into the program, or the innermost operator the profiler saw), the
program's own spans (``nmftpu.<layer>.<stage>``, `program_spans`) and
the difference of the program's counters over the slice.

`kernel_class` and `device_summary` are copied from the port's profiling
script (``chip_profile.py``), so the benchmark keeps its own yardstick.
The profiler widens host gaps, so an idle share read here is an upper
bound on the untraced run's.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
# the program's spans, and where operations and gaps no span covers go
PREFIX = "nmftpu."
OUTSIDE = "outside"


def kernel_class(name: str) -> str:
    """The port's kernel classes: its hand-written kernels by number, and
    library kernels by what they do."""
    for frag, cls in (("update_kernel", "mu_update"),
                      ("hals_sweep_kernel", "hals_sweep"),
                      ("int8_numer_kernel", "int8_numer"),
                      ("muldiv_kernel", "muldiv")):
        if frag in name:
            return cls
    if "ell_spmm_kernel" in name:
        return "ell_rowsums"
    if "ell_kl_kernel" in name:
        return "ell_kl"
    if "reservoir_" in name:
        return "reservoir_scan"
    if "count_tc_kernel" in name or "count_band_kernel" in name:
        return "count_above"
    low = name.lower()
    if any(k in low for k in ("potrf", "trsm", "trsv", "chol")):
        return "solve"
    if "indexselect" in low or "gather" in low:
        return "gather"
    if "indexfunc" in low:
        return "index_add"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "cublas")):
        return "gemm"
    if any(k in low for k in ("topk", "sort", "radix", "select")):
        return "topk_sort"
    if "memcpy" in low:
        return "memcpy"
    if "memset" in low:
        return "memset"
    return "other"


def _merged(spans):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_summary(events) -> dict:
    """Device seconds and event counts by kernel class, the device's busy
    seconds (the union of its operations) and the span from its first
    operation to its last, from a chrome trace's event list."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    classes: dict[str, dict] = {}
    for e in dev:
        c = classes.setdefault(kernel_class(e["name"]),
                               {"seconds": 0.0, "events": 0})
        c["seconds"] += e["dur"] / 1e6
        c["events"] += 1
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_s = sum(e - s for s, e in busy) / 1e6
    span_s = (busy[-1][1] - busy[0][0]) / 1e6 if busy else 0.0
    return {"classes": classes, "busy_s": busy_s, "span_s": span_s,
            "busy": busy}


def idle_gaps(events, busy) -> dict:
    """Idle device seconds summed by what the host was doing at the start
    of each gap between device operations: the innermost host event that
    covers that instant, or "host" where none does."""
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    starts = [h[0] for h in host]
    named: dict[str, float] = {}
    for g0, g1 in _gaps(events, busy):
        name = "host"
        j = bisect.bisect_right(starts, g0) - 1
        # the latest-starting event that still covers g0 is the innermost
        while j >= 0:
            if host[j][1] > g0:
                name = host[j][2]
                break
            j -= 1
        named[name] = named.get(name, 0.0) + (g1 - g0) / 1e6
    return named


def program_spans(events, busy) -> dict:
    """The program's spans in a chrome trace, by name: `count`; `host_s`,
    the spans' time less the program spans nested in them; `device_s`,
    the device operations (`DEVICE_CATS`) whose launching runtime call,
    found by the trace's `correlation` id, lies inside the span, each
    laid to the innermost span covering that call; `idle_s`, the gaps
    between the device's busy intervals (`busy`, merged), each laid to
    the innermost span covering its start. Operations and gaps that no
    span covers go to `outside`. Spans are host ranges
    (`user_annotation`); their device-side copies
    (`gpu_user_annotation`) are neither spans nor busy time."""
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    # each span's parent: the innermost span still open at its start
    parent, stack = [], []
    for j, (t0, t1, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= t0:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(j)
    starts = [s[0] for s in spans]

    def innermost(t):
        j = bisect.bisect_right(starts, t) - 1
        while j >= 0 and spans[j][1] <= t:
            j = parent[j]
        return spans[j][2] if j >= 0 else OUTSIDE

    out: dict[str, dict] = {}

    def entry(name):
        return out.setdefault(name, {"count": 0, "host_s": 0.0,
                                     "device_s": 0.0, "idle_s": 0.0})

    entry(OUTSIDE)
    for j, (t0, t1, name) in enumerate(spans):
        e = entry(name)
        e["count"] += 1
        e["host_s"] += (t1 - t0) / 1e6
        if parent[j] >= 0:
            entry(spans[parent[j]][2])["host_s"] -= (t1 - t0) / 1e6
    launched = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launched[corr] = e["ts"]
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            t = launched.get(e.get("args", {}).get("correlation"))
            name = OUTSIDE if t is None else innermost(t)
            entry(name)["device_s"] += e["dur"] / 1e6
    for g0, g1 in _gaps(events, busy):
        entry(innermost(g0))["idle_s"] += (g1 - g0) / 1e6
    return out


def _gaps(events, busy):
    """The device's idle intervals: from the first host event to the
    first busy interval, between busy intervals, and from the last one
    to the end of the last host event."""
    host = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if host:
        first, last = min(h[0] for h in host), max(h[1] for h in host)
        gaps = ([(first, busy[0][0] if busy else last)] + gaps
                + ([(busy[-1][1], last)] if busy else []))
    return [(g0, g1) for g0, g1 in gaps if g1 > g0]


def slice_spans(rec):
    """The program's spans of a layer record's traced slice, or None
    where it has none."""
    sl = rec.get("slice")
    return sl["trace"].get("spans") if sl else None


def per_span(spans, names, key, per):
    """Milliseconds of `key` (`host_s`, `device_s` or `idle_s`) summed
    over the spans `names`, per span of the name `per`; None where the
    slice holds no such span."""
    n = spans.get(per, {}).get("count", 0) if spans else 0
    if n <= 0:
        return None
    return 1e3 * sum(spans[s][key] for s in names if s in spans) / n


def _counters():
    """The program's counters, or None where it keeps none."""
    try:
        from nmftpu_torch.utils.metrics import counters
    except ImportError:
        return None
    return counters()


def reduce_trace(events) -> dict:
    """The slice's device summary, its `breakdown`, the program's `spans`
    and `idle_gaps_s`, the sum of the gaps `idle_gaps` names."""
    summ = device_summary(events)
    busy = summ.pop("busy")
    gaps = idle_gaps(events, busy)
    top_ops = sorted(((c, v["seconds"]) for c, v in summ["classes"].items()),
                     key=lambda x: -x[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda x: -x[1])[:TOP]
    summ["breakdown"] = {"device_ops": [list(x) for x in top_ops],
                         "idle_gaps": [list(x) for x in top_gaps]}
    summ["spans"] = program_spans(events, busy)
    summ["idle_gaps_s"] = sum(gaps.values())
    return summ


class Slice:
    """A profiled stretch of the window. `start()` snapshots the program's
    counters, synchronizes and starts the profiler; `due(now)` says
    whether `seconds` have passed; `stop()` synchronizes, stops it,
    reduces the chrome trace (`reduce_trace`), written under the
    process's temporary directory and deleted once read, and adds
    `counters`, their difference from `start()` to `stop()` (None where
    the program keeps none)."""

    def __init__(self, seconds: float, device):
        self.seconds = seconds
        self.device = device
        self.prof = None
        self.t0 = None
        self.before = None
        self.result = None

    @property
    def running(self) -> bool:
        return self.prof is not None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.before = _counters()
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def due(self, now: float) -> bool:
        return self.running and now - self.t0 >= self.seconds

    def stop(self) -> dict:
        self._sync()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        after = _counters()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.result = reduce_trace(events)
        self.result["window_s"] = window_s
        self.result["counters"] = (
            None if after is None else
            {k: v - self.before.get(k, 0) for k, v in after.items()})
        return self.result
