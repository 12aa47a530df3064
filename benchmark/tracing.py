"""The traced slice of a run: `torch.profiler` over a bounded stretch of
the steady window, reduced to device seconds by kernel class, the busy
and idle time of the device, and the idle gaps named by what the host
was doing (the benchmark's own `record_function` spans around each call
into the program, or the innermost operator the profiler saw).

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
TOP = 10


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
    if host:
        first, last = host[0][0], max(h[1] for h in host)
        gaps = [(first, busy[0][0] if busy else last)]
        gaps += [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        if busy:
            gaps.append((busy[-1][1], last))
    else:
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    named: dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
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


def reduce_trace(events) -> dict:
    summ = device_summary(events)
    gaps = idle_gaps(events, summ.pop("busy"))
    top_ops = sorted(((c, v["seconds"]) for c, v in summ["classes"].items()),
                     key=lambda x: -x[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda x: -x[1])[:TOP]
    summ["breakdown"] = {"device_ops": [list(x) for x in top_ops],
                         "idle_gaps": [list(x) for x in top_gaps]}
    return summ


class Slice:
    """A profiled stretch of the window. `start()` synchronizes and starts
    the profiler; `due(now)` says whether `seconds` have passed; `stop()`
    synchronizes, stops it, and reduces the chrome trace, written under
    the process's temporary directory and deleted once read."""

    def __init__(self, seconds: float, device):
        self.seconds = seconds
        self.device = device
        self.prof = None
        self.t0 = None
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
        return self.result
