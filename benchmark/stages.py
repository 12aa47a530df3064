"""A cell's time by the program's own stages: one traced run of a cell,
its slice reduced by the spans the program marks while a profiler runs
(``nmftpu.<layer>.<stage>``, `nmftpu_torch.utils.span`) and by the
difference of the program's counters (`nmftpu_torch.utils.counters`)
over the slice.

    python3 benchmark/stages.py --workload <name> --seed <n> \\
        --seconds <s>

from the root of a checkout, on the card. The run is the cell's set-up
and window as `run.py` makes them, with a slice that keeps these two
records besides the ones `tracing.Slice` keeps; no check follows. The
last line of standard output is one JSON object: each span's `count`,
`host_s`, `device_s` and `idle_s` (`program_spans`), the counters'
difference, the span metrics (`METRICS`) and the closure of the idle
time (the idle seconds laid to spans and `outside` against the sum of
the gaps `tracing.idle_gaps` names).

The result line of `run.py` does not carry spans: its slice keeps none.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import harness, tracing  # noqa: E402

PREFIX = "nmftpu."
OUTSIDE = "outside"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def program_spans(events, busy) -> dict:
    """The program's spans in a chrome trace, by name: `count`; `host_s`,
    the spans' time less the program spans nested in them; `device_s`,
    the device operations (`tracing.DEVICE_CATS`) whose launching
    runtime call, found by the trace's `correlation` id, lies inside the
    span, each laid to the innermost span covering that call; `idle_s`,
    the gaps between the device's busy intervals (`busy`, merged), each
    laid to the innermost span covering its start. Operations and gaps
    that no span covers go to `outside`. Spans are host ranges
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
        if e.get("ph") == "X" and e.get("cat") in tracing.DEVICE_CATS:
            t = launched.get(e.get("args", {}).get("correlation"))
            name = OUTSIDE if t is None else innermost(t)
            entry(name)["device_s"] += e["dur"] / 1e6
    for g0, g1 in _gaps(events, busy):
        entry(innermost(g0))["idle_s"] += (g1 - g0) / 1e6
    return out


def _gaps(events, busy):
    """The idle intervals `tracing.idle_gaps` names: from the first host
    event to the first busy interval, between busy intervals, and from
    the last one to the end of the last host event."""
    host = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in tracing.HOST_CATS]
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if host:
        first, last = min(h[0] for h in host), max(h[1] for h in host)
        gaps = ([(first, busy[0][0] if busy else last)] + gaps
                + ([(busy[-1][1], last)] if busy else []))
    return [(g0, g1) for g0, g1 in gaps if g1 > g0]


def _per(spans, names, key, per):
    """Milliseconds of `key` summed over the spans `names`, per span of
    the name `per`; None where the slice holds no such span."""
    n = spans.get(per, {}).get("count", 0)
    if n <= 0:
        return None
    return 1e3 * sum(spans[s][key] for s in names if s in spans) / n


def _loop_other(spans):
    return [s for s in spans if s != "nmftpu.loop.update"
            and s.startswith(("nmftpu.fit", "nmftpu.loop."))]


# each span metric from the spans of one slice: per check, per iteration
# (`nmftpu.loop.update`), per fit (`nmftpu.fit`) or per request
# (`nmftpu.serve.request`)
METRICS = {
    "check_ms.train": lambda sp: _per(
        sp, ["nmftpu.loop.check"], "device_s", "nmftpu.loop.check"),
    "update_idle_ms.train": lambda sp: _per(
        sp, ["nmftpu.loop.update"], "idle_s", "nmftpu.loop.update"),
    "fit_idle_ms.train": lambda sp: _per(
        sp, _loop_other(sp), "idle_s", "nmftpu.fit"),
    "exclusion_ms.serve": lambda sp: _per(
        sp, ["nmftpu.serve.exclusion"], "host_s", "nmftpu.serve.request"),
    "rescore_ms.serve": lambda sp: _per(
        sp, ["nmftpu.serve.rescore"], "device_s", "nmftpu.serve.request"),
    "fallback_ms.serve": lambda sp: _per(
        sp, ["nmftpu.serve.fallback"], "device_s", "nmftpu.serve.request"),
    "program_idle_ms.serve": lambda sp: _per(
        sp, [s for s in sp if s.startswith("nmftpu.serve.")], "idle_s",
        "nmftpu.serve.request"),
}


def _counters():
    """The program's counters, or None where it keeps none."""
    try:
        from nmftpu_torch.utils.metrics import counters
    except ImportError:
        return None
    return counters()


class StageSlice(tracing.Slice):
    """`tracing.Slice`, whose result also holds `spans` (`program_spans`),
    `idle_gaps_s` (the sum of the gaps `tracing.idle_gaps` names) and
    `counters` (their difference from `start()` to `stop()`)."""

    def start(self):
        self.before = _counters()
        super().start()

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
        busy = tracing.device_summary(events)["busy"]
        self.result = tracing.reduce_trace(events)
        self.result["window_s"] = window_s
        self.result["spans"] = program_spans(events, busy)
        self.result["idle_gaps_s"] = sum(
            tracing.idle_gaps(events, busy).values())
        self.result["counters"] = (
            None if after is None else
            {k: v - self.before.get(k, 0) for k, v in after.items()})
        return self.result


def run(root: Path, workload: str, seed: int, seconds: float,
        device=None) -> dict:
    """One traced run of a cell, reduced by stage (see the module)."""
    import torch

    cell = harness.find_cell(root, workload)
    dev = harness.device_for(cell, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    kind = cell.kind
    state = kind.setup(harness.Ctx(cell, seed, dev))
    sl = StageSlice(cell.traffic["trace_seconds"], dev)
    rec = kind.window(state, seconds, sl)
    layer = kind.layer_record(state, rec)
    kind.release(state)
    tr = layer["slice"]["trace"]
    spans = tr["spans"]
    metrics = {name: fn(spans) for name, fn in METRICS.items()}
    for m in cell.per_layer():
        if m["source"] == "program_counter":
            metrics[m["name"]] = cell.reader(m["name"]).read(layer)
    attributed = sum(s["idle_s"] for s in spans.values())
    out = {"workload": workload, "seed": seed,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else dev.type),
           "window_s": tr["window_s"], "busy_s": tr["busy_s"],
           "idle_gaps_s": tr["idle_gaps_s"], "attributed_idle_s": attributed,
           "metrics": metrics, "spans": spans, "counters": tr["counters"]}
    if "uncertified" in layer["slice"]:
        out["slice_uncertified_rows"] = sum(layer["slice"]["uncertified"])
        out["slice_requests"] = layer["slice"]["requests"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    try:
        out = run(root, args.workload, args.seed, args.seconds)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
