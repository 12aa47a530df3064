"""The reduction of a trace by the program's spans (`stages.py`) on
hand-made traces, its span metrics, the `exact_rows.serve` reader, the
existing readers on records with and without the new keys, and a traced
run of each kind of cell at the tiny size on the CPU."""

import json
import time

import pytest
from conftest import ROOT

from benchmark import harness, stages, tracing

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    """A request span [0, 100] holding a scan [10, 40] and a fetch
    [60, 90], one program span outside it [200, 220], and a benchmark
    span around the request. Two kernels launched in the scan and the
    fetch, one launched outside every span, a copy in the late span, and
    a device-side copy of a span that is no device work."""
    return [
        _x("bench.request", "user_annotation", -5, 110),
        _x("nmftpu.serve.request", "user_annotation", 0, 100),
        _x("nmftpu.serve.scan", "user_annotation", 10, 30),
        _x("nmftpu.serve.fetch", "user_annotation", 60, 30),
        _x("nmftpu.serve.request", "user_annotation", 200, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 2, correlation=1),
        _x("cudaMemcpyAsync", "cuda_runtime", 62, 20, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 150, 2, correlation=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 205, 2, correlation=4),
        _x("reservoir_tc_kernel", "kernel", 20, 30, correlation=1),
        _x("Memcpy DtoH", "gpu_memcpy", 70, 10, correlation=2),
        _x("other_kernel", "kernel", 160, 10, correlation=3),
        _x("Memcpy HtoD", "gpu_memcpy", 210, 5, correlation=4),
        _x("nmftpu.serve.scan", "gpu_user_annotation", 20, 100),
    ]


def _reduce(events):
    summ = tracing.device_summary(events)
    return stages.program_spans(events, summ["busy"]), summ["busy"]


def test_program_spans_nest_self_time_and_correlation():
    spans, busy = _reduce(_trace())
    # the device copy of a span is not busy time
    assert busy == [[20, 50], [70, 80], [160, 170], [210, 215]]
    req, scan = spans["nmftpu.serve.request"], spans["nmftpu.serve.scan"]
    assert req["count"] == 2 and scan["count"] == 1
    # 100 + 20 less the scan's 30 and the fetch's 30
    assert req["host_s"] == pytest.approx(60e-6)
    assert scan["host_s"] == pytest.approx(30e-6)
    assert scan["device_s"] == pytest.approx(30e-6)
    assert spans["nmftpu.serve.fetch"]["device_s"] == pytest.approx(10e-6)
    assert req["device_s"] == pytest.approx(5e-6)
    assert spans["outside"]["device_s"] == pytest.approx(10e-6)


def test_idle_goes_to_the_innermost_span_and_closes():
    events = _trace()
    spans, busy = _reduce(events)
    # gaps: [-5, 20] starts outside the program; [50, 70] in the request;
    # [80, 160] in the fetch; [170, 210] outside; [215, 220] in the
    # request
    assert spans["outside"]["idle_s"] == pytest.approx((25 + 40) * 1e-6)
    assert spans["nmftpu.serve.request"]["idle_s"] == pytest.approx(
        (20 + 5) * 1e-6)
    assert spans["nmftpu.serve.fetch"]["idle_s"] == pytest.approx(80e-6)
    assert spans["nmftpu.serve.scan"]["idle_s"] == 0.0
    total = sum(s["idle_s"] for s in spans.values())
    assert total == pytest.approx(
        sum(tracing.idle_gaps(events, busy).values()), abs=1e-6)


def test_span_metrics_per_request_and_none_without_spans():
    spans, _ = _reduce(_trace())
    got = {n: fn(spans) for n, fn in stages.METRICS.items()}
    assert got["exclusion_ms.serve"] == 0.0
    assert got["rescore_ms.serve"] == 0.0
    assert got["fallback_ms.serve"] == 0.0
    assert got["program_idle_ms.serve"] == pytest.approx(
        (25 + 80) * 1e-3 / 2)
    for name in ("check_ms.train", "update_idle_ms.train",
                 "fit_idle_ms.train"):
        assert got[name] is None
    none, _ = _reduce([_x("k", "kernel", 0, 5, correlation=1)])
    assert all(fn(none) is None for fn in stages.METRICS.values())


def test_training_span_metrics():
    ev = [_x("nmftpu.fit", "user_annotation", 0, 100),
          _x("nmftpu.loop.setup", "user_annotation", 1, 4)]
    for j in range(4):
        ev.append(_x("nmftpu.loop.update", "user_annotation",
                     10 + 10 * j, 8))
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", 11 + 10 * j, 1,
                     correlation=j))
        ev.append(_x("k", "kernel", 12 + 10 * j, 4, correlation=j))
    ev += [_x("nmftpu.loop.check", "user_annotation", 50, 20),
           _x("cudaLaunchKernel", "cuda_runtime", 52, 1, correlation=9),
           _x("k", "kernel", 55, 5, correlation=9),
           _x("nmftpu.fit.result", "user_annotation", 80, 10)]
    spans, _ = _reduce(ev)
    got = {n: fn(spans) for n, fn in stages.METRICS.items()}
    assert got["check_ms.train"] == pytest.approx(5e-3)
    # gaps starting in an update: [16, 22], [26, 32], [36, 42], [46, 55];
    # in the fit before the first kernel, [0, 12]; in the check after
    # the last one, [60, 100]
    assert got["update_idle_ms.train"] == pytest.approx(27e-3 / 4)
    assert got["fit_idle_ms.train"] == pytest.approx((12 + 40) * 1e-3)
    assert got["exclusion_ms.serve"] is None


def test_exact_rows_reader_reads_the_program_counters(monkeypatch):
    from nmftpu_torch import serving

    reader = harness.load_module(ROOT / "benchmark" / "metrics"
                                 / "exact_rows.serve.py")
    monkeypatch.setattr(serving, "COUNTS", dict.fromkeys(serving.COUNTS, 0))
    assert reader.read({}) is None
    serving.COUNTS.update(certified_requests=4, exact_rows=6)
    assert reader.read({}) == 1.5


def _layer(new_keys: bool):
    trace = {"classes": {"reservoir_scan": {"seconds": 1.0, "events": 4},
                         "count_above": {"seconds": 0.5, "events": 4},
                         "ell_rowsums": {"seconds": 0.2, "events": 8}},
             "busy_s": 1.6, "span_s": 1.9, "window_s": 2.0,
             "breakdown": {"device_ops": [], "idle_gaps": []}}
    if new_keys:
        trace.update(spans=_reduce(_trace())[0], counters={"x": 1},
                     idle_gaps_s=0.4)
    return {"b": 512, "n": 100000, "m": 10000000, "r": 200, "nnz": 10**6,
            "table_dtype": "int8", "slots": 4096, "method": "reservoir",
            "requests": 10, "mean_request_s": 0.04, "uncertified_rows": 7,
            "flops_per_iteration": 1e9, "peak": 67e12, "iteration_s": 2e-3,
            "slice": {"requests": 4, "iterations": 8, "launches": [4, 4],
                      "wall_s": 2.0, "trace": trace}}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]
                                    if m["name"] != "exact_rows.serve"])
def test_existing_readers_ignore_the_new_keys(metric):
    reader = harness.load_module(ROOT / "benchmark" / "metrics"
                                 / f"{metric}.py")
    rec = _layer(False)
    if metric == "ell_rowsums_roofline":
        rec["slice"]["launches"] = 8
    with_keys = _layer(True)
    with_keys["slice"]["launches"] = rec["slice"]["launches"]
    assert reader.read(rec) == reader.read(with_keys)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_tiny_run_reduces_by_stage(tiny_root, cell):
    out = stages.run(tiny_root, cell, 2**31 + 11, 0.3, device="cpu")
    assert out["device"] == "cpu"
    m = out["metrics"]
    if cell.startswith("text2image10m"):
        assert m["exclusion_ms.serve"] > 0
        assert m["exact_rows.serve"] is not None
        assert out["counters"]["serve.uncertified_rows"] \
            == out["slice_uncertified_rows"]
        assert out["spans"]["nmftpu.serve.request"]["count"] \
            == out["slice_requests"]
    else:
        # a check every 10 iterations, and none between
        assert 10 * out["spans"]["nmftpu.loop.check"]["count"] \
            == out["spans"]["nmftpu.loop.update"]["count"]
        assert m["check_ms.train"] == 0.0          # no device here
    assert out["attributed_idle_s"] == pytest.approx(out["idle_gaps_s"],
                                                     abs=1e-6)


def test_the_result_line_reports_exact_rows(tiny_root):
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["traffic"].startswith("serve"))
    out = harness.run_cell(tiny_root, cell, 2**31 + 13, 0.3, True,
                           time.perf_counter(), device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["exact_rows.serve"]["value"] >= 0
    assert out["metrics"]["exact_rows.serve"]["unit"] == "rows"
