"""The reduction of a trace by the program's spans
(`tracing.program_spans`) on hand-made traces, the span metrics' readers,
the `exact_rows.serve` and `ell_kl_roofline` readers, the device and host
readers on records with and without the program's spans, and a traced
run of each cell at the tiny size on the CPU, by stage (`stages.py`) and
as the result line carries it."""

import json
import time

import pytest
from conftest import ROOT, check_span_metrics, check_stages

from benchmark import harness, tracing, yardstick

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
    return tracing.program_spans(events, summ["busy"]), summ["busy"]


SPAN_METRICS = [m["name"] for m in BENCH["per_layer"]
                if m["source"] == "program_span"]


def _reader(metric):
    return harness.load_module(ROOT / "benchmark" / "metrics"
                               / f"{metric}.py")


def _span_metrics(spans):
    """Every span metric's reader on a record whose slice holds `spans`."""
    rec = {"slice": {"trace": {"spans": spans}}}
    return {n: _reader(n).read(rec) for n in SPAN_METRICS}


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
    assert len(SPAN_METRICS) == 7
    spans, _ = _reduce(_trace())
    got = _span_metrics(spans)
    assert got["exclusion_ms.serve"] == 0.0
    assert got["rescore_ms.serve"] == 0.0
    assert got["fallback_ms.serve"] == 0.0
    assert got["program_idle_ms.serve"] == pytest.approx(
        (25 + 80) * 1e-3 / 2)
    for name in ("check_ms.train", "update_idle_ms.train",
                 "fit_idle_ms.train"):
        assert got[name] is None
    none, _ = _reduce([_x("k", "kernel", 0, 5, correlation=1)])
    assert all(v is None for v in _span_metrics(none).values())
    # a record with no traced slice, or a slice without spans
    for rec in ({"slice": None}, {"slice": {"trace": {}}}):
        assert all(_reader(n).read(rec) is None for n in SPAN_METRICS)


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
    got = _span_metrics(spans)
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
                         "ell_rowsums": {"seconds": 0.2, "events": 8},
                         "ell_kl": {"seconds": 0.3, "events": 8}},
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
                                    if m["name"] != "exact_rows.serve"
                                    and m["source"] != "program_span"])
def test_existing_readers_ignore_the_new_keys(metric):
    """The readers of the device trace and the host clock read the same
    with and without the program's spans and counters in the slice."""
    reader = _reader(metric)
    rec, with_keys = _layer(False), _layer(True)
    if metric.startswith("ell_"):
        for r in (rec, with_keys):
            r["slice"]["launches"] = {"ell_rowsums": 8, "ell_kl": 8}
    assert reader.read(rec) == reader.read(with_keys)


def test_ell_kl_roofline_on_a_synthetic_record():
    """#11's share: the launches, half W half-steps and half H
    half-steps, each at 4·nnz·r operations over the float32 peak (the
    bound at ML-20M's shape, r = 64), over the kernel's device time;
    #10's launches and time do not enter it."""
    n, m, r, nnz = 138493, 26744, 64, 20000263
    least = 4.0 * nnz * r / 67e12
    assert least * 1e3 == pytest.approx(0.0764, abs=1e-4)
    for own, table in ((n, m), (m, n)):
        assert yardstick.bound_s(*yardstick.ell_kl_work(own, table, r, nnz),
                                 yardstick.F32_PEAK) \
            == (pytest.approx(least), "operations")
    rec = {"n": n, "m": m, "r": r, "nnz": nnz,
           "slice": {"launches": {"ell_kl": 800, "ell_rowsums": 5},
                     "trace": {"classes": {
                         "ell_kl": {"seconds": 800 * 0.795e-3,
                                    "events": 800},
                         "ell_rowsums": {"seconds": 1.0, "events": 5}}}}}
    got = _reader("ell_kl_roofline").read(rec)
    assert got == pytest.approx(100 * least / 0.795e-3)
    assert 9.5 < got < 9.7
    rec["slice"]["launches"]["ell_kl"] = 0
    assert _reader("ell_kl_roofline").read(rec) is None
    rec["slice"]["launches"]["ell_kl"] = 800
    del rec["slice"]["trace"]["classes"]["ell_kl"]
    assert _reader("ell_kl_roofline").read(rec) is None
    # the #10 reader reads its own launches alone
    assert _reader("ell_rowsums_roofline").read(rec) == pytest.approx(
        100 * 5 * yardstick.bound_s(*yardstick.ell_spmm_work(n, m, r, nnz),
                                    yardstick.F32_PEAK)[0])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_tiny_run_reduces_by_stage(tiny_root, cell):
    check_stages(tiny_root, cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_result_line_carries_the_span_metrics(tiny_root, cell):
    check_span_metrics(tiny_root, cell)


def test_the_result_line_reports_exact_rows(tiny_root):
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["traffic"].startswith("serve"))
    out = harness.run_cell(tiny_root, cell, 2**31 + 13, 0.3, True,
                           time.perf_counter(), device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["exact_rows.serve"]["value"] >= 0
    assert out["metrics"]["exact_rows.serve"]["unit"] == "rows"
