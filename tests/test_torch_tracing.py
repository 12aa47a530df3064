"""The port's spans and counters (nmftpu_torch.utils.span, .counters,
serving.COUNTS) on the CPU: a span is a shared no-op with no profiler
running and a record_function range inside one; a fit and a certified
request emit their stage spans nested in one outer span; the serving
counters follow the returned flags; results are bit-identical with and
without a profiler; trace_session synchronizes the card on both sides
of its region."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import serving as PSV  # noqa: E402
from nmftpu_torch.sparse import from_dense  # noqa: E402
from nmftpu_torch.utils import counters, metrics, span  # noqa: E402

CPU = [torch.profiler.ProfilerActivity.CPU]

SERVE_STAGES = ("nmftpu.serve.exclusion", "nmftpu.serve.scan",
                "nmftpu.serve.rescore", "nmftpu.serve.certify",
                "nmftpu.serve.fetch", "nmftpu.serve.fallback")


def _spans(prof, tmp_path):
    """The program's spans of a finished profile, as (name, start, end)
    from its Chrome trace, ordered by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("name", "").startswith("nmftpu.")),
                  key=lambda s: s[1])


def _inside(outer, spans):
    """The names of the spans that lie within `outer`'s interval."""
    return [n for n, a, b in spans
            if (n, a, b) != outer and outer[1] <= a and b <= outer[2]]


def _ratings(seed=0, n=60, m=40):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, m)) < 0.25) * rng.uniform(1.0, 5.0, (n, m))
    return from_dense(a.astype(np.float32))


def _fit(sp):
    return nt.nmf(sp, 4, device="cpu", strategy="ell", num_iterations=50,
                  check_interval=10, threshold=0.0, seed=3)


def _recommender(seed=8, n=40, m=320, slots=8):
    """A catalog too wide for an 8-slot reservoir: most rows miss an item
    and cannot certify."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (n, 8)).astype(np.float32)
    mag = np.logspace(0, -2, 8).astype(np.float32)[:, None]
    H = (rng.uniform(0.0, 1.0, (8, m)) * mag).astype(np.float32)
    # two seen items a user: k + 2 candidates fit the reservoir's 2 * slots
    seen = np.zeros((n, m), np.float32)
    for row in seen:
        row[rng.choice(m, 2, replace=False)] = 1.0
    return nt.Recommender(W, H, train=from_dense(seen), method="reservoir",
                          reservoir_slots=slots, device="cpu")


class _Spy:
    """Stands in for torch.profiler.record_function, counting the ranges
    made."""

    made = 0

    def __init__(self, name):
        type(self).made += 1
        self.inner = torch.autograd.profiler.record_function(name)

    def __enter__(self):
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch,
                                                   tmp_path):
    monkeypatch.setattr(_Spy, "made", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Spy)
    first, second = span("nmftpu.a"), span("nmftpu.b")
    assert first is second is metrics._NO_SPAN
    with first:
        pass
    assert _Spy.made == 0
    with torch.profiler.profile(activities=CPU) as prof:
        with span("nmftpu.test.stage"):
            torch.ones(3).sum()
    assert _Spy.made == 1
    assert [n for n, _, _ in _spans(prof, tmp_path)] == ["nmftpu.test.stage"]
    assert span("nmftpu.c") is metrics._NO_SPAN


def test_a_fit_nests_its_stages_in_one_fit_span(tmp_path):
    sp = _ratings()
    with torch.profiler.profile(activities=CPU) as prof:
        res = _fit(sp)
    assert res.num_iterations == 50
    spans = _spans(prof, tmp_path)
    fits = [s for s in spans if s[0] == "nmftpu.fit"]
    assert len(fits) == 1
    inner = _inside(fits[0], spans)
    assert len(inner) == len(spans) - 1     # every stage inside the fit
    assert inner.count("nmftpu.loop.update") == 50
    assert inner.count("nmftpu.loop.check") == 5
    for stage in ("nmftpu.fit.init", "nmftpu.loop.setup",
                  "nmftpu.loop.finish", "nmftpu.fit.result"):
        assert stage in inner, stage


@pytest.mark.parametrize("users", [np.arange(12), np.arange(40)],
                         ids=["exact-only", "escalated"])
def test_a_certified_request_nests_six_stages_and_counts_rows(
        tmp_path, users, monkeypatch):
    rec = _recommender()
    exact_calls = []
    orig = rec._exact_rows

    def spy(u, k, ex):
        exact_calls.append(len(u))
        return orig(u, k, ex)

    monkeypatch.setattr(rec, "_exact_rows", spy)
    before = counters()
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(2):
            s, i, cert = rec.recommend_certified(users, k=10,
                                                 fallback="exact")
    moved = {k: v - before[k] for k, v in counters().items()}
    bad = int((~cert).sum())
    assert bad > 0
    assert moved["serve.certified_requests"] == 2
    assert moved["serve.rows"] == 2 * len(users)
    assert moved["serve.uncertified_rows"] == 2 * bad
    assert moved["serve.exact_rows"] == sum(exact_calls)
    assert moved["serve.exact_rows"] <= moved["serve.uncertified_rows"]
    if bad > 16:
        assert moved["serve.escalated_rows"] == 2 * bad
    else:
        assert moved["serve.escalated_rows"] == 0
        assert moved["serve.exact_rows"] == 2 * bad
    spans = _spans(prof, tmp_path)
    requests = [s for s in spans if s[0] == "nmftpu.serve.request"]
    assert len(requests) == 2
    for req in requests:
        inner = _inside(req, spans)
        assert sorted(inner) == sorted(SERVE_STAGES), inner
    # nothing of the program runs outside a request
    assert len(spans) == 2 * (1 + len(SERVE_STAGES))


def test_counters_name_every_kernel_entry():
    snap = counters()
    assert all(type(v) is int for v in snap.values())
    assert {"launches.reservoir_scan", "launches.count_above",
            "launches.ell_rowsums", "launches.w_update_fused",
            "launches.hals_sweep"} <= set(snap)
    assert {f"serve.{k}" for k in PSV.COUNTS} <= set(snap)


def test_results_are_bit_identical_under_a_profiler():
    sp = _ratings(1)
    plain = _fit(sp)
    rec = _recommender(9)
    users = np.arange(40)
    served = rec.recommend_certified(users, k=10, fallback="exact")
    with torch.profiler.profile(activities=CPU):
        traced = _fit(sp)
        served_t = rec.recommend_certified(users, k=10, fallback="exact")
    assert torch.equal(plain.W, traced.W) and torch.equal(plain.H, traced.H)
    assert plain.error == traced.error
    np.testing.assert_array_equal(plain.stats.errors, traced.stats.errors)
    for a, b in zip(served, served_t):
        np.testing.assert_array_equal(a, b)


def test_trace_session_synchronizes_before_and_after(monkeypatch,
                                                     tmp_path):
    log = []

    class FakeProfile:
        def __init__(self, activities):
            log.append(("activities", len(activities)))

        def start(self):
            log.append("start")

        def stop(self):
            log.append("stop")

        def export_chrome_trace(self, path):
            log.append("export")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: log.append("sync"))
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    with metrics.trace_session(str(tmp_path / "tr")):
        log.append("region")
    assert log == ["sync", ("activities", 2), "start", "region", "sync",
                   "stop", "export"]
