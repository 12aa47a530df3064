"""Shared fixtures and checks of the benchmark's CPU tests: the checkout
root on the import path; a copy of the benchmark cut to a size the CPU
runs in seconds (the same files, each configuration and traffic mix
merged with the `tiny` object it carries); and the checks every cell is
held to, run on a cell of a given root."""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults, harness, stages  # noqa: E402

SEED = 2**31 + 77


def copy_bench(dst: Path) -> Path:
    """A checkout-like root at `dst` holding BENCHMARK.json and a copy of
    the benchmark's folder, at full size."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def _merge(d: dict, tiny: dict) -> None:
    for key, value in tiny.items():
        if isinstance(value, dict):
            d[key].update(value)
        else:
            d[key] = value


def shrink(root: Path) -> Path:
    """Cut every configuration and traffic mix that a cell of `root`'s
    BENCHMARK.json runs to its `tiny` object (a group of the file,
    such as `data`, is updated key by key). A file without one is an
    error: the CPU would run it at full size."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    files = {root / c["file"] for c in bench["configs"]}
    files |= {root / bench["paths"][0] / "traffic" / (w["traffic"] + ".json")
              for w in bench["workloads"]}
    for path in sorted(files):
        d = json.loads(path.read_text())
        if "tiny" not in d:
            raise KeyError(f"{path.name} has no `tiny` sizes")
        _merge(d, d["tiny"])
        path.write_text(json.dumps(d))
    return root


def make_tiny(dst: Path) -> Path:
    """`copy_bench`, then `shrink`."""
    return shrink(copy_bench(dst))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


def kind_faults(root: Path, cell: str) -> list[str]:
    """The faults the cell's kind declares."""
    return list(harness.find_cell(root, cell).kind.FAULTS)


def run(root: Path, cell: str, trace=False, seed=SEED):
    return harness.run_cell(root, cell, seed, 0.3, trace,
                            time.perf_counter(), device="cpu")


def check_resolves(root: Path, cell: str):
    """The cell's files resolve by name, and it reports `setup_s`, another
    end-to-end metric and a per-layer metric."""
    c = harness.find_cell(root, cell)
    assert c.kind.setup and c.kind.window and c.kind.compare
    assert c.kind.FAULTS, "every kind declares its faults"
    assert c.reference is not None
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())
    assert (root / "benchmark" / "datagen"
            / (c.config["data"]["generator"] + ".py")).is_file()
    assert c.config["control"] in ("tf32", "fp8")
    assert "tiny" in c.config and "tiny" in c.traffic
    for m in c.per_layer():
        assert callable(c.reader(m["name"]).read)
    reported = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer(), "every cell reports a per-layer metric"


def check_sound(root: Path, cell: str):
    out = run(root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"


def check_control(root: Path, cell: str):
    c = harness.find_cell(root, cell)
    ctx = harness.Ctx(c, SEED, harness.device_for(c, "cpu"))
    state = c.kind.setup(ctx)
    rec = c.kind.window(state, 0.2, None)
    c.kind.release(state)
    numbers = c.kind.compare(state, c.kind.control(state, rec, c.reference),
                             c.reference)
    checks = harness.judged(numbers, c.limits)
    assert not harness.is_correct(checks), checks


def check_fault(root: Path, cell: str, fault: str):
    with faults.planted(harness.find_cell(root, cell).kind, fault):
        out = run(root, cell)
    assert not out["correct"], out["checks"]


def check_stages(root: Path, cell: str, seed=2**31 + 11):
    """A traced tiny run reduced by stage: the program's spans and
    counters agree with what the window counted, and the idle laid to
    spans closes on the gaps."""
    out = stages.run(root, cell, seed, 0.3, device="cpu")
    assert out["device"] == "cpu"
    spans, m = out["spans"], out["metrics"]
    traffic = harness.find_cell(root, cell).traffic
    if "nmftpu.serve.request" in spans:
        assert m["exclusion_ms.serve"] > 0
        assert m["exact_rows.serve"] is not None
        assert out["counters"]["serve.uncertified_rows"] \
            == out["slice_uncertified_rows"]
        assert spans["nmftpu.serve.request"]["count"] \
            == out["slice_requests"]
    else:
        # a check every `check_interval` iterations, and none between
        assert traffic["check_interval"] \
            * spans["nmftpu.loop.check"]["count"] \
            == spans["nmftpu.loop.update"]["count"]
        assert m["check_ms.train"] == 0.0          # no device here
    assert out["attributed_idle_s"] == pytest.approx(out["idle_gaps_s"],
                                                     abs=1e-6)
    return out


def check_span_metrics(root: Path, cell: str, seed=2**31 + 13):
    """A traced tiny run's result line carries every span metric
    (`program_span`, `program_counter`) its cell lists, each a number."""
    c = harness.find_cell(root, cell)
    out = run(root, cell, trace=True, seed=seed)
    assert out["correct"], out["checks"]
    want = {m["name"]: m["unit"] for m in c.per_layer()
            if m["source"] in ("program_span", "program_counter")}
    assert want, "the cell lists a metric of the program's spans"
    for name, unit in want.items():
        got = out["metrics"][name]
        assert got["unit"] == unit and got["value"] >= 0, (name, got)
    return out
