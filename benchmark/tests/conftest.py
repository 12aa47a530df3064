"""Shared fixtures of the benchmark's CPU tests: the checkout root on the
import path, and a copy of the benchmark cut to a size the CPU runs in
seconds (the same files, with the configurations' scale and the traffic's
batch made small)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_DATA = {
    "ml20m": dict(n_users=240, n_items=160, n_ratings=7200,
                  rows_per_chunk=64),
    "text2image10m": dict(n_users=200, n_items=6000, columns_per_chunk=1024),
}


def _edit(path: Path, **changes):
    d = json.loads(path.read_text())
    for key, value in changes.items():
        if isinstance(value, dict):
            d[key].update(value)
        else:
            d[key] = value
    path.write_text(json.dumps(d))


def make_tiny(dst: Path) -> Path:
    """A checkout-like root at `dst` holding BENCHMARK.json and a tiny
    copy of the benchmark's folder."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    cfgs = dst / "benchmark" / "configs"
    _edit(cfgs / "ml20m.json", data=TINY_DATA["ml20m"])
    _edit(cfgs / "text2image10m.json", data=TINY_DATA["text2image10m"],
          serving={"reservoir_slots": 64})
    tr = dst / "benchmark" / "traffic"
    for name in ("train-kl", "train-fro-kernel"):
        _edit(tr / f"{name}.json", iterations=20, trace_seconds=0.1)
    _edit(tr / "serve-b512.json", batch=24, k=10, trace_seconds=0.1,
          warmup_requests=1, sample_rows_per_request=24,
          max_check_rows=4096)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))
