"""The port's observability utilities (nmftpu_torch.utils) against
nmftpu.utils: the FLOP model's integer for every algorithm, dense and
sparse; the JSONL logger's records; the torch.profiler trace session.
Exact comparisons (integers, record keys and values)."""

import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmftpu  # noqa: E402
from nmftpu.utils import JsonlLogger as JLogger  # noqa: E402
from nmftpu.utils import flops_per_iteration as j_flops  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch.utils import (  # noqa: E402
    JsonlLogger,
    flops_per_iteration,
    trace_session,
)

ALGORITHMS = ["mu", "als", "acls", "ahcls", "gdcls", "nsnmf", "hals"]


@pytest.mark.parametrize("algorithm", ALGORITHMS + [None])
@pytest.mark.parametrize("nnz", [None, 0, 12_345, 20_000_263])
@pytest.mark.parametrize("shape", [(943, 1682, 32), (138_493, 26_744, 64),
                                   (4096, 4096, 256)])
def test_flops_per_iteration_equals_nmftpu(algorithm, nnz, shape):
    n, m, r = shape
    jc = tc = None
    if algorithm is not None:
        jc = nmftpu.NmfConfig(rank=r, algorithm=algorithm)
        tc = nt.NmfConfig(rank=r, algorithm=algorithm)
    want = j_flops(n, m, r, jc, nnz=nnz)
    got = flops_per_iteration(n, m, r, tc, nnz=nnz)
    assert type(got) is int and got == want


def _records(logger_cls, stream):
    with logger_cls(stream) as lg:
        lg.bind(cfg="c2", mesh=None)
        cb = lg.as_callback()
        cb(np.int32(1), np.int64(10), np.float32(2.5), 0.25)
        lg.log(kind="summary", value=3)
    return [json.loads(line) for line in stream.getvalue().splitlines()]


def test_jsonl_logger_records_match_nmftpu():
    got = _records(JsonlLogger, io.StringIO())
    want = _records(JLogger, io.StringIO())
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k in g:
            if k not in ("ts", "elapsed_ms"):
                assert g[k] == w[k], k
    assert got[0]["run"] == 1 and got[0]["iteration"] == 10


def test_jsonl_logger_file_and_driver_callback(tmp_path):
    path = tmp_path / "m.jsonl"
    V = np.random.default_rng(0).uniform(0.1, 1, (30, 20)).astype(np.float32)
    with JsonlLogger(str(path)).bind(run_name="x") as lg:
        res = nt.nmf(V, 3, num_iterations=20, check_interval=5,
                     device="cpu", callback=lg.as_callback())
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["iteration"] for r in recs] == [5, 10, 15, 20]
    np.testing.assert_allclose([r["error"] for r in recs],
                               res.stats.errors, rtol=1e-6)
    assert all(r["run_name"] == "x" for r in recs)


def test_trace_session_writes_a_chrome_trace(tmp_path):
    V = torch.rand(40, 30)
    with trace_session(str(tmp_path / "tr")):
        nt.nmf(V, 3, num_iterations=3)
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    trace = json.loads(path.read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names)
    assert os.path.getsize(path) > 0
