"""Observability (port of ``nmftpu/utils/metrics.py``).

The convergence records {iteration, error, delta, elapsed} that the loop
hands its callback can be persisted as JSONL (`JsonlLogger`);
`trace_session` wraps `torch.profiler` and writes a Chrome trace of the
region (CPU and, on the card, CUDA activity) into a directory;
`flops_per_iteration` is the FLOP model of one update iteration.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO

from nmftpu_torch.config import Algorithm, NmfConfig


class JsonlLogger:
    """Append-only JSONL metrics sink usable as a compute() callback.

    Each convergence check appends
      {"ts", "run", "iteration", "error", "delta", "elapsed_ms"}.
    Extra context fields (e.g. config name) can be bound once via `bind`.
    """

    def __init__(self, path_or_file: str | IO):
        if hasattr(path_or_file, "write"):
            self._f = path_or_file
            self._own = False
        else:
            self._f = open(path_or_file, "a")
            self._own = True
        self._t0 = time.perf_counter()
        self._bound: dict = {}

    def bind(self, **fields) -> "JsonlLogger":
        self._bound.update(fields)
        return self

    def log(self, **record) -> None:
        rec = {
            "ts": time.time(),
            "elapsed_ms": (time.perf_counter() - self._t0) * 1e3,
            **self._bound,
            **record,
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def as_callback(self):
        """Adapter matching the driver callback signature."""

        def cb(run_idx, iteration, error, delta):
            self.log(
                run=int(run_idx),
                iteration=int(iteration),
                error=float(error),
                delta=float(delta),
            )

        return cb

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def trace_session(logdir: str):
    """Profile a region with `torch.profiler` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome trace
    (chrome://tracing, Perfetto) to `logdir`/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def flops_per_iteration(
    n: int, m: int, rank: int, config: NmfConfig | None = None,
    nnz: int | None = None,
) -> int:
    """FLOP model for one update iteration (used for GFLOP/s reporting).

    Dense MU: the two O(nmr) products dominate; sparse replaces them with
    O(nnz * r) gather/scatter FLOPs. ALS-family adds the O(r^3) solves
    (negligible). Good to ~10% — intended for roofline ratios, not exact
    accounting. The same integer as ``nmftpu``'s.
    """
    r = rank
    if nnz is not None:
        big = 8 * nnz * r          # wt_v + v_ht (mul+add each) x2 halves
    else:
        big = 4 * n * m * r
    grams = 4 * n * r * r + 4 * m * r * r
    elementwise = 3 * (n * r + m * r)
    total = big + grams + elementwise
    if config is not None and config.algorithm in (
        Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS, Algorithm.GDCLS,
    ):
        total += 2 * r ** 3  # LU-ish solve cost, both sides
    return total
