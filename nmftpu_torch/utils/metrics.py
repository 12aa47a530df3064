"""Observability (port of ``nmftpu/utils/metrics.py``).

The convergence records {iteration, error, delta, elapsed} that the loop
hands its callback can be persisted as JSONL (`JsonlLogger`);
`trace_session` wraps `torch.profiler` and writes a Chrome trace of the
region (CPU and, on the card, CUDA activity) into a directory;
`flops_per_iteration` is the FLOP model of one update iteration.

`span(name)` marks a stage of the program in that trace: a
`record_function` range while a torch profiler runs, so the stage lands
on the same clock as the kernels, copies and runtime calls it launches,
and nothing but a flag check otherwise. The names are fixed,
``nmftpu.<layer>.<stage>``; each stage span nests in its layer's outer
span (``nmftpu.fit``, ``nmftpu.serve.request``) on the calling thread:

  nmftpu.fit             loop.execute: every restart, init and result
    nmftpu.fit.init      a run's starting factors
    nmftpu.loop.setup    the loop's constants and its first error
    nmftpu.loop.update   one iteration's update
      nmftpu.ials.grams  an iALS half-step on ELL: the base Gram and the
                         per-row Gram deltas and right-hand sides
                         (gathers, batched products, `index_add_`)
      nmftpu.ials.solve  that half-step's per-row solves, every panel
    nmftpu.loop.check    the error check: metric, stats, its host sync,
                         callback, interrupt
    nmftpu.loop.finish   the final Frobenius and KL errors
    nmftpu.fit.result    the best run's choice, stats copy, NmfResult
  nmftpu.serve.request   Recommender.recommend_certified
    nmftpu.serve.exclusion  seen arrays built on the host, copied over
    nmftpu.serve.scan       the candidate scan
    nmftpu.serve.rescore    the candidates re-scored and sorted
    nmftpu.serve.certify    the certificate's count and seen discount
    nmftpu.serve.fetch      scores, ids and flags copied to the host
    nmftpu.serve.fallback   escalation and exact re-scan of the rows
                            that did not certify

`counters()` snapshots the port's integer counters.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO

import torch
from torch.autograd import profiler as _autograd_profiler

from nmftpu_torch.config import Algorithm, NmfConfig

# what `span` returns while no profiler runs: one shared context that
# does nothing (no RecordFunction is made)
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context marking the stage `name` of the program: a
    `torch.profiler.record_function` range while a torch profiler runs
    (`torch.profiler.profile`, `trace_session`), else a shared no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def counters() -> dict[str, int]:
    """A flat snapshot of the port's integer counters, read on the host
    (nothing waits for the device): each kernel entry's launches as
    ``launches.<entry>``, serving's certified-path counts as
    ``serve.<count>`` (`serving.COUNTS`) and iALS's on the ELL engine as
    ``ials.<count>`` (`sparse_ell.IALS_COUNTS`: ``rows_solved``,
    ``gram_segments``). Differences of two snapshots count what ran
    between them."""
    from nmftpu_torch import serving, sparse_ell
    from nmftpu_torch.kernels import (
        count_above,
        dense_mu,
        dual_numer,
        hals_sweep,
        mips_reservoir,
        quantized,
        sparse_ell_kernel,
    )

    out = {}
    for mod in (dense_mu, quantized, dual_numer, hals_sweep,
                sparse_ell_kernel, mips_reservoir, count_above):
        out.update((f"launches.{k}", int(v)) for k, v in mod.LAUNCHES.items())
    out.update((f"serve.{k}", int(v)) for k, v in serving.COUNTS.items())
    out.update((f"ials.{k}", int(v))
               for k, v in sparse_ell.IALS_COUNTS.items())
    return out


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
    (chrome://tracing, Perfetto) to `logdir`/trace.json. The card is
    synchronized before the profiler starts, so work queued before the
    region stays out of its trace, and again before it stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
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
