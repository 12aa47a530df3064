"""Iterate/converge loop (port of ``nmftpu/loop.py``).

The algorithm-specific math is injected as a `LoopOps` bundle. One run
applies the update every iteration and evaluates the error every
`check_interval` iterations and at the last one; the threshold applies to
|Δerror| between checks. The error, its delta and the stats rows
(iteration, error, delta) stay on the device; the host synchronizes once
per check, to read the error and delta that decide whether to stop and
that the callback, interrupt and verbose lines see.

The update returns new W/H tensors each iteration (the fused kernels
cannot write in place); the previous factors are freed as they go.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from nmftpu_torch.config import NmfConfig, Objective, ThresholdType


@dataclasses.dataclass(frozen=True)
class LoopOps:
    """Algorithm/data-format specific operations for the loop.

    make_aux(V)                      -> tuple of loop constants
    update(V, aux, W, H)             -> (W, H)
    effective_h(aux, H)              -> H used for error metrics
    frobenius(V, aux, W, He, svsq)   -> ||V - W He||_F  (0-dim tensor)
    kl(V, aux, W, He)                -> D_KL(V || W He)   (may be None)
    sum_v_sq(V)                      -> ||V||_F^2 (precomputed per problem)
    numel(V)                         -> total entry count n*m (for RMSD)
    """

    make_aux: Callable
    update: Callable
    effective_h: Callable
    frobenius: Callable
    kl: Callable | None
    sum_v_sq: Callable
    numel: Callable


@dataclasses.dataclass
class RunStats:
    """Per-check convergence records for one run (SURVEY.md C17)."""

    iterations: np.ndarray
    errors: np.ndarray
    deltas: np.ndarray


@dataclasses.dataclass
class NmfResult:
    """Result of a factorization: best-of-N factors plus metadata."""

    W: torch.Tensor
    H: torch.Tensor
    error: float
    frobenius_error: float
    rmsd: float
    # D_KL(V || WH) for objective=KL (the quantity best-of-N minimizes);
    # None under Frobenius.
    kl_error: float | None
    num_iterations: int
    converged: bool
    best_run: int
    run_errors: list[float]
    stats: RunStats
    # Host wall-clock over all runs (initialization included).
    elapsed_ms: float


def _verbose_callback(run_idx, iteration, error, delta):
    print(
        f"[nmftpu_torch] run {int(run_idx)} iter {int(iteration):6d}  "
        f"error {float(error):.6g}  delta {float(delta):.3g}"
    )


def _make_verbose_callback_timed():
    """Verbosity 3: per-check line including wall-clock since the run's
    first check — the reference's full stats record {iteration, error,
    delta, elapsed ms} (SURVEY.md C17)."""
    state = {"run": None, "t0": 0.0, "it": -1}

    def cb(run_idx, iteration, error, delta):
        now = time.perf_counter()
        if state["run"] != int(run_idx) or int(iteration) <= state["it"]:
            state["run"] = int(run_idx)
            state["t0"] = now
        state["it"] = int(iteration)
        ms = (now - state["t0"]) * 1e3
        print(
            f"[nmftpu_torch] run {int(run_idx)} iter {int(iteration):6d}  "
            f"error {float(error):.6g}  delta {float(delta):.3g}  "
            f"elapsed {ms:.1f} ms"
        )

    return cb


def build_runner(config: NmfConfig, ops: LoopOps, callback,
                 interrupt=None):
    """Build the single-run loop for (config, ops).

    callback(run_idx, iteration, error, delta), if given, is called with
    host numbers at every convergence check. interrupt, a zero-arg host
    callable, is polled at every check; a truthy return stops the run and
    keeps the current factors (reference C9).
    """
    if callback is None and config.verbosity >= 3:
        callback = _make_verbose_callback_timed()
    elif callback is None and config.verbosity >= 2:
        callback = _verbose_callback
    num_iterations = config.num_iterations
    check_interval = config.check_interval
    # nmftpu compares the float32 delta with the threshold in float32
    threshold = (
        float(np.float32(config.threshold_value))
        if config.threshold_value > 0
        else -float("inf")
    )
    max_checks = num_iterations // check_interval + 2
    # a non-Frobenius objective hands best-of-N its divergence through
    # the `kl` slot; convergence deltas stay on the Gram-trick Frobenius
    # metric either way
    kl_objective = config.objective is not Objective.FROBENIUS
    use_rmsd = config.threshold_type is ThresholdType.RMSD

    def error_metric(V, aux, W, H, sum_v_sq, numel):
        He = ops.effective_h(aux, H)
        fro = ops.frobenius(V, aux, W, He, sum_v_sq)
        if use_rmsd:
            fro = fro / torch.sqrt(torch.tensor(float(numel),
                                                dtype=fro.dtype))
        return fro.to(torch.float32)

    def run(V, W, H, run_idx):
        aux = ops.make_aux(V)
        sum_v_sq = ops.sum_v_sq(V)
        numel = ops.numel(V)
        err = error_metric(V, aux, W, H, sum_v_sq, numel)
        stats = torch.zeros((max_checks, 3), dtype=torch.float32,
                            device=W.device)
        it, nc = 0, 0
        delta = float("inf")
        stop = False
        while it < num_iterations and delta > threshold and not stop:
            W, H = ops.update(V, aux, W, H)
            it += 1
            if it % check_interval and it != num_iterations:
                continue
            cur = error_metric(V, aux, W, H, sum_v_sq, numel)
            d = torch.abs(err - cur)
            stats[nc, 0] = float(it)
            stats[nc, 1] = cur
            stats[nc, 2] = d
            nc += 1
            err = cur
            # the one host sync of this check
            cur_host, delta = torch.stack((cur, d)).tolist()
            if callback is not None:
                callback(run_idx, it, cur_host, delta)
            if interrupt is not None:
                stop = bool(interrupt())
        converged = delta <= threshold and not stop

        He = ops.effective_h(aux, H)
        fro = ops.frobenius(V, aux, W, He, sum_v_sq).to(torch.float32)
        if kl_objective:
            kl = ops.kl(V, aux, W, He).to(torch.float32)
            compare = kl
        else:
            kl, compare = None, err
        return W, H, err, fro, kl, compare, it, converged, stats, nc

    return run


def execute(
    V: Any,
    config: NmfConfig,
    runner,
    init_fn: Callable,
    numel: int,
) -> NmfResult:
    """Multi-run restart loop (SURVEY.md §3.5): restarts run one after
    another, `init_fn(run_idx)` gives each its factors, and the run with
    the lowest objective wins, the first on a tie: the last-checked
    error under Frobenius, the final divergence otherwise."""
    if config.vectorize_runs:
        raise NotImplementedError(
            "vectorize_runs=True is not ported to nmftpu_torch yet "
            "(ROADMAP.md slice 5); restarts run one after another"
        )
    best, best_idx = None, None
    run_errors: list[float] = []
    t0 = time.perf_counter()
    for run_idx in range(config.num_runs):
        out = runner(V, *init_fn(run_idx), run_idx)
        err = float(out[5])
        run_errors.append(err)
        if config.verbosity >= 1:
            print(
                f"[nmftpu_torch] run {run_idx}: {out[6]} iterations, "
                f"final error {err:.6g}"
                f"{' (converged)' if out[7] else ''}"
            )
        if best is None or err < run_errors[best_idx]:
            best, best_idx = out, run_idx
        del out  # a losing run's factors go before the next init
    elapsed_ms = (time.perf_counter() - t0) * 1e3

    W, H, err, fro, kl, _, it, converged, stats, nc = best
    stats_np = stats[:nc].cpu().numpy()
    fro_f = float(fro)
    return NmfResult(
        W=W,
        H=H,
        error=float(err),
        frobenius_error=fro_f,
        rmsd=fro_f / np.sqrt(numel),
        kl_error=None if kl is None else float(kl),
        num_iterations=it,
        converged=converged,
        best_run=best_idx,
        run_errors=run_errors,
        stats=RunStats(
            iterations=stats_np[:, 0].astype(np.int64),
            errors=stats_np[:, 1],
            deltas=stats_np[:, 2],
        ),
        elapsed_ms=elapsed_ms,
    )
