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

`build_batched_runner` runs S such loops in lockstep on stacked factors
(S, n, r) / (S, r, m): the restarts of one V (``vectorize_runs=True``)
or a stack of problems (``batched.compute_batched``). A slot whose run
has stopped keeps its factors, iteration count and stats, as a slot of
``nmftpu``'s vmapped while-loop does, so each slot's result is the one
its run gives alone.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from nmftpu_torch.config import NmfConfig, Objective, ThresholdType
from nmftpu_torch.utils.metrics import span


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
    # stacked_update(V, W, H) -> (W, H): the update on stacked factors
    # (S, n, r) / (S, r, m) against one V (n, m) or a stack (S, n, m), as
    # batched GEMMs; routes whose aux is () may offer it (None: the
    # lockstep runner updates each slot with `update`)
    stacked_update: Callable | None = None


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
    # Sharded runs kept on the mesh (`ShardedPlan.run(unpermute=False)`):
    # the factors are this rank's permuted, padded blocks, and these map
    # each ORIGINAL index to its PERMUTED one; None everywhere else.
    row_perm: object = None
    col_perm: object = None


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


def _loop_settings(config: NmfConfig, ops: LoopOps, callback):
    """(callback, threshold, max_checks, kl_objective, error_metric)
    shared by the single and the lockstep runner."""
    if callback is None and config.verbosity >= 3:
        callback = _make_verbose_callback_timed()
    elif callback is None and config.verbosity >= 2:
        callback = _verbose_callback
    # nmftpu compares the float32 delta with the threshold in float32
    threshold = (
        float(np.float32(config.threshold_value))
        if config.threshold_value > 0
        else -float("inf")
    )
    max_checks = config.num_iterations // config.check_interval + 2
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

    return callback, threshold, max_checks, kl_objective, error_metric


def build_runner(config: NmfConfig, ops: LoopOps, callback,
                 interrupt=None):
    """Build the single-run loop for (config, ops), or, with
    ``vectorize_runs=True`` and more than one run, the lockstep runner of
    every restart (`build_batched_runner`).

    callback(run_idx, iteration, error, delta), if given, is called with
    host numbers at every convergence check. interrupt, a zero-arg host
    callable, is polled at every check; a truthy return stops the run and
    keeps the current factors (reference C9).
    """
    if config.vectorize_runs and config.num_runs > 1:
        if interrupt is not None:
            # nmftpu's refusal, word for word
            raise ValueError(
                "interrupt= cannot be combined with vectorize_runs=True "
                "(ordered io_callback does not support vmap); use "
                "sequential runs for interruptible execution"
            )
        return build_batched_runner(config, ops, callback)
    num_iterations = config.num_iterations
    check_interval = config.check_interval
    callback, threshold, max_checks, kl_objective, error_metric = \
        _loop_settings(config, ops, callback)

    def run(V, W, H, run_idx):
        with span("nmftpu.loop.setup"):
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
            with span("nmftpu.loop.update"):
                W, H = ops.update(V, aux, W, H)
            it += 1
            if it % check_interval and it != num_iterations:
                continue
            with span("nmftpu.loop.check"):
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

        with span("nmftpu.loop.finish"):
            He = ops.effective_h(aux, H)
            fro = ops.frobenius(V, aux, W, He, sum_v_sq).to(torch.float32)
            if kl_objective:
                kl = ops.kl(V, aux, W, He).to(torch.float32)
                compare = kl
            else:
                kl, compare = None, err
        return W, H, err, fro, kl, compare, it, converged, stats, nc

    return run


def build_batched_runner(config: NmfConfig, ops: LoopOps, callback=None):
    """Build the lockstep loop of S runs on stacked factors.

    `run(V, W, H, run_ids, shared_v=True)` takes W (S, n, r), H (S, r, m)
    and either one V that every slot factorizes (shared_v: the restarts
    of ``vectorize_runs``) or a sequence of S operands, one per slot (a
    stacked (S, n, m) tensor for ``compute_batched``). Every slot applies
    the update at the same iteration and is checked at the same ones; a
    slot stops as `build_runner`'s run does (threshold or iteration
    budget) and then keeps its factors, count and stats while the others
    go on. The update is `ops.stacked_update` on the whole stack where
    the route offers one (batched GEMMs; a stopped slot's new factors are
    discarded), else `ops.update` on each running slot's 2-D slices, so a
    kernel launches once per slot. The callback sees each running slot
    at each check. Returns (W, H, err, fro, kl, compare, it, converged,
    stats, nc): W and H stacked, stats (S, checks, 3), the others lists
    of S host values (kl None under Frobenius)."""
    num_iterations = config.num_iterations
    check_interval = config.check_interval
    callback, threshold, max_checks, kl_objective, error_metric = \
        _loop_settings(config, ops, callback)

    def run(V, W, H, run_ids, shared_v=True):
        S = W.shape[0]
        if shared_v:
            aux = ops.make_aux(V)
            Vs, auxs = [V] * S, [aux] * S
            svsq = [ops.sum_v_sq(V)] * S
        else:
            Vs = [V[i] for i in range(S)]
            auxs = [ops.make_aux(v) for v in Vs]
            svsq = [ops.sum_v_sq(v) for v in Vs]
        numel = ops.numel(Vs[0])
        run_ids = [int(i) for i in run_ids]
        err = [error_metric(Vs[i], auxs[i], W[i], H[i], svsq[i], numel)
               for i in range(S)]
        stats = torch.zeros((S, max_checks, 3), dtype=torch.float32,
                            device=W.device)
        its, ncs = [0] * S, [0] * S
        deltas = [float("inf")] * S
        running = [num_iterations > 0] * S
        step = 0
        while any(running):
            if ops.stacked_update is not None:
                Wn, Hn = ops.stacked_update(V, W, H)
                if not all(running):
                    keep = torch.tensor(running, device=W.device)
                    Wn = torch.where(keep[:, None, None], Wn, W)
                    Hn = torch.where(keep[:, None, None], Hn, H)
            else:
                outs = [ops.update(Vs[i], auxs[i], W[i], H[i]) if running[i]
                        else (W[i], H[i]) for i in range(S)]
                Wn = torch.stack([o[0] for o in outs])
                Hn = torch.stack([o[1] for o in outs])
                del outs
            W, H = Wn, Hn
            del Wn, Hn
            step += 1
            live = [i for i in range(S) if running[i]]
            for i in live:
                its[i] = step
            if step % check_interval and step != num_iterations:
                continue
            cur = torch.stack([error_metric(Vs[i], auxs[i], W[i], H[i],
                                            svsq[i], numel) for i in live])
            d = torch.abs(torch.stack([err[i] for i in live]) - cur)
            # the one host sync of this check
            host = torch.stack((cur, d)).tolist()
            for j, i in enumerate(live):
                stats[i, ncs[i], 0] = float(step)
                stats[i, ncs[i], 1] = cur[j]
                stats[i, ncs[i], 2] = d[j]
                ncs[i] += 1
                err[i] = cur[j]
                deltas[i] = host[1][j]
                if callback is not None:
                    callback(run_ids[i], step, host[0][j], host[1][j])
                running[i] = (step < num_iterations
                              and deltas[i] > threshold)
        converged = [delta <= threshold for delta in deltas]

        fro, kl = [], [] if kl_objective else None
        for i in range(S):
            He = ops.effective_h(auxs[i], H[i])
            fro.append(float(ops.frobenius(Vs[i], auxs[i], W[i], He,
                                           svsq[i])))
            if kl_objective:
                kl.append(float(ops.kl(Vs[i], auxs[i], W[i], He)))
        err = [float(e) for e in err]
        compare = kl if kl_objective else err
        return W, H, err, fro, kl, compare, its, converged, stats, ncs

    return run


def _run_stats(stats, nc) -> RunStats:
    stats_np = stats[:nc].cpu().numpy()
    return RunStats(
        iterations=stats_np[:, 0].astype(np.int64),
        errors=stats_np[:, 1],
        deltas=stats_np[:, 2],
    )


def _execute_vectorized(V, config, runner, init_fn, numel) -> NmfResult:
    """Every restart at once on stacked factors (`build_batched_runner`),
    each from `init_fn(run_idx)` as the sequential restarts start; the
    run with the lowest objective wins, the first on a tie."""
    t0 = time.perf_counter()
    inits = [init_fn(i) for i in range(config.num_runs)]
    Ws = torch.stack([w for w, _ in inits])
    Hs = torch.stack([h for _, h in inits])
    del inits
    W, H, err, fro, kl, compare, it, converged, stats, nc = runner(
        V, Ws, Hs, range(config.num_runs))
    del Ws, Hs
    best = int(np.argmin(compare))
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    return NmfResult(
        W=W[best].clone(),
        H=H[best].clone(),
        error=err[best],
        frobenius_error=fro[best],
        rmsd=fro[best] / np.sqrt(numel),
        kl_error=None if kl is None else kl[best],
        num_iterations=it[best],
        converged=converged[best],
        best_run=best,
        run_errors=list(compare),
        stats=_run_stats(stats[best], nc[best]),
        elapsed_ms=elapsed_ms,
    )


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
    error under Frobenius, the final divergence otherwise. With
    ``vectorize_runs=True`` (and more than one run) `runner` is
    `build_batched_runner`'s and the restarts run in lockstep."""
    with span("nmftpu.fit"):
        if config.vectorize_runs and config.num_runs > 1:
            return _execute_vectorized(V, config, runner, init_fn, numel)
        return _execute_sequential(V, config, runner, init_fn, numel)


def _execute_sequential(V, config, runner, init_fn, numel) -> NmfResult:
    best, best_idx = None, None
    run_errors: list[float] = []
    t0 = time.perf_counter()
    for run_idx in range(config.num_runs):
        with span("nmftpu.fit.init"):
            W0, H0 = init_fn(run_idx)
        out = runner(V, W0, H0, run_idx)
        del W0, H0
        with span("nmftpu.fit.result"):
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

    with span("nmftpu.fit.result"):
        W, H, err, fro, kl, _, it, converged, stats, nc = best
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
            stats=_run_stats(stats, nc),
            elapsed_ms=elapsed_ms,
        )
