"""Smoke run of the PyTorch/CUDA port (nmftpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from nmftpu_torch/csrc with nvcc (sm_90a), checks
each against its plain torch twin, drives nmftpu_torch.nmf end to end at
the 4096 x 4096 / rank-256 headline shape and at the ML-20M shape, times
one MU iteration on three paths, then serves top-k recommendations with
nmftpu_torch.Recommender at BASELINE config 5's full width (10,485,760
items, rank 256, batches of 512 and 2048 users, k = 100) through the
reservoir-scan and count-above kernels, and times the serving paths.
Phases 10-12 factorize sparse V at BASELINE config 2's full width
(ML-20M's 138,493 x 26,744 shape and 20,000,263 ratings, rank 64)
through the ELL engine with the segment-SpMM kernel, the plain ELL
engine and the densified bf16 engine, under the Frobenius and KL
objectives, and time them. Every phase prints its results; any failure
exits non-zero. Without a CUDA device it exits 1 and runs nothing.

The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SEED = 20240611

# phase 3: kernel vs plain twin, all inputs nonnegative. float32 sums of up
# to K = 4096 terms in two orders differ by ~sqrt(K) * 2^-24 ~ 4e-6
# relative; the ratio num / den adds two such errors. 1e-4 leaves >10x.
KERNEL_RTOL = 1e-4
KERNEL_SHAPES = [(4096, 4096, 256), (943, 1682, 32), (1000, 1500, 37)]
# phase 4: final W/H of 50 kernel iterations vs the plain path, as
# max|a - b| / max|b|. The per-step reordering error above compounds over
# the run: 3e-6 after 50 steps at 1024^2 / r = 64 on the CPU; 1e-3 leaves
# room for K = 4096 and r = 256.
E2E_RTOL = 1e-3

# phases 7-9: the serving kernels. Scores are float32 sums of 256 exact
# products in two orders, ~sqrt(256) * 2^-24 = 1e-6 relative apart;
# 1e-5 leaves 10x. Ids and counts may differ only at such near-ties.
SCAN_RTOL = 1e-5
# BASELINE config 5 at full width; users as ML-20M's
SERVE_USERS, SERVE_ITEMS, SERVE_RANK = 138_493, 10_485_760, 256
SERVE_SEEN = 100            # seen items per user, uniform over the catalog
SERVE_K = 100
RECALL_FLOOR = 0.999        # expected miss C(k,3)/R^2 = 0.0096 items/row

# phases 10-12: the ELL segment SpMM. Each output is a float32 sum of at
# most 512 nonnegative products in two orders, ~sqrt(512) * 2^-24 =
# 1.3e-6 relative apart; 1e-5 leaves 7x.
ELL_RTOL = 1e-5
# BASELINE config 2: ML-20M's shape and rating count, rank 64
SPARSE_RANK = 64
SPARSE_ITERS, SPARSE_CHECK = 10, 2
# final W/H of the kernel run vs the plain ELL run after 10 iterations
# (max|a - b| / max|b|): per-step reordering error ~1e-6, and index_add_
# adds segments atomically, in another order on every run
SPARSE_E2E_RTOL = 1e-3
# final D_KL of the ELL run vs the densified run. Half-star ratings are
# exact in bf16, so the two see the same V; they differ in that the
# densified contractions round W and H to bf16 (2^-9 relative per
# operand, at random over the r = 64 terms) and sum in another order
KL_ENGINES_RTOL = 1e-3

# the card's peaks (NVIDIA's H100 SXM data sheet, dense): float32 on the
# CUDA cores, bf16 on the tensor cores, HBM bandwidth
F32_PEAK, BF16_PEAK, HBM_BYTES_PER_S = 67e12, 989e12, 3.35e12

# where each kernel's TPU original is (file:line of the wrapper that
# reaches pl.pallas_call), and its source here
REPLACES = {
    "w_update_fused": "nmftpu/kernels/dense_mu.py:277",
    "h_update_fused": "nmftpu/kernels/dense_mu.py:188",
    "w_update_fused_q": "nmftpu/kernels/quantized.py:148",
    "h_update_fused_q": "nmftpu/kernels/quantized.py:70",
    "reservoir_scan": "nmftpu/kernels/mips_reservoir.py:135",
    "count_above": "nmftpu/kernels/count_above.py:95",
    "ell_rowsums": "nmftpu/kernels/sparse_ell_kernel.py:98",
}
SOURCES = {
    "w_update_fused": "nmftpu_torch/csrc/dense_mu.cu",
    "h_update_fused": "nmftpu_torch/csrc/dense_mu.cu",
    "w_update_fused_q": "nmftpu_torch/csrc/dense_mu.cu",
    "h_update_fused_q": "nmftpu_torch/csrc/dense_mu.cu",
    "reservoir_scan": "nmftpu_torch/csrc/mips_reservoir.cu",
    "count_above": "nmftpu_torch/csrc/count_above.cu",
    "ell_rowsums": "nmftpu_torch/csrc/ell_rowsums.cu",
}
DENSE = ("w_update_fused", "h_update_fused", "w_update_fused_q",
         "h_update_fused_q")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + "  ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / |b|) over all elements. Where b is
    exactly 0 (an MU factor entry that reached zero), a must be 0 too."""
    diff = (a - b).abs()
    tiny = torch.finfo(b.dtype).tiny
    return float(diff.max()), float((diff / b.abs().clamp_min(tiny)).max())


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def abba_ms(fns: dict, iters: int) -> dict:
    """Time each callable twice, in the order A B C ... C B A, on one
    card, and return the mean of the two readings per name."""
    names = list(fns)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(cuda_ms(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in times.items()}


def synthetic_lowrank(n, m, r, gen, dev):
    """Nonnegative rank-r V with 5% uniform noise, values about 0..5."""
    Wt = torch.rand(n, r, generator=gen, device=dev)
    Ht = torch.rand(r, m, generator=gen, device=dev)
    V = Wt @ Ht * (4.0 / r)
    V += 0.05 * V.mean() * torch.rand(n, m, generator=gen, device=dev)
    return V


def synthetic_ratings(n, m, nnz, gen, dev, rows_per_chunk=2048):
    """Dense (n, m) float32 matrix of half-star ratings (0.5 .. 5.0) with
    exactly `nnz` nonzeros, made on the device. Users rate at least 20
    items, with lognormal counts; items are picked without replacement
    with Zipf-like popularity (Efraimidis–Spirakis keys log(u) / w)."""
    w = torch.exp(torch.randn(n, generator=gen, device=dev))
    extra = nnz - 20 * n
    counts = 20 + torch.floor(extra * w / w.sum()).long()
    short = nnz - int(counts.sum())
    counts[torch.argsort(counts)[:short]] += 1
    if int(counts.sum()) != nnz or int(counts.max()) > m:
        raise RuntimeError("rating counts do not fit the shape")
    pop = 1.0 / torch.arange(1, m + 1, device=dev, dtype=torch.float32) ** 0.9
    pop = pop[torch.randperm(m, generator=gen, device=dev)]
    V = torch.zeros(n, m, device=dev)
    for i in range(0, n, rows_per_chunk):
        c = counts[i:i + rows_per_chunk]
        u = torch.rand(len(c), m, generator=gen, device=dev)
        keys = torch.log(u) / pop
        kmax = int(c.max())
        cols = torch.topk(keys, kmax, dim=1).indices
        del u, keys
        keep = torch.arange(kmax, device=dev)[None, :] < c[:, None]
        stars = torch.randint(1, 11, (len(c), kmax), generator=gen,
                              device=dev).float() * 0.5
        V[i:i + rows_per_chunk].scatter_(1, cols, stars * keep)
    return V


def serving_data(gen, dev, chunk=1 << 20):
    """Config-5-shaped factors made on the device: W (n, r) uniform; H
    (r, m) uniform times per-dimension magnitudes from 1 down to 0.01
    (the spread the int8 table's per-dimension scales exist for); and
    the training CSR, SERVE_SEEN items per user drawn uniformly."""
    from nmftpu_torch.sparse import SparseCSR

    n, m, r = SERVE_USERS, SERVE_ITEMS, SERVE_RANK
    W = torch.rand(n, r, generator=gen, device=dev)
    mag = torch.logspace(0, -2, r, device=dev)[:, None]
    H = torch.empty(r, m, device=dev)
    for lo in range(0, m, chunk):
        H[:, lo:lo + chunk] = torch.rand(r, min(chunk, m - lo),
                                         generator=gen, device=dev) * mag
    # distinct items per user: draw a few spare, drop repeats (they sort
    # last as m), keep the first SERVE_SEEN
    items = torch.randint(0, m, (n, SERVE_SEEN + 8), generator=gen,
                          device=dev)
    items = torch.sort(items, dim=1).values
    items[:, 1:].masked_fill_(items[:, 1:] == items[:, :-1], m)
    items = torch.sort(items, dim=1).values[:, :SERVE_SEEN]
    if int(items.max()) >= m:
        raise RuntimeError("too many repeated draws for one user")
    items = items.int().cpu().numpy()
    indptr = np.arange(0, n * SERVE_SEEN + 1, SERVE_SEEN, dtype=np.int64)
    train = SparseCSR(indptr, items.reshape(-1),
                      np.ones(n * SERVE_SEEN, np.float32), (n, m))
    return W, H, train


def check_reservoir(MR, label, Wq, H, m, slots):
    """The reservoir kernel against its twin, slot by slot: scores within
    SCAN_RTOL; where the ids differ, the two competing items' float64
    scores (at the kernel's operand values) within SCAN_RTOL. Returns
    (max |score difference|, candidate scores of the twin)."""
    s, i = MR.reservoir_scan(Wq, H, m, slots)
    s0, i0 = MR.reservoir_scan_plain(Wq, H, m, slots)
    torch.cuda.synchronize()
    fin = torch.isfinite(s0)
    if not bool((fin == torch.isfinite(s)).all()):
        fail(f"reservoir_scan {label}: -inf slots differ from the twin")
    diff = (s - s0).abs()[fin]
    max_abs = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / s0.abs()[fin].clamp_min(1e-30)).max()) \
        if diff.numel() else 0.0
    q, c = ((i != i0) & fin).nonzero(as_tuple=True)
    qd = Wq.to(torch.bfloat16).double()[q]
    got = (qd * H[:, i[q, c].long()].double().T).sum(1)
    want = (qd * H[:, i0[q, c].long()].double().T).sum(1)
    far = int(((got - want).abs() > SCAN_RTOL * want.abs()).sum())
    say("7 reservoir_scan", case=label, max_abs=f"{max_abs:.3e}",
        max_rel=f"{rel:.3e}", rtol=SCAN_RTOL,
        slots_with_other_id_at_near_tie=len(q) - far,
        slots_with_other_id_beyond_tol=far)
    if not rel <= SCAN_RTOL or far:
        fail(f"reservoir_scan {label}: kernel disagrees with its twin")
    return max_abs, s0


def check_count(CA, label, Wq, H, theta, h_scale):
    """The count kernel against its twin at theta; the counts may differ
    by at most the number of items whose twin score lies within
    SCAN_RTOL of theta (counted with the twin at theta(1 -+ SCAN_RTOL),
    theta > 0 here). Returns max |count difference|."""
    got = CA.count_above_fused(Wq, H, theta, h_scale=h_scale)
    want = CA.count_above_fused_plain(Wq, H, theta, h_scale=h_scale)
    near = (CA.count_above_fused_plain(Wq, H, theta * (1 - SCAN_RTOL),
                                       h_scale=h_scale)
            - CA.count_above_fused_plain(Wq, H, theta * (1 + SCAN_RTOL),
                                         h_scale=h_scale))
    torch.cuda.synchronize()
    d = (got - want).abs()
    say("7 count_above", case=label, max_count_diff=int(d.max()),
        near_tie_bound_of_that_row=int(near[int(d.argmax())]),
        rows_over_bound=int((d > near).sum()),
        mean_count=f"{float(want.float().mean()):.2f}")
    if bool((d > near).any()):
        fail(f"count_above {label}: kernel disagrees with its twin")
    return float(d.max())


def rows_not_exact(s, i, s_ex, i_ex, k):
    """Rows of (s, i) that are not the exact top-k (s_ex, i_ex hold the
    exact top k+1): the id set and the sorted scores must match, except
    that a row whose kth and (k+1)th exact scores tie within SCAN_RTOL
    may hold either item."""
    bad = 0
    for row in range(len(s)):
        ok = np.allclose(np.sort(s[row]), np.sort(s_ex[row, :k]),
                         rtol=SCAN_RTOL, atol=0)
        same = set(i[row].tolist()) == set(i_ex[row, :k].tolist())
        tie = abs(s_ex[row, k - 1] - s_ex[row, k]) \
            <= SCAN_RTOL * abs(s_ex[row, k - 1])
        bad += not (ok and (same or tie))
    return bad


def event_ms(fn, iters: int) -> float:
    """Mean ms per call by CUDA events, after one warm-up call. Each
    serving call ends in a device-to-host copy of its result."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def serve_table(MR, CA, td, rec, train, batches, card) -> None:
    """Phase 8 for one table: serve its batches (512 and 2048 users for
    int8, 512 for bf16), check recall, seen violations and the exact
    fallback against the exact scan, and time the serving paths."""
    exact = type(rec).from_table(
        rec.W, rec.H, h_scale=rec._h_scale, train=train,
        method="exact")
    for b in ((512, 2048) if td == "int8" else (512,)):
        users = batches[b]
        seen = [set(train.indices[train.indptr[u]:train.indptr[u + 1]]
                    .tolist()) for u in users]
        torch.cuda.reset_peak_memory_stats()
        before = (MR.LAUNCHES["reservoir_scan"],
                  CA.LAUNCHES["count_above"])
        s_ex, i_ex = exact.recommend(users, k=SERVE_K + 1)
        s, i = rec.recommend(users, k=SERVE_K)
        recall = np.mean([
            len(set(i[row].tolist()) & set(i_ex[row, :SERVE_K]
                                           .tolist())) / SERVE_K
            for row in range(b)])
        violations = sum(len(set(i[row].tolist()) & seen[row])
                         for row in range(b))
        s_c, i_c, cert = rec.recommend_certified(users, k=SERVE_K,
                                                 fallback="exact")
        not_exact = rows_not_exact(s_c, i_c, s_ex, i_ex, SERVE_K)
        cert_violations = sum(len(set(i_c[row].tolist()) & seen[row])
                              for row in range(b))
        launched = (MR.LAUNCHES["reservoir_scan"] - before[0],
                    CA.LAUNCHES["count_above"] - before[1])
        finite = bool(np.isfinite(s).all() and np.isfinite(s_c).all())
        say("8 serve", table=td, batch=b, k=SERVE_K,
            recall_at_100=f"{recall:.6f}", seen_violations=violations,
            certified_fraction=f"{cert.mean():.6f}",
            rows_not_exact=not_exact,
            certified_seen_violations=cert_violations,
            finite=finite, launches=launched,
            peak_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
        if not (recall >= RECALL_FLOOR and violations == 0
                and not_exact == 0 and cert_violations == 0 and finite):
            fail(f"serving {td} b={b}: recall {recall:.6f} (floor "
                 f"{RECALL_FLOOR}), {violations} + {cert_violations} "
                 f"seen violations, {not_exact} rows not exact")
        if min(launched) < 1:
            fail(f"serving {td} b={b}: kernels not launched {launched}")
        paths = {
            "reservoir": lambda: rec.recommend(users, k=SERVE_K),
            "reservoir_no_exclusion": lambda: rec.recommend(
                users, k=SERVE_K, exclude_seen=False),
            "certified": lambda: rec.recommend_certified(
                users, k=SERVE_K),
            "all_exact_composed": lambda: rec.recommend_certified(
                users, k=SERVE_K, fallback="exact"),
            "exact_scan": lambda: exact.recommend(users, k=SERVE_K),
        }
        for path, fn in paths.items():
            ms = event_ms(fn, iters=3)
            say("8 timing", table=td, batch=b, path=path,
                ms=f"{ms:.3f}", q_per_s=f"{b / ms * 1e3:.1f}", card=card)


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time the card could take for a kernel's work, in ms: the
    larger of its operations over `peak` and its bytes (each input read
    once, each output written once) over the HBM rate, and which of the
    two that is."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ratings_csr(R, rows_per_chunk=8192):
    """The nonzeros of a dense (n, m) device matrix as a host SparseCSR,
    row block by row block (nonzero() walks each block's rows in order,
    columns ascending)."""
    from nmftpu_torch.sparse import SparseCSR

    n, m = R.shape
    rows, cols, vals = [], [], []
    for i in range(0, n, rows_per_chunk):
        blk = R[i:i + rows_per_chunk]
        idx = blk.nonzero()
        rows.append((idx[:, 0] + i).cpu().numpy())
        cols.append(idx[:, 1].int().cpu().numpy())
        vals.append(blk[idx[:, 0], idx[:, 1]].cpu().numpy())
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(np.concatenate(rows), minlength=n),
              out=indptr[1:])
    return SparseCSR(indptr, np.concatenate(cols), np.concatenate(vals),
                     (n, m))


def ragged_csr(n, m, seed):
    """A small ratings CSR at 2% density with an empty row and a row of
    1,200 nonzeros (three segments of the widest bucket)."""
    from nmftpu_torch.sparse import from_dense

    rng = np.random.default_rng(seed)
    a = np.where(rng.random((n, m)) < 0.02,
                 rng.integers(1, 11, (n, m)) * 0.5, 0.0).astype(np.float32)
    a[0, rng.choice(m, 1200, replace=False)] = 2.5
    a[1] = 0.0
    return from_dense(a).to_csr()


def check_ell(SEK, label, buckets, table) -> float:
    """Kernel #10 against its twin on every bucket of one ELL direction:
    max relative error within ELL_RTOL. Returns max |difference|."""
    worst_abs = worst_rel = 0.0
    for b in buckets:
        got = SEK.bucket_rowsums(b.vals, b.cols, table)
        want = SEK.bucket_rowsums_plain(b.vals, b.cols, table)
        torch.cuda.synchronize()
        a, rel = rel_err(got, want)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, rel)
        del got, want
    say("10 ell_rowsums", case=label, dtype=str(table.dtype),
        widths=[b.width for b in buckets],
        segments=sum(b.vals.shape[0] for b in buckets),
        max_abs=f"{worst_abs:.3e}", max_rel=f"{worst_rel:.3e}",
        rtol=ELL_RTOL)
    if not worst_rel <= ELL_RTOL:
        fail(f"ell_rowsums {label}: kernel disagrees with its twin")
    return worst_abs


def sparse_phases(nt, ratings, card, dev) -> dict:
    """Phases 10-12 on the host CSR `ratings` (config 2's shape): kernel
    #10 against its twin, the sparse engines end to end through
    prepare_sparse / nmf, and their timing. Returns the ELL kernel's
    fields of the kernels line."""
    from nmftpu_torch import densified as DF
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch.config import Initialization, NmfConfig, Objective
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK
    from nmftpu_torch.linalg import dense as D

    n, m = ratings.shape
    nnz, r = ratings.nnz, SPARSE_RANK
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    # -- 10. kernel #10 against its twin -----------------------------------
    max_abs = 0.0
    small = ragged_csr(1000, 1500, SEED + 10)
    for dtype in (torch.float32, torch.float64):
        pair = SE.build_ell_pair(small, dtype=dtype, device=dev)
        Ht = torch.rand(1500, 37, generator=gen, device=dev, dtype=dtype)
        Wt = torch.rand(1000, 37, generator=gen, device=dev, dtype=dtype)
        for label, ell, table in (("V Ht", pair.rows, Ht),
                                  ("Vt W", pair.cols, Wt)):
            max_abs = max(max_abs, check_ell(
                SEK, f"ragged 1000x1500 r=37 {label}", ell.buckets, table))
    cfg = NmfConfig(rank=r, init_method=Initialization.COPY_EXISTING,
                    num_iterations=SPARSE_ITERS, check_interval=SPARSE_CHECK)
    t0 = time.perf_counter()
    plan = nt.prepare_sparse(ratings, cfg, strategy="ell", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pair = plan.operand
    lanes = sum(b.vals.numel() for b in pair.rows.buckets)
    say("10 ell layout", shape=f"{n}x{m}", nnz=nnz,
        build_s=f"{build_s:.2f}",
        row_buckets=[(b.width, b.vals.shape[0]) for b in pair.rows.buckets],
        col_buckets=[(b.width, b.vals.shape[0]) for b in pair.cols.buckets],
        row_lanes_per_nnz=f"{lanes / nnz:.3f}")
    Ht = torch.rand(m, r, generator=gen, device=dev)
    Wt = torch.rand(n, r, generator=gen, device=dev)
    max_abs = max(max_abs, check_ell(
        SEK, f"ML-20M shape r={r} V Ht (table {m}x{r})", pair.rows.buckets,
        Ht))
    max_abs = max(max_abs, check_ell(
        SEK, f"ML-20M shape r={r} Vt W (table {n}x{r})", pair.cols.buckets,
        Wt))
    del Ht, Wt

    # -- 11. config 2 end to end (the third main path) ----------------------
    # W0/H0 drawn as the random init draws them: (u + 1e-4) sqrt(mean V / r)
    scale = (float(ratings.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    W0 = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H0 = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale
    kl0 = float(SE.kl_error_ell(pair, W0, H0))
    common = dict(init="copy", W0=W0, H0=H0, num_iterations=SPARSE_ITERS,
                  check_interval=SPARSE_CHECK, device=dev)

    def run(label, fn, frobenius=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        errs = res.stats.errors
        finite = bool(torch.isfinite(res.W).all()
                      and torch.isfinite(res.H).all())
        say("11 e2e", run=label, errors=[f"{e:.6g}" for e in errs],
            kl_error=res.kl_error, iterations=res.num_iterations,
            finite=finite, seconds=f"{secs:.3f}",
            loop_seconds=f"{res.elapsed_ms / 1e3:.3f}",
            peak_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        # under KL the checked Frobenius error need not fall; D_KL is
        # checked below
        if not (finite and (errs[-1] < errs[0] or not frobenius)):
            fail(f"{label}: non-finite factors or the error did not fall: "
                 f"{errs.tolist()}")
        return res

    SEK.LAUNCHES["ell_rowsums"] = 0          # the main path starts here
    res_k = run("nmf ell use_pallas=True frobenius", lambda: nt.nmf(
        ratings, r, strategy="ell", use_pallas=True, **common))
    res_p = run("plan.run ell frobenius", lambda: plan.run(W0=W0, H0=H0))
    cfg_kl = NmfConfig(rank=r, objective=Objective.KL,
                       init_method=Initialization.COPY_EXISTING,
                       num_iterations=SPARSE_ITERS,
                       check_interval=SPARSE_CHECK)
    t0 = time.perf_counter()
    plan_kl = nt.prepare_sparse(ratings, cfg_kl, strategy="auto",
                                device=dev)
    torch.cuda.synchronize()
    say("11 auto", objective="kl", resolved=plan_kl.strategy,
        densify_s=f"{time.perf_counter() - t0:.2f}")
    if plan_kl.strategy != "densified":
        fail(f"strategy='auto' resolved to {plan_kl.strategy!r} at the "
             "ML-20M shape, not 'densified'")
    res_dk = run("plan.run auto (densified bf16) kl",
                 lambda: plan_kl.run(W0=W0, H0=H0), frobenius=False)
    res_ek = run("plan.run ell kl", lambda: plan.run(cfg_kl, W0=W0, H0=H0),
                 frobenius=False)
    launches = SEK.LAUNCHES["ell_rowsums"]   # the main path ends here
    dw = float((res_k.W - res_p.W).abs().max() / res_p.W.abs().max())
    dh = float((res_k.H - res_p.H).abs().max() / res_p.H.abs().max())
    dkl = abs(res_ek.kl_error - res_dk.kl_error) / res_dk.kl_error
    # the two KL engines' factors, for the record (no limit: densified
    # rounds W and H to bf16 in each contraction)
    dw_kl = float((res_ek.W - res_dk.W).abs().max() / res_dk.W.abs().max())
    say("11 checks", ell_rowsums_launches=launches, kernel_vs_plain_W=
        f"{dw:.3e}", kernel_vs_plain_H=f"{dh:.3e}", rtol=SPARSE_E2E_RTOL,
        kl_start=f"{kl0:.6g}", kl_ell=f"{res_ek.kl_error:.6g}",
        kl_densified=f"{res_dk.kl_error:.6g}", kl_rel=f"{dkl:.3e}",
        kl_rtol=KL_ENGINES_RTOL, kl_engines_W_rel=f"{dw_kl:.3e}")
    if launches < 1:
        fail("the ELL kernel was not launched on the main path")
    if not (dw <= SPARSE_E2E_RTOL and dh <= SPARSE_E2E_RTOL):
        fail(f"ELL kernel run differs from the plain ELL run (W {dw:.3e}, "
             f"H {dh:.3e} > {SPARSE_E2E_RTOL})")
    if not (res_ek.kl_error < kl0 and res_dk.kl_error < kl0
            and dkl <= KL_ENGINES_RTOL):
        fail(f"KL did not fall or the engines disagree: start {kl0}, ell "
             f"{res_ek.kl_error}, densified {res_dk.kl_error}")
    del res_k, res_p, res_dk, res_ek

    # the densified Frobenius step's transient memory with the row-panel
    # bf16 contraction, and with the contraction as it was before (one
    # float32 copy of each whole operand)
    Vd = plan_kl.operand
    Wp = torch.nn.functional.pad(W0, (0, 0, 0, Vd.shape[0] - n))
    panels = D._bf16_dot

    def whole(a, b, block_rows=None):
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()

    for label, dot in (("row panels", panels), ("whole operands", whole)):
        D._bf16_dot = dot
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            D.mu_update_frobenius_bf16v(Vd, Wp, H0)
            torch.cuda.synchronize()
        finally:
            D._bf16_dot = panels
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        say("11 densified frobenius step", bf16_contraction=label,
            transient_GiB=f"{peak:.2f}", card=card)

    # -- 12. timing at config 2's shape --------------------------------------
    it_ms = abba_ms({
        "ell_plain_frobenius": lambda: SE.mu_update_frobenius_ell(
            pair, W0, H0),
        "ell_kernel_frobenius": lambda: SEK.mu_update_frobenius_ell_pallas(
            pair, W0, H0),
        "densified_frobenius": lambda: D.mu_update_frobenius_bf16v(
            Vd, Wp, H0),
        "ell_kl": lambda: SE.mu_update_kl_ell(pair, W0, H0),
        "densified_kl": lambda: DF.mu_update_kl_densified(Vd, Wp, H0),
    }, iters=3)
    for path, ms in it_ms.items():
        say("12 timing", path=path, ms_per_iter=f"{ms:.3f}", card=card)
    Ht0 = H0.T.contiguous()
    # cuSPARSE through torch.sparse.mm: the library yardstick, timed here
    # and called nowhere in the port (torch warns that its sparse CSR
    # support is in beta)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        Vcsr = torch.sparse_csr_tensor(
            torch.from_numpy(ratings.indptr).to(dev),
            torch.from_numpy(ratings.indices.astype(np.int64)).to(dev),
            torch.from_numpy(ratings.data).to(dev), size=(n, m),
            check_invariants=True)
    _, lib_rel = rel_err(torch.sparse.mm(Vcsr, Ht0),
                         SEK.v_ht_ell_pallas(pair.rows, H0))
    sp_ms = abba_ms({
        "kernel_path": lambda: SEK.v_ht_ell_pallas(pair.rows, H0),
        "kernel_only": lambda: [SEK.bucket_rowsums(b.vals, b.cols, Ht0)
                                for b in pair.rows.buckets],
        "plain_path": lambda: SE.v_ht_ell(pair.rows, H0),
        "torch_sparse_mm": lambda: torch.sparse.mm(Vcsr, Ht0),
        "kernel_path_WtV": lambda: SEK.wt_v_ell_pallas(pair, W0),
        "kernel_only_WtV": lambda: [SEK.bucket_rowsums(b.vals, b.cols, W0)
                                    for b in pair.cols.buckets],
        "plain_path_WtV": lambda: SE.wt_v_ell(pair, W0),
    }, iters=5)
    # one V Ht SpMM needs each nonzero's value and column once, the table
    # and the output: counted over the nonzeros, not the padded lanes
    flops = 2 * nnz * r
    nbytes = nnz * (4 + 4) + (m + n) * r * 4
    bound_ms, bound_by = bound(flops, nbytes, F32_PEAK)
    for path, ms in sp_ms.items():
        say("12 spmm timing", path=path, ms=f"{ms:.4f}",
            GB_s_of_needed_bytes=f"{nbytes / ms / 1e6:.1f}", card=card)
    say("12 spmm bound", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        library_vs_kernel_path_max_rel=f"{lib_rel:.3e}", card=card)
    if not lib_rel <= 1e-4:
        fail(f"torch.sparse.mm and the kernel path disagree ({lib_rel:.3e})")
    return {"launches": launches, "max_abs_err": max_abs,
            "ms": sp_ms["kernel_path"], "plain_ms": sp_ms["plain_path"],
            "library_ms": sp_ms["torch_sparse_mm"], "bound_ms": bound_ms,
            "bound_by": bound_by}


def main() -> None:
    if not (HERE / "nmftpu_torch").is_dir():
        fail(f"no nmftpu_torch package beside {__file__}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    sys.path.insert(0, str(HERE))

    import nmftpu_torch as nt
    from nmftpu_torch.kernels import _build
    from nmftpu_torch.kernels import count_above as CA
    from nmftpu_torch.kernels import dense_mu as K
    from nmftpu_torch.kernels import mips_reservoir as MR
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.linalg import dense as D
    from nmftpu_torch.serving import quantize_table

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi_line()

    # -- 1. device ---------------------------------------------------------
    print(card, flush=True)
    say("1 device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    secs = time.perf_counter() - t0
    _build.load()
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".so.log")
             .read_text().splitlines() if "registers" in ln]
    say("2 build", library=lib_path.name, seconds=f"{secs:.2f}",
        ptxas=" | ".join(ptxas))

    # -- 3. each kernel against its plain twin -------------------------------
    max_abs = dict.fromkeys(REPLACES, 0.0)
    for n, m, r in KERNEL_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + n + m + r)
        V = 5.0 * torch.rand(n, m, generator=gen, device=dev)
        W = torch.rand(n, r, generator=gen, device=dev) + 0.05
        H = torch.rand(r, m, generator=gen, device=dev) + 0.05
        Vq, scale = Q.quantize_v(V)
        Gw, Gh = H @ H.T, W.T @ W
        cases = {
            "w_update_fused": (K.w_update_fused(V, W, H, Gw),
                               K.w_update_fused_plain(V, W, H, Gw)),
            "h_update_fused": (K.h_update_fused(V, W, H, Gh),
                               K.h_update_fused_plain(V, W, H, Gh)),
            "w_update_fused_q": (
                Q.w_update_fused_q(Vq, scale, W, H, Gw),
                Q.w_update_fused_q_plain(Vq, scale, W, H, Gw)),
            "h_update_fused_q": (
                Q.h_update_fused_q(Vq, scale, W, H, Gh),
                Q.h_update_fused_q_plain(Vq, scale, W, H, Gh)),
        }
        torch.cuda.synchronize()
        for name, (got, want) in cases.items():
            if got.shape != want.shape:
                fail(f"{name} {n}x{m} r={r}: shape {tuple(got.shape)}")
            a, rel = rel_err(got, want)
            max_abs[name] = max(max_abs[name], a)
            say("3 kernel", kernel=name, shape=f"{n}x{m}", rank=r,
                max_abs=f"{a:.3e}", max_rel=f"{rel:.3e}",
                rtol=KERNEL_RTOL)
            if not rel <= KERNEL_RTOL:
                fail(f"{name} {n}x{m} r={r}: max rel {rel:.3e} > "
                     f"{KERNEL_RTOL}")
        del V, W, H, Vq, scale, Gw, Gh, cases

    # the main path starts here: every count from zero
    for counts in (K.LAUNCHES, Q.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))

    # -- 4. end to end at the headline shape ---------------------------------
    n = m = 4096
    r = 256
    gen = torch.Generator(device=dev).manual_seed(SEED)
    V = synthetic_lowrank(n, m, r, gen, dev)
    W0 = torch.rand(n, r, generator=gen, device=dev) + 0.01
    H0 = torch.rand(r, m, generator=gen, device=dev) + 0.01
    Vq, scale = Q.quantize_v(V)
    V_dq = Vq.float() * scale
    common = dict(init="copy", W0=W0, H0=H0, num_iterations=50,
                  check_interval=10, device="cuda")
    runs = {
        "float32": (dict(use_pallas=True), V, K.LAUNCHES,
                    ("w_update_fused", "h_update_fused")),
        "int8": (dict(v_storage="int8", use_pallas=True), V, Q.LAUNCHES,
                 ("w_update_fused_q", "h_update_fused_q")),
    }
    plain_V = {"float32": V, "int8": V_dq}
    for label, (knobs, V_in, counts, names) in runs.items():
        before = {k: counts[k] for k in names}
        t0 = time.perf_counter()
        res = nt.nmf(V_in, r, **common, **knobs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ref = nt.nmf(plain_V[label], r, **common, use_pallas=False)
        launched = {k: counts[k] - before[k] for k in names}
        errs = res.stats.errors
        dw = float((res.W - ref.W).abs().max() / ref.W.abs().max())
        dh = float((res.H - ref.H).abs().max() / ref.H.abs().max())
        say("4 e2e 4096^2 r=256", v_storage=label, launches=launched,
            first_error=f"{errs[0]:.6g}", last_error=f"{errs[-1]:.6g}",
            iterations=res.num_iterations, W_rel=f"{dw:.3e}",
            H_rel=f"{dh:.3e}", rtol=E2E_RTOL, seconds=f"{secs:.3f}")
        if min(launched.values()) < 1:
            fail(f"{label}: kernels not launched: {launched}")
        if not errs[-1] < errs[0]:
            fail(f"{label}: error did not fall: {errs.tolist()}")
        if not (dw <= E2E_RTOL and dh <= E2E_RTOL):
            fail(f"{label}: factors differ from the plain path "
                 f"(W {dw:.3e}, H {dh:.3e} > {E2E_RTOL})")
        del res, ref

    # -- 5. end to end at the ML-20M shape (int8 kernels) --------------------
    n5, m5, r5, nnz = 138_493, 26_744, 64, 20_000_263
    gen5 = torch.Generator(device=dev).manual_seed(SEED + 5)
    t0 = time.perf_counter()
    R = synthetic_ratings(n5, m5, nnz, gen5, dev)
    got_nnz = int(torch.count_nonzero(R))
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    if got_nnz != nnz:
        fail(f"ML-20M-shaped V has {got_nnz} nonzeros, not {nnz}")
    before = dict(Q.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = nt.nmf(R, r5, init="random", seed=0, num_iterations=10,
                 check_interval=2, v_storage="int8", use_pallas=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {k: Q.LAUNCHES[k] - before[k] for k in Q.LAUNCHES}
    errs = res.stats.errors
    finite = bool(torch.isfinite(res.W).all() and torch.isfinite(res.H).all())
    say("5 e2e ML-20M shape", shape=f"{n5}x{m5}", rank=r5, nnz=got_nnz,
        make_V_s=f"{make_s:.2f}", launches=launched,
        errors=[f"{e:.6g}" for e in errs], finite=finite,
        seconds=f"{secs:.3f}",
        peak_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    if not finite:
        fail("ML-20M shape: non-finite factors")
    if not errs[-1] < errs[0]:
        fail(f"ML-20M shape: error did not fall: {errs.tolist()}")
    if min(launched.values()) < 1:
        fail(f"ML-20M shape: kernels not launched: {launched}")

    # the main path ends here; the launches below only check the kernels
    main_path_launches = {**K.LAUNCHES, **Q.LAUNCHES}
    if min(main_path_launches.values()) < 1:
        fail(f"a kernel of the path never launched: {main_path_launches}")

    # the int8 kernels against their twins on this run's Vq, scale and
    # final factors: the only shape with n * m >= 2**31 (64-bit offsets)
    # and with a partial second wave of H-step blocks. quantize_v is
    # deterministic, so this Vq is the one the run used. Every term is
    # nonnegative and most of V is zero, so each sum has at most a
    # column's or a row's nonzeros: KERNEL_RTOL holds as in phase 3.
    Vq5, scale5 = Q.quantize_v(R)
    # the same ratings as a host CSR: config 2's sparse V for phases 10-12
    ratings = ratings_csr(R)
    del R
    W5, H5 = res.W, res.H
    Gw, Gh = H5 @ H5.T, W5.T @ W5
    for name, kernel, plain, G in (
        ("w_update_fused_q", Q.w_update_fused_q, Q.w_update_fused_q_plain, Gw),
        ("h_update_fused_q", Q.h_update_fused_q, Q.h_update_fused_q_plain, Gh),
    ):
        got = kernel(Vq5, scale5, W5, H5, G)
        want = plain(Vq5, scale5, W5, H5, G)
        torch.cuda.synchronize()
        a, rel = rel_err(got, want)
        max_abs[name] = max(max_abs[name], a)
        say("5 kernel", kernel=name, shape=f"{n5}x{m5}", rank=r5,
            max_abs=f"{a:.3e}", max_rel=f"{rel:.3e}", rtol=KERNEL_RTOL)
        if not rel <= KERNEL_RTOL:
            fail(f"{name} {n5}x{m5} r={r5}: max rel {rel:.3e} > "
                 f"{KERNEL_RTOL}")
        del got, want
    del Vq5, scale5, res, W5, H5, Gw, Gh

    # -- 6. timing at 4096^2, r = 256 ----------------------------------------
    W, H = W0, H0
    Gw, Gh = H @ H.T, W.T @ W
    it_ms = abba_ms({
        "plain_f32": lambda: D.mu_update_frobenius(V, W, H),
        "kernel_f32": lambda: K.mu_update_frobenius_fused(V, W, H),
        "kernel_int8": lambda: Q.mu_update_frobenius_q(Vq, scale, W, H),
    }, iters=20)
    flops = 4 * n * m * r + 4 * (n + m) * r * r
    for path, ms in it_ms.items():
        say("6 timing", path=path, ms_per_iter=f"{ms:.4f}",
            TFLOP_s=f"{flops / ms / 1e9:.2f}", card=card)
    k_ms = abba_ms({
        "w_update_fused": lambda: K.w_update_fused(V, W, H, Gw),
        "h_update_fused": lambda: K.h_update_fused(V, W, H, Gh),
        "w_update_fused_q": lambda: Q.w_update_fused_q(Vq, scale, W, H, Gw),
        "h_update_fused_q": lambda: Q.h_update_fused_q(Vq, scale, W, H, Gh),
    }, iters=20)
    p_ms = abba_ms({
        "w_update_fused": lambda: K.w_update_fused_plain(V, W, H, Gw),
        "h_update_fused": lambda: K.h_update_fused_plain(V, W, H, Gh),
        "w_update_fused_q": lambda: Q.w_update_fused_q_plain(
            Vq, scale, W, H, Gw),
        "h_update_fused_q": lambda: Q.h_update_fused_q_plain(
            Vq, scale, W, H, Gh),
    }, iters=20)
    bounds = {}
    for name in DENSE:
        # V read once (float32 or int8), W, H, G read, one factor written;
        # the numerator GEMM and the Gram apply on the float32 CUDA cores
        v_bytes = 1 if name.endswith("_q") else 4
        out = n * r if name.startswith("w") else r * m
        bounds[name] = bound(2 * n * m * r + 2 * out * r,
                             v_bytes * n * m + 4 * (n * r + r * m + r * r
                                                    + out), F32_PEAK)
        say("6 kernel timing", kernel=name, ms=f"{k_ms[name]:.4f}",
            plain_ms=f"{p_ms[name]:.4f}", bound_ms=f"{bounds[name][0]:.4f}",
            bound_by=bounds[name][1], card=card)

    # -- 7. serving kernels against their twins -----------------------------
    for b, r, m, slots, dtypes in ((37, 37, 10_007, 1024,
                                    ("bfloat16", "int8")),
                                   (512, 256, 1 << 20, 4096,
                                    ("bfloat16", "int8"))):
        gen = torch.Generator(device=dev).manual_seed(SEED + 7 + b)
        Wq = torch.rand(b, r, generator=gen, device=dev)
        Hf = torch.rand(r, m, generator=gen, device=dev)
        for td in dtypes:
            H, hs = ((Hf.to(torch.bfloat16), None) if td == "bfloat16"
                     else quantize_table(Hf))
            Wk = Wq if hs is None else Wq * hs
            label = f"b={b} r={r} m={m} R={slots} {td}"
            a, cand = check_reservoir(MR, label, Wk, H, m, slots)
            max_abs["reservoir_scan"] = max(max_abs["reservoir_scan"], a)
            theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
            max_abs["count_above"] = max(max_abs["count_above"], check_count(
                CA, label, Wq, H, theta, hs))
        del Wq, Hf, H, hs, Wk, cand, theta

    gen8 = torch.Generator(device=dev).manual_seed(SEED + 8)
    t0 = time.perf_counter()
    W8, H8, train = serving_data(gen8, dev)
    torch.cuda.synchronize()
    say("8 data", users=SERVE_USERS, items=SERVE_ITEMS, rank=SERVE_RANK,
        seen_per_user=SERVE_SEEN, seconds=f"{time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(SEED)
    batches = {b: np.sort(rng.choice(SERVE_USERS, b, replace=False))
               for b in (512, 2048)}
    # the two tables phase 8 serves (int8 2.7 GB, bf16 5.4 GB); the
    # kernels are held against their twins on them, at every batch and
    # slot count phase 8 runs (R = 16384 is the escalation's)
    recs = {td: nt.Recommender(W8, H8, train=train, method="reservoir",
                               table_dtype=td)
            for td in ("int8", "bfloat16")}
    for td, b, slots in (("int8", 512, 4096), ("int8", 512, 16384),
                         ("int8", 2048, 4096),
                         ("bfloat16", 512, 4096), ("bfloat16", 512, 16384)):
        rec = recs[td]
        Wq = rec.W[torch.as_tensor(batches[b], device=dev)]
        Wk = Wq if rec._h_scale is None else Wq * rec._h_scale
        label = f"full table b={b} R={slots} {td}"
        a, cand = check_reservoir(MR, label, Wk, rec.H, SERVE_ITEMS, slots)
        max_abs["reservoir_scan"] = max(max_abs["reservoir_scan"], a)
        theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
        max_abs["count_above"] = max(max_abs["count_above"], check_count(
            CA, label, Wq, rec.H, theta, rec._h_scale))
        del Wq, Wk, cand, theta
    del rec

    # -- 8. serving end to end at config 5 (the second main path) -----------
    for counts in (MR.LAUNCHES, CA.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    # the escalation's only fallback is a RuntimeWarning on out of device
    # memory; as an error here, no kernel leaves the measured path unseen
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for td, rec in recs.items():
            serve_table(MR, CA, td, rec, train, batches, card)
    serve_launches = {**MR.LAUNCHES, **CA.LAUNCHES}
    if min(serve_launches.values()) < 1:
        fail(f"a serving kernel never launched: {serve_launches}")

    # -- 9. serving kernel timing at the phase-8 shape (int8, b = 512) ------
    Hq, hs = recs["int8"].H, recs["int8"]._h_scale
    del recs, rec, H8
    torch.cuda.empty_cache()
    Wq = W8[torch.as_tensor(batches[512], device=dev)]
    Wk = (Wq * hs).contiguous()
    cand = MR.reservoir_scan(Wk, Hq, SERVE_ITEMS, 4096)[0]
    theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
    t_ms = abba_ms({
        "reservoir_scan": lambda: MR.reservoir_scan(Wk, Hq, SERVE_ITEMS,
                                                    4096),
        "reservoir_scan_plain": lambda: MR.reservoir_scan_plain(
            Wk, Hq, SERVE_ITEMS, 4096),
        "count_above": lambda: CA.count_above_fused(Wq, Hq, theta,
                                                    h_scale=hs),
        "count_above_plain": lambda: CA.count_above_fused_plain(
            Wq, Hq, theta, h_scale=hs),
    }, iters=3)
    flops = 2 * 512 * SERVE_RANK * SERVE_ITEMS
    # the int8 table read once, the queries, and the (score, id) slots or
    # the counts written once; the operands are bf16 queries and table
    # values exact in bf16, so the bf16 tensor-core peak bounds the work
    table_bytes = Hq.numel() * Hq.element_size()
    bounds["reservoir_scan"] = bound(
        flops, table_bytes + Wk.numel() * 4 + 512 * 2 * 4096 * 8, BF16_PEAK)
    bounds["count_above"] = bound(
        flops, table_bytes + Wq.numel() * 4 + hs.numel() * 4 + 512 * 8,
        BF16_PEAK)
    for name in ("reservoir_scan", "count_above"):
        k_ms[name], p_ms[name] = t_ms[name], t_ms[name + "_plain"]
        say("9 kernel timing", kernel=name, shape="b=512 r=256 m=10485760 "
            "int8", ms=f"{k_ms[name]:.3f}", plain_ms=f"{p_ms[name]:.3f}",
            TFLOP_s=f"{flops / k_ms[name] / 1e9:.2f}",
            bound_ms=f"{bounds[name][0]:.4f}", bound_by=bounds[name][1],
            card=card)
    del Hq, hs, Wq, Wk, cand, theta, W8, train
    torch.cuda.empty_cache()

    # -- 10-12. sparse V at config 2's full width (ELL, densified) ----------
    ell = sparse_phases(nt, ratings, card, dev)
    del ratings
    max_abs["ell_rowsums"] = ell["max_abs_err"]
    k_ms["ell_rowsums"], p_ms["ell_rowsums"] = ell["ms"], ell["plain_ms"]
    bounds["ell_rowsums"] = (ell["bound_ms"], ell["bound_by"])
    library_ms = {"ell_rowsums": ell["library_ms"]}

    if "jax" in sys.modules:
        fail("jax was imported")

    launches = {**main_path_launches, **serve_launches,
                "ell_rowsums": ell["launches"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_abs[name],
         "ms": k_ms[name], "plain_ms": p_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library_ms.get(name)}
        for name in REPLACES
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
