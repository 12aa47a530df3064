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
objectives, and time them. Phases 13-15 hold the fused multiply-divide,
the int8 x int8 numerator kernels and the HALS sweep against their twins
(up to the ML-20M shape), factorize 4096 x 4096 / rank 256, 2048 x 2048 /
rank 512 and the ML-20M shape (dense float32 V, rank 64) with HALS
through the sweep kernel, and run Jacobi MU (Frobenius and KL; float32,
bfloat16 and int8 V, int8 with the dual-numerator kernel) and int8 x int8
Gauss-Seidel MU against their Gauss-Seidel and kernel counterparts. After
the build, cuobjdump -sass counts each kernel's tensor-core instructions
and the script fails unless the int8 numerator kernels, the bf16 and
int8 reservoir and count scans and the split-tf32 MU kernels have some.
Phases 3, 5 and 13 also hold the MU kernels (#1-#4) and the HALS sweep
(#7) against float64: their error at most 4x the plain float32 twin's.
Every phase prints its results; any failure exits non-zero, as does a
kernel timed below its bound. Without a CUDA device it exits 1 and runs
nothing.

The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import shutil
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
# phases 3, 5 and 13: the float64 check. #1-#4 multiply on the tensor
# cores in split tf32 and #7 sums in another order; one tf32 pass (2^-11
# relative) would pass KERNEL_RTOL, so every output is also held against
# a float64 product: its largest relative error (#7: largest error over
# max|W|) at most F64_FACTOR times the plain float32 twin's
F64_FACTOR = 4
# phase 4: final W/H of 50 kernel iterations vs the plain path, as
# max|a - b| / max|b|. The per-step reordering error above compounds over
# the run: 3e-6 after 50 steps at 1024^2 / r = 64 on the CPU; 1e-3 leaves
# room for K = 4096 and r = 256.
E2E_RTOL = 1e-3

# phases 7-9: the serving kernels. Scores are float32 sums of 256 exact
# products in two orders, ~sqrt(256) * 2^-24 = 1e-6 relative apart;
# 1e-5 leaves 10x. Reservoir ids may differ only at such near-ties. The
# count must equal the chain count exactly: the reference counts a float32
# matmul's scores where they lie farther than SCAN_RTOL |theta| from theta
# and re-scores the rest by the k-ordered chain (_gather_scores).
SCAN_RTOL = 1e-5
# the band's constant (kernels/count_above.py BAND_C, in units of
# r 2^-23 ||q||_1 h_max) must exceed the largest tensor-core error seen on
# the full tables, in those units, this many times
BAND_MARGIN = 4
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

# phases 13-15: dense HALS and the int8 x int8 numerators. The HALS
# kernel sums in float32 in another order than its twin, and the clamp
# and the division by the hessian amplify it: nmftpu's bound for its own
# sweep kernel, times max|W|
HALS_ATOL = 3e-5
# HALS through the kernel vs the plain blocked sweep. One iteration's W/H,
# max|a - b| / max|b|: float32 reordering, ~1e-6. After that a float32
# ulp can flip a clamp, and coordinate descent moves the factors to
# another point of nearly equal error (two plain sweeps in another order
# or precision do the same), so the factors are held after one iteration
# and the error after 50; the factors after 50 are printed, with no limit.
HALS_STEP_RTOL = 1e-4
HALS_E2E_RTOL = 2e-3
# ML-20M's shape, rank and rating count (phases 5 and 13-15)
ML20M = (138_493, 26_744, 64, 20_000_263)

# the card's peaks (NVIDIA's H100 SXM data sheet, dense): float32 on the
# CUDA cores, bf16 and int8 on the tensor cores, HBM bandwidth
F32_PEAK, BF16_PEAK, INT8_PEAK = 67e12, 989e12, 1979e12
TF32_PEAK = 495e12
HBM_BYTES_PER_S = 3.35e12

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
    "fused_multiply_divide": "nmftpu/kernels/dense_mu.py:341",
    "dual_numerators_int8": "nmftpu/kernels/dual_numer.py:128",
    "hals_sweep": "nmftpu/kernels/hals_sweep.py:121",
    # the one-sided int8 entries replace XLA contractions, not a TPU
    # kernel: the _rhs_vht_int8 / _rhs_wtv_int8 dots
    "vht_int8": "nmftpu/linalg/dense.py:334",
    "wtv_int8": "nmftpu/linalg/dense.py:344",
}
SOURCES = {
    "w_update_fused": "nmftpu_torch/csrc/dense_mu.cu",
    "h_update_fused": "nmftpu_torch/csrc/dense_mu.cu",
    "w_update_fused_q": "nmftpu_torch/csrc/dense_mu.cu",
    "h_update_fused_q": "nmftpu_torch/csrc/dense_mu.cu",
    "reservoir_scan": "nmftpu_torch/csrc/mips_reservoir.cu",
    "count_above": "nmftpu_torch/csrc/count_above.cu",
    "ell_rowsums": "nmftpu_torch/csrc/ell_rowsums.cu",
    "fused_multiply_divide": "nmftpu_torch/csrc/muldiv.cu",
    "dual_numerators_int8": "nmftpu_torch/csrc/dual_numer.cu",
    "hals_sweep": "nmftpu_torch/csrc/hals_sweep.cu",
    "vht_int8": "nmftpu_torch/csrc/dual_numer.cu",
    "wtv_int8": "nmftpu_torch/csrc/dual_numer.cu",
}
DENSE = ("w_update_fused", "h_update_fused", "w_update_fused_q",
         "h_update_fused_q")


# the kernels that must run on the tensor cores: (symbol fragment, how
# many instantiations); cuobjdump -sass must show wgmma (IGMMA/HGMMA) or
# mma.sync (IMMA/HMMA) instructions in each
TENSOR_CORE_KERNELS = (("int8_numer_kernel", 3), ("reservoir_tc_kernel", 4),
                       ("count_tc_kernel", 4), ("update_kernel", 8))
TC_OPCODE = re.compile(r"\b(IGMMA|HGMMA|IMMA|HMMA)\b")


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


def cuda_tool(name: str) -> str:
    for path in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if path and Path(path).exists():
            return path
    fail(f"{name} not found")


def sass_tensor_core_counts(lib_path) -> dict:
    """{kernel symbol (demangled): its count of tensor-core instructions}
    for every kernel in the built library, from cuobjdump -sass."""
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name is not None:
            counts[name] += len(TC_OPCODE.findall(line))
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    if filt and counts:
        names = subprocess.run([filt], input="\n".join(counts),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    return counts


def check_tensor_cores(lib_path) -> None:
    """Phase 2's SASS check: print each kernel's tensor-core instruction
    count; fail unless every instantiation of TENSOR_CORE_KERNELS has
    some."""
    counts = sass_tensor_core_counts(lib_path)
    for name, c in sorted(counts.items()):
        say("2 sass", kernel=name, tensor_core_instructions=c)
    for frag, want in TENSOR_CORE_KERNELS:
        found = {k: c for k, c in counts.items() if frag in k}
        if len(found) != want or min(found.values(), default=0) < 1:
            fail(f"{frag}: expected {want} kernels with tensor-core "
                 f"instructions, found {found}")


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / |b|) over all elements. Where b is
    exactly 0 (an MU factor entry that reached zero), a must be 0 too."""
    diff = (a - b).abs()
    tiny = torch.finfo(b.dtype).tiny
    return float(diff.max()), float((diff / b.abs().clamp_min(tiny)).max())


def f64_check(phase: str, name: str, label: str, got, plain, exact,
              scaled=False) -> None:
    """The float64 check: fail unless the kernel's error against `exact`
    is at most F64_FACTOR times the plain twin's. Relative per element
    (rel_err), or with `scaled` over max|exact| (#7)."""
    if scaled:
        top = float(exact.abs().max())
        k = float((got.double() - exact).abs().max()) / top
        p = float((plain.double() - exact).abs().max()) / top
    else:
        k, p = rel_err(got.double(), exact)[1], rel_err(plain.double(),
                                                       exact)[1]
    say(f"{phase} float64", kernel=name, case=label, kernel_err=f"{k:.3e}",
        plain_f32_err=f"{p:.3e}", ratio=f"{k / p:.3f}" if p else "inf",
        limit=F64_FACTOR)
    if not k <= F64_FACTOR * p:
        fail(f"{name} {label}: error {k:.3e} against float64 exceeds "
             f"{F64_FACTOR}x the plain float32 twin's {p:.3e}")


def mu_exact(step: str, V, scale, W, H, G, eps=1e-9, rows=8192):
    """One MU half-step ("w" or "h") in float64 on V * scale (scale None:
    1), V's rows taken in chunks so that no float64 copy of V exists."""
    W64, H64, G64 = W.double(), H.double(), G.double()
    s = 1.0 if scale is None else float(scale)
    if step == "w":
        num = torch.cat([V[i:i + rows].double() @ H64.T
                         for i in range(0, V.shape[0], rows)]) * s
        return W64 * num / (W64 @ G64 + eps)
    num = torch.zeros_like(H64)
    for i in range(0, V.shape[0], rows):
        num += W64[i:i + rows].T @ V[i:i + rows].double()
    return H64 * (num * s) / (G64 @ H64 + eps)


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
    (max |score difference|, candidate scores of the twin, the kernel's
    candidates (scores, ids))."""
    before = dict(MR.VARIANT_LAUNCHES)
    s, i = MR.reservoir_scan(Wq, H, m, slots)
    ran = [k for k in before if MR.VARIANT_LAUNCHES[k] > before[k]]
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
    say("7 reservoir_scan", case=label, kernels=ran, max_abs=f"{max_abs:.3e}",
        max_rel=f"{rel:.3e}", rtol=SCAN_RTOL,
        slots_with_other_id_at_near_tie=len(q) - far,
        slots_with_other_id_beyond_tol=far)
    if not rel <= SCAN_RTOL or far:
        fail(f"reservoir_scan {label}: kernel disagrees with its twin")
    return max_abs, s0, (s, i)


def tensor_core_error(Wq, H, h_scale, h_max, cand, rows=128) -> float:
    """The largest |tensor-core score - chain score| over the reservoir
    kernel's finite candidates `cand` (scores, ids), each row's in units
    of r 2^-23 ||q||_1 h_max (q the bf16 scan operand): the quantity the
    count kernel's band constant must bound. The chain is
    retrieval.mips._gather_scores."""
    from nmftpu_torch._operands import _scan_operands
    from nmftpu_torch.retrieval.mips import _gather_scores

    s, i = cand
    q = _scan_operands(Wq, H.dtype, h_scale)[0]
    unit = q.shape[1] * 2.0**-23 * q.double().abs().sum(1) * float(h_max)
    worst = 0.0
    for lo in range(0, s.shape[0], rows):
        hi = min(lo + rows, s.shape[0])
        chain = _gather_scores(Wq[lo:hi], H, i[lo:hi], h_scale)
        fin = torch.isfinite(s[lo:hi])
        err = ((s[lo:hi] - chain).abs().double() / unit[lo:hi, None])[fin]
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


def chain_count(Wq, H, theta, h_scale, block=1 << 17):
    """#{j : chain(q, j) > theta} per row, the count the certificate needs:
    a float32 matmul decides the pairs farther than SCAN_RTOL |theta| from
    a finite theta, and retrieval.mips._gather_scores (the k-ordered
    chain) re-scores the rest. Returns (counts (b,) int32, pairs
    re-scored)."""
    from nmftpu_torch._operands import _scan_operands
    from nmftpu_torch.retrieval.mips import _gather_scores

    q = _scan_operands(Wq, H.dtype, h_scale)[0]
    b, m = Wq.shape[0], H.shape[1]
    slack = torch.where(torch.isfinite(theta), SCAN_RTOL * theta.abs(),
                        torch.zeros_like(theta))[:, None]
    count = torch.zeros(b, dtype=torch.int64, device=H.device)
    rows, cols = [], []
    for lo in range(0, m, block):
        s = q @ H[:, lo:lo + block].float()
        near = (s - theta[:, None]).abs() <= slack
        count += ((s > theta[:, None]) & ~near).sum(1)
        rr, cc = near.nonzero(as_tuple=True)
        rows.append(rr)
        cols.append(cc + lo)
        del s, near
    rows, cols = torch.cat(rows), torch.cat(cols)
    for lo in range(0, rows.numel(), 1 << 20):
        rr, cc = rows[lo:lo + (1 << 20)], cols[lo:lo + (1 << 20)]
        sc = _gather_scores(Wq[rr], H, cc[:, None], h_scale)[:, 0]
        count.index_add_(0, rr, (sc > theta[rr]).long())
    return count.int(), rows.numel()


def check_count(CA, label, Wq, H, theta, h_scale, h_max=None,
                all_band=False) -> tuple[int, int]:
    """The count kernel against the exact chain count (`chain_count`):
    equal in every row. With `all_band`, every pair of a finite-theta row
    must have gone through the band. Returns (the largest count
    difference measured, the kernel's band pairs)."""
    before = CA.band_pairs()
    got = CA.count_above_fused(Wq, H, theta, h_scale=h_scale, h_max=h_max)
    band = CA.band_pairs() - before
    want, rescored = chain_count(Wq, H, theta, h_scale)
    torch.cuda.synchronize()
    d = int((got - want).abs().max())
    say("7 count_above", case=label, max_count_diff=d, band_pairs=band,
        reference_rescored_pairs=rescored,
        mean_count=f"{float(want.float().mean()):.2f}")
    if d != 0:
        fail(f"count_above {label}: kernel differs from the chain count")
    finite_rows = int(torch.isfinite(theta).sum())
    if all_band and band != finite_rows * H.shape[1]:
        fail(f"count_above {label}: {band} band pairs, expected every pair "
             f"({finite_rows * H.shape[1]})")
    return d, band


def check_zero_queries(CA, rec, Wq, theta, card) -> int:
    """A batch of config 5 whose queries 3, 130, 300 and 511 (one in each
    128-query block) are all zero, as a user with no factors is: they
    score exactly 0 on every item and their kth score, theta, is 0, so all
    m items tie it. The count must stay exact and those ties must not go
    through the band; the batch is timed beside the same batch without
    them. Returns the largest count difference."""
    zero = torch.tensor([3, 130, 300, 511], device=Wq.device)
    Wz, tz = Wq.clone(), theta.clone()
    Wz[zero], tz[zero] = 0.0, 0.0
    m = rec.H.shape[1]
    d, band = check_count(CA, f"zero queries b={Wq.shape[0]} m={m} int8",
                          Wz, rec.H, tz, rec._h_scale)
    ms = abba_ms({
        "zero_queries": lambda: CA.count_above_fused(
            Wz, rec.H, tz, h_scale=rec._h_scale),
        "no_zero_queries": lambda: CA.count_above_fused(
            Wq, rec.H, theta, h_scale=rec._h_scale)}, iters=3)
    say("7 count_above", case="zero queries timing", band_pairs=band,
        ms_with_zero_queries=f"{ms['zero_queries']:.3f}",
        ms_without=f"{ms['no_zero_queries']:.3f}", card=card)
    if band >= m:
        fail(f"count_above zero queries: {band} band pairs, so an all-zero "
             f"row's {m} ties went through the band")
    return d


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
                  CA.LAUNCHES["count_above"], CA.band_pairs())
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
        band = CA.band_pairs() - before[2]
        finite = bool(np.isfinite(s).all() and np.isfinite(s_c).all())
        say("8 serve", table=td, batch=b, k=SERVE_K,
            recall_at_100=f"{recall:.6f}", seen_violations=violations,
            certified_fraction=f"{cert.mean():.6f}",
            rows_not_exact=not_exact,
            certified_seen_violations=cert_violations,
            finite=finite, launches=launched, count_band_pairs=band,
            band_pairs_per_query=f"{band / b:.4f}",
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


def check_ell_products(SEK, SE, label, pair, W, H) -> float:
    """The fused path (one launch per product, every bucket, sums added
    into the rows) against the plain ELL products in both directions:
    V Hᵀ (n, r) and Wᵀ V (r, m) within ELL_RTOL. Returns max |difference|.
    """
    worst = 0.0
    for direction, fused, plain in (
            ("V Ht", lambda: SEK.v_ht_ell_pallas(pair.rows, H),
             lambda: SE.v_ht_ell(pair.rows, H)),
            ("Wt V", lambda: SEK.wt_v_ell_pallas(pair, W),
             lambda: SE.wt_v_ell(pair, W))):
        before = SEK.LAUNCHES["ell_rowsums"]
        got = fused()
        launched = SEK.LAUNCHES["ell_rowsums"] - before
        want = plain()
        torch.cuda.synchronize()
        a, rel = rel_err(got, want)
        worst = max(worst, a)
        say("10 ell_spmm", case=label, product=direction,
            dtype=str(H.dtype), launches=launched, max_abs=f"{a:.3e}",
            max_rel=f"{rel:.3e}", rtol=ELL_RTOL)
        if not (rel <= ELL_RTOL and launched == 1):
            fail(f"ell_spmm {label} {direction}: fused path disagrees with "
                 f"the plain product or took {launched} launches")
        del got, want
    return worst


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
        max_abs = max(max_abs, check_ell_products(
            SEK, SE, "ragged 1000x1500 r=37", pair, Wt, Ht.T))
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
    max_abs = max(max_abs, check_ell_products(
        SEK, SE, f"ML-20M shape r={r}", pair, Wt, Ht.T))
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
    say("11 checks", ell_rowsums_launches_one_per_product=launches,
        kernel_vs_plain_W=
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
    # cuSPARSE through torch.sparse.mm, on V and on Vᵀ as CSR: the library
    # yardsticks, timed here and called nowhere in the port (torch warns
    # that its sparse CSR support is in beta)
    def device_csr(csr):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                torch.from_numpy(csr.indptr).to(dev),
                torch.from_numpy(csr.indices.astype(np.int64)).to(dev),
                torch.from_numpy(csr.data).to(dev), size=csr.shape,
                check_invariants=True)

    Vcsr, VTcsr = device_csr(ratings), device_csr(ratings.T.to_csr())
    _, lib_rel = rel_err(torch.sparse.mm(Vcsr, Ht0),
                         SEK.v_ht_ell_pallas(pair.rows, H0))
    _, lib_rel_wtv = rel_err(torch.sparse.mm(VTcsr, W0),
                             SEK.wt_v_ell_pallas(pair, W0).T)
    out_vht = torch.zeros(n, r, device=dev)
    out_wtv = torch.zeros(m, r, device=dev)
    sp_ms = abba_ms({
        "kernel_path": lambda: SEK.v_ht_ell_pallas(pair.rows, H0),
        "kernel_only": lambda: SEK.ell_spmm(pair.rows.buckets, Ht0,
                                            out_vht.zero_()),
        "plain_path": lambda: SE.v_ht_ell(pair.rows, H0),
        "torch_sparse_mm": lambda: torch.sparse.mm(Vcsr, Ht0),
        "kernel_path_WtV": lambda: SEK.wt_v_ell_pallas(pair, W0),
        "kernel_only_WtV": lambda: SEK.ell_spmm(pair.cols.buckets, W0,
                                                out_wtv.zero_()),
        "plain_path_WtV": lambda: SE.wt_v_ell(pair, W0),
        "torch_sparse_mm_WtV": lambda: torch.sparse.mm(VTcsr, W0),
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
        gathered_row_GB=f"{nnz * r * 4 / 1e9:.2f}",
        library_vs_kernel_path_max_rel=f"{lib_rel:.3e}",
        library_vs_kernel_path_WtV_max_rel=f"{lib_rel_wtv:.3e}", card=card)
    if not (lib_rel <= 1e-4 and lib_rel_wtv <= 1e-4):
        fail(f"torch.sparse.mm and the kernel path disagree ({lib_rel:.3e}, "
             f"{lib_rel_wtv:.3e})")
    del Vcsr, VTcsr, out_vht, out_wtv
    return {"launches": launches, "max_abs_err": max_abs,
            "ms": sp_ms["kernel_path"], "plain_ms": sp_ms["plain_path"],
            "library_ms": sp_ms["torch_sparse_mm"], "bound_ms": bound_ms,
            "bound_by": bound_by}


def check_hals(HS, label, n, r, gen, dev, zero_col=None) -> float:
    """Kernel #7 against its twin (the blocked sweep) on a random
    problem: |difference| <= HALS_ATOL * max|twin|; a zero-hessian
    column stays as it was. Returns max |difference|."""
    X = torch.randn(n, r, generator=gen, device=dev)
    A = torch.randn(r, r, generator=gen, device=dev)
    G = A @ A.T + torch.eye(r, device=dev)
    if zero_col is not None:
        G[zero_col, :] = 0.0
        G[:, zero_col] = 0.0
    W = torch.rand(n, r, generator=gen, device=dev)
    got = HS.hals_sweep(X, G, W)
    want = HS.hals_sweep_plain(X, G, W)
    exact = HS.hals_sweep_plain(X.double(), G.double(), W.double())
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    kept = (zero_col is None
            or bool(torch.equal(got[:, zero_col], W[:, zero_col])))
    say("13 hals_sweep", case=label, max_abs=f"{diff:.3e}",
        rel_to_max=f"{diff / scale:.3e}", bound=HALS_ATOL,
        zero_hessian_column_kept=kept)
    if not (diff <= HALS_ATOL * scale and kept):
        fail(f"hals_sweep {label}: kernel disagrees with its twin")
    f64_check("13", "hals_sweep", label, got, want, exact, scaled=True)
    return diff


def check_int8(DN, label, Vq, WqT, Hq) -> None:
    """Kernel #6 (dual entry, both outputs) and the one-sided entries
    against the exact float64 products: equal, and every sum inside the
    int32 range, so that "equal" needs no wrap-around."""
    exact_w, exact_h = DN.vht_exact(Vq, Hq), DN.wtv_exact(Vq, WqT)
    peak = max(float(exact_w.abs().max()), float(exact_h.abs().max()))
    want_w, want_h = DN._wrap_int32(exact_w), DN._wrap_int32(exact_h)
    del exact_w, exact_h
    nw, nh = DN.dual_int8(Vq, WqT, Hq)
    vht, wtv = DN.vht_int8(Vq, Hq), DN.wtv_int8(Vq, WqT)
    torch.cuda.synchronize()
    same = {"dual_nw": torch.equal(nw, want_w),
            "dual_nh": torch.equal(nh, want_h),
            "vht": torch.equal(vht, want_w), "wtv": torch.equal(wtv, want_h)}
    say("13 int8 numerators", case=label, equal=same,
        max_abs_sum=f"{peak:.6g}", int32_limit=2**31 - 1)
    if peak >= 2**31:
        fail(f"int8 numerators {label}: a sum leaves the int32 range")
    if not all(same.values()):
        fail(f"int8 numerators {label}: a kernel differs from the exact "
             f"product: {same}")


def slice4a_phases(nt, card, dev, V, W0, H0, Vq, scale, plain_ms) -> dict:
    """Phases 13-15: kernels #5-#7 against their twins, dense HALS end to
    end, Jacobi and int8 x int8 MU end to end. V, W0, H0, Vq, scale are
    phase 4's 4096^2 / r = 256 problem; plain_ms is phase 6's plain
    float32 ms per MU iteration. Returns the kernels line's fields of
    the five kernel entries."""
    from nmftpu_torch.kernels import dense_mu as K
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.linalg import dense as D

    n, m = V.shape
    r = W0.shape[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    n5, m5, r5, nnz = ML20M
    t0 = time.perf_counter()
    R = synthetic_ratings(n5, m5, nnz, torch.Generator(device=dev)
                          .manual_seed(SEED + 5), dev)
    torch.cuda.synchronize()
    say("13 data", shape=f"{n5}x{m5}", nnz=int(torch.count_nonzero(R)),
        make_V_s=f"{time.perf_counter() - t0:.2f}")
    Vq5, scale5 = Q.quantize_v(R)

    # -- 13. kernels #5, #6, #7 against their plain versions ----------------
    max_abs = {"hals_sweep": 0.0}
    for label, (hn, hr), zero in (("4096x256", (4096, 256), None),
                                  ("2048x512", (2048, 512), None),
                                  ("138493x64", (n5, r5), None),
                                  ("ragged 1000x37, hessian 0 at 5",
                                   (1000, 37), 5)):
        max_abs["hals_sweep"] = max(max_abs["hals_sweep"], check_hals(
            HS, label, hn, hr, gen, dev, zero))
    W5 = torch.rand(n5, r5, generator=gen, device=dev)
    H5 = torch.rand(r5, m5, generator=gen, device=dev)
    ragged = Q.quantize_v(5.0 * torch.rand(1000, 1500, generator=gen,
                                           device=dev))[0]
    for label, Vqc, Wc, Hc in (
            ("4096^2 r=256", Vq, W0, H0),
            ("ML-20M shape r=64", Vq5, W5, H5),
            ("ragged 1000x1500 r=37", ragged,
             torch.rand(1000, 37, generator=gen, device=dev),
             torch.rand(37, 1500, generator=gen, device=dev))):
        check_int8(DN, label, Vqc, D.quantize_sym_t(Wc)[1],
                   D.quantize_sym(Hc)[1])
    # #6 at the ML-20M shape, where reading V (3.70 GB) once pays: the
    # kernels, the float64 twins, and torch._int_mm for V Hqᵀ (Wqᵀ V's
    # contraction, n = 138,493, is not a multiple of 8, which _int_mm needs)
    WqT5, Hq5 = D.quantize_sym_t(W5)[1], D.quantize_sym(H5)[1]
    del W5, H5, ragged
    ml_ms = abba_ms({
        "dual_numerators_int8": lambda: DN.dual_int8(Vq5, WqT5, Hq5),
        "dual_numerators_int8_plain": lambda: DN.dual_int8_plain(
            Vq5, WqT5, Hq5),
        "vht_int8": lambda: DN.vht_int8(Vq5, Hq5),
        "vht_int8_plain": lambda: DN.vht_int8_plain(Vq5, Hq5),
        "vht_int8_library": lambda: torch._int_mm(Vq5, Hq5.t()),
        "wtv_int8": lambda: DN.wtv_int8(Vq5, WqT5),
        "wtv_int8_plain": lambda: DN.wtv_int8_plain(Vq5, WqT5),
    }, iters=3)
    ml_bounds = {
        "dual_numerators_int8": bound(4 * n5 * m5 * r5,
                                      n5 * m5 + 5 * r5 * (n5 + m5),
                                      INT8_PEAK),
        "vht_int8": bound(2 * n5 * m5 * r5, n5 * m5 + r5 * m5 + 4 * n5 * r5,
                          INT8_PEAK),
        "wtv_int8": bound(2 * n5 * m5 * r5, n5 * m5 + n5 * r5 + 4 * r5 * m5,
                          INT8_PEAK),
    }
    for name, (b_ms, b_by) in ml_bounds.items():
        say("13 kernel timing", kernel=name, shape=f"{n5}x{m5} r={r5}",
            ms=f"{ml_ms[name]:.4f}", plain_ms=f"{ml_ms[name + '_plain']:.4f}",
            library_ms=(f"{ml_ms['vht_int8_library']:.4f}"
                        if name == "vht_int8" else None),
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, card=card)
    del WqT5, Hq5
    for label, shape in (("4096x4096", (4096, 4096)),
                         ("ragged 1000x37", (1000, 37))):
        x, y, z = (torch.rand(*shape, generator=gen, device=dev)
                   for _ in range(3))
        same = torch.equal(K.fused_multiply_divide(x, y, z),
                           K.fused_multiply_divide_plain(x, y, z))
        say("13 fused_multiply_divide", case=label, bit_equal=same)
        if not same:
            fail(f"fused_multiply_divide {label}: kernel differs from its "
                 "twin")
    # timing at the main path's 4096^2 / r = 256 shapes
    WqT, Hq = D.quantize_sym_t(W0)[1], D.quantize_sym(H0)[1]
    XHt, G = V @ H0.T, H0 @ H0.T
    x, y, z = (torch.rand(n, m, generator=gen, device=dev) for _ in range(3))
    # the library yardstick for #6: cuBLASLt's int8 GEMM through
    # torch._int_mm, in the operand layouts it takes (B column-major),
    # which costs Vq's transpose, made here once
    VqT = Vq.t().contiguous()
    lib_w, lib_ht = torch._int_mm(Vq, Hq.t()), torch._int_mm(VqT, WqT.t())
    nw, nh = DN.dual_int8(Vq, WqT, Hq)
    lib_same = bool(torch.equal(lib_w, nw) and torch.equal(lib_ht.t(), nh))
    del lib_w, lib_ht, nw, nh
    t_ms = abba_ms({
        "hals_sweep": lambda: HS.hals_sweep(XHt, G, W0),
        "hals_sweep_plain": lambda: HS.hals_sweep_plain(XHt, G, W0),
        "dual_numerators_int8": lambda: DN.dual_int8(Vq, WqT, Hq),
        "dual_numerators_int8_plain": lambda: DN.dual_int8_plain(Vq, WqT,
                                                                 Hq),
        "dual_numerators_int8_library": lambda: (
            torch._int_mm(Vq, Hq.t()), torch._int_mm(VqT, WqT.t())),
        "vht_int8": lambda: DN.vht_int8(Vq, Hq),
        "vht_int8_plain": lambda: DN.vht_int8_plain(Vq, Hq),
        "vht_int8_library": lambda: torch._int_mm(Vq, Hq.t()),
        "wtv_int8": lambda: DN.wtv_int8(Vq, WqT),
        "wtv_int8_plain": lambda: DN.wtv_int8_plain(Vq, WqT),
        "wtv_int8_library": lambda: torch._int_mm(VqT, WqT.t()),
        "fused_multiply_divide": lambda: K.fused_multiply_divide(x, y, z),
        "fused_multiply_divide_plain": lambda: K.fused_multiply_divide_plain(
            x, y, z),
    }, iters=10)
    del VqT, WqT
    # bounds: each input read once, each output written once; #7 on the
    # float32 CUDA cores, #6 and its one-sided entries on the int8 tensor
    # cores' rate, #5 by its bytes
    b = 16
    bounds = {
        "hals_sweep": bound(2 * n * r * r + 2 * n * r * b,
                            4 * (3 * n * r + r * r), F32_PEAK),
        "dual_numerators_int8": bound(4 * n * m * r,
                                      n * m + n * r + r * m
                                      + 4 * (n * r + r * m), INT8_PEAK),
        "vht_int8": bound(2 * n * m * r, n * m + r * m + 4 * n * r,
                          INT8_PEAK),
        "wtv_int8": bound(2 * n * m * r, n * m + n * r + 4 * r * m,
                          INT8_PEAK),
        "fused_multiply_divide": bound(2 * n * m, 4 * 4 * n * m, F32_PEAK),
    }
    library = {"dual_numerators_int8": t_ms["dual_numerators_int8_library"],
               "vht_int8": t_ms["vht_int8_library"],
               "wtv_int8": t_ms["wtv_int8_library"],
               "hals_sweep": None, "fused_multiply_divide": None}
    for name, (b_ms, b_by) in bounds.items():
        say("13 kernel timing", kernel=name, shape=f"{n}x{m} r={r}",
            ms=f"{t_ms[name]:.4f}", plain_ms=f"{t_ms[name + '_plain']:.4f}",
            library_ms=(None if library[name] is None
                        else f"{library[name]:.4f}"),
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, card=card)
    say("13 library", torch_int_mm_equals_kernel=lib_same)
    if not lib_same:
        fail("torch._int_mm and the int8 kernels disagree")

    # -- 14. dense HALS end to end (the fourth main path) --------------------
    # -- 15. Jacobi and int8 x int8 MU end to end (the fifth) ----------------
    for counts in (HS.LAUNCHES, DN.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    K.LAUNCHES["fused_multiply_divide"] = 0
    common = dict(init="copy", W0=W0, H0=H0, num_iterations=50,
                  check_interval=10, device="cuda")

    def run(phase, label, V_in, rank, check=True, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = nt.nmf(V_in, rank, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        errs = res.stats.errors
        finite = bool(torch.isfinite(res.W).all()
                      and torch.isfinite(res.H).all())
        say(phase, run=label, iterations=res.num_iterations,
            first_error=f"{errs[0]:.6g}", last_error=f"{errs[-1]:.6g}",
            kl_error=res.kl_error, finite=finite, seconds=f"{secs:.3f}")
        if not finite or (check and not errs[-1] < errs[0]):
            fail(f"{label}: non-finite factors or the error did not fall: "
                 f"{errs.tolist()}")
        return res

    before = HS.LAUNCHES["hals_sweep"]
    hals = run("14 hals e2e", "4096^2 r=256 hals", V, r, algorithm="hals",
               **common)
    hals_launches = HS.LAUNCHES["hals_sweep"] - before
    mu = run("14 hals e2e", "4096^2 r=256 mu (plain f32)", V, r, **common)
    # one iteration, then the same 50, through the plain blocked sweep;
    # the kernel's two launches here compare, and stay out of the count
    one_k = D.hals_update(V, W0, H0)
    HS.LAUNCHES["hals_sweep"] -= 2
    Wp, Hp = D.hals_update(V, W0, H0, impl="blocked")
    dw = float((one_k[0] - Wp).abs().max() / Wp.abs().max())
    dh = float((one_k[1] - Hp).abs().max() / Hp.abs().max())
    for _ in range(49):
        Wp, Hp = D.hals_update(V, Wp, Hp, impl="blocked")
    e_plain = float(D.frobenius_error(V, Wp, Hp))
    de = abs(hals.frobenius_error / e_plain - 1)
    # the factors after 50 iterations, for the record (no limit: see
    # HALS_STEP_RTOL)
    dw50 = float((hals.W - Wp).abs().max() / Wp.abs().max())
    dh50 = float((hals.H - Hp).abs().max() / Hp.abs().max())
    say("14 checks", cell="4096^2 r=256", hals_sweep_launches=hals_launches,
        expected=100, one_iteration_kernel_vs_plain_W=f"{dw:.3e}",
        one_iteration_kernel_vs_plain_H=f"{dh:.3e}", rtol=HALS_STEP_RTOL,
        after_50_W=f"{dw50:.3e}", after_50_H=f"{dh50:.3e}",
        hals_error=f"{hals.frobenius_error:.6g}",
        plain_sweep_error=f"{e_plain:.6g}", error_rel=f"{de:.3e}",
        error_rtol=HALS_E2E_RTOL, mu_error=f"{mu.frobenius_error:.6g}")
    if hals_launches != 100:
        fail(f"hals_sweep launched {hals_launches} times, not 100")
    if not (dw <= HALS_STEP_RTOL and dh <= HALS_STEP_RTOL):
        fail(f"one HALS iteration through the kernel differs from the plain "
             f"sweep (W {dw:.3e}, H {dh:.3e} > {HALS_STEP_RTOL})")
    if not de <= HALS_E2E_RTOL:
        fail(f"50 HALS iterations through the kernel end {de:.3e} from the "
             f"plain sweep's error (> {HALS_E2E_RTOL})")
    del one_k
    if not hals.frobenius_error <= mu.frobenius_error * 1.001:
        fail("HALS ends above MU at equal iterations")
    del hals, mu, Wp, Hp
    V2 = synthetic_lowrank(2048, 2048, 512, gen, dev)
    for label, V_in, rank, kw in (
            ("2048^2 r=512", V2, 512, dict(init="random", seed=0)),
            ("ML-20M shape r=64 (float32 V)", R, r5,
             dict(init="random", seed=0))):
        before = HS.LAUNCHES["hals_sweep"]
        h = run("14 hals e2e", f"{label} hals", V_in, rank,
                algorithm="hals", num_iterations=10, check_interval=2,
                **kw)
        launched = HS.LAUNCHES["hals_sweep"] - before
        u = run("14 hals e2e", f"{label} mu (plain f32)", V_in, rank,
                num_iterations=10, check_interval=2, **kw)
        say("14 checks", cell=label, hals_sweep_launches=launched,
            expected=20, hals_error=f"{h.frobenius_error:.6g}",
            mu_error=f"{u.frobenius_error:.6g}")
        if launched != 20:
            fail(f"{label}: hals_sweep launched {launched} times, not 20")
        if not h.frobenius_error <= u.frobenius_error * 1.001:
            fail(f"{label}: HALS ends above MU at equal iterations")
        del h, u
    del V2

    # -- 15. Jacobi and int8 x int8 MU at 4096^2 / r = 256 -------------------
    pairs = {
        "float32 frobenius": dict(),
        "float32 kl": dict(objective="kl"),
        "bfloat16 frobenius": dict(v_storage="bfloat16"),
        "int8 frobenius": dict(v_storage="int8"),
        "int8 frobenius use_pallas": dict(v_storage="int8", use_pallas=True),
    }
    finals = {}
    for label, knobs in pairs.items():
        for style in ("gauss-seidel", "jacobi"):
            before = dict(DN.LAUNCHES)
            res = run("15 mu e2e", f"{label} {style}", V, r,
                      check=knobs.get("objective") != "kl",
                      mu_style=style, **common, **knobs)
            finals[label, style] = (res.kl_error if "kl" in label
                                    else res.frobenius_error)
            launched = {k: DN.LAUNCHES[k] - before[k] for k in DN.LAUNCHES}
            want = dict.fromkeys(DN.LAUNCHES, 0)
            if label == "int8 frobenius":
                want.update(vht_int8=50, wtv_int8=50)
            elif label == "int8 frobenius use_pallas" and style == "jacobi":
                want["dual_numerators_int8"] = 50
            say("15 launches", run=f"{label} {style}", launches=launched)
            if launched != want:
                fail(f"{label} {style}: int8 kernel launches {launched}, "
                     f"expected {want}")
            del res
        ratio = finals[label, "jacobi"] / finals[label, "gauss-seidel"]
        say("15 checks", run=label, jacobi_over_gauss_seidel=f"{ratio:.4f}",
            limit=1.10)
        if not ratio <= 1.10:
            fail(f"{label}: jacobi ends {ratio:.4f}x above Gauss-Seidel")
    gs_rel = abs(finals["int8 frobenius", "gauss-seidel"]
                 / finals["int8 frobenius use_pallas", "gauss-seidel"] - 1)
    say("15 checks", int8_x_int8_vs_int8_kernels_3_4=f"{gs_rel:.3e}",
        rtol=1e-3)
    if not gs_rel <= 1e-3:
        fail(f"int8 x int8 and the int8 kernels #3/#4 end {gs_rel:.3e} "
             "apart")
    before = DN.LAUNCHES["dual_numerators_int8"]
    run("15 mu e2e", "ML-20M shape r=64 int8 jacobi use_pallas", R, r5,
        init="random", seed=0, num_iterations=10, check_interval=2,
        v_storage="int8", use_pallas=True, mu_style="jacobi")
    launched = DN.LAUNCHES["dual_numerators_int8"] - before
    say("15 checks", cell="ML-20M shape", dual_launches=launched, expected=10)
    if launched != 10:
        fail(f"ML-20M shape: dual kernel launched {launched} times, not 10")
    # the main paths end here (fused_multiply_divide has no caller on them)
    launches = {**HS.LAUNCHES, **DN.LAUNCHES,
                "fused_multiply_divide": K.LAUNCHES["fused_multiply_divide"]}
    del R, Vq5, scale5

    # ms per iteration at 4096^2 / r = 256, beside phase 6's plain f32 MU
    it_ms = abba_ms({
        "hals (kernel #7)": lambda: D.hals_update(V, W0, H0),
        "mu jacobi f32": lambda: D.mu_update_frobenius(V, W0, H0,
                                                       order="jacobi"),
        "mu jacobi bf16": lambda: D.mu_update_frobenius_bf16v(
            V.to(torch.bfloat16), W0, H0, order="jacobi"),
        "mu jacobi int8 (one-sided #6)": lambda: (
            D.mu_update_frobenius_int8x8(Vq, scale, W0, H0, order="jacobi")),
        "mu jacobi int8 use_pallas (dual #6)": lambda: (
            D.mu_update_frobenius_int8x8(Vq, scale, W0, H0, order="jacobi",
                                         use_fused=True)),
        "mu gauss-seidel int8 (one-sided #6)": lambda: (
            D.mu_update_frobenius_int8x8(Vq, scale, W0, H0)),
        "mu kl jacobi f32": lambda: D.mu_update_kl(V, W0, H0,
                                                   order="jacobi"),
    }, iters=10)
    for path, ms in it_ms.items():
        say("15 timing", path=path, ms_per_iter=f"{ms:.4f}",
            phase6_plain_f32_mu_ms=f"{plain_ms:.4f}", card=card)
    return {name: {"launches": launches[name],
                   "max_abs_err": max_abs.get(name, 0.0),
                   "ms": t_ms[name], "plain_ms": t_ms[name + "_plain"],
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                   "library_ms": library[name]}
            for name in bounds}


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
    from nmftpu_torch.retrieval.mips import _gather_scores
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
    check_tensor_cores(lib_path)

    # -- 3. each kernel against its plain twin -------------------------------
    max_abs = dict.fromkeys(REPLACES, 0.0)
    for n, m, r in KERNEL_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + n + m + r)
        V = 5.0 * torch.rand(n, m, generator=gen, device=dev)
        W = torch.rand(n, r, generator=gen, device=dev) + 0.05
        H = torch.rand(r, m, generator=gen, device=dev) + 0.05
        Vq, scale = Q.quantize_v(V)
        Gw, Gh = H @ H.T, W.T @ W
        exact = {"w": mu_exact("w", V, None, W, H, Gw),
                 "h": mu_exact("h", V, None, W, H, Gh),
                 "w_q": mu_exact("w", Vq, scale, W, H, Gw),
                 "h_q": mu_exact("h", Vq, scale, W, H, Gh)}
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
            key = name[0] + ("_q" if name.endswith("_q") else "")
            f64_check("3", name, f"{n}x{m} r={r}", got, want, exact[key])
        del V, W, H, Vq, scale, Gw, Gh, cases, exact

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
    main_path_launches = {k: v for k, v in {**K.LAUNCHES, **Q.LAUNCHES}
                          .items() if k in DENSE}
    if min(main_path_launches.values()) < 1:
        fail(f"a kernel of the path never launched: {main_path_launches}")

    # the kernels against their twins and float64 on this run's V (float32
    # and its Vq, scale) and final factors: the only shape with
    # n * m >= 2**31 (64-bit offsets) and whose H step splits its depth
    # (418 blocks over n = 138,493). quantize_v is deterministic, so this
    # Vq is the one the run used. Every term is nonnegative and most of V
    # is zero, so each sum has at most a column's or a row's nonzeros:
    # KERNEL_RTOL holds as in phase 3.
    Vq5, scale5 = Q.quantize_v(R)
    W5, H5 = res.W, res.H
    Gw, Gh = H5 @ H5.T, W5.T @ W5
    ml_cases = {
        "w_update_fused": (lambda: K.w_update_fused(R, W5, H5, Gw),
                           lambda: K.w_update_fused_plain(R, W5, H5, Gw),
                           ("w", R, None, Gw)),
        "h_update_fused": (lambda: K.h_update_fused(R, W5, H5, Gh),
                           lambda: K.h_update_fused_plain(R, W5, H5, Gh),
                           ("h", R, None, Gh)),
        "w_update_fused_q": (
            lambda: Q.w_update_fused_q(Vq5, scale5, W5, H5, Gw),
            lambda: Q.w_update_fused_q_plain(Vq5, scale5, W5, H5, Gw),
            ("w", Vq5, scale5, Gw)),
        "h_update_fused_q": (
            lambda: Q.h_update_fused_q(Vq5, scale5, W5, H5, Gh),
            lambda: Q.h_update_fused_q_plain(Vq5, scale5, W5, H5, Gh),
            ("h", Vq5, scale5, Gh)),
    }
    for name, (kernel, plain, (step, Vx, sx, G)) in ml_cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        a, rel = rel_err(got, want)
        max_abs[name] = max(max_abs[name], a)
        say("5 kernel", kernel=name, shape=f"{n5}x{m5}", rank=r5,
            max_abs=f"{a:.3e}", max_rel=f"{rel:.3e}", rtol=KERNEL_RTOL)
        if not rel <= KERNEL_RTOL:
            fail(f"{name} {n5}x{m5} r={r5}: max rel {rel:.3e} > "
                 f"{KERNEL_RTOL}")
        f64_check("5", name, f"{n5}x{m5} r={r5}", got, want,
                  mu_exact(step, Vx, sx, W5, H5, G))
        del got, want
    # the kernels' times at this shape (the kernels line keeps phase 6's)
    ml_ms = abba_ms({**{k: f[0] for k, f in ml_cases.items()},
                     **{k + "_plain": f[1] for k, f in ml_cases.items()}},
                    iters=2)
    for name in ml_cases:
        say("5 kernel timing", kernel=name, shape=f"{n5}x{m5} r={r5}",
            ms=f"{ml_ms[name]:.4f}", plain_ms=f"{ml_ms[name + '_plain']:.4f}",
            card=card)
    del ml_cases
    # the same ratings as a host CSR: config 2's sparse V for phases 10-12
    ratings = ratings_csr(R)
    del R, Vq5, scale5, res, W5, H5, Gw, Gh

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
    plain_ms = it_ms["plain_f32"]
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
        # the numerator and the Gram apply as the kernel runs them, on the
        # tensor cores in split tf32: three products of each float32
        # operand pair, two where V is int8 (exact in tf32); the
        # denominator's operands are float32, three products
        v_bytes = 1 if name.endswith("_q") else 4
        out = n * r if name.startswith("w") else r * m
        bounds[name] = bound((2 if name.endswith("_q") else 3) * 2 * n * m * r
                             + 3 * 2 * out * r,
                             v_bytes * n * m + 4 * (n * r + r * m + r * r
                                                    + out), TF32_PEAK)
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
            a, cand, _ = check_reservoir(MR, label, Wk, H, m, slots)
            max_abs["reservoir_scan"] = max(max_abs["reservoir_scan"], a)
            theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
            d, _ = check_count(CA, label, Wq, H, theta, hs)
            max_abs["count_above"] = max(max_abs["count_above"], d)
        del Wq, Hf, H, hs, Wk, cand, theta
    # every item ties theta: one column repeated, theta its chain score
    # (row 0: -inf, every item counts); each pair goes through the band,
    # the default list of 4,096 overflows, and the count stays exact
    gen = torch.Generator(device=dev).manual_seed(SEED + 77)
    b, r, m = 37, 37, 10_007
    Wq = torch.rand(b, r, generator=gen, device=dev)
    col = torch.rand(r, 1, generator=gen, device=dev)
    for td in ("bfloat16", "int8"):
        H, hs = ((col.to(torch.bfloat16), None) if td == "bfloat16"
                 else quantize_table(col))
        H = H.expand(r, m).contiguous()
        theta = _gather_scores(Wq, H, torch.zeros(b, 1, dtype=torch.int32,
                                                  device=dev), hs)[:, 0]
        theta[0] = float("-inf")
        d, _ = check_count(CA, f"all ties b={b} r={r} m={m} {td}", Wq, H,
                           theta.contiguous(), hs, all_band=True)
        max_abs["count_above"] = max(max_abs["count_above"], d)
    del Wq, col, H, hs, theta

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
    tc_err = dict.fromkeys(recs, 0.0)
    for td, b, slots in (("int8", 512, 4096), ("int8", 512, 16384),
                         ("int8", 2048, 4096),
                         ("bfloat16", 512, 4096), ("bfloat16", 512, 16384)):
        rec = recs[td]
        Wq = rec.W[torch.as_tensor(batches[b], device=dev)]
        Wk = Wq if rec._h_scale is None else Wq * rec._h_scale
        label = f"full table b={b} R={slots} {td}"
        a, cand, got = check_reservoir(MR, label, Wk, rec.H, SERVE_ITEMS,
                                       slots)
        max_abs["reservoir_scan"] = max(max_abs["reservoir_scan"], a)
        h_max = CA.table_h_max(rec.H, rec._h_max)
        tc_err[td] = max(tc_err[td], tensor_core_error(
            Wq, rec.H, rec._h_scale, h_max, got))
        theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
        d, _ = check_count(CA, label, Wq, rec.H, theta, rec._h_scale,
                           rec._h_max)
        max_abs["count_above"] = max(max_abs["count_above"], d)
        if td == "int8" and b == 512 and slots == 4096:
            d = check_zero_queries(CA, rec, Wq, theta, card)
            max_abs["count_above"] = max(max_abs["count_above"], d)
        del Wq, Wk, cand, got, theta
    del rec
    # the band's constant against the tensor cores' largest error seen
    for td, err in tc_err.items():
        say("7 band", table=td, largest_tc_error_in_r_ulps_of_A=f"{err:.4g}",
            band_constant=CA.BAND_C, margin=f"{CA.BAND_C / err:.4g}"
            if err else "inf", required_margin=BAND_MARGIN)
        if not CA.BAND_C >= BAND_MARGIN * err:
            fail(f"{td}: the tensor cores' error {err:.4g} leaves the band "
                 f"constant {CA.BAND_C} less than {BAND_MARGIN}x margin")

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
    before = dict(MR.VARIANT_LAUNCHES)
    cand = MR.reservoir_scan(Wk, Hq, SERVE_ITEMS, 4096)[0]
    ran = {k: MR.VARIANT_LAUNCHES[k] - before[k] for k in before}
    say("9 variant", reservoir_scan=ran)
    if ran != {"tc": 1, "tc_unaligned": 0, "f32": 0, "merge": 0}:
        fail(f"phase 9 does not time the aligned tensor-core scan: {ran}")
    theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
    band = CA.band_pairs()
    CA.count_above_fused(Wq, Hq, theta, h_scale=hs)
    band = CA.band_pairs() - band
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
            **({"band_pairs_per_call": band} if name == "count_above"
               else {}), card=card)
    del Hq, hs, Wq, Wk, cand, theta, W8, train
    torch.cuda.empty_cache()

    # -- 10-12. sparse V at config 2's full width (ELL, densified) ----------
    ell = sparse_phases(nt, ratings, card, dev)
    del ratings
    max_abs["ell_rowsums"] = ell["max_abs_err"]
    k_ms["ell_rowsums"], p_ms["ell_rowsums"] = ell["ms"], ell["plain_ms"]
    bounds["ell_rowsums"] = (ell["bound_ms"], ell["bound_by"])
    library_ms = {"ell_rowsums": ell["library_ms"]}

    # -- 13-15. slice 4a: HALS, Jacobi and int8 x int8 MU ---------------------
    new = slice4a_phases(nt, card, dev, V, W0, H0, Vq, scale, plain_ms)
    for name, f in new.items():
        max_abs[name], k_ms[name], p_ms[name] = (f["max_abs_err"], f["ms"],
                                                 f["plain_ms"])
        bounds[name] = (f["bound_ms"], f["bound_by"])
        library_ms[name] = f["library_ms"]

    if "jax" in sys.modules:
        fail("jax was imported")
    # a time below the least the card could take means a wrong bound
    below = {name: (k_ms[name], bounds[name][0]) for name in REPLACES
             if k_ms[name] < bounds[name][0]}
    if below:
        fail(f"kernels timed below their bound (ms, bound_ms): {below}")

    launches = {**main_path_launches, **serve_launches,
                "ell_rowsums": ell["launches"],
                **{name: f["launches"] for name, f in new.items()}}
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
