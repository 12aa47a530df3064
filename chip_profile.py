"""Where one MU iteration and one serving batch of the PyTorch/CUDA port
(nmftpu_torch) spend their time on one NVIDIA GPU.

    python3 chip_profile.py [--out DIR]
                            [--cells dense,serving,sparse,slice8,foldin,beta,
                                     algorithms,sparse_algorithms,surfaces,
                                     sharded,ring,dense_mesh]

Two shapes -- 4096 x 4096 at rank 256 (bench.py's headline) and the
ML-20M shape 138,493 x 26,744 at rank 64, with chip_smoke.py's synthetic
data -- and three update paths: plain float32 torch.matmul ("plain_f32"),
the float32 kernels ("kernel_f32") and the int8 kernels ("kernel_int8");
at 4096 x 4096 also HALS through the sweep kernel ("hals_kernel") and
Jacobi MU with the dual int8 numerator kernel ("int8_jacobi_fused"),
which have no half-step split.
For each it prints one line with

- ms per MU iteration, per W half-step and per H half-step (each with
  its Gram), by CUDA events in A B C C B A order, TF32 off;
- from torch.profiler over a 20-iteration ``nmftpu_torch.nmf`` run with a
  check every 10: device ms per iteration by kernel class (each of the
  port's dense kernels: mu_update, hals_sweep, int8_numer, muldiv;
  cuBLAS/CUTLASS GEMMs, everything else) and the device's idle
  share over the span from its first to its last kernel. The profiler
  widens the host's launch gaps, so the idle share is an upper bound.

and per shape one line with the ms of one error check. Then the serving
cell (BASELINE config 5 at full width, chip_smoke.py's phase-8 data, int8
table, k = 100): for batches of 512 and 2048 users and each serving path
(reservoir, certified, all-exact composed, exact scan), one line with
the call's host-clock ms and, from torch.profiler over one call, device
ms by kernel class (the reservoir and count kernels, GEMMs, top-k and
sorts, everything else) and the idle share. Then the sparse cell
(BASELINE config 2's full width: the same synthetic ratings as a sparse
CSR, rank 64): for the ELL engine with and without the segment-SpMM
kernel and the densified bf16 engine, under the Frobenius and KL
objectives, one line with ms per iteration by CUDA events and, from
torch.profiler over a 20-iteration ``SparsePlan.run`` with a check every
10, device ms per iteration by class (the ELL kernel, gathers,
index_add_ scatters, GEMMs, everything else) and the idle share, and
one line with the ms of each engine's Frobenius and KL error checks.
Then slice 8's paths (cell "slice8"): at config 2's shape, int8
densified MU under Frobenius (#6's one-sided entries) and KL and masked
completion (Frobenius, KL) on ELL and scatter, each profiled over a
5-iteration run; then BASELINE config 3 at full size (chip_smoke.py's
phase-16 data, rank 128, alpha 40) on the densified bf16 and int8, ELL
and scatter engines, each profiled over a 2-iteration run; ms per
iteration by CUDA events as above. Then cold users (cell "foldin"):
config 5's two tables (int8 and bf16, chip_smoke.py's phase-8 data),
512 users outside training with 100 items each (as phase 18 draws them),
one profiled ``recommend_from_history_batch`` (ALS fold-in, then the
reservoir scan) and ``prepare_table`` per table, and on the int8 table
``fold_in_batch`` under MU, KL and HALS (50 iterations): host-clock ms,
device ms by class (the reservoir, int8 numerator and sweep kernels, the
Cholesky and triangular solves, GEMMs, gathers, everything else) and the
idle share. Then the beta divergence at config 2's full width (cell
"beta", chip_smoke.py's phase-20 paths): beta = 0.5 and 1.5 on the
densified bf16 and int8, ELL and scatter engines, each profiled over a
2-iteration run with a check at its end; ms per iteration by CUDA
events. Then the dense ALS family, GDCLS and nsNMF (cell "algorithms",
chip_smoke.py's phase-21 paths): each of ALS, ACLS, AHCLS, GDCLS, nsNMF
and nsNMF-KL on float32, bf16 and int8 V at 4096 x 4096 / rank 256
(profiled over 10 iterations), and int8 ALS, GDCLS and nsNMF at the ML-20M
shape (dense, rank 64, 3 iterations), each with one check at its end: ms
per iteration by CUDA events, device ms per iteration by class (GEMMs,
the Cholesky and triangular solves, #6's int8 entries, everything else)
and the idle share. Then the ALS family and HALS on sparse V (cell
"sparse_algorithms", chip_smoke.py's phase-22 paths): ALS at config 2's
full width (rank 64) on ELL, scatter and densified bf16 and HALS on
scatter, each profiled over a 2-iteration run with a check at its end,
and iALS at config 3's full size (rank 128, alpha 40) on ELL, profiled
over one iteration (the Gram budget raised to 16 GiB for it): ms per
iteration by CUDA events, device ms per iteration by class (gathers,
index_add_ scatters, GEMMs, the Cholesky and triangular solves, #6's int8
entries, #7's sweep, everything else) and the idle share. Then slice 5's
surfaces (cell "surfaces", chip_smoke.py's phase-23 paths): the sklearn
facade's NMF(solver="cd") fit at config 2 (2 iterations, its set-up
included), MiniBatchNMF's host loop over its first 8 panels (KL, 1,024
rows each, each panel densified on the host), compute_batched (8 x
4096^2, rank 256; plain, the float32 and int8 MU kernels, HALS) and 4
vectorized restarts (MU kernels, HALS) over 4 iterations: host-clock ms
per iteration or panel, device ms per iteration or panel by class and
the idle share. Then slice 6a's grid engine (cell "sharded",
chip_smoke.py's phase 24 (a)): one rank of the port's launcher under
NCCL, a 1 x 1 mesh, one device's share of BASELINE config 4 (12,500,000
x 2,500,000 from 156,250,000 power-law draws, rank 256): one MU-Frobenius
iteration of the sharded update on the ELL and the scatter tiles, each
profiled after a warm-up iteration: CUDA-event ms, device ms by class and
the idle share. Then slice 6b (chip_smoke.py's phase 25 (a) and (b)),
four ranks of the launcher sharing the card over gloo: the ring engine
at config 2 (cell "ring": phase 10's ratings, rank 64, one MU-Frobenius
iteration on a 4-ring) and dense V at the ML-20M shape on a 2 x 2 mesh
(cell "dense_mesh": one MU-Frobenius iteration, float32 V), each rank
profiling its own iteration after a warm-up one: CUDA-event ms, device
ms by class and the idle share a rank (four processes time-share the
card, so the idle share of one rank's timeline counts the others'
kernels as idle). --cells picks a subset of the twelve cells. Every line
ends with the card's nvidia-smi name and power limit.
The profiler traces and summary.json go to --out (default: profile_out/
beside this script). Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

import torch

from chip_smoke import (
    C2_BETAS,
    C3_ALPHA,
    C3_RANK,
    CONFIG3,
    FAMILY,
    HERE,
    ML20M,
    SEED,
    abba_ms,
    cuda_ms,
    distinct_items,
    event_ms,
    fail,
    nvidia_smi_line,
    SERVE_K,
    SERVE_USERS,
    say,
    serving_data,
    ratings_csr,
    synthetic_lowrank,
    synthetic_ratings,
)

PROFILE_ITERS = 20
CHECK_INTERVAL = 10
# slice 8's paths are 10-400 ms an iteration: fewer iterations profiled
S8_PROFILE_ITERS = 5
C3_PROFILE_ITERS = 2
# the beta cell's paths are 100-500 ms an iteration
BETA_PROFILE_ITERS = 2
# the dense ALS family: iterations profiled at 4096^2 and at the ML-20M
# shape
FAMILY_PROFILE_ITERS = 10
CELLS = ("dense", "serving", "sparse", "slice8", "foldin", "beta",
         "algorithms", "sparse_algorithms", "surfaces", "sharded", "ring",
         "dense_mesh")
# the sparse algorithms: iterations profiled at config 2 and for config 3's
# iALS
S12_PROFILE_ITERS = 2
IALS_PROFILE_ITERS = 1
# the surfaces: iterations of the facade's fit and of the batched and
# vectorized runs, and mini-batch panels profiled
SURFACE_PROFILE_ITERS = 2
BATCHED_PROFILE_ITERS = 4
MB_PROFILE_PANELS = 8


def kernel_class(name: str) -> str:
    # the dense kernels: the split-tf32 MU half-steps (#1-#4), the HALS
    # sweep (#7), the int8 numerators (#6) and the multiply-divide (#5)
    for frag, cls in (("update_kernel", "mu_update"),
                      ("hals_sweep_kernel", "hals_sweep"),
                      ("int8_numer_kernel", "int8_numer"),
                      ("muldiv_kernel", "muldiv")):
        if frag in name:
            return cls
    if "ell_spmm_kernel" in name:
        return "ell_rowsums"
    # the scans (float32 and tensor-core) and the merge of a split walk
    if "reservoir_" in name:
        return "reservoir_scan"
    # the tensor-core count and its band re-score
    if "count_tc_kernel" in name or "count_band_kernel" in name:
        return "count_above"
    low = name.lower()
    # cuSOLVER's Cholesky and cuBLAS's triangular solves (the fold-in)
    if any(k in low for k in ("potrf", "trsm", "trsv", "chol")):
        return "solve"
    if "indexselect" in low or "gather" in low:
        return "gather"
    if "indexfunc" in low:
        return "index_add"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "cublas")):
        return "gemm"
    if any(k in low for k in ("topk", "sort", "radix", "select")):
        return "topk_sort"
    return "other"


def device_summary(trace: Path, iters: int) -> dict:
    """Device ms per iteration by kernel class, and the idle share, from a
    chrome trace written by torch.profiler."""
    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        fail(f"{trace.name}: the profiler recorded no device events")
    per_class: dict[str, float] = {}
    for e in dev:
        c = kernel_class(e["name"])
        per_class[c] = per_class.get(c, 0.0) + e["dur"] / 1e3 / iters
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    return {"device_ms_per_iter": per_class,
            "idle_share": 1.0 - busy / span, "span_ms": span / 1e3}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(HERE / "profile_out"))
    p.add_argument("--cells", default=",".join(CELLS),
                   help="comma-separated subset of " + ", ".join(CELLS)
                        + " (default: all)")
    args = p.parse_args()
    cells = set(args.cells.split(","))
    if not cells <= set(CELLS):
        fail(f"unknown cells: {sorted(cells)}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")

    import nmftpu_torch as nt
    from nmftpu_torch.kernels import dense_mu as K
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.linalg import dense as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi_line()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(card, flush=True)

    eps = 1e-9
    summary = {"card": card}
    dense_cells = (("4096^2_r256", (4096, 4096, 256)),
                   ("ml20m_shape_r64", (138_493, 26_744, 64)))
    for cell, (n, m, r) in dense_cells if "dense" in cells else ():
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        if n == m:
            V = synthetic_lowrank(n, m, r, gen, dev)
        else:
            V = synthetic_ratings(n, m, 20_000_263, gen, dev)
        W = torch.rand(n, r, generator=gen, device=dev) + 0.01
        H = torch.rand(r, m, generator=gen, device=dev) + 0.01
        Vq, scale = Q.quantize_v(V)
        halves = {
            "plain_f32": (
                lambda: D.mu_update_w_frobenius(V, W, H, eps),
                lambda: D.mu_update_h_frobenius(V, W, H, eps)),
            "kernel_f32": (
                lambda: K.w_update_fused(V, W, H, H @ H.T, eps),
                lambda: K.h_update_fused(V, W, H, W.T @ W, eps)),
            "kernel_int8": (
                lambda: Q.w_update_fused_q(Vq, scale, W, H, H @ H.T, eps),
                lambda: Q.h_update_fused_q(Vq, scale, W, H, W.T @ W, eps)),
        }
        iteration = {
            "plain_f32": lambda: D.mu_update_frobenius(V, W, H, eps),
            "kernel_f32": lambda: K.mu_update_frobenius_fused(V, W, H, eps),
            "kernel_int8": lambda: Q.mu_update_frobenius_q(Vq, scale, W, H,
                                                           eps),
        }
        knobs = {"plain_f32": {}, "kernel_f32": {"use_pallas": True},
                 "kernel_int8": {"v_storage": "int8", "use_pallas": True}}
        if n == m:
            # slice 4a: HALS through the sweep kernel, and Jacobi MU with
            # the dual int8 numerator kernel (no half-step split)
            iteration["hals_kernel"] = lambda: D.hals_update(V, W, H)
            iteration["int8_jacobi_fused"] = lambda: (
                D.mu_update_frobenius_int8x8(Vq, scale, W, H, eps,
                                             order="jacobi", use_fused=True))
            knobs["hals_kernel"] = {"algorithm": "hals"}
            knobs["int8_jacobi_fused"] = {"v_storage": "int8",
                                          "use_pallas": True,
                                          "mu_style": "jacobi"}
        iters = 20 if n == m else 5
        it_ms = abba_ms(iteration, iters)
        w_ms = abba_ms({k: f[0] for k, f in halves.items()}, iters)
        h_ms = abba_ms({k: f[1] for k, f in halves.items()}, iters)
        svsq = torch.sum(V * V)
        check_ms = cuda_ms(lambda: D.frobenius_error(V, W, H, svsq), iters)
        say("check", cell=cell, error_check_ms=f"{check_ms:.4f}", card=card)
        summary[cell] = {"error_check_ms": check_ms}
        for path in iteration:
            nt.nmf(V, r, init="copy", W0=W, H0=H, num_iterations=2,
                   check_interval=1, device="cuda", **knobs[path])
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                nt.nmf(V, r, init="copy", W0=W, H0=H,
                       num_iterations=PROFILE_ITERS,
                       check_interval=CHECK_INTERVAL, device="cuda",
                       **knobs[path])
                torch.cuda.synchronize()
            trace = out / f"{cell}_{path}.json"
            prof.export_chrome_trace(str(trace))
            row = {"ms_per_iter": it_ms[path], "w_half_ms": w_ms.get(path),
                   "h_half_ms": h_ms.get(path),
                   **device_summary(trace, PROFILE_ITERS)}
            summary[cell][path] = row
            say("profile", cell=cell, path=path,
                ms_per_iter=f"{it_ms[path]:.4f}",
                w_half_ms=row["w_half_ms"], h_half_ms=row["h_half_ms"],
                device_ms_per_iter={k: round(v, 4) for k, v in
                                    row["device_ms_per_iter"].items()},
                idle_share=f"{row['idle_share']:.4f}", card=card)
        del V, Vq, scale, W, H, halves, iteration, svsq
        torch.cuda.empty_cache()

    if "serving" in cells:
        serving_cell(nt, dev, card, out, summary)
    if cells & {"sparse", "slice8", "beta"}:
        sparse_cells(nt, dev, card, out, summary, cells)
    if "foldin" in cells:
        foldin_cell(nt, dev, card, out, summary)
    if "algorithms" in cells:
        algorithms_cell(nt, dev, card, out, summary)
    if "sparse_algorithms" in cells:
        sparse_algorithms_cell(nt, dev, card, out, summary)
    if "surfaces" in cells:
        surfaces_cell(nt, dev, card, out, summary)
    if "sharded" in cells:
        from nmftpu_torch.kernels import _build
        from nmftpu_torch.parallel import launch

        _build.build()  # the rank loads it
        torch.cuda.empty_cache()
        summary["sharded"] = launch(sharded_rank, 1, args=(str(out), card),
                                    backend="nccl", timeout=1200)[0]

    if cells & {"ring", "dense_mesh"}:
        from nmftpu_torch.kernels import _build
        from nmftpu_torch.parallel import launch

        _build.build()  # the ranks load it
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        n, m = ML20M[:2]
        R = synthetic_ratings(n, m, ML20M[3], gen, dev)
        ratings = ratings_csr(R)
        del R
        torch.cuda.empty_cache()
        path = out / "ratings.npz"
        np.savez(path, indptr=ratings.indptr, indices=ratings.indices,
                 data=ratings.data, shape=np.array(ratings.shape))
        del ratings
        rows = launch(mesh_cells_rank, 4,
                      args=(str(path), str(out), card,
                            sorted(cells & {"ring", "dense_mesh"})),
                      backend="gloo", timeout=1200, threads=2)
        path.unlink()
        for cell in ("ring", "dense_mesh"):
            if cell in cells:
                summary[cell] = [r[cell] for r in rows]

    if "jax" in sys.modules:
        fail("jax was imported")
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)


def serving_cell(nt, dev, card, out, summary) -> None:
    """Config 5 at full width, int8 table: each serving path profiled."""
    W8, H8, train = serving_data(
        torch.Generator(device=dev).manual_seed(SEED + 8), dev)
    rec = nt.Recommender(W8, H8, train=train, method="reservoir",
                         table_dtype="int8")
    del H8
    exact = nt.Recommender.from_table(rec.W, rec.H, h_scale=rec._h_scale,
                                      train=train, method="exact")
    rng = np.random.default_rng(SEED)
    summary["serving_int8"] = {}
    for b in (512, 2048):
        users = np.sort(rng.choice(SERVE_USERS, b, replace=False))
        paths = {
            "reservoir": lambda: rec.recommend(users, k=SERVE_K),
            "certified": lambda: rec.recommend_certified(users, k=SERVE_K),
            "all_exact_composed": lambda: rec.recommend_certified(
                users, k=SERVE_K, fallback="exact"),
            "exact_scan": lambda: exact.recommend(users, k=SERVE_K),
        }
        for path, fn in paths.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            trace = out / f"serving_int8_b{b}_{path}.json"
            prof.export_chrome_trace(str(trace))
            row = {"profiled_call_ms": wall, **device_summary(trace, 1)}
            summary["serving_int8"][f"b{b}_{path}"] = row
            say("profile", cell="serving_int8", batch=b, path=path,
                profiled_call_ms=f"{wall:.3f}",
                device_ms={k: round(v, 3) for k, v in
                           row["device_ms_per_iter"].items()},
                idle_share=f"{row['idle_share']:.4f}", card=card)

    del rec, exact, W8, train
    torch.cuda.empty_cache()


def foldin_cell(nt, dev, card, out, summary) -> None:
    """Config 5's tables, 512 cold users: one recommend_from_history_batch
    per table profiled (after a warm-up call that builds the fold-in's
    table statistics)."""
    W8, H8, _ = serving_data(
        torch.Generator(device=dev).manual_seed(SEED + 8), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    hists = list(distinct_items(512, gen, dev))
    summary["foldin"] = {}
    # the profiler's first use starts its tracer, which takes seconds
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    from nmftpu_torch.foldin import prepare_table

    for td in ("int8", "bfloat16"):
        rec = nt.Recommender(W8, H8, method="reservoir", table_dtype=td)
        rec.recommend_from_history_batch(hists, k=SERVE_K)
        paths = {"recommend_from_history_batch": lambda: (
            rec.recommend_from_history_batch(hists, k=SERVE_K)),
            "prepare_table": lambda: prepare_table(rec.H,
                                                   scale=rec._h_scale)}
        if td == "int8":
            for rule, kw in (("MU", {"algorithm": "mu"}),
                             ("KL", {"algorithm": "mu", "objective": "kl"}),
                             ("HALS", {"algorithm": "hals"})):
                paths[f"fold_in_batch {rule}"] = (
                    lambda kw=kw: rec.fold_in_batch(hists, **kw))
        for path, fn in paths.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            trace = out / f"foldin_{td}_b512_{path.replace(' ', '_')}.json"
            prof.export_chrome_trace(str(trace))
            row = {"profiled_call_ms": wall, **device_summary(trace, 1)}
            summary["foldin"][f"{td}_b512 {path}"] = row
            say("profile", cell="foldin", table=td, batch=512, path=path,
                profiled_call_ms=f"{wall:.3f}",
                device_ms={k: round(v, 3) for k, v in
                           row["device_ms_per_iter"].items()},
                idle_share=f"{row['idle_share']:.4f}", card=card)
        del rec, paths
        torch.cuda.empty_cache()
    del W8, H8


def algorithms_cell(nt, dev, card, out, summary) -> None:
    """The dense ALS family, GDCLS and nsNMF: every algorithm on float32,
    bf16 and int8 V at 4096^2 / r = 256, and the int8 family at the ML-20M
    shape. The profiled window holds the iterations alone: `iters` chained
    calls of the update that nmf runs, after V's stored copy is made (the
    set-up) and one warm-up call, and without an error check."""
    from nmftpu_torch.algorithms import build_dense_update

    summary["algorithms"] = {}
    cells = [("4096^2_r256", (4096, 4096, 256), FAMILY,
              ("float32", "bfloat16", "int8")),
             ("ml20m_shape_r64", ML20M[:3],
              [f for f in FAMILY if f[0] in ("als", "gdcls")
               or f[:2] == ("nsnmf", "frobenius")], ("int8",))]
    iters = FAMILY_PROFILE_ITERS
    for cell, (n, m, r), algs, storages in cells:
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        if n == m:
            V = synthetic_lowrank(n, m, r, gen, dev)
        else:
            V = synthetic_ratings(n, m, ML20M[3], gen, dev)
        W = torch.rand(n, r, generator=gen, device=dev) + 0.01
        H = torch.rand(r, m, generator=gen, device=dev) + 0.01
        for alg, obj, kn in algs:
            for storage in storages:
                path = (f"{alg}{'_kl' if obj == 'kullback-leibler' else ''}"
                        f"_{storage}")
                knobs = dict(algorithm=alg, objective=obj,
                             v_storage=storage, **kn)
                make_aux, update, _ = build_dense_update(
                    nt.NmfConfig(rank=r, **knobs))
                aux = make_aux(V)
                it_ms = abba_ms({path: lambda: update(V, aux, W, H)},
                                3 if n == m else 1)[path]
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    Wi, Hi = W, H
                    for _ in range(iters):
                        Wi, Hi = update(V, aux, Wi, Hi)
                    torch.cuda.synchronize()
                del aux, Wi, Hi
                trace = out / f"algorithms_{cell}_{path}.json"
                prof.export_chrome_trace(str(trace))
                row = {"ms_per_iter": it_ms, **device_summary(trace, iters)}
                summary["algorithms"][f"{cell} {path}"] = row
                say("profile", cell=f"algorithms {cell}", path=path,
                    ms_per_iter=f"{it_ms:.4f}",
                    device_ms_per_iter={k: round(v, 4) for k, v in
                                        row["device_ms_per_iter"].items()},
                    idle_share=f"{row['idle_share']:.4f}", card=card)
        del V, W, H
        torch.cuda.empty_cache()


def profiled(plan, config, W, H, trace: Path, iters: int) -> dict:
    """One warm-up run of `config` on `plan`, then one under
    torch.profiler: device ms per iteration by class and idle share."""
    plan.run(config, W0=W, H0=H)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        plan.run(config, W0=W, H0=H)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    return device_summary(trace, iters)


def sparse_cells(nt, dev, card, out, summary, cells) -> None:
    """Config 2 at full width (ELL with and without the kernel, densified
    bf16; Frobenius and KL), the beta divergence at config 2 on four
    engines, then slice 8's paths: config 3 on its four engines, int8
    densified and masked completion at config 2's shape."""
    from nmftpu_torch import densified as DF
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch import sparse_ops as TS
    from nmftpu_torch.config import Initialization, NmfConfig, Objective
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK
    from nmftpu_torch.linalg import dense as D

    eps = 1e-9
    n, m, r = 138_493, 26_744, 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    R = synthetic_ratings(n, m, 20_000_263, gen, dev)
    ratings = ratings_csr(R)
    del R
    torch.cuda.empty_cache()
    scale = (float(ratings.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    W = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale

    def config(objective, iters=PROFILE_ITERS, check=CHECK_INTERVAL,
               rank=r, **knobs):
        return NmfConfig(rank=rank, objective=objective,
                         init_method=Initialization.COPY_EXISTING,
                         num_iterations=iters, check_interval=check,
                         **knobs)

    def report(cell, paths, iters, it_ms):
        summary.setdefault(cell, {})
        for path, (plan, cfg, Wi, Hi) in paths.items():
            row = {"ms_per_iter": it_ms[path],
                   **profiled(plan, cfg, Wi, Hi, out / f"{cell}_{path}.json",
                              iters)}
            summary[cell][path] = row
            say("profile", cell=cell, path=path,
                ms_per_iter=f"{it_ms[path]:.4f}",
                device_ms_per_iter={k: round(v, 4) for k, v in
                                    row["device_ms_per_iter"].items()},
                idle_share=f"{row['idle_share']:.4f}", card=card)

    fro, kl = Objective.FROBENIUS, Objective.KL
    if "sparse" in cells:
        ell = nt.prepare_sparse(ratings, config(fro), strategy="ell",
                                device=dev)
        dense = nt.prepare_sparse(ratings, config(fro), strategy="densified",
                                  device=dev)
        pair, Vd = ell.operand, dense.operand
        Wp = torch.nn.functional.pad(W, (0, 0, 0, Vd.shape[0] - n))
        paths = {
            "ell_kernel_frobenius": (
                ell, config(fro, use_pallas=True),
                lambda: SEK.mu_update_frobenius_ell_pallas(pair, W, H, eps)),
            "ell_plain_frobenius": (
                ell, config(fro),
                lambda: SE.mu_update_frobenius_ell(pair, W, H, eps)),
            "ell_kl": (ell, config(kl),
                       lambda: SE.mu_update_kl_ell(pair, W, H, eps)),
            "densified_frobenius": (
                dense, config(fro),
                lambda: D.mu_update_frobenius_bf16v(Vd, Wp, H, eps)),
            "densified_kl": (dense, config(kl),
                             lambda: DF.mu_update_kl_densified(Vd, Wp, H,
                                                               eps)),
        }
        it_ms = abba_ms({k: v[2] for k, v in paths.items()}, 3)
        svsq_e, svsq_d = SE.sum_v_sq_ell(pair.rows), DF.sum_v_sq_densified(Vd)
        checks = abba_ms({
            "ell_frobenius_kernel": lambda: SE.frobenius_error_ell(
                pair, W, H, svsq_e, wt_v=SEK.wt_v_ell_pallas),
            "ell_frobenius_plain": lambda: SE.frobenius_error_ell(
                pair, W, H, svsq_e),
            "ell_kl": lambda: SE.kl_error_ell(pair, W, H),
            "densified_frobenius": lambda: DF.frobenius_error_densified(
                Vd, Wp, H, svsq_d),
            "densified_kl": lambda: DF.kl_error_densified(Vd, Wp, H),
        }, 3)
        say("check", cell="sparse_ml20m_r64",
            error_check_ms={k: round(v, 4) for k, v in checks.items()},
            card=card)
        summary["sparse_ml20m_r64"] = {"error_check_ms": checks}
        report("sparse_ml20m_r64",
               {k: (p, c, W, H) for k, (p, c, _) in paths.items()},
               PROFILE_ITERS, it_ms)
        del ell, dense, pair, Vd, Wp, paths
        torch.cuda.empty_cache()
    if "beta" in cells:
        iters = BETA_PROFILE_ITERS
        for beta in C2_BETAS:
            for label, strategy, knobs in (
                    ("densified_bf16", "densified", {}),
                    ("densified_int8", "densified", {"v_storage": "int8"}),
                    ("ell", "ell", {}), ("scatter", "scatter", {})):
                cfg = config(Objective.BETA, iters, iters, beta=beta,
                             **knobs)
                plan = nt.prepare_sparse(ratings, cfg, strategy=strategy,
                                         device=dev)
                op, update = plan.operand, plan._bundle(cfg).update
                Wp = torch.nn.functional.pad(W, (0, 0, 0, plan.n_pad - n))
                path = f"{label}_beta{beta}"
                it_ms = abba_ms({path: lambda: update(op, (), Wp, H)}, 1)
                report("beta_ml20m_r64", {path: (plan, cfg, W, H)}, iters,
                       it_ms)
                del plan, op, update, Wp
                torch.cuda.empty_cache()
    if "slice8" not in cells:
        return

    # -- slice 8 at config 2's shape: int8 densified, masked completion ------
    iters = S8_PROFILE_ITERS
    q = nt.prepare_sparse(ratings, config(fro, v_storage="int8"),
                          strategy="densified", device=dev)
    Vq, vscale = q.operand
    Wp = torch.nn.functional.pad(W, (0, 0, 0, Vq.shape[0] - n))
    paths = {"int8_densified_frobenius": (
                 q, config(fro, iters, iters, v_storage="int8"),
                 lambda: D.mu_update_frobenius_int8x8(Vq, vscale, Wp, H)),
             "int8_densified_kl": (
                 q, config(kl, iters, iters, v_storage="int8"),
                 lambda: DF.mu_update_kl_densified(Vq, Wp, H,
                                                   scale=vscale))}
    it_ms = abba_ms({k: v[2] for k, v in paths.items()}, 2)
    report("slice8_ml20m_r64",
           {k: (p, c, W, H) for k, (p, c, _) in paths.items()}, iters, it_ms)
    del q, Vq, vscale, Wp, paths
    torch.cuda.empty_cache()
    for strategy in ("ell", "scatter"):
        plan = nt.prepare_sparse(ratings, config(fro, mask="observed"),
                                 strategy=strategy, device=dev)
        op = plan.operand
        fns = ({fro: SE.mu_update_frobenius_masked_ell,
                kl: SE.mu_update_kl_masked_ell} if strategy == "ell" else
               {fro: TS.mu_update_frobenius_masked,
                kl: TS.mu_update_kl_masked})
        paths = {f"masked_{strategy}_{o.name.lower()}": (
                     plan, config(o, iters, iters, mask="observed"),
                     lambda f=fns[o]: f(op, W, H))
                 for o in (fro, kl)}
        it_ms = abba_ms({k: v[2] for k, v in paths.items()}, 2)
        report("slice8_ml20m_r64",
               {k: (p, c, W, H) for k, (p, c, _) in paths.items()}, iters,
               it_ms)
        del plan, op, paths
        torch.cuda.empty_cache()
    del ratings, W, H

    # -- config 3 at full size on its four engines ---------------------------
    from nmftpu_torch.data.synthetic import synthetic_powerlaw_sparse

    sp3 = synthetic_powerlaw_sparse(rank=16, **CONFIG3)
    sp3.data[:] = 1.0
    csr = sp3.to_csr()
    del sp3
    n, m = csr.shape
    r3 = C3_RANK
    g3 = torch.Generator(device=dev).manual_seed(SEED + 16)
    s3 = (csr.nnz / (n * m) / r3) ** 0.5
    W3 = (torch.rand(n, r3, generator=g3, device=dev) + 1e-4) * s3
    H3 = (torch.rand(r3, m, generator=g3, device=dev) + 1e-4) * s3
    summary["config3"] = {"nnz": csr.nnz}
    for label, strategy, knobs in (("densified_bf16", "densified", {}),
                                   ("densified_int8", "densified",
                                    {"v_storage": "int8"}),
                                   ("ell", "ell", {}),
                                   ("scatter", "scatter", {})):
        cfg = config(fro, C3_PROFILE_ITERS, C3_PROFILE_ITERS, rank=r3,
                     alpha_confidence=C3_ALPHA, **knobs)
        plan = nt.prepare_sparse(csr, cfg, strategy=strategy, device=dev)
        op, update = plan.operand, plan._bundle(cfg).update
        Wp = torch.nn.functional.pad(W3, (0, 0, 0, plan.n_pad - n))
        it_ms = abba_ms({label: lambda: update(op, (), Wp, H3)}, 1)
        report("config3", {label: (plan, cfg, W3, H3)}, C3_PROFILE_ITERS,
               it_ms)
        del plan, op, update, Wp
        torch.cuda.empty_cache()


def sparse_algorithms_cell(nt, dev, card, out, summary) -> None:
    """ALS on config 2's ELL, scatter and densified bf16 engines and HALS
    on scatter; iALS at config 3's full size on ELL."""
    import os

    from nmftpu_torch.config import Initialization, NmfConfig
    from nmftpu_torch.data.synthetic import synthetic_powerlaw_sparse

    cell = "sparse_algorithms"
    summary[cell] = {}

    def report(path, plan, cfg, W, H, iters, ms):
        row = {"ms_per_iter": ms,
               **profiled(plan, cfg, W, H, out / f"{cell}_{path}.json",
                          iters)}
        summary[cell][path] = row
        say("profile", cell=cell, path=path, ms_per_iter=f"{ms:.4f}",
            device_ms_per_iter={k: round(v, 4) for k, v in
                                row["device_ms_per_iter"].items()},
            idle_share=f"{row['idle_share']:.4f}", card=card)

    n, m, r = 138_493, 26_744, 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    R = synthetic_ratings(n, m, 20_000_263, gen, dev)
    ratings = ratings_csr(R)
    del R
    torch.cuda.empty_cache()
    scale = (float(ratings.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    W = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale
    iters = S12_PROFILE_ITERS
    for path, alg, strategy in (("als_ell", "als", "ell"),
                                ("als_scatter", "als", "scatter"),
                                ("als_densified_bf16", "als", "auto"),
                                ("hals_scatter", "hals", "auto")):
        cfg = NmfConfig(rank=r, algorithm=alg,
                        init_method=Initialization.COPY_EXISTING,
                        num_iterations=iters, check_interval=iters)
        plan = nt.prepare_sparse(ratings, cfg, strategy=strategy, device=dev)
        op, update = plan.operand, plan._bundle(cfg).update
        Wp = torch.nn.functional.pad(W, (0, 0, 0, plan.n_pad - n))
        ms = abba_ms({path: lambda: update(op, (), Wp, H)}, 1)[path]
        report(path, plan, cfg, W, H, iters, ms)
        del plan, op, update, Wp
        torch.cuda.empty_cache()
    del ratings, W, H

    sp3 = synthetic_powerlaw_sparse(rank=16, **CONFIG3)
    sp3.data[:] = 1.0
    csr = sp3.to_csr()
    del sp3
    n, m = csr.shape
    r3 = C3_RANK
    g3 = torch.Generator(device=dev).manual_seed(SEED + 16)
    s3 = (csr.nnz / (n * m) / r3) ** 0.5
    W3 = (torch.rand(n, r3, generator=g3, device=dev) + 1e-4) * s3
    H3 = (torch.rand(r3, m, generator=g3, device=dev) + 1e-4) * s3
    os.environ["NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES"] = str(16 * 2**30)
    cfg = NmfConfig(rank=r3, algorithm="als", alpha_confidence=C3_ALPHA,
                    init_method=Initialization.COPY_EXISTING,
                    num_iterations=IALS_PROFILE_ITERS,
                    check_interval=IALS_PROFILE_ITERS)
    plan = nt.prepare_sparse(csr, cfg, strategy="auto", device=dev)
    if plan.strategy != "ell":
        fail(f"config 3 iALS: auto resolved to {plan.strategy!r}")
    update = plan._bundle(cfg).update
    ms = event_ms(lambda: update(plan.operand, (), W3, H3), 1)
    report("ials_config3_ell", plan, cfg, W3, H3, IALS_PROFILE_ITERS, ms)
    os.environ.pop("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES")
    del plan, update, W3, H3
    torch.cuda.empty_cache()


def surfaces_cell(nt, dev, card, out, summary) -> None:
    """Slice 5's surfaces (chip_smoke.py's phase 23 (a)-(d)): the sklearn
    facade's HALS fit at config 2 (set-up included), MiniBatchNMF's host
    loop over its first panels (KL, the host's densify of each panel
    included), compute_batched on four routes and vectorized restarts at
    4096^2 / r = 256."""
    import scipy.sparse as sps

    from nmftpu_torch import minibatch as MB
    from nmftpu_torch import sklearn_api as SK
    from nmftpu_torch.batched import compute_batched
    from nmftpu_torch.config import Initialization, NmfConfig

    from chip_smoke import BATCH, BATCH_SHAPE, MB_BATCH, VEC_RUNS, \
        config2_start

    cell = "surfaces"
    summary[cell] = {}

    def report(path, fn, iters, unit="iteration"):
        fn()                                    # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        trace = out / f"{cell}_{path}.json"
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        row = {f"host_ms_per_{unit}": host_ms,
               **device_summary(trace, iters)}
        summary[cell][path] = row
        say("profile", cell=cell, path=path,
            **{f"host_ms_per_{unit}": f"{host_ms:.4f}"},
            device_ms_per=unit,
            device_ms={k: round(v, 4) for k, v in
                       row["device_ms_per_iter"].items()},
            idle_share=f"{row['idle_share']:.4f}", card=card)

    n, m, r = 138_493, 26_744, 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    R = synthetic_ratings(n, m, 20_000_263, gen, dev)
    ratings = ratings_csr(R)
    del R
    torch.cuda.empty_cache()
    X = sps.csr_matrix((ratings.data, ratings.indices, ratings.indptr),
                       shape=(n, m))
    W0, H0 = config2_start(n, m, r,
                           float(ratings.data.sum(dtype=np.float64)), dev)
    W0n, H0n = W0.cpu().numpy(), H0.cpu().numpy()
    del ratings, W0, H0
    its = SURFACE_PROFILE_ITERS
    est = SK.NMF(r, init="custom", solver="cd", max_iter=its, tol=0.0,
                 device=dev)
    report("nmf_cd_fit_config2",
           lambda: est.fit_transform(X, W=W0n, H=H0n), its)
    panels = MB_PROFILE_PANELS
    Xp = SK._RowSource(X[:panels * MB_BATCH])
    report("minibatch_kl_host_panels",
           lambda: MB.minibatch_fit(Xp, r, batch_size=MB_BATCH, max_iter=1,
                                    beta=1.0, tol=0.0,
                                    max_no_improvement=None,
                                    W0=W0n[:panels * MB_BATCH], H0=H0n,
                                    device=dev), panels, unit="panel")
    del X, Xp, est
    torch.cuda.empty_cache()

    nb, rb = BATCH_SHAPE
    Vs, W0s, H0s = [], [], []
    for i in range(BATCH):
        g = torch.Generator(device=dev).manual_seed(SEED + i)
        Vs.append(synthetic_lowrank(nb, nb, rb, g, dev))
        W0s.append(torch.rand(nb, rb, generator=g, device=dev) + 0.01)
        H0s.append(torch.rand(rb, nb, generator=g, device=dev) + 0.01)
    Vs, W0s, H0s = torch.stack(Vs), torch.stack(W0s), torch.stack(H0s)
    its = BATCHED_PROFILE_ITERS
    for path, knobs in (("batched_plain", {}),
                        ("batched_kernels_f32", {"use_pallas": True}),
                        ("batched_int8", {"v_storage": "int8",
                                          "use_pallas": True}),
                        ("batched_hals", {"algorithm": "hals"})):
        cfg = NmfConfig(rank=rb, init_method=Initialization.COPY_EXISTING,
                        num_iterations=its, check_interval=its, **knobs)
        report(path, lambda: compute_batched(Vs, cfg, W0=W0s, H0=H0s), its)
    V0 = Vs[0]
    del Vs, W0s, H0s
    for path, knobs in (("vectorized_kernels_f32", {"use_pallas": True}),
                        ("vectorized_hals", {"algorithm": "hals"})):
        report(path, lambda: nt.nmf(V0, rb, num_runs=VEC_RUNS,
                                    vectorize_runs=True, num_iterations=its,
                                    check_interval=its, seed=SEED,
                                    device=dev, **knobs), its)
    del V0
    torch.cuda.empty_cache()


def sharded_rank(out: str, card: str) -> dict:
    """The "sharded" cell, in a one-rank NCCL world of the launcher: one
    sharded MU-Frobenius iteration at config 4's one-device share on each
    tile engine, profiled."""
    from nmftpu_torch.config import Initialization, NmfConfig
    from nmftpu_torch.data.synthetic import synthetic_powerlaw_sparse
    from nmftpu_torch.parallel import make_grid_mesh, prepare_sharded
    from nmftpu_torch.parallel.driver import _sharded_ops

    from chip_smoke import C4_DRAWS, C4_RANK, C4_SEED, C4_SHAPE

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = make_grid_mesh((1, 1))
    n, m = C4_SHAPE
    r = C4_RANK
    t0 = time.perf_counter()
    sp = synthetic_powerlaw_sparse(n, m, C4_DRAWS, seed=C4_SEED)
    gen_s = time.perf_counter() - t0
    cfg = NmfConfig(rank=r, init_method=Initialization.COPY_EXISTING,
                    num_iterations=1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    scale = (float(sp.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    summary = {"nnz": int(sp.nnz), "generator_s": gen_s}
    for engine in ("ell", "scatter"):
        plan = prepare_sharded(sp, cfg, mesh=mesh, balance=False,
                               chunk=1 << 17, engine=engine)
        ops = _sharded_ops(cfg, mesh, plan.engine, n, m, plan.nnz)
        W = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
        H = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale
        W, H = ops.update(plan.operand, (), W, H)     # warm-up
        ms = cuda_ms(lambda: ops.update(plan.operand, (), W, H), 1)
        trace = Path(out) / f"sharded_config4_{engine}.json"
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            ops.update(plan.operand, (), W, H)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        row = {"ms_per_iter": ms, **device_summary(trace, 1)}
        summary[engine] = row
        say("profile", cell="sharded_config4_1x1", path=engine,
            nnz=sp.nnz, ms_per_iter=f"{ms:.1f}",
            device_ms_per_iter={k: round(v, 2) for k, v in
                                row["device_ms_per_iter"].items()},
            idle_share=f"{row['idle_share']:.4f}", card=card)
        del plan, ops, W, H
        torch.cuda.empty_cache()
    return summary


def mesh_cells_rank(path: str, out: str, card: str, cells) -> dict:
    """The "ring" and "dense_mesh" cells on one rank of four sharing the
    card (gloo): one MU-Frobenius iteration of each, profiled after a
    warm-up one."""
    import torch.distributed as dist

    from nmftpu_torch.config import Initialization, NmfConfig
    from nmftpu_torch.parallel import make_grid_mesh, prepare_sharded
    from nmftpu_torch.parallel.dense_mesh import (
        DenseTile, _tile_of, block_shape, dense_mesh_ops)
    from nmftpu_torch.parallel.driver import _sharded_ops
    from nmftpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS

    from chip_smoke import CSRTiles, config2_start, load_ratings

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rank = dist.get_rank()
    ratings = load_ratings(path)
    n, m = ratings.shape
    r = ML20M[2]
    cfg = NmfConfig(rank=r, init_method=Initialization.COPY_EXISTING,
                    num_iterations=1)
    W0, H0 = config2_start(n, m, r, float(ratings.data.sum(
        dtype=np.float64)), dev)
    summary = {"rank": rank}

    def profile(cell, step):
        step()      # warm-up
        ms = cuda_ms(step, 1)
        trace = Path(out) / f"{cell}_rank{rank}.json"
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        row = {"ms_per_iter": ms, **device_summary(trace, 1)}
        say("profile", cell=cell, rank=rank, ms_per_iter=f"{ms:.1f}",
            device_ms_per_iter={k: round(v, 2) for k, v in
                                row["device_ms_per_iter"].items()},
            idle_share=f"{row['idle_share']:.4f}", card=card,
            note="four ranks time-share the card")
        summary[cell] = row

    if "ring" in cells:
        mesh = make_grid_mesh((1, 4))
        plan = prepare_sharded(ratings, cfg, mesh=mesh, engine="ring",
                               chunk=1 << 17)
        ops = _sharded_ops(cfg, plan.mesh, "ring", n, m, plan.nnz)
        W, H = plan._init_fn(cfg, W0, H0)(0)
        profile("ring", lambda: ops.update(plan.operand, (), W, H))
        del plan, ops, W, H
        torch.cuda.empty_cache()
    if "dense_mesh" in cells:
        mesh = make_grid_mesh((2, 2))
        br, bc = block_shape((n, m), (2, 2))
        i, j = (mesh.get_local_rank(AXIS_USERS),
                mesh.get_local_rank(AXIS_ITEMS))
        tile = DenseTile(V=_tile_of(CSRTiles(ratings, dev),
                                    slice(i * br, (i + 1) * br),
                                    slice(j * bc, (j + 1) * bc), (br, bc),
                                    torch.float32, dev),
                         shape=(n, m), coords=(i, j))
        ops = dense_mesh_ops(cfg, mesh)
        aux = ops.make_aux(tile)
        # the blocks zero-padded to the tile, as compute_dense_mesh pads them
        W = torch.zeros((br, r), device=dev)
        H = torch.zeros((r, bc), device=dev)
        Wb, Hb = W0[i * br:(i + 1) * br], H0[:, j * bc:(j + 1) * bc]
        W[:Wb.shape[0]], H[:, :Hb.shape[1]] = Wb, Hb
        profile("dense_mesh", lambda: ops.update(tile, aux, W, H))
    return summary


if __name__ == "__main__":
    main()
