"""Where one MU iteration and one serving batch of the PyTorch/CUDA port
(nmftpu_torch) spend their time on one NVIDIA GPU.

    python3 chip_profile.py [--out DIR]

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
Every line ends with the card's nvidia-smi name and power limit. The profiler traces and
summary.json go to --out (default: profile_out/ beside this script).
Exits 1 without a CUDA device.
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
    HERE,
    SEED,
    abba_ms,
    cuda_ms,
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
    args = p.parse_args()
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
    for cell, (n, m, r) in (("4096^2_r256", (4096, 4096, 256)),
                            ("ml20m_shape_r64", (138_493, 26_744, 64))):
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

    # -- serving: config 5 at full width, int8 table -------------------------
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

    # -- sparse: config 2 at full width (ELL with and without the kernel,
    #    densified bf16), Frobenius and KL --------------------------------
    from nmftpu_torch import densified as DF
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch.config import Initialization, NmfConfig, Objective
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK

    n, m, r = 138_493, 26_744, 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    R = synthetic_ratings(n, m, 20_000_263, gen, dev)
    ratings = ratings_csr(R)
    del R
    torch.cuda.empty_cache()
    scale = (float(ratings.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    W = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale

    def config(objective, **knobs):
        return NmfConfig(rank=r, objective=objective,
                         init_method=Initialization.COPY_EXISTING,
                         num_iterations=PROFILE_ITERS,
                         check_interval=CHECK_INTERVAL, **knobs)

    fro, kl = Objective.FROBENIUS, Objective.KL
    ell = nt.prepare_sparse(ratings, config(fro), strategy="ell", device=dev)
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
                         lambda: DF.mu_update_kl_densified(Vd, Wp, H, eps)),
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
    for path, (plan, cfg, _) in paths.items():
        plan.run(cfg, W0=W, H0=H)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            plan.run(cfg, W0=W, H0=H)
            torch.cuda.synchronize()
        trace = out / f"sparse_ml20m_r64_{path}.json"
        prof.export_chrome_trace(str(trace))
        row = {"ms_per_iter": it_ms[path],
               **device_summary(trace, PROFILE_ITERS)}
        summary["sparse_ml20m_r64"][path] = row
        say("profile", cell="sparse_ml20m_r64", path=path,
            ms_per_iter=f"{it_ms[path]:.4f}",
            device_ms_per_iter={k: round(v, 4) for k, v in
                                row["device_ms_per_iter"].items()},
            idle_share=f"{row['idle_share']:.4f}", card=card)

    if "jax" in sys.modules:
        fail("jax was imported")
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
