"""Where one MU iteration of the PyTorch/CUDA port (nmftpu_torch) spends
its time on one NVIDIA GPU.

    python3 chip_profile.py [--out DIR]

Two shapes -- 4096 x 4096 at rank 256 (bench.py's headline) and the
ML-20M shape 138,493 x 26,744 at rank 64, with chip_smoke.py's synthetic
data -- and three update paths: plain float32 torch.matmul ("plain_f32"),
the float32 kernels ("kernel_f32") and the int8 kernels ("kernel_int8").
For each it prints one line with

- ms per MU iteration, per W half-step and per H half-step (each with
  its Gram), by CUDA events in A B C C B A order, TF32 off;
- from torch.profiler over a 20-iteration ``nmftpu_torch.nmf`` run with a
  check every 10: device ms per iteration by kernel class (the port's
  kernels, cuBLAS/CUTLASS GEMMs, everything else) and the device's idle
  share over the span from its first to its last kernel. The profiler
  widens the host's launch gaps, so the idle share is an upper bound.

and per shape one line with the ms of one error check. Every line ends
with the card's nvidia-smi name and power limit. The profiler traces and
summary.json go to --out (default: profile_out/ beside this script).
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from chip_smoke import (
    HERE,
    SEED,
    abba_ms,
    cuda_ms,
    fail,
    nvidia_smi_line,
    say,
    synthetic_lowrank,
    synthetic_ratings,
)

PROFILE_ITERS = 20
CHECK_INTERVAL = 10


def kernel_class(name: str) -> str:
    if "update_kernel" in name:
        return "port_kernels"
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "cublas")):
        return "gemm"
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
            row = {"ms_per_iter": it_ms[path], "w_half_ms": w_ms[path],
                   "h_half_ms": h_ms[path],
                   **device_summary(trace, PROFILE_ITERS)}
            summary[cell][path] = row
            say("profile", cell=cell, path=path,
                ms_per_iter=f"{it_ms[path]:.4f}",
                w_half_ms=f"{w_ms[path]:.4f}", h_half_ms=f"{h_ms[path]:.4f}",
                device_ms_per_iter={k: round(v, 4) for k, v in
                                    row["device_ms_per_iter"].items()},
                idle_share=f"{row['idle_share']:.4f}", card=card)
        del V, Vq, scale, W, H, halves, iteration, svsq
        torch.cuda.empty_cache()

    if "jax" in sys.modules:
        fail("jax was imported")
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
