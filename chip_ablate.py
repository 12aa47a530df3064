"""Ablation of the hand-written kernels on one NVIDIA GPU: where the time
of the reservoir scan (#8), the count-above scan (#9), the int8
numerators (#6), the split-tf32 MU half-steps (#1-#4) and the HALS sweep
(#7) goes, and what splitting the scan's tile walk buys at small batches.

    python3 chip_ablate.py [--out DIR] [--kernels all|scan|mu]

Builds variants of nmftpu_torch/csrc/{mips_reservoir,count_above,
dual_numer}.cu with one part removed each (a text patch of the source,
listed in VARIANTS: the carry fold or the count's compare, the table
conversion, the products, a class of loads or atomics; one with the
scan's k-loop unrolled at compile time for r = 256, and the count with
3 or 4 warpgroups walking the tiles), each compiled by `_build.build`
from a directory of patched copies, all variants at once.
A variant whose patch no longer matches its source is reported and
skipped. Then it times each variant's C entry with CUDA events on random
data at the main paths' shapes: the reservoir scan and the count at
BASELINE config 5 (int8 table, 10,485,760 items, r = 256, b = 512, 4096
slots; the count with a threshold no score reaches) and the dual, vht
and wtv entries at 4096^2 / r = 256 and at the ML-20M shape (138,493 x
26,744, r = 64, 0.54% nonzero). A variant computes wrong results by
design: only its time is read. The time a part costs is the base time
minus the time without it; parts that overlap each other do not add up.

Last, on the unpatched kernel and config 5's table, it times the scan at
b = 64 and 256 with the walk in one range and split into 2 and 3 ranges
(the split's merge kernel included): the grid there is 64 and 128 blocks
of 128 queries x 64 slots for the card's 132 SMs.

With --kernels mu (or all) it builds variants of dense_mu.cu and
hals_sweep.cu (without the lo products, without the per-stage promotion,
without the hi/lo conversion, the products or the raw loads, or with a
5-stage ring; the sweep without the panel prefetch, the chain or the
base) and times the four MU entries at 4096^2 / r = 256 (float32 and
int8 V) and the sweep at 4096 x 256, 2048 x 512 and 138,493 x 64.
--kernels scan skips them.

Prints one line per (entry, shape, variant) and the card's name and power
limit; writes DIR/ablation.json (DIR defaults to profile_out/). Without a
CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from chip_smoke import fail, nvidia_smi_line  # noqa: E402
from nmftpu_torch.kernels import _build  # noqa: E402

SCAN_SOURCES = ("mips_reservoir.cu", "dual_numer.cu", "count_above.cu",
                "hopper_tc.cuh", "mips_tile.cuh", "tc_scan.cuh")
MU_SOURCES = ("dense_mu.cu", "hals_sweep.cu", "hopper_tc.cuh")
NEVER = "false && "

# variant -> [(source, text, replacement)]
VARIANTS = {
    "base": [],
    "no_fold": [("mips_reservoir.cu",
                 "      tc_fold<false>(cur, s1, s2, ix, nc, "
                 "static_cast<uint32_t>(t));", "      ;")],
    "no_convert": [("mips_reservoir.cu",
                    "    tc_convert<T>(raw + (u % NR) * raw_bytes, tile, "
                    "min(kc, r - c * kc), kd,\n                  kc, "
                    "threadIdx.x, TC_THREADS);", "")],
    "no_mma": [("mips_reservoir.cu", "for (int s = 0; s < kd / 16; ++s)",
                "for (int s = 0; s < 0; ++s)")],
    "no_table_loads": [("mips_reservoir.cu",
                        "    if (u + NR - 1 < steps) load_raw(u + NR - 1);",
                        "")],
    # not a removal: the k-loop over r = 256 with a compile-time trip
    # count, which ptxas can follow (its notes change from C7514 to C7515)
    "static_k_loop": [("mips_reservoir.cu",
                       "    for (int s = 0; s < kd / 16; ++s)\n",
                       "#pragma unroll\n    for (int s = 0; s < 16; ++s)\n")],
    "count_no_epilogue": [("count_above.cu",
                           "  // most tiles hold no score near",
                           "  return false;\n  // most tiles hold no score "
                           "near")],
    "count_no_convert": [("count_above.cu",
                          "      tc_convert<T>(raw + (u % NR) * raw_bytes, "
                          "op, min(kc, r - c * kc), kd,\n"
                          "                    kc, tid, 128);", "")],
    "count_no_mma": [("count_above.cu",
                      "      for (int s = 0; s < kd / 16; ++s) {",
                      "      for (int s = 0; s < 0; ++s) {")],
    "count_no_table_loads": [("count_above.cu",
                              "      if (u + NR - 1 < steps) "
                              "load_raw(u + NR - 1);", "")],
    # not removals: three and four warpgroups walking the tiles (ranks up
    # to 512 fit their shared memory)
    **{f"count_{w}_warpgroups": [
        ("count_above.cu", "constexpr int CT_WGS = 2;",
         f"constexpr int CT_WGS = {w};"),
        ("count_above.cu", "constexpr int CT_MAX_RANK = 832;",
         "constexpr int CT_MAX_RANK = 512;")] for w in (3, 4)},
    "no_chunk_loads": [("dual_numer.cu",
                        "    if (c + PF < nchunks) load_chunk(c + PF);", "")],
    "no_transpose": [("dual_numer.cu", "      transpose_chunk(v, vt);", "")],
    "no_nw_mma": [("dual_numer.cu", "for (int s = 0; s < BK / 32; ++s)",
                   "for (int s = 0; s < 0; ++s)")],
    "no_nh_mma": [("dual_numer.cu", "for (int s = 0; s < RB / 32; ++s)",
                   "for (int s = 0; s < 0; ++s)")],
    "no_nh_atomics": [("dual_numer.cu",
                       "        if (f < r && col < m && acch[i] != 0)",
                       "        if (" + NEVER + "acch[i] != 0)")],
    "no_nw_atomics": [("dual_numer.cu",
                       "      if (f < r && row < n && accw[i] != 0)",
                       "      if (" + NEVER + "accw[i] != 0)")],
    # #1-#4 and #7, built from MU_SOURCES
    "mu_base": [],
    "mu_no_lo": [("dense_mu.cu",
                  "      if constexpr (SPLIT_A) mma<WN>(part, dal + step, "
                  "dbh + step, kk > 0);\n"
                  "      mma<WN>(part, dah + step, dbl + step, SPLIT_A || "
                  "kk > 0);\n", ""),
                 ("dense_mu.cu",
                  "mma<WN>(part, dah + step, dbh + step, 1);",
                  "mma<WN>(part, dah + step, dbh + step, kk > 0);")],
    "mu_no_promote": [("dense_mu.cu",
                       "    wgmma_wait<0>();\n    fence_regs(part);\n"
                       "#pragma unroll\n"
                       "    for (int i = 0; i < WN / 2; ++i) acc[i] += "
                       "part[i];\n", "    wgmma_wait<1>();\n")],
    "mu_no_convert": [("dense_mu.cu", "      convert(t + 1);\n", "")],
    "mu_no_mma": [("dense_mu.cu", "for (int kk = 0; kk < BK / 8; ++kk)",
                   "for (int kk = 0; kk < 0; ++kk)")],
    "mu_no_loads": [("dense_mu.cu",
                     "    if (t + NSTAGE - 1 < tiles) load(t + NSTAGE - 1);",
                     "")],
    "hals_no_prefetch": [("hals_sweep.cu", "      cp_async_wait<1>();",
                          "      cp_async_wait<0>();")],
    # not a removal: a deeper ring of copies
    "mu_ring5": [("dense_mu.cu", "constexpr int NSTAGE = 3;",
                  "constexpr int NSTAGE = 5;")],
    # diagnostics: the copies of stage t + NSTAGE - 1 issued after the
    # products of stage t; the factor tile loaded and split only for the
    # first stages (wrong results); no wait for the copies (wrong
    # results); the products of one warpgroup only (wrong results)
    "mu_loads_late": [("dense_mu.cu",
                       "    if (t + NSTAGE - 1 < tiles) load(t + NSTAGE - 1);"
                       "\n    cp_async_commit();\n", ""),
                      ("dense_mu.cu", "    wgmma_commit();\n",
                       "    wgmma_commit();\n"
                       "    if (t + NSTAGE - 1 < tiles) load(t + NSTAGE - 1);"
                       "\n    cp_async_commit();\n")],
    "mu_b_once": [("dense_mu.cu", "    load_raw<C::NB, NT, B_KC>(raw_b",
                   "    if (t < NSTAGE) load_raw<C::NB, NT, B_KC>(raw_b"),
                  ("dense_mu.cu", "    convert_raw<C::NB, NT, B_KC, float>(raw_b",
                   "    if (t < 2) convert_raw<C::NB, NT, B_KC, float>(raw_b")],
    "mu_no_copy_wait": [("dense_mu.cu", "      cp_async_wait<NSTAGE - 2>();\n",
                         "")],
    "mu_one_wg_mma": [("dense_mu.cu", "for (int kk = 0; kk < BK / 8; ++kk)",
                       "for (int kk = 0; kk < (wg ? 0 : BK / 8); ++kk)")],
    # the sweep with 16 or 8 rows a block at 4096 x 256 (2 or 3 blocks an
    # SM), and with the division in the chain
    "hals_tr16": [("hals_sweep.cu", "(n + tr - 1) / tr >= 128;",
                   "(n + tr - 1) / tr >= 256;")],
    "hals_tr8": [("hals_sweep.cu", "(n + tr - 1) / tr >= 128;",
                  "(n + tr - 1) / tr >= 512;")],
    "hals_div": [("hals_sweep.cu",
                  "? fmaxf(fmaf(-grad, rh[j], old[q][j]), 0.f)",
                  "? fmaxf(old[q][j] - grad / d[j * MAXB + j], 0.f)")],
    "hals_no_chain": [("hals_sweep.cu", "      if (j < b) {\n",
                       "      if (" + NEVER + "j < b) {\n")],
    "hals_no_base": [("hals_sweep.cu",
                      "for (int q = ks; q < quads; q += KS) {",
                      "for (int q = ks; q < 0; q += KS) {")],
}
RESERVOIR = ("base", "no_fold", "no_convert", "no_mma", "no_table_loads",
             "static_k_loop")
COUNT = ("base", "count_no_epilogue", "count_no_convert", "count_no_mma",
         "count_no_table_loads", "count_3_warpgroups", "count_4_warpgroups")
INT8 = ("base", "no_chunk_loads", "no_transpose", "no_nw_mma", "no_nh_mma",
        "no_nh_atomics", "no_nw_atomics")
SCAN_ENTRIES = ("nmftpu_reservoir_scan_i8", "nmftpu_reservoir_merge",
                "nmftpu_count_above_i8",
                "nmftpu_int8_vht", "nmftpu_int8_wtv", "nmftpu_int8_dual")
MU = ("mu_base", "mu_no_lo", "mu_no_promote", "mu_no_convert", "mu_no_mma",
      "mu_no_loads", "mu_ring5", "mu_loads_late", "mu_b_once",
      "mu_no_copy_wait", "mu_one_wg_mma")
HALS = ("mu_base", "hals_no_prefetch", "hals_no_chain", "hals_no_base",
        "hals_tr16", "hals_tr8", "hals_div")
MU_ENTRIES = ("nmftpu_w_update_f32", "nmftpu_h_update_f32",
              "nmftpu_w_update_i8", "nmftpu_h_update_i8",
              "nmftpu_hals_sweep_f32")


def is_mu(variant: str) -> bool:
    return variant.startswith(("mu_", "hals_"))


def patched_copy(name: str, patches, out: Path) -> Path | None:
    """out/name holding the variant's sources (MU_SOURCES or
    SCAN_SOURCES) with `patches` applied; None (and a note) when a patch
    no longer matches its source."""
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for src in MU_SOURCES if is_mu(name) else SCAN_SOURCES:
        text = (_build.CSRC / src).read_text()
        for f, old, new in patches:
            if f == src:
                if old not in text:
                    print(f"[ablate] variant={name} skipped: {src} no "
                          f"longer holds {old!r}", flush=True)
                    return None
                text = text.replace(old, new)
        (d / src).write_text(text)
    return d


def build(out: Path, kernels: str) -> dict:
    """{variant: loaded library}, each built by `_build.build`, for the
    variants of `kernels` (all, scan or mu)."""
    dirs = {name: patched_copy(name, patches, out)
            for name, patches in VARIANTS.items()
            if kernels == "all" or is_mu(name) == (kernels == "mu")}
    dirs = {name: d for name, d in dirs.items() if d is not None}
    for base in {"all": ("base", "mu_base"), "scan": ("base",),
                 "mu": ("mu_base",)}[kernels]:
        if base not in dirs:
            fail("the unpatched sources did not copy")
    with ThreadPoolExecutor(len(dirs)) as pool:
        paths = dict(zip(dirs, pool.map(_build.build, dirs.values())))
    libs = {}
    for name, path in paths.items():
        cdll = ctypes.CDLL(str(path))
        for entry in MU_ENTRIES if is_mu(name) else SCAN_ENTRIES:
            getattr(cdll, entry).argtypes = _build.ENTRIES[entry]
        libs[name] = cdll
    return libs


def event_ms(fn, iters: int) -> float:
    if fn() != 0:
        fail("a variant's launch failed")
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def ratings_like(n, m, gen):
    """(n, m) int8 with 0.54% nonzero entries in 1..127 (ML-20M's fill)."""
    V = torch.zeros(n, m, dtype=torch.int8, device="cuda")
    for i in range(0, n, 8192):
        u = torch.rand(min(8192, n - i), m, generator=gen, device="cuda")
        V[i:i + 8192] = torch.where(u < 0.0054, (u * 2e4).clamp(1, 127),
                                    0).to(torch.int8)
    return V


def split_scan(lib, Wq, H, m, slots, splits, stream):
    """The scan with its walk cut into `splits` ranges, then the merge
    (a callable returning the first nonzero launch code)."""
    b, r = Wq.shape
    tiles = -(-m // slots)
    per = -(-tiles // splits)
    ps = torch.empty(splits, b, 2 * slots, device="cuda")
    pi = torch.empty(splits, b, 2 * slots, dtype=torch.int32, device="cuda")
    out_s = torch.empty(b, 2 * slots, device="cuda")
    out_i = torch.empty(b, 2 * slots, dtype=torch.int32, device="cuda")

    def run():
        rc = lib.nmftpu_reservoir_scan_i8(
            Wq.data_ptr(), H.data_ptr(), ps.data_ptr(), pi.data_ptr(), b, r,
            m, m, slots, per, -(-tiles // per), 16, stream)
        if rc or splits == 1:
            return rc
        return lib.nmftpu_reservoir_merge(
            ps.data_ptr(), pi.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            -(-tiles // per), b, slots, stream)
    return run


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(HERE / "profile_out"))
    p.add_argument("--kernels", choices=("all", "scan", "mu"), default="all")
    args = p.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    card = nvidia_smi_line()
    print(card, flush=True)
    libs = build(_build.BUILD_DIR / "ablate", args.kernels)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(20240611)
    rows = []

    def record(entry, shape, variant, ms):
        rows.append({"entry": entry, "shape": shape, "variant": variant,
                     "ms": ms, "card": card})
        print(f"[ablate] entry={entry}  shape={shape}  variant={variant}  "
              f"ms={ms:.4f}", flush=True)

    if args.kernels != "scan":
        mu_and_hals(libs, gen, stream, record)
    if args.kernels != "mu":
        scans(libs, gen, stream, record)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ablation.json").write_text(json.dumps(rows, indent=1))


def mu_and_hals(libs, gen, stream, record) -> None:
    """The MU entries at 4096^2 / r = 256 and the sweep at phase 14's
    shapes, per variant."""
    from nmftpu_torch.kernels.dense_mu import mu_splits

    n = m = 4096
    r = 256
    V = 5.0 * torch.rand(n, m, generator=gen, device="cuda")
    Vq = torch.randint(0, 128, (n, m), generator=gen, device="cuda",
                       dtype=torch.int8)
    scale = torch.full((1,), 5.0 / 127, device="cuda")
    W = torch.rand(n, r, generator=gen, device="cuda") + 0.05
    H = torch.rand(r, m, generator=gen, device="cuda") + 0.05
    Gw, Gh = H @ H.T, W.T @ W
    outs = {"w": torch.empty_like(W), "h": torch.empty_like(H)}
    plans = {step: mu_splits(n, m, r) for step in ("w", "h")}
    ws = torch.empty(max(plans.values()) * n * r, device="cuda")
    # the kernel leaves its arrival counters at zero
    counters = torch.zeros(n // 64, dtype=torch.int32, device="cuda")
    for name in MU:
        if name not in libs:
            continue
        for step, v_kind in (("w", "f32"), ("h", "f32"), ("w", "i8"),
                             ("h", "i8")):
            fn = getattr(libs[name], f"nmftpu_{step}_update_{v_kind}")
            Vx, sp = (V, None) if v_kind == "f32" else (Vq, scale)
            G = Gw if step == "w" else Gh
            record(f"{step}_update_{v_kind}", f"{n}x{m} r={r}", name,
                   event_ms(lambda: fn(
                       Vx.data_ptr(), None if sp is None else sp.data_ptr(),
                       W.data_ptr(), H.data_ptr(), G.data_ptr(),
                       outs[step].data_ptr(), ws.data_ptr(),
                       counters.data_ptr(), n, m, r, plans[step], 1e-9,
                       stream), iters=20))
    del V, Vq, W, H, Gw, Gh, outs, ws
    for hn, hr in ((4096, 256), (2048, 512), (138_493, 64)):
        X = torch.randn(hn, hr, generator=gen, device="cuda")
        A = torch.randn(hr, hr, generator=gen, device="cuda")
        G = A @ A.T + torch.eye(hr, device="cuda")
        W = torch.rand(hn, hr, generator=gen, device="cuda")
        out = torch.empty_like(W)
        for name in HALS:
            if name in libs:
                lib = libs[name]
                record("hals_sweep", f"{hn}x{hr}", name, event_ms(
                    lambda: lib.nmftpu_hals_sweep_f32(
                        X.data_ptr(), G.data_ptr(), W.data_ptr(),
                        out.data_ptr(), hn, hr, 16, stream), iters=10))


def scans(libs, gen, stream, record) -> None:
    """The reservoir scan, the count and the int8 numerators per
    variant, and the reservoir scan's split walk."""

    b, r, m, slots = 512, 256, 10_485_760, 4096
    Wq = torch.rand(b, r, generator=gen, device="cuda")
    H = torch.randint(-127, 128, (r, m), generator=gen, device="cuda",
                      dtype=torch.int8)
    for name in RESERVOIR:
        if name in libs:
            record("reservoir_scan_i8", f"b={b} r={r} m={m} R={slots}", name,
                   event_ms(split_scan(libs[name], Wq, H, m, slots, 1,
                                       stream), iters=3))
    # the count at config 5 with a threshold no score reaches: every pair
    # is compared, none counts, none goes through the band
    from nmftpu_torch.kernels.count_above import count_plan
    lim = torch.full((3 * b,), 1e30, device="cuda")
    counts = torch.zeros(b, dtype=torch.int32, device="cuda")
    nband = torch.zeros(1, dtype=torch.int64, device="cuda")
    pairs = torch.empty(2 * 8192, dtype=torch.int32, device="cuda")
    per = count_plan(b, m)[0]
    for name in COUNT:
        if name in libs:
            lib = libs[name]
            record("count_above_i8", f"b={b} r={r} m={m}", name, event_ms(
                lambda: lib.nmftpu_count_above_i8(
                    Wq.data_ptr(), H.data_ptr(), lim.data_ptr(),
                    counts.data_ptr(), pairs.data_ptr(),
                    nband.data_ptr(), 8192, b, r, m, m, per, 16,
                    stream), iters=3))
    del lim, counts, nband, pairs
    for nb in (64, 256):
        for splits in (1, 2, 3):
            record("reservoir_scan_i8", f"b={nb} r={r} m={m} R={slots}",
                   f"{splits}_range" + ("" if splits == 1 else "s_merged"),
                   event_ms(split_scan(libs["base"], Wq[:nb].contiguous(), H,
                                       m, slots, splits, stream), iters=5))
    del Wq, H

    for n, m, r in ((4096, 4096, 256), (138_493, 26_744, 64)):
        if n == m:
            V = torch.randint(-127, 128, (n, m), generator=gen,
                              device="cuda", dtype=torch.int8)
        else:
            V = ratings_like(n, m, gen)
        WqT = torch.randint(-127, 128, (r, n), generator=gen, device="cuda",
                            dtype=torch.int8)
        Hq = torch.randint(-127, 128, (r, m), generator=gen, device="cuda",
                           dtype=torch.int8)
        nw = torch.zeros(n, r, dtype=torch.int32, device="cuda")
        nh = torch.zeros(r, m, dtype=torch.int32, device="cuda")
        gv = _build.copy_alignment(m, V.data_ptr(), Hq.data_ptr())
        gw = _build.copy_alignment(n, WqT.data_ptr())
        iters = 20 if n == m else 3
        for name in INT8:
            if name not in libs:
                continue
            lib = libs[name]
            calls = {
                "dual": lambda: lib.nmftpu_int8_dual(
                    V.data_ptr(), WqT.data_ptr(), Hq.data_ptr(),
                    nw.data_ptr(), nh.data_ptr(), n, m, r, gv, gw, stream),
                "vht": lambda: lib.nmftpu_int8_vht(
                    V.data_ptr(), Hq.data_ptr(), nw.data_ptr(), n, m, r, gv,
                    gw, stream),
                "wtv": lambda: lib.nmftpu_int8_wtv(
                    V.data_ptr(), WqT.data_ptr(), nh.data_ptr(), n, m, r, gv,
                    gw, stream),
            }
            for entry, fn in calls.items():
                record(f"int8_{entry}", f"{n}x{m} r={r}", name,
                       event_ms(fn, iters))
        del V, WqT, Hq, nw, nh


if __name__ == "__main__":
    main()
