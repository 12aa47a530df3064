"""Ablation of the two tensor-core kernels on one NVIDIA GPU: where the
time of the reservoir scan (#8) and of the int8 numerators (#6) goes, and
what splitting the scan's tile walk buys at small batches.

    python3 chip_ablate.py [--out DIR]

Builds variants of nmftpu_torch/csrc/{mips_reservoir,dual_numer}.cu with
one part removed each (a text patch of the source, listed in VARIANTS:
the carry fold, the table conversion, the products, a class of loads or
atomics; and one with the scan's k-loop unrolled at compile time for
r = 256), through the package's builder (`_build.build` of a directory
of patched copies), all variants at once. A variant whose patch no longer
matches its source is reported and skipped. Then it times each variant's
C entry with CUDA events on random data at the main paths' shapes: the
reservoir scan at BASELINE config 5 (int8 table, 10,485,760 items,
r = 256, b = 512, 4096 slots) and the dual, vht and wtv entries at
4096^2 / r = 256 and at the ML-20M shape (138,493 x 26,744, r = 64,
0.54% nonzero). A variant computes wrong results by design: only its time
is read. The time a part costs is the base time minus the time without
it; parts that overlap each other do not add up.

Last, on the unpatched kernel and config 5's table, it times the scan at
b = 64 and 256 with the walk in one range and split into 2 and 3 ranges
(the split's merge kernel included): the grid there is 64 and 128 blocks
of 128 queries x 64 slots for the card's 132 SMs.

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

SOURCES = ("mips_reservoir.cu", "dual_numer.cu", "hopper_tc.cuh",
           "mips_tile.cuh")
NEVER = "false && "

# variant -> [(source, text, replacement)]
VARIANTS = {
    "base": [],
    "no_fold": [("mips_reservoir.cu",
                 "      tc_fold<false>(cur, s1, s2, ix, nc, "
                 "static_cast<uint32_t>(t));", "      ;")],
    "no_convert": [("mips_reservoir.cu",
                    "    tc_convert<T>(raw + (u % NR) * raw_bytes, tile, "
                    "min(kc, r - c * kc), kd,\n                  kc);", "")],
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
}
RESERVOIR = ("base", "no_fold", "no_convert", "no_mma", "no_table_loads",
             "static_k_loop")
INT8 = ("base", "no_chunk_loads", "no_transpose", "no_nw_mma", "no_nh_mma",
        "no_nh_atomics", "no_nw_atomics")
SCAN_ENTRIES = ("nmftpu_reservoir_scan_i8", "nmftpu_reservoir_merge",
                "nmftpu_int8_vht", "nmftpu_int8_wtv", "nmftpu_int8_dual")


def patched_copy(name: str, patches, out: Path) -> Path | None:
    """out/name holding SOURCES with `patches` applied; None (and a note)
    when a patch no longer matches its source."""
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for src in SOURCES:
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


def build(out: Path) -> dict:
    """{variant: loaded library}, each built by `_build.build`."""
    dirs = {name: patched_copy(name, patches, out)
            for name, patches in VARIANTS.items()}
    dirs = {name: d for name, d in dirs.items() if d is not None}
    if "base" not in dirs:
        fail("the unpatched sources did not copy")
    with ThreadPoolExecutor(len(dirs)) as pool:
        paths = dict(zip(dirs, pool.map(_build.build, dirs.values())))
    libs = {}
    for name, path in paths.items():
        cdll = ctypes.CDLL(str(path))
        for entry in SCAN_ENTRIES:
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
    args = p.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    card = nvidia_smi_line()
    print(card, flush=True)
    libs = build(_build.BUILD_DIR / "ablate")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(20240611)
    rows = []

    def record(entry, shape, variant, ms):
        rows.append({"entry": entry, "shape": shape, "variant": variant,
                     "ms": ms, "card": card})
        print(f"[ablate] entry={entry}  shape={shape}  variant={variant}  "
              f"ms={ms:.4f}", flush=True)

    b, r, m, slots = 512, 256, 10_485_760, 4096
    Wq = torch.rand(b, r, generator=gen, device="cuda")
    H = torch.randint(-127, 128, (r, m), generator=gen, device="cuda",
                      dtype=torch.int8)
    for name in RESERVOIR:
        if name in libs:
            record("reservoir_scan_i8", f"b={b} r={r} m={m} R={slots}", name,
                   event_ms(split_scan(libs[name], Wq, H, m, slots, 1,
                                       stream), iters=3))
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

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ablation.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
