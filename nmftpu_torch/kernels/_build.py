"""Build and load the port's CUDA kernels (the counterpart of
``nmftpu/native_loader.py``).

At first use, ``nvcc`` compiles every ``nmftpu_torch/csrc/*.cu`` to an
object file, one process per source, all started together, and links
them into one shared library with a plain C interface under
``nmftpu_torch/_build/``, keyed by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused. The library is
loaded with ``ctypes``; each C entry's argument types are declared in
``ENTRIES`` (pointers and the stream as ``c_void_p``). Each C entry
returns ``cudaGetLastError()``, which :func:`check` turns into an
exception.

Nothing here runs at import time: the CPU-only test machines import every
module of the package and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (V, scale, W, H, G, out, ws, counters, n, m, r, splits, eps, stream)
_MU = [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P]
# (Wq, H, out_s, out_i, b, r, m, ldh, slots, stream)
_RESERVOIR = [_P] * 4 + [_I] * 3 + [_LL, _I, _P]
# ... and (tiles_per_split, splits, g) before the stream; g (and gv, gw
# of the int8 entries) is a `copy_alignment`
_RESERVOIR_TC = [_P] * 4 + [_I] * 3 + [_LL] + [_I] * 4 + [_P]
# (Wq, H, lim, counts, pairs, nband, cap, b, r, m, ldh, tiles_per_block,
# g, stream)
_COUNT = [_P] * 6 + [_I] * 4 + [_LL, _I, _I, _P]
# (desc, nb, table, out, r, stream); desc a host int64 array
_ELL = [_P, _I, _P, _P, _I, _P]
# (desc, nb, own, table, out, r, eps, stream)
_ELL_KL = [_P, _I, _P, _P, _P, _I, ctypes.c_double, _P]
# (V, X, out, n, m, r, gv, gw, stream)
_INT8 = [_P] * 3 + [_I] * 5 + [_P]
# (x, numer, denom, out, count, eps, stream)
_MULDIV = [_P] * 4 + [_LL, ctypes.c_double, _P]
ENTRIES = {
    "nmftpu_int8_vht": _INT8,
    "nmftpu_int8_wtv": _INT8,
    # (V, WqT, Hq, nw, nh, n, m, r, gv, gw, stream)
    "nmftpu_int8_dual": [_P] * 5 + [_I] * 5 + [_P],
    # (XHt, G, W, out, n, r, block, stream)
    "nmftpu_hals_sweep_f32": [_P] * 4 + [_I] * 3 + [_P],
    "nmftpu_muldiv_f32": _MULDIV,
    "nmftpu_muldiv_f64": _MULDIV,
    "nmftpu_ell_spmm_f32": _ELL,
    "nmftpu_ell_spmm_f64": _ELL,
    "nmftpu_ell_kl_f32": _ELL_KL,
    "nmftpu_ell_kl_f64": _ELL_KL,
    "nmftpu_w_update_f32": _MU,
    "nmftpu_h_update_f32": _MU,
    "nmftpu_w_update_i8": _MU,
    "nmftpu_h_update_i8": _MU,
    "nmftpu_reservoir_scan_f32": _RESERVOIR,
    "nmftpu_reservoir_scan_bf16": _RESERVOIR_TC,
    "nmftpu_reservoir_scan_i8": _RESERVOIR_TC,
    # (part_s, part_i, out_s, out_i, splits, b, slots, stream)
    "nmftpu_reservoir_merge": [_P] * 4 + [_I] * 3 + [_P],
    "nmftpu_count_above_bf16": _COUNT,
    "nmftpu_count_above_i8": _COUNT,
}


def _sources(src: Path | None = None) -> list[Path]:
    return sorted((src or CSRC).glob("*.cu"))


def _source_hash(src: Path | None = None) -> str:
    src = src or CSRC
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(src.glob("*.cu")) + sorted(src.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from nmftpu_torch/csrc at first use"
    )


def library_path(src: Path | None = None) -> Path:
    return BUILD_DIR / f"libnmftpu_torch_{_source_hash(src)}.so"


def build(src: Path | None = None) -> Path:
    """Compile the sources in `src` (by default the package's ``csrc/``;
    a directory of patched copies builds a variant) unless a library for
    their hash exists; return its path. The compiler's output (including
    ``-Xptxas -v``'s register and shared-memory report) is kept beside it
    as ``<library>.log``."""
    out = library_path(src)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = out.with_suffix(".so.log")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [str(Path(objdir) / f"{cu.stem}.o") for cu in _sources(src)]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(cu)]
                    for obj, cu in zip(objs, _sources(src))]
        # one nvcc per source, all running at once
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        steps = [(cmd, p.communicate()[0], p.returncode)
                 for cmd, p in zip(compiles, procs)]
        if all(rc == 0 for _, _, rc in steps):
            link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            steps.append((link, proc.stdout + proc.stderr, proc.returncode))
    log.write_text("".join(" ".join(cmd) + "\n" + text
                           for cmd, text, _ in steps))
    failed = [(cmd, text, rc) for cmd, text, rc in steps if rc != 0]
    if failed:
        os.unlink(tmp)
        cmd, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                           f"{text[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the entries."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nmftpu_error_string.argtypes = [ctypes.c_int]
    lib.nmftpu_error_string.restype = ctypes.c_char_p
    return lib


def copy_alignment(*byte_offsets) -> int:
    """The widest copy, 16, 8, 4 or 1 bytes, to which every offset (an
    operand's address, its row stride in bytes, a tile's step) is
    aligned: the tensor-core kernels stage rows with cp.async copies of
    that size, so any row stride takes the same kernel."""
    for g in (16, 8, 4):
        if all(x % g == 0 for x in byte_offsets):
            return g
    return 1


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        msg = load().nmftpu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def launch(entry: str, what: str, device, *args) -> None:
    """Call C entry `entry` with `args` and the current stream of
    `device`, and raise if the launch failed."""
    import torch

    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    check(rc, what)
