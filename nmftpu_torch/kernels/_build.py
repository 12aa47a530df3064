"""Build and load the port's CUDA kernels (the counterpart of
``nmftpu/native_loader.py``).

At first use, ``nvcc`` compiles every ``nmftpu_torch/csrc/*.cu`` into one
shared library with a plain C interface, under ``nmftpu_torch/_build/``,
keyed by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused. The library is loaded with ``ctypes``;
pointers and the stream pass as ``c_void_p``. Each C entry returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Every C entry: (V, scale, W, H, G, out, n, m, r, eps, stream) -> int
_ENTRY_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_void_p,
]
ENTRIES = (
    "nmftpu_w_update_f32",
    "nmftpu_h_update_f32",
    "nmftpu_w_update_i8",
    "nmftpu_h_update_i8",
)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
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


def library_path() -> Path:
    return BUILD_DIR / f"libnmftpu_torch_{_source_hash()}.so"


def build() -> Path:
    """Compile the sources unless a library for their hash exists; return
    its path. The compiler's output (including ``-Xptxas -v``'s register
    and shared-memory report) is kept beside it as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".so.log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the entries."""
    lib = ctypes.CDLL(str(build()))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _ENTRY_ARGTYPES
        fn.restype = ctypes.c_int
    lib.nmftpu_error_string.argtypes = [ctypes.c_int]
    lib.nmftpu_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        msg = load().nmftpu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")
