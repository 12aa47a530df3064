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
# (V, scale, W, H, G, out, n, m, r, eps, stream)
_MU = [_P] * 6 + [_I] * 3 + [ctypes.c_float, _P]
# (Wq, H, out_s, out_i, b, r, m, ldh, slots, stream)
_RESERVOIR = [_P] * 4 + [_I] * 3 + [_LL, _I, _P]
# (Wq, H, theta, counts, b, r, m, ldh, stream)
_COUNT = [_P] * 4 + [_I] * 3 + [_LL, _P]
# (vals, cols, table, out, nseg, w, r, stream)
_ELL = [_P] * 4 + [_LL, _I, _I, _P]
ENTRIES = {
    "nmftpu_ell_rowsums_f32": _ELL,
    "nmftpu_ell_rowsums_f64": _ELL,
    "nmftpu_w_update_f32": _MU,
    "nmftpu_h_update_f32": _MU,
    "nmftpu_w_update_i8": _MU,
    "nmftpu_h_update_i8": _MU,
    "nmftpu_reservoir_scan_f32": _RESERVOIR,
    "nmftpu_reservoir_scan_bf16": _RESERVOIR,
    "nmftpu_reservoir_scan_i8": _RESERVOIR,
    "nmftpu_count_above_bf16": _COUNT,
    "nmftpu_count_above_i8": _COUNT,
}


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
    log = out.with_suffix(".so.log")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [str(Path(objdir) / f"{src.stem}.o") for src in _sources()]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for obj, src in zip(objs, _sources())]
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
