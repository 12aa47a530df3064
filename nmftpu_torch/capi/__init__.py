"""Build the port's C ABI library (``libnmftpu_torch.so``).

``nmftpu_torch_capi.cc`` embeds CPython and drives the port through
``nmftpu_torch.capi_bridge``; ``nmftpu_capi.h`` here declares the same
functions as ``native/nmftpu_capi.h``, so a host program such as
``native/test_capi.c`` compiles against this directory's header and links
against this library:

    from nmftpu_torch import capi
    lib = capi.build()          # nmftpu_torch/_build/capi/libnmftpu_torch.so
    gcc native/test_capi.c -I nmftpu_torch/capi -L <lib dir> \\
        -lnmftpu_torch -lm -o test_capi
    env = capi.embed_env()      # PYTHONPATH for the embedded interpreter
    ./test_capi <repo root>     # runs on CUDA; NMFTPU_PLATFORM=cpu: CPU

The library is compiled with the ``g++`` found on PATH (not ``$CXX``,
which some toolchains point at a wrapper without OpenMP's spec file) and
linked with ``python3-config --embed`` of the running interpreter. It is
built at first use and rebuilt when the source changes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "nmftpu_torch_capi.cc"
HEADER = HERE / "nmftpu_capi.h"
BUILD_DIR = HERE.parent / "_build" / "capi"
LIB_NAME = "nmftpu_torch"


def library_path() -> Path:
    return BUILD_DIR / f"lib{LIB_NAME}.so"


def _python_config() -> str:
    """The python3-config of the running interpreter: beside it, else
    beside its base installation, else on PATH."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    for d in (Path(sys.executable).parent,
              Path(sys.base_prefix) / "bin"):
        for name in (f"python{ver}-config", "python3-config"):
            if (d / name).exists():
                return str(d / name)
    found = shutil.which(f"python{ver}-config") or \
        shutil.which("python3-config")
    if found is None:
        raise RuntimeError("python3-config not found: the C ABI library "
                           "links against libpython (--embed)")
    return found


def _flags(*args) -> list[str]:
    return subprocess.run([_python_config(), *args], capture_output=True,
                          text=True, check=True).stdout.split()


def build(force: bool = False) -> Path:
    """Compile the library into nmftpu_torch/_build/capi/ unless it is
    there already for this source and header; return its path. Raises
    when g++ or python3-config is missing or the build fails."""
    digest = hashlib.sha256(SOURCE.read_bytes() + HEADER.read_bytes()
                            ).hexdigest()[:16]
    lib = library_path()
    stamp = lib.with_suffix(".so.sha")
    if (not force and lib.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the C ABI library "
                           "needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".so.{os.getpid()}")
    cmd = [gxx, "-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC",
           "-shared", *_flags("--includes"), "-I", str(HERE), "-o",
           str(tmp), str(SOURCE), *_flags("--ldflags", "--embed")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"C ABI build failed ({' '.join(cmd)}):\n"
                           f"{out.stderr[-4000:]}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def embed_env(env: dict | None = None) -> dict:
    """`env` (default: this process's) with LD_LIBRARY_PATH reaching the
    library and libpython, and PYTHONPATH holding this interpreter's
    import path, so a host program's embedded interpreter imports the
    same packages (torch among them) as the process that built it."""
    env = dict(os.environ if env is None else env)
    libdirs = [str(BUILD_DIR)] + [
        f[2:] for f in _flags("--ldflags", "--embed") if f.startswith("-L")]
    env["LD_LIBRARY_PATH"] = os.pathsep.join(
        libdirs + [p for p in env.get("LD_LIBRARY_PATH", "").split(
            os.pathsep) if p])
    paths = [p for p in sys.path if p and os.path.isdir(p)]
    env["PYTHONPATH"] = os.pathsep.join(
        paths + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    return env
