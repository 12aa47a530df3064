"""ctypes binding of the native host library ``native/build/libnmftpu_io.so``
(C surface in ``native/nmftpu_io.h``): the MovieLens parser, COO -> CSR
and the bucketed-ELL fill. Written after ``nmftpu/native_loader.py``;
the port carries its own copy so that it never imports ``nmftpu``.

The library is found at ``native/build/libnmftpu_io.so`` beside the
package, or at the path in ``NMFTPU_NATIVE_LIB``; `build()` compiles it
there with ``make -C native build/libnmftpu_io.so CXX=g++`` (g++ and
OpenMP, no Python headers). `available()` says whether it loads. Callers take their
numpy paths only when the library is not built (or lacks an entry point)
or the input does not apply (`applies`: the dtype, `NATIVE_MIN_NNZ`,
`NMFTPU_NATIVE_CSR`); an error from a loaded library raises
RuntimeError.

`CALLS` counts the successful native calls per entry point, so a caller
can tell that a build went through the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_TARGET = os.path.join("build", "libnmftpu_io.so")

# Inputs below this nonzero count take the numpy paths: the ctypes
# overhead dominates there, and small inputs keep numpy's behaviour.
NATIVE_MIN_NNZ = 1 << 20

CALLS = {"parse_movielens": 0, "coo_to_csr": 0, "csr_build": 0,
         "ell_build": 0}

_lib = None
_lib_checked = False

_VP = ctypes.c_void_p
_SIGNATURES = {
    "nmio_parse": (_VP, [ctypes.c_char_p, ctypes.c_int32]),
    "nmio_nnz": (ctypes.c_int64, [_VP]),
    "nmio_n_users": (ctypes.c_int32, [_VP]),
    "nmio_n_items": (ctypes.c_int32, [_VP]),
    "nmio_fill_coo": (ctypes.c_int32, [_VP] * 5),
    "nmio_fill_ids": (ctypes.c_int32, [_VP] * 3),
    "nmio_free": (None, [_VP]),
    "nmio_last_error": (ctypes.c_char_p, []),
    "nmio_coo_to_csr": (ctypes.c_int32, [ctypes.c_int64, ctypes.c_int32]
                        + [_VP] * 4),
    "nmio_csr_build": (ctypes.c_int32, [ctypes.c_int64, ctypes.c_int64]
                       + [_VP] * 6),
    "nmio_ell_count": (ctypes.c_int32, [_VP, ctypes.c_int64, ctypes.c_int32,
                                        _VP, ctypes.c_int32, _VP]),
    "nmio_ell_fill": (ctypes.c_int32, [_VP, _VP, _VP, ctypes.c_int64,
                                       ctypes.c_int32, _VP, ctypes.c_int32,
                                       _VP, _VP, _VP]),
}


def library_path() -> str:
    return os.environ.get("NMFTPU_NATIVE_LIB",
                          os.path.join(_NATIVE_DIR, _TARGET))


def _load():
    """The loaded library, or None when its file does not exist. Entry
    points missing from an older build are left unbound (`_has`)."""
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    path = library_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    _lib = lib
    return _lib


def _has(name: str) -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, name)


def available() -> bool:
    return _load() is not None


def applies(data: np.ndarray) -> bool:
    """Whether the native builders take these values: float32 (the
    library stores float), at least NATIVE_MIN_NNZ of them (below that
    the ctypes overhead dominates, and numpy's behaviour is kept), and
    NMFTPU_NATIVE_CSR not "0"."""
    return (os.environ.get("NMFTPU_NATIVE_CSR", "1") != "0"
            and data.dtype == np.float32 and len(data) >= NATIVE_MIN_NNZ)


def has_csr_build() -> bool:
    return _has("nmio_csr_build")


def has_ell_build() -> bool:
    return _has("nmio_ell_fill")


def build(quiet: bool = True) -> bool:
    """Compile the IO library in place (needs make, g++ and OpenMP) and
    load it; False when the build cannot run or fails. Only the IO
    target is built: the Makefile's default target also links the C ABI
    library against the embedded Python, which a machine may lack. The
    compiler is the Makefile's own default, g++ from PATH: a CXX
    inherited from the environment (a toolchain wrapper set for other
    builds) may lack the OpenMP runtime the library links."""
    global _lib, _lib_checked
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, _TARGET, "CXX=g++"],
                       check=True, capture_output=quiet)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    _lib, _lib_checked = None, False
    return available()


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_VP)


def _require(name: str):
    lib = _load()
    if lib is None or not hasattr(lib, name):
        raise RuntimeError(f"native {name} unavailable: build "
                           f"{library_path()} (native_loader.build())")
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed (rc={rc})")


def parse_movielens(path: str, implicit: bool = False):
    """Parse a MovieLens u.data or ratings.csv file natively ->
    (rows int32, cols int32, vals float32, ts int64, user_ids int64,
    item_ids int64), ids remapped to contiguous indices in sorted order
    of the original ids."""
    lib = _require("nmio_parse")
    handle = lib.nmio_parse(path.encode(), 1 if implicit else 0)
    if not handle:
        raise RuntimeError(
            f"nmio_parse failed: {lib.nmio_last_error().decode()}")
    try:
        nnz = lib.nmio_nnz(handle)
        rows = np.empty(nnz, np.int32)
        cols = np.empty(nnz, np.int32)
        vals = np.empty(nnz, np.float32)
        ts = np.empty(nnz, np.int64)
        _check(lib.nmio_fill_coo(handle, _ptr(rows), _ptr(cols), _ptr(vals),
                                 _ptr(ts)), "nmio_fill_coo")
        user_ids = np.empty(lib.nmio_n_users(handle), np.int64)
        item_ids = np.empty(lib.nmio_n_items(handle), np.int64)
        _check(lib.nmio_fill_ids(handle, _ptr(user_ids), _ptr(item_ids)),
               "nmio_fill_ids")
    finally:
        lib.nmio_free(handle)
    CALLS["parse_movielens"] += 1
    return rows, cols, vals, ts, user_ids, item_ids


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, n_rows: int):
    """Native COO -> CSR order: (indptr int64[n_rows + 1], perm int64[nnz])
    with perm sorting the triplets by (row, col)."""
    lib = _require("nmio_coo_to_csr")
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    indptr = np.zeros(n_rows + 1, np.int64)
    perm = np.empty(len(rows), np.int64)
    _check(lib.nmio_coo_to_csr(len(rows), n_rows, _ptr(rows), _ptr(cols),
                               _ptr(indptr), _ptr(perm)), "nmio_coo_to_csr")
    CALLS["coo_to_csr"] += 1
    return indptr, perm


def csr_build(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              n_rows: int):
    """Fused native COO -> CSR (a counting sort by row into the outputs,
    then each row's columns sorted in parallel) -> (indptr int64,
    indices int32, data float32). Equal to numpy's (row, col) sort except
    in the order of duplicate coordinates."""
    lib = _require("nmio_csr_build")
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    nnz = len(rows)
    indptr = np.zeros(n_rows + 1, np.int64)
    out_cols = np.empty(nnz, np.int32)
    out_vals = np.empty(nnz, np.float32)
    _check(lib.nmio_csr_build(nnz, n_rows, _ptr(rows), _ptr(cols), _ptr(vals),
                              _ptr(indptr), _ptr(out_cols), _ptr(out_vals)),
           "nmio_csr_build")
    CALLS["csr_build"] += 1
    return indptr, out_cols, out_vals


def ell_build(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
              seg_max: int, widths, pad_segments=None):
    """Native bucketed-ELL fill (the layout of ``sparse_ell``) -> a list of
    (vals (nseg_p, w) float32, cols (nseg_p, w) int32, rows (nseg_p,)
    int32, nseg, width) per non-empty bucket, segments in the numpy
    builder's order. `pad_segments(nseg) -> nseg_p` is the caller's
    padding rule: the pad tail stays zero, except rows, which repeat the
    last real row."""
    lib = _require("nmio_ell_fill")
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    widths = np.ascontiguousarray(widths, np.int32)
    nw, n_rows = len(widths), len(indptr) - 1
    counts = np.zeros(nw, np.int64)
    _check(lib.nmio_ell_count(_ptr(indptr), n_rows, int(seg_max),
                              _ptr(widths), nw, _ptr(counts)),
           "nmio_ell_count")
    pad = pad_segments or (lambda ns: ns)
    bufs = []
    for ns, w in zip(counts.tolist(), widths.tolist()):
        ns_p = max(int(pad(ns)), ns) if ns else 0
        bufs.append((np.zeros((ns_p, w), np.float32),
                     np.zeros((ns_p, w), np.int32),
                     np.zeros(ns_p, np.int32)))
    ptrs = [(_VP * nw)(*(b[k].ctypes.data for b in bufs)) for k in range(3)]
    _check(lib.nmio_ell_fill(_ptr(indptr), _ptr(indices), _ptr(data), n_rows,
                             int(seg_max), _ptr(widths), nw,
                             *(ctypes.cast(p, _VP) for p in ptrs)),
           "nmio_ell_fill")
    out = []
    for (v, c, r), ns, w in zip(bufs, counts.tolist(), widths.tolist()):
        if ns:
            r[ns:] = r[ns - 1]
            out.append((v, c, r, ns, w))
    CALLS["ell_build"] += 1
    return out
