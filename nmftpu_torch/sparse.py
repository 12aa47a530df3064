"""Host-side sparse matrix containers: CSR / CSC / COO (port of
``nmftpu/sparse.py``).

Plain numpy storage and format conversions, field for field as in
``nmftpu``. The port carries its own copy because ``nmftpu.sparse`` cannot
be imported without jax (its native CSR build reaches
``nmftpu.native_loader`` through the package's ``__init__``). A COO's
`to_csr` / `to_csc` take the native CSR build
(``nmftpu_torch.native_loader.csr_build``) for float32 data of at least
``NATIVE_MIN_NNZ`` nonzeros when the library is built and
``NMFTPU_NATIVE_CSR`` is not "0"; otherwise numpy's sort.

No scipy dependency is required; `from_scipy` accepts scipy.sparse
objects when scipy is installed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _native_csr(major, minor, data, n_major):
    """The native fused CSR build of (major, minor, data) -> (indptr,
    indices, data), or None where it does not apply
    (`native_loader.applies`) or the library is not built. An error of
    the loaded library raises."""
    from nmftpu_torch import native_loader

    if not (native_loader.applies(data) and native_loader.has_csr_build()):
        return None
    return native_loader.csr_build(major, minor, data, n_major)


def _two_key_order(major, minor, minor_extent):
    """argsort by (major, minor). When major*extent+minor fits int64 the
    two keys fuse into ONE int64 sort; otherwise np.lexsort. The fused
    sort is deterministic but not input-order stable, so duplicate
    (row, col) entries land in unspecified relative order (they are
    summed downstream)."""
    major = np.asarray(major, np.int64)
    minor = np.asarray(minor, np.int64)
    extent = int(minor_extent)
    if extent > 0 and major.size and (
        int(major.max()) < (2**63 - 1) // max(extent, 1)
    ):
        return np.argsort(major * extent + minor)
    return np.lexsort((minor, major))


class SparseMatrix:
    """Base class for the host sparse containers."""

    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        raise NotImplementedError

    def to_coo(self) -> "SparseCOO":
        raise NotImplementedError

    def to_csr(self) -> "SparseCSR":
        return self.to_coo().to_csr()

    def to_csc(self) -> "SparseCSC":
        return self.to_coo().to_csc()

    def todense(self) -> np.ndarray:
        coo = self.to_coo()
        out = np.zeros(self.shape, dtype=coo.data.dtype)
        # += handles duplicate coordinates like scipy (summed)
        np.add.at(out, (coo.row, coo.col), coo.data)
        return out

    def transpose(self):
        coo = self.to_coo()
        return SparseCOO(
            row=coo.col, col=coo.row, data=coo.data,
            shape=(self.shape[1], self.shape[0]),
        )

    @property
    def T(self):
        return self.transpose()


@dataclasses.dataclass
class SparseCOO(SparseMatrix):
    """Coordinate triplets (row, col, data); duplicates are summed on use."""

    row: np.ndarray
    col: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    def __post_init__(self):
        self.row = np.asarray(self.row, dtype=np.int32)
        self.col = np.asarray(self.col, dtype=np.int32)
        self.data = np.asarray(self.data)
        if not (len(self.row) == len(self.col) == len(self.data)):
            raise ValueError("row/col/data length mismatch")
        self.shape = (int(self.shape[0]), int(self.shape[1]))

    @property
    def nnz(self) -> int:
        return len(self.data)

    def to_coo(self) -> "SparseCOO":
        return self

    def to_csr(self) -> "SparseCSR":
        n, m = self.shape
        nat = _native_csr(self.row, self.col, self.data, n)
        if nat is not None:
            return SparseCSR(indptr=nat[0], indices=nat[1], data=nat[2],
                             shape=self.shape)
        order = _two_key_order(self.row, self.col, m)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.row, minlength=n), out=indptr[1:])
        return SparseCSR(
            indptr=indptr,
            indices=self.col[order],
            data=self.data[order],
            shape=self.shape,
        )

    def to_csc(self) -> "SparseCSC":
        n, m = self.shape
        nat = _native_csr(self.col, self.row, self.data, m)
        if nat is not None:
            return SparseCSC(indptr=nat[0], indices=nat[1], data=nat[2],
                             shape=self.shape)
        order = _two_key_order(self.col, self.row, n)
        indptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.col, minlength=m), out=indptr[1:])
        return SparseCSC(
            indptr=indptr,
            indices=self.row[order],
            data=self.data[order],
            shape=self.shape,
        )


@dataclasses.dataclass
class SparseCSR(SparseMatrix):
    """Compressed sparse rows: indptr (n+1), indices (nnz) cols, data (nnz)."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    def __post_init__(self):
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        self.data = np.asarray(self.data)
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        if len(self.indptr) != self.shape[0] + 1:
            raise ValueError(
                f"indptr length {len(self.indptr)} != rows+1 "
                f"({self.shape[0] + 1})"
            )

    @property
    def nnz(self) -> int:
        return len(self.data)

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_coo(self) -> SparseCOO:
        row = np.repeat(
            np.arange(self.shape[0], dtype=np.int32), self.row_lengths()
        )
        return SparseCOO(
            row=row, col=self.indices, data=self.data, shape=self.shape
        )

    def to_csr(self) -> "SparseCSR":
        return self


@dataclasses.dataclass
class SparseCSC(SparseMatrix):
    """Compressed sparse columns: indptr (m+1), indices (nnz) rows, data."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    def __post_init__(self):
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        self.data = np.asarray(self.data)
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        if len(self.indptr) != self.shape[1] + 1:
            raise ValueError(
                f"indptr length {len(self.indptr)} != cols+1 "
                f"({self.shape[1] + 1})"
            )

    @property
    def nnz(self) -> int:
        return len(self.data)

    def to_coo(self) -> SparseCOO:
        col = np.repeat(
            np.arange(self.shape[1], dtype=np.int32), np.diff(self.indptr)
        )
        return SparseCOO(
            row=self.indices, col=col, data=self.data, shape=self.shape
        )

    def to_csc(self) -> "SparseCSC":
        return self


def from_dense(dense: np.ndarray, threshold: float = 0.0) -> SparseCOO:
    """Extract |v| > threshold entries of a dense matrix into COO."""
    dense = np.asarray(dense)
    row, col = np.nonzero(np.abs(dense) > threshold)
    return SparseCOO(
        row=row.astype(np.int32),
        col=col.astype(np.int32),
        data=dense[row, col],
        shape=dense.shape,
    )


def from_scipy(mat) -> SparseMatrix:
    """Adapt a scipy.sparse matrix (any format) without copying data arrays."""
    fmt = getattr(mat, "format", None)
    if fmt == "csr":
        return SparseCSR(mat.indptr, mat.indices, mat.data, mat.shape)
    if fmt == "csc":
        return SparseCSC(mat.indptr, mat.indices, mat.data, mat.shape)
    coo = mat.tocoo()
    return SparseCOO(coo.row, coo.col, coo.data, coo.shape)
