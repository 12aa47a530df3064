"""2-D tiled sparse layout for the rank mesh (port of
``nmftpu/parallel/sharded_coo.py``).

Rank (i, j) owns the nonzeros of V falling in row block i and column
block j, stored with block-LOCAL indices and zero-padded to the uniform
per-tile capacity (the largest tile's count rounded up to the chunk
size), so every rank runs the same chunk loop. Padding entries (value 0,
indices 0) are exact no-ops in every primitive, as in
``sparse_ops.DeviceCOO``. Each rank keeps only its own tile on its
device; the host arrays equal the (i, j) tile of ``nmftpu``'s
`partition_sparse`.

Load balance: power-law matrices give uneven tiles, so
`partition_sparse(balance=True)` permutes rows and columns by a seeded
permutation before tiling; the permutations are returned so factors can
be un-permuted on the way out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmftpu_torch import sparse as host_sparse
from nmftpu_torch.sparse_ops import DeviceCOO

_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class ShardedCOO:
    """This rank's tile of V, plus the layout every rank shares."""

    values: torch.Tensor   # (Nt,) this rank's tile, zero padded
    rows: torch.Tensor     # (Nt,) int32, LOCAL row index within the block
    cols: torch.Tensor     # (Nt,) int32, LOCAL column index
    shape: tuple[int, int]   # true (unpadded) global shape
    nnz: int                 # global nonzero count
    chunk: int
    mesh_shape: tuple[int, int]
    block_rows: int
    block_cols: int
    coords: tuple[int, int]  # this rank's tile (i, j)
    tile_nnz: np.ndarray     # (pu, pi) nonzero values per tile

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (self.mesh_shape[0] * self.block_rows,
                self.mesh_shape[1] * self.block_cols)

    def local(self) -> DeviceCOO:
        """The tile as a block-shaped DeviceCOO (for the local ops)."""
        i, j = self.coords
        return DeviceCOO(values=self.values, rows=self.rows, cols=self.cols,
                         shape=(self.block_rows, self.block_cols),
                         nnz=int(self.tile_nnz[i, j]), chunk=self.chunk)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def permutations(n: int, m: int, balance: bool, seed: int):
    """(row_perm, col_perm), ORIGINAL index -> PERMUTED index: seeded
    numpy permutations (``nmftpu``'s draws), or the identity."""
    if not balance:
        return np.arange(n, dtype=np.int32), np.arange(m, dtype=np.int32)
    rng = np.random.default_rng(seed)
    return (rng.permutation(n).astype(np.int32),
            rng.permutation(m).astype(np.int32))


def block_sizes(shape, mesh_shape) -> tuple[int, int]:
    """Rows and columns of a tile: the even split, rounded up to 8."""
    (n, m), (pu, pi) = shape, mesh_shape
    return (_round_up((n + pu - 1) // pu, 8),
            _round_up((m + pi - 1) // pi, 8))


def partition_sparse(
    mat: host_sparse.SparseMatrix,
    mesh_shape: tuple[int, int],
    coords: tuple[int, int] = (0, 0),
    dtype=torch.float32,
    chunk: int = 8192,
    balance: bool = True,
    seed: int = 0,
    device="cpu",
):
    """Tile a host sparse matrix over a (pu, pi) grid and keep tile
    `coords` on `device`.

    Returns (ShardedCOO, row_perm, col_perm) where the permutations map
    ORIGINAL index -> PERMUTED index (identity when balance=False):
    W_orig = W_perm[row_perm]. Every rank passes the whole matrix; the
    capacity and chunk follow the largest tile, as in ``nmftpu``."""
    tiles, row_perm, col_perm = partition_tiles(
        mat, mesh_shape, [coords], dtype=dtype, chunk=chunk,
        balance=balance, seed=seed, device=device)
    return tiles[0], row_perm, col_perm


def partition_tiles(mat, mesh_shape, coords_list, dtype=torch.float32,
                    chunk: int = 8192, balance: bool = True, seed: int = 0,
                    device="cpu"):
    """`partition_sparse` keeping every tile of `coords_list` (one pass
    over the nonzeros): ([ShardedCOO], row_perm, col_perm)."""
    pu, pi = mesh_shape
    coo = mat.to_coo()
    n, m = coo.shape
    row_perm, col_perm = permutations(n, m, balance, seed)
    rows = row_perm[coo.row] if balance else coo.row
    cols = col_perm[coo.col] if balance else coo.col
    block_rows, block_cols = block_sizes((n, m), (pu, pi))

    tile_r = rows // block_rows
    tile_c = cols // block_cols
    tile_id = tile_r * pi + tile_c
    counts = np.bincount(tile_id, minlength=pu * pi)
    cap = max(int(counts.max()), 1)
    chunk = min(chunk, _round_up(cap, 256))
    cap = _round_up(cap, chunk)
    nz = np.bincount(tile_id, weights=coo.data != 0, minlength=pu * pi)
    tiles = []
    for ti, tj in coords_list:
        sel = np.flatnonzero(tile_id == ti * pi + tj)
        k = len(sel)
        values = np.zeros(cap, dtype=_NUMPY[dtype])
        lrows = np.zeros(cap, dtype=np.int32)
        lcols = np.zeros(cap, dtype=np.int32)
        values[:k] = coo.data[sel]
        lrows[:k] = rows[sel] - ti * block_rows
        lcols[:k] = cols[sel] - tj * block_cols
        tiles.append(ShardedCOO(
            values=torch.from_numpy(values).to(device),
            rows=torch.from_numpy(lrows).to(device),
            cols=torch.from_numpy(lcols).to(device),
            shape=(n, m), nnz=coo.nnz, chunk=chunk, mesh_shape=(pu, pi),
            block_rows=block_rows, block_cols=block_cols, coords=(ti, tj),
            tile_nnz=nz.astype(np.int64).reshape(pu, pi),
        ))
    return tiles, row_perm, col_perm


def balance_report(scoo: ShardedCOO) -> dict:
    """Tile-population statistics (padding waste, max/mean imbalance)."""
    nz = scoo.tile_nnz
    cap = scoo.values.shape[0]
    return {
        "tile_capacity": int(cap),
        "tile_nnz_max": int(nz.max()),
        "tile_nnz_min": int(nz.min()),
        "tile_nnz_mean": float(nz.mean()),
        "imbalance": float(nz.max() / max(nz.mean(), 1e-9)),
        "padding_fraction": float(1.0 - nz.sum() / (nz.size * cap)),
    }
