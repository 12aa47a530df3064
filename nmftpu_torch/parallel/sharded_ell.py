"""The 2-D grid engine on gather-only ELL tiles (port of
``nmftpu/parallel/sharded_ell.py``).

The mesh and the sums over its axes are those of ``parallel/updates.py``;
each rank's tile is stored in the bucketed-segment layout of
``sparse_ell`` instead of COO, in both orientations: the row-major ELL of
the tile (for V Hᵀ) and of its transpose (for (Wᵀ V)ᵀ). The products are
``sparse_ell``'s plain gathers (``v_ht_ell``, ``sampled_rowsums_ell``,
``sddmm_ell``), as the reference's are.

Every bucket's segment count is padded to its largest over the tiles
(and a width present in any tile is present in all), so the arrays of
tile (i, j) equal the (i, j) slice of ``nmftpu``'s `partition_sparse_ell`;
the balancing permutation keeps that padding small. Each rank builds its
own tile only, through ``sparse_ell.build_ell_rows`` (the native builder
for float32 tiles of at least ``native_loader.NATIVE_MIN_NNZ`` nonzeros
where it is built, else numpy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmftpu_torch import sparse as host_sparse
from nmftpu_torch import sparse_ell as SE
from nmftpu_torch.config import Algorithm, Objective
from nmftpu_torch.linalg.dense import (
    _beta_apply,
    beta_denom_h_blocked,
    beta_denom_w_blocked,
    beta_gamma,
)
from nmftpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS, psum
from nmftpu_torch.parallel.sharded_coo import block_sizes, permutations
from nmftpu_torch.parallel.updates import (
    beta_grid,
    frobenius_grid,
    kl_grid,
    kl_terms,
    ordered,
)
from nmftpu_torch.sparse_ell import EllBucket, EllPair, EllRows


@dataclasses.dataclass(frozen=True)
class ShardedEll:
    """This rank's tile as an EllPair (rows: the tile, cols: its
    transpose), plus the layout every rank shares."""

    pair: EllPair
    shape: tuple[int, int]
    nnz: int
    mesh_shape: tuple[int, int]
    block_rows: int
    block_cols: int
    coords: tuple[int, int]

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (self.mesh_shape[0] * self.block_rows,
                self.mesh_shape[1] * self.block_cols)


def _segment_counts(tile_id, major, block, ntiles, seg_max, widths):
    """(ntiles, len(widths)) segment counts per tile and bucket: each row
    (of `block` per tile) of L stored entries makes L // seg_max full
    segments and, if L % seg_max, one of that length, in the narrowest
    bucket that holds it."""
    lengths = np.bincount(tile_id.astype(np.int64) * block + major,
                          minlength=ntiles * block).reshape(ntiles, block)
    counts = np.zeros((ntiles, len(widths)), np.int64)
    counts[:, np.searchsorted(widths, seg_max)] += (lengths // seg_max).sum(1)
    rem = lengths % seg_max
    t, r = np.nonzero(rem)
    np.add.at(counts, (t, np.searchsorted(widths, rem[t, r])), 1)
    return counts


def _padded_rows(ell: EllRows, counts, widths, dtype, device) -> EllRows:
    """`ell` with a bucket for every width any tile has, each padded to
    the most segments of any tile (pad segments: zeros, out_row the last
    real row; an absent width: zeros, out_row 0)."""
    have = {b.width: b for b in ell.buckets}
    out = []
    for k, w in enumerate(widths):
        most = int(counts[:, k].max())
        if most == 0:
            continue
        b = have.get(int(w))
        if b is None:
            z = torch.zeros((most, int(w)), dtype=torch.int32, device=device)
            out.append(EllBucket(vals=torch.zeros(
                (most, int(w)), dtype=dtype, device=device),
                cols=z, out_row=torch.zeros(most, dtype=torch.int32,
                                            device=device), width=int(w)))
            continue
        pad = most - b.vals.shape[0]
        if pad:
            b = EllBucket(
                vals=torch.cat([b.vals, b.vals.new_zeros((pad, b.width))]),
                cols=torch.cat([b.cols, b.cols.new_zeros((pad, b.width))]),
                out_row=torch.cat([b.out_row, b.out_row[-1:].repeat(pad)]),
                width=b.width)
        out.append(b)
    return EllRows(buckets=tuple(out), shape=ell.shape, nnz=ell.nnz)


def partition_sparse_ell(
    mat: host_sparse.SparseMatrix,
    mesh_shape: tuple[int, int],
    coords: tuple[int, int] = (0, 0),
    dtype=torch.float32,
    seg_max: int = 512,
    buckets: tuple[int, ...] = SE.DEFAULT_BUCKETS,
    balance: bool = True,
    seed: int = 0,
    device="cpu",
):
    """Tile + ELL-encode a host sparse matrix for the grid and keep tile
    `coords` on `device`. Returns (ShardedEll, row_perm, col_perm), the
    permutations as `sharded_coo.partition_sparse` draws them."""
    pu, pi = mesh_shape
    coo = mat.to_coo()
    n, m = coo.shape
    row_perm, col_perm = permutations(n, m, balance, seed)
    rows = row_perm[coo.row] if balance else coo.row
    cols = col_perm[coo.col] if balance else coo.col
    block_rows, block_cols = block_sizes((n, m), (pu, pi))
    ti, tj = rows // block_rows, cols // block_cols
    lr = (rows - ti * block_rows).astype(np.int32)
    lc = (cols - tj * block_cols).astype(np.int32)
    tile_id = ti * pi + tj
    widths = np.asarray(buckets, np.int64)
    r_counts = _segment_counts(tile_id, lr, block_rows, pu * pi, seg_max,
                               widths)
    c_counts = _segment_counts(tile_id, lc, block_cols, pu * pi, seg_max,
                               widths)

    i, j = coords
    sel = np.flatnonzero(tile_id == i * pi + j)
    tile = host_sparse.SparseCOO(row=lr[sel], col=lc[sel],
                                 data=coo.data[sel],
                                 shape=(block_rows, block_cols))
    # no chunk padding: the tiles are padded to each other below
    kw = dict(dtype=dtype, seg_max=seg_max, buckets=buckets,
              chunk_segments=1 << 62, device=device)
    pair = EllPair(
        rows=_padded_rows(SE.build_ell_rows(tile, **kw), r_counts, widths,
                          dtype, device),
        cols=_padded_rows(SE.build_ell_rows(tile.T, **kw), c_counts, widths,
                          dtype, device),
    )
    sell = ShardedEll(pair=pair, shape=(n, m), nnz=coo.nnz,
                      mesh_shape=(pu, pi), block_rows=block_rows,
                      block_cols=block_cols, coords=(i, j))
    return sell, row_perm, col_perm


def build_sharded_ell_update(config, mesh):
    """(make_aux, update, effective_h) of the MU family (Frobenius,
    confidence-weighted, KL, beta) over ELL tiles."""
    if config.algorithm is not Algorithm.MU:
        raise ValueError("sharded ELL engine supports the MU family")
    eps = config.eps
    obj = config.objective
    alpha = config.alpha_confidence

    if obj is Objective.FROBENIUS and alpha > 0.0:
        # one gather per tile serves the weighted numerator AND the
        # alpha term (sampled_rowsums_ell)
        wfns = (lambda v, s: v * (1.0 + alpha * v), lambda v, s: v * s)

        def upd_w(W, H, sell):
            numer, apart = SE.sampled_rowsums_ell(sell.pair.rows, W, H, wfns)
            den = (W @ psum(H @ H.T, mesh, AXIS_ITEMS)
                   + alpha * psum(apart, mesh, AXIS_ITEMS) + eps)
            return W * (psum(numer, mesh, AXIS_ITEMS) / den)

        def upd_h(W, H, sell):
            numer, apart = SE.sampled_rowsums_ell(sell.pair.cols, H.T, W.T,
                                                  wfns)
            den = (psum(W.T @ W, mesh, AXIS_USERS) @ H
                   + alpha * psum(apart.T, mesh, AXIS_USERS) + eps)
            return H * (psum(numer.T, mesh, AXIS_USERS) / den)

    elif obj is Objective.FROBENIUS:

        def upd_w(W, H, sell):
            numer = psum(SE.v_ht_ell(sell.pair.rows, H), mesh, AXIS_ITEMS)
            denom = W @ psum(H @ H.T, mesh, AXIS_ITEMS)
            denom += eps
            numer /= denom
            del denom
            numer *= W
            return numer

        def upd_h(W, H, sell):
            numer = psum(SE.wt_v_ell(sell.pair, W), mesh, AXIS_USERS)
            denom = psum(W.T @ W, mesh, AXIS_USERS) @ H
            denom += eps
            numer /= denom
            del denom
            numer *= H
            return numer

    elif obj is Objective.BETA:
        # the fused gather-once numerator with the coefficient
        # v·clamp(WH)^(β-2); the dense denominator streams this rank's
        # (W H_local)^(β-1) panels, summed over the axis
        b_ = config.beta
        gamma = beta_gamma(b_)
        cfns = (SE.beta_coef(b_),)

        def upd_w(W, H, sell):
            numer, = SE.sampled_rowsums_ell(sell.pair.rows, W, H, cfns)
            blk = max(1, min(2048, H.shape[1]))
            denom = psum(beta_denom_w_blocked(W, H, b_, blk), mesh,
                         AXIS_ITEMS)
            return _beta_apply(W, psum(numer, mesh, AXIS_ITEMS), denom, b_,
                               gamma)

        def upd_h(W, H, sell):
            numer, = SE.sampled_rowsums_ell(sell.pair.cols, H.T, W.T, cfns)
            blk = max(1, min(2048, W.shape[0]))
            denom = psum(beta_denom_h_blocked(W, H, b_, blk), mesh,
                         AXIS_USERS)
            return _beta_apply(H, psum(numer.T, mesh, AXIS_USERS), denom, b_,
                               gamma)

    else:  # KL: the fused gather-once ratio + SpMM per tile
        rfns = (lambda v, s: v / (s + eps),)

        def upd_w(W, H, sell):
            numer, = SE.sampled_rowsums_ell(sell.pair.rows, W, H, rfns)
            h_sum = psum(torch.sum(H, dim=1), mesh, AXIS_ITEMS)
            return W * (psum(numer, mesh, AXIS_ITEMS)
                        / torch.clamp(h_sum, min=eps)[None, :])

        def upd_h(W, H, sell):
            numer, = SE.sampled_rowsums_ell(sell.pair.cols, H.T, W.T, rfns)
            w_sum = psum(torch.sum(W, dim=0), mesh, AXIS_USERS)
            return H * (psum(numer.T, mesh, AXIS_USERS)
                        / torch.clamp(w_sum, min=eps)[:, None])

    step = ordered(config, upd_w, upd_h)

    def update(sell, aux, W, H):
        return step(W, H, sell)

    return (lambda s: ()), update, (lambda aux, H: H)


def _stored(ell: EllRows, sampled: EllRows):
    """The stored values and their sampled WH, flattened over buckets."""
    return (torch.cat([b.vals.reshape(-1) for b in ell.buckets]),
            torch.cat([b.vals.reshape(-1) for b in sampled.buckets]))


def build_sharded_ell_errors(mesh):
    """(frobenius, kl) over ELL tiles, the same scalar on every rank."""
    def frobenius(sell, W, H, svsq):
        return frobenius_grid(mesh, SE.wt_v_ell(sell.pair, W), W, H, svsq)

    def kl(sell, W, H):
        rows = sell.pair.rows
        v, wh = _stored(rows, SE.sddmm_ell(rows, W, H))
        return kl_grid(mesh, kl_terms(v, wh), W, H)

    return frobenius, kl


def build_sharded_ell_beta_error(mesh, beta: float):
    """D_β(V || WH) over ELL tiles (the twin of
    `updates.build_sharded_beta_error`; pad lanes carry v = 0, which the
    v > EPSILON filter drops)."""
    def err(sell, W, H):
        rows = sell.pair.rows
        v, wh = _stored(rows, SE.sddmm_ell(rows, W, H))
        return beta_grid(mesh, v, wh, W, H, beta, sell.shape)

    return err


def sum_v_sq(sell) -> torch.Tensor:
    """This rank's Σ v² over its tile (the caller sums over the mesh)."""
    return SE.sum_v_sq_ell(sell.pair.rows)
