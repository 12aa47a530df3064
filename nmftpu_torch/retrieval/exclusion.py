"""Block-bucketed seen-item exclusion for top-k serving and evaluation at
the 10M-item scale (port of ``nmftpu/retrieval/exclusion.py``; numpy
only).

A dense (batch, m) bool mask is O(batch·m). Instead the seen pairs are
bucketed BY SCORING BLOCK on the host (O(total_seen) work), giving two
small (nblocks, E) int32 arrays:

    ex_user[blk, j], ex_col[blk, j]  — the j-th excluded (batch-row,
    block-local column) of block blk, padded with -1.

Inside the scoring scan each block sets its own E entries to -inf; the
consumer (`retrieval.mips`) keeps only entries with a column >= 0, so the
padding never indexes anything. E is rounded up to a power of two, as in
``nmftpu``, so both packages build the same arrays.
"""

from __future__ import annotations

import numpy as np


def _round_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(x, 1)))))


def build_block_exclusion(user_ids, csr, m: int, block: int,
                          shards: int = 1):
    """Bucket each batch user's seen items by scoring block.

    user_ids: (b,) global user ids of the batch; csr: training
    interactions (SparseCSR-like with indptr/indices); m: item count;
    block: the scoring block size; shards: for the items-sharded path,
    the number of item shards (m must divide evenly): block indices are
    then per-shard-local, concatenated shard-major, and columns are
    shard-local, matching what each shard's blocked scan sees.

    Returns (ex_user, ex_col): (nblocks_total, E) int32, -1 padded.
    """
    user_ids = np.asarray(user_ids)
    if shards > 1 and m % shards != 0:
        raise ValueError(f"m={m} must divide into {shards} item shards")
    m_loc = m // shards
    eff_block = min(block, m_loc)
    nblocks_loc = (m_loc + eff_block - 1) // eff_block
    nblocks = nblocks_loc * shards

    b = len(user_ids)
    starts = np.asarray(csr.indptr)[user_ids]
    ends = np.asarray(csr.indptr)[user_ids + 1]
    counts = ends - starts
    total = int(counts.sum())
    if total == 0:
        return (np.full((nblocks, 1), -1, np.int32),
                np.full((nblocks, 1), -1, np.int32))

    rows = np.repeat(np.arange(b, dtype=np.int64), counts)
    pos = np.concatenate(
        [np.arange(s, e, dtype=np.int64)
         for s, e in zip(starts, ends) if e > s]
    )
    items = np.asarray(csr.indices)[pos].astype(np.int64)
    shard, loc = np.divmod(items, m_loc)
    blk_loc, col = np.divmod(loc, eff_block)
    blk = shard * nblocks_loc + blk_loc

    order = np.argsort(blk, kind="stable")
    blk_s, rows_s, col_s = blk[order], rows[order], col[order]
    blk_counts = np.bincount(blk_s, minlength=nblocks)
    E = _round_pow2(int(blk_counts.max()))
    offsets = np.concatenate([[0], np.cumsum(blk_counts)[:-1]])
    j = np.arange(total, dtype=np.int64) - offsets[blk_s]

    ex_user = np.full((nblocks, E), -1, np.int32)
    ex_col = np.full((nblocks, E), -1, np.int32)
    ex_user[blk_s, j] = rows_s
    ex_col[blk_s, j] = col_s
    return ex_user, ex_col
