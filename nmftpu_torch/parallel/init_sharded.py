"""Data-dependent inits on the mesh (port of
``nmftpu/parallel/init_sharded.py``): mean columns and the k-means family
over V's columns, each rank on its own tile with summed centroid sums and
counts, so no rank ever holds a full factor.

Per Lloyd iteration on the (pu, pi) grid:

  cross    = psum_users( wt_v(tile, centroid block) )   -> (r, bm)
  labels   = argmin over r of ||v_col - c||^2           (rank-local)
  sums     = psum_items( tile · onehot )                -> (bn, r)
  counts   = psum_items( onehot column sums )
  new centroid block = sums / counts

The draws every rank must share (the seed columns, the mean-columns
samples) come from one CPU generator seeded from the config seed and the
run; the random H block of k-means-random from a generator seeded from
those and the rank's 'items' coordinate, so H is equal along 'users'.
Seed columns are global PERMUTED ids in [0, m): padding columns live in
[m, padded m) and are never drawn.
"""

from __future__ import annotations

import torch

from nmftpu_torch.config import Initialization, NmfConfig
from nmftpu_torch.init.strategies import run_seed
from nmftpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS, psum
from nmftpu_torch.sparse_ops import _chunks, col_sums, project_columns, wt_v

_BOTH = (AXIS_USERS, AXIS_ITEMS)


def block_generator(seed: int, run_idx: int, which: str, index: int,
                    device) -> torch.Generator:
    """The generator of factor `which` ("W" or "H") block `index` in a
    run: one stream per (seed, run, factor, block), so each factor is
    equal along the axis that replicates it."""
    g = torch.Generator(device=device)
    g.manual_seed((run_seed(seed, run_idx) * 64 + 2 * index
                   + (which == "H")) % 2**63)
    return g


def extract_local_columns(local, cols_global, offset: int) -> torch.Tensor:
    """(bn, k): the columns `cols_global` (k distinct global ids) of V,
    each from the tile whose column range [offset, offset + bm) holds
    it, zero elsewhere (the caller sums the tiles over 'items')."""
    bm = local.shape[1]
    device = local.values.device
    loc = torch.as_tensor(cols_global, device=device).long() - offset
    k = loc.shape[0]
    own = (loc >= 0) & (loc < bm)
    slot = torch.full((bm,), -1, dtype=torch.long, device=device)
    slot[loc[own]] = torch.arange(k, device=device)[own]
    acc = torch.zeros((local.shape[0], k), dtype=local.values.dtype,
                      device=device)
    flat = acc.view(-1)
    for v, rr, cc in _chunks(local):
        s = slot[cc.long()]
        flat.index_add_(0, rr.long() * k + torch.clamp(s, min=0),
                        torch.where(s >= 0, v, 0.0))
    return acc


def sharded_data_init(config: NmfConfig, mesh, scoo, run_idx: int):
    """(W block, H block) of mean columns or a k-means init on this
    rank's tile; the same blocks along each factor's replicated axis."""
    method, rank = config.init_method, config.rank
    n, m = scoo.shape
    bm = scoo.block_cols
    local = scoo.local()
    dtype, device = local.values.dtype, local.values.device
    iu, ii = scoo.coords
    shared = torch.Generator().manual_seed(run_seed(config.seed, run_idx))

    mean_v = psum(torch.sum(local.values), mesh, _BOTH) / (float(n) * float(m))
    scale = torch.sqrt(torch.clamp(mean_v, min=1e-12) / rank).to(dtype)

    def rand_h():
        g = block_generator(config.seed, run_idx, "H", ii, device)
        u = torch.rand((rank, bm), generator=g, dtype=dtype, device=device)
        return (u + 1e-4) * scale

    if method is Initialization.MEAN_COLUMNS:
        q = int(min(max(5, m // max(rank, 1)), m))
        cols = torch.randint(0, m, (rank, q), generator=shared).to(device)
        # A[j, k] = (# times local column j was drawn for k) / q; draws on
        # other item shards fall outside [0, bm) and are dropped
        loc = cols.reshape(-1) - ii * bm
        which = torch.arange(rank, device=device).repeat_interleave(q)
        own = (loc >= 0) & (loc < bm)
        A = torch.zeros((bm, rank), dtype=dtype, device=device)
        A.index_put_((loc[own], which[own]),
                     torch.tensor(1.0 / q, dtype=dtype, device=device),
                     accumulate=True)
        return psum(project_columns(local, A), mesh, AXIS_ITEMS), rand_h()

    if method not in (Initialization.K_MEANS_AND_RANDOM_VALUES,
                      Initialization.K_MEANS_AND_NON_NEGATIVE_WTV,
                      Initialization.K_MEANS_AND_ABSOLUTE_WTV):
        raise ValueError(f"not a data-dependent init: {method}")
    seeds = torch.randperm(m, generator=shared)[:rank]
    centroids = psum(extract_local_columns(local, seeds, ii * bm), mesh,
                     AXIS_ITEMS)                               # (bn, r)
    col_sq = psum(col_sums(local.with_values(local.values * local.values)),
                  mesh, AXIS_USERS)                            # (bm,)
    real = (ii * bm + torch.arange(bm, device=device)) < m

    def assign(centroids):
        cross = psum(wt_v(local, centroids), mesh, AXIS_USERS).T  # (bm, r)
        cent_sq = psum(torch.sum(centroids * centroids, dim=0), mesh,
                       AXIS_USERS)
        d2 = col_sq[:, None] - 2.0 * cross + cent_sq[None, :]
        # padding columns (empty) would all join one centroid and drag it
        # to zero: they take the out-of-range label `rank`
        return torch.where(real, torch.argmin(d2, dim=1), rank)

    for _ in range(config.kmeans_max_iter):
        # labels are equal on every rank of a users group (their inputs
        # are 'users' sums), so the counts need only the 'items' sum
        onehot = torch.nn.functional.one_hot(
            assign(centroids), rank + 1)[:, :rank].to(dtype)    # (bm, r)
        sums = psum(project_columns(local, onehot), mesh, AXIS_ITEMS)
        counts = psum(torch.sum(onehot, dim=0), mesh, AXIS_ITEMS)
        new = sums / torch.clamp(counts, min=1.0)[None, :]
        centroids = torch.where(counts[None, :] > 0, new, centroids)
    W = torch.clamp(centroids, min=0.0) + 1e-6

    if method is Initialization.K_MEANS_AND_RANDOM_VALUES:
        return W, rand_h()
    WtV = psum(wt_v(local, W), mesh, AXIS_USERS)               # (r, bm)
    if method is Initialization.K_MEANS_AND_NON_NEGATIVE_WTV:
        return W, torch.clamp(WtV, min=0.0) + 1e-6
    return W, torch.abs(WtV) + 1e-6
