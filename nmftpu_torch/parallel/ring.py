"""The ring engine on a 1-D rank mesh (port of ``nmftpu/parallel/ring.py``).

The 2-D grid engine (``parallel/updates.py``) is the default; this one is
the ring topology for a 1-D mesh or a very long item axis, the
ring-attention pattern with H's blocks in the key/value role:

* p ranks on the 'shards' axis; rank i owns W's row block i, H's column
  block i, and its row panel of V split into p column tiles
  (block-local indices), tile j of the panel in `RingCOO.tiles[j]`.
* W-side numerators (V Hᵀ and the like): H's blocks ROTATE around the
  ring (`mesh.ppermute`); at step s rank i holds block (i - s) mod p and
  consumes its matching tile, so after p steps every W block has seen
  every H block. The last rotation, which would only bring H home, is
  not sent: the rank still holds its own block.
* H-side numerators:
  - Frobenius and the ALS family need only Wᵀ V: a ring REDUCE. Each
    accumulator travels the ring, every rank adding its contribution to
    the block the accumulator is bound for; a final +2 rotation delivers
    every completed block to its owner (p > 2).
  - KL, beta and the weighted objective need the owner's H block too
    (the SDDMM ratio), so the (H block, accumulator) PAIR rotates; after
    p - 1 add-and-rotate steps one more rotation delivers.
* Grams (WᵀW, HHᵀ) and row and column sums are `psum`s over the ring.

Per iteration O(r·m) travels around the ring (2·r·m for the pair
rotation) plus r·n for the W side, more than the 2-D grid's
O((n/pu + m/pi)·r). The per-tile primitives are the scatter engine's
(``sparse_ops.v_ht / wt_v / sddmm``), as in ``nmftpu``: no ELL tiles and
no kernel.

Supported: MU (Frobenius, KL, generalized beta, confidence-weighted),
HALS, ALS/ACLS/AHCLS, iALS, GDCLS and nsNMF (both objectives). Selected
by ``compute_sharded(..., engine="ring")``.
"""

from __future__ import annotations

import dataclasses

import torch

from nmftpu_torch import sparse as host_sparse
from nmftpu_torch.config import Algorithm, Initialization, NmfConfig, Objective
from nmftpu_torch.init.strategies import run_seed
from nmftpu_torch.linalg import dense as D
from nmftpu_torch.linalg.dense import (
    _als_family_shifts,
    _beta_apply,
    beta_denom_h_blocked,
    beta_denom_w_blocked,
    row_solver,
)
from nmftpu_torch.parallel.init_sharded import block_generator
from nmftpu_torch.parallel.mesh import AXIS_RING, ppermute, psum
from nmftpu_torch.parallel.sharded_coo import ShardedCOO, partition_tiles
from nmftpu_torch.sparse_ops import (
    _beta_numer_values,
    _weighted_row_grams,
    col_sums,
    project_columns,
    sddmm,
    v_ht,
    wt_v,
)


@dataclasses.dataclass(frozen=True)
class RingCOO:
    """This rank's row panel of V as p column tiles, plus the layout
    every rank shares. The factor blocks are those of a (p, p) grid
    whose rank sits at (my, my): W's row block `my`, H's column block
    `my`."""

    tiles: tuple[ShardedCOO, ...]   # tile (my, j) at index j
    shape: tuple[int, int]
    nnz: int
    block_rows: int
    block_cols: int
    p: int
    my: int

    @property
    def mesh_shape(self) -> tuple[int, int]:
        return (self.p, self.p)

    @property
    def coords(self) -> tuple[int, int]:
        return (self.my, self.my)

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (self.p * self.block_rows, self.p * self.block_cols)

    def local(self, j: int):
        """Tile j of the panel as a block-shaped DeviceCOO."""
        return self.tiles[j].local()


def partition_for_ring(mat: host_sparse.SparseMatrix, p: int, my: int,
                       dtype=torch.float32, chunk: int = 8192,
                       balance: bool = True, seed: int = 0, device="cpu"):
    """Rank `my`'s row panel as p column tiles: the (p, p) grid
    partition with only the leading axis sharded (``nmftpu``'s tiles
    (my, 0..p-1), array for array). Returns (RingCOO, row_perm,
    col_perm)."""
    tiles, row_perm, col_perm = partition_tiles(
        mat, (p, p), [(my, j) for j in range(p)], dtype=dtype, chunk=chunk,
        balance=balance, seed=seed, device=device)
    t = tiles[0]
    return (RingCOO(tiles=tuple(tiles), shape=t.shape, nnz=t.nnz,
                    block_rows=t.block_rows,
                    block_cols=t.block_cols, p=p, my=my),
            row_perm, col_perm)


class _Ring:
    """The three ring dataflows over this rank's tiles, parameterized by
    per-tile contribution functions."""

    def __init__(self, mesh, op: RingCOO):
        self.mesh = mesh
        self.op = op
        self.p = op.p
        self.my = op.my

    def rot(self, x, shift=1):
        return ppermute(x, self.mesh, AXIS_RING, shift)

    def rotate_w(self, H, contrib):
        """Σ_j contrib(tile_j, H_j), H's blocks rotating: (block_rows, x)
        or a scalar."""
        p, my = self.p, self.my
        acc, H_rot = None, H
        for s in range(p):
            c = contrib(self.op.local((my - s) % p), H_rot)
            acc = c if acc is None else acc + c
            if s < p - 1:
                H_rot = self.rot(H_rot)
        return acc

    def reduce_h(self, contrib):
        """Ring reduce for H-side terms that need no H block: the
        accumulator bound for block b visits every rank once.
        contrib(tile_b) -> (x, block_cols) or (block_cols, x)."""
        p, my = self.p, self.my
        acc = contrib(self.op.local((my + 1) % p))
        for s in range(1, p):
            acc = self.rot(acc)
            acc = acc + contrib(self.op.local((my - s + 1) % p))
        # after the loop the accumulator bound for block my + 2 sits at
        # rank my, for every p: a +2 rotation delivers it
        return self.rot(acc, 2) if p > 2 else acc

    def pair_reduce_h(self, H, contrib):
        """Ring reduce where the contribution needs the destination H
        block (KL's ratio, the weighted SDDMM): the (H block,
        accumulator) pair rotates together. contrib(tile_j, H_j)."""
        p, my = self.p, self.my
        acc, H_rot = contrib(self.op.local(my), H), H
        for s in range(1, p):
            H_rot = self.rot(H_rot)
            acc = self.rot(acc)
            acc = acc + contrib(self.op.local((my - s) % p), H_rot)
        # the accumulator bound for block my + 1 sits at rank my
        return self.rot(acc)


def build_ring_update(config: NmfConfig, mesh):
    """The ring twin of ``updates.build_sharded_update``: (make_aux,
    update, effective_h); update(op, aux, W, H) is one iteration on this
    rank's blocks."""
    eps = config.eps
    alg, obj = config.algorithm, config.objective

    def ps(x):
        return psum(x, mesh, AXIS_RING)

    # ---- W half-steps (rotation) ---------------------------------------
    def w_fro(ring, W, H):
        numer = ring.rotate_w(H, v_ht)
        return W * (numer / (W @ ps(H @ H.T) + eps))

    def w_kl(ring, W, H):
        def contrib(l, h):
            return v_ht(l.with_values(l.values / (sddmm(l, W, h) + eps)), h)

        numer = ring.rotate_w(H, contrib)
        s_sum = ps(torch.sum(H, dim=1))
        return W * (numer / torch.clamp(s_sum, min=eps)[None, :])

    def w_beta(ring, W, H, beta):
        """One rotation carries both the powered-SDDMM numerator and the
        dense denominator's per-block panels (W h)^(β-1) hᵀ."""
        r = W.shape[1]
        blk = max(1, min(2048, H.shape[1]))

        def contrib(l, h):
            return torch.cat([v_ht(_beta_numer_values(l, W, h, beta), h),
                              beta_denom_w_blocked(W, h, beta, blk)], dim=1)

        both = ring.rotate_w(H, contrib)
        return _beta_apply(W, both[:, :r], both[:, r:], beta,
                           D.beta_gamma(beta))

    def w_weighted(ring, W, H, alpha):
        def contrib(l, h):
            cv = l.with_values(l.values * (1.0 + alpha * l.values))
            swh = l.with_values(l.values * sddmm(l, W, h))
            return torch.cat([v_ht(cv, h), v_ht(swh, h)], dim=1)

        both = ring.rotate_w(H, contrib)
        r = W.shape[1]
        numer, alpha_part = both[:, :r], both[:, r:]
        return W * (numer / (W @ ps(H @ H.T) + alpha * alpha_part + eps))

    def w_als(ring, W, H, shift, off):
        rhs = ring.rotate_w(H, v_ht)
        return D.solve_clamped(ps(H @ H.T), rhs.T, shift, off,
                               eps).T.contiguous()

    def w_hals(ring, W, H, l2, l1):
        eye = torch.eye(W.shape[1], dtype=W.dtype, device=W.device)
        XHt = ring.rotate_w(H, v_ht) - l1
        return D.hals_half_sweep(XHt, ps(H @ H.T) + l2 * eye, W)

    def w_als_weighted(ring, W, H, alpha, lam, solve):
        """iALS's W half: one rotation carries the per-row Gram deltas
        and the c ⊙ v right-hand sides, flattened into one (bn, r² + r)
        accumulator; the base Gram is a psum."""
        bn, r = W.shape

        def contrib(l, h):
            dg = _weighted_row_grams(l, h.T, alpha, bn).reshape(bn, r * r)
            cv = l.with_values(l.values * (1.0 + alpha * l.values))
            return torch.cat([dg, v_ht(cv, h).to(torch.float32)], dim=1)

        both = ring.rotate_w(H, contrib)
        G = ps((H @ H.T).to(torch.float32))
        out = solve(G, both[:, :r * r].reshape(bn, r, r), both[:, r * r:],
                    lam, eps, W.to(torch.float32))
        return out.to(W.dtype)

    # ---- H half-steps (ring reduce) ------------------------------------
    def h_fro(ring, W, H):
        numer = ring.reduce_h(lambda l: wt_v(l, W))
        return H * (numer / (ps(W.T @ W) @ H + eps))

    def h_kl(ring, W, H):
        def contrib(l, h):
            return wt_v(l.with_values(l.values / (sddmm(l, W, h) + eps)), W)

        numer = ring.pair_reduce_h(H, contrib)
        s_sum = ps(torch.sum(W, dim=0))
        return H * (numer / torch.clamp(s_sum, min=eps)[:, None])

    def h_beta(ring, W, H, beta):
        r = W.shape[1]
        blk = max(1, min(2048, W.shape[0]))

        def contrib(l, h):
            return torch.cat([wt_v(_beta_numer_values(l, W, h, beta), W),
                              beta_denom_h_blocked(W, h, beta, blk)], dim=0)

        both = ring.pair_reduce_h(H, contrib)
        return _beta_apply(H, both[:r], both[r:], beta, D.beta_gamma(beta))

    def h_weighted(ring, W, H, alpha):
        def contrib(l, h):
            cv = l.with_values(l.values * (1.0 + alpha * l.values))
            swh = l.with_values(l.values * sddmm(l, W, h))
            return torch.cat([wt_v(cv, W), wt_v(swh, W)], dim=0)

        both = ring.pair_reduce_h(H, contrib)
        r = W.shape[1]
        numer, alpha_part = both[:r], both[r:]
        return H * (numer / (ps(W.T @ W) @ H + alpha * alpha_part + eps))

    def h_als(ring, W, H, shift, off):
        rhs = ring.reduce_h(lambda l: wt_v(l, W))
        return D.solve_clamped(ps(W.T @ W), rhs, shift, off, eps)

    def h_hals(ring, W, H, l2, l1):
        eye = torch.eye(W.shape[1], dtype=W.dtype, device=W.device)
        XtW = ring.reduce_h(lambda l: wt_v(l, W)).T - l1
        return D.hals_half_sweep(XtW, ps(W.T @ W) + l2 * eye,
                                 H.T).T.contiguous()

    def h_als_weighted(ring, W, H, alpha, lam, solve):
        """iALS's H half: the per-column Gram deltas need only the
        resident W block, so one ring reduce carries the flattened
        (bm, r² + r) deltas and right-hand sides."""
        r, bm = H.shape

        def contrib(l):
            dg = _weighted_row_grams(l, W, alpha, bm,
                                     by_cols=True).reshape(bm, r * r)
            cv = l.with_values(l.values * (1.0 + alpha * l.values))
            return torch.cat([dg, wt_v(cv, W).T.to(torch.float32)], dim=1)

        both = ring.reduce_h(contrib)
        G = ps((W.T @ W).to(torch.float32))
        out = solve(G, both[:, :r * r].reshape(bm, r, r), both[:, r * r:],
                    lam, eps, H.T.to(torch.float32))
        return out.T.contiguous().to(H.dtype)

    # ---- assemble ------------------------------------------------------
    smoothed = False
    if alg is Algorithm.MU:
        if obj is Objective.FROBENIUS and config.alpha_confidence > 0.0:
            a = config.alpha_confidence
            upd_w = lambda g, W, H: w_weighted(g, W, H, a)  # noqa: E731
            upd_h = lambda g, W, H: h_weighted(g, W, H, a)  # noqa: E731
        elif obj is Objective.FROBENIUS:
            upd_w, upd_h = w_fro, h_fro
        elif obj is Objective.BETA:
            b = config.beta
            upd_w = lambda g, W, H: w_beta(g, W, H, b)  # noqa: E731
            upd_h = lambda g, W, H: h_beta(g, W, H, b)  # noqa: E731
        else:
            upd_w, upd_h = w_kl, h_kl
    elif alg is Algorithm.HALS:
        lw, lh, l1w, l1h = (config.lambda_w, config.lambda_h, config.l1_w,
                            config.l1_h)
        upd_w = lambda g, W, H: w_hals(g, W, H, lw, l1w)  # noqa: E731
        upd_h = lambda g, W, H: h_hals(g, W, H, lh, l1h)  # noqa: E731
    elif alg is Algorithm.ALS and config.alpha_confidence > 0.0:
        a, lw, lh = config.alpha_confidence, config.lambda_w, config.lambda_h
        solve = row_solver(config.als_solver, config.cg_steps)
        upd_w = lambda g, W, H: w_als_weighted(g, W, H, a, lw,  # noqa: E731
                                               solve)
        upd_h = lambda g, W, H: h_als_weighted(g, W, H, a, lh,  # noqa: E731
                                               solve)
    elif alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        sw, sh, ow, oh = _als_family_shifts(config)
        upd_w = lambda g, W, H: w_als(g, W, H, sw, ow)  # noqa: E731
        upd_h = lambda g, W, H: h_als(g, W, H, sh, oh)  # noqa: E731
    elif alg is Algorithm.GDCLS:
        lt = config.lambda_tik
        upd_w = w_fro
        upd_h = lambda g, W, H: h_als(g, W, H, lt, 0.0)  # noqa: E731
    elif alg is Algorithm.NSNMF:
        # the smoothed partners S H and W S take H's and W's places; the
        # rotated block S h_j equals rank j's own S h_j bit for bit
        smoothed = True
        fw, fh = (w_fro, h_fro) if obj is Objective.FROBENIUS else (w_kl,
                                                                    h_kl)

        def upd_w(g, W, H, S):
            SH = S @ H
            return fw(g, W, SH)

        def upd_h(g, W, H, S):
            return fh(g, W @ S, H)
    else:
        raise ValueError(f"ring engine does not support algorithm {alg}")

    order = config.update_order

    def update(op, aux, W, H):
        ring = _Ring(mesh, op)
        if order == "WH":
            W = upd_w(ring, W, H, *aux)
            H = upd_h(ring, W, H, *aux)
        else:
            H = upd_h(ring, W, H, *aux)
            W = upd_w(ring, W, H, *aux)
        return W, H

    if smoothed:
        def make_aux(op):
            v = op.tiles[0].values
            return (D.nsnmf_smoothing_matrix(config.rank, config.theta,
                                             dtype=v.dtype, device=v.device),)

        return make_aux, update, (lambda aux, H: aux[0] @ H)
    return (lambda op: ()), update, (lambda aux, H: H)


# ---------------------------------------------------------------------------
# Error metrics (the same scalar on every rank)
# ---------------------------------------------------------------------------


def build_ring_errors(mesh):
    """(frobenius(op, W, He, svsq), kl(op, W, He)) on the ring: the
    stored-set terms accumulate over one rotation of H, the Grams and
    sums are psums."""
    from nmftpu_torch.parallel.updates import kl_terms

    def frobenius(op, W, H, svsq):
        ring = _Ring(mesh, op)
        cross = psum(ring.rotate_w(
            H, lambda l, h: torch.sum(l.values * sddmm(l, W, h))), mesh,
            AXIS_RING)
        WtW = psum(W.T @ W, mesh, AXIS_RING)
        HHt = psum(H @ H.T, mesh, AXIS_RING)
        quad = torch.sum(WtW * HHt)
        return torch.sqrt(torch.clamp(svsq - 2.0 * cross + quad, min=0.0))

    def kl(op, W, H):
        ring = _Ring(mesh, op)
        total = psum(ring.rotate_w(
            H, lambda l, h: kl_terms(l.values, sddmm(l, W, h))), mesh,
            AXIS_RING)
        w_col = psum(torch.sum(W, dim=0), mesh, AXIS_RING)
        h_row = psum(torch.sum(H, dim=1), mesh, AXIS_RING)
        return total + w_col @ h_row

    return frobenius, kl


def _stored_terms(v, wh, beta):
    """The stored-set part of D_β on one tile, as ``updates.beta_grid``
    sums it: Σ v/wh - Σ log(v/wh) for β = 0, else
    Σ v^β - β Σ v wh^(β-1)
    (entries with v ≤ EPSILON, the padding among them, add nothing)."""
    keep = v > D.EPSILON
    wh_c = torch.clamp(wh, min=D.EPSILON)
    if beta == 0.0:
        div = (v / wh_c).to(torch.float32)
        return (torch.sum(torch.where(keep, div, 0.0))
                - torch.sum(torch.where(
                    keep, torch.log(torch.where(keep, div, 1.0)), 0.0)))
    return (torch.sum(torch.where(keep, (v ** beta).to(torch.float32), 0.0))
            - beta * torch.sum(torch.where(
                keep, (v * wh_c ** (beta - 1.0)).to(torch.float32), 0.0)))


def _masked_sum_wh_beta(W, h, rows, col0: int, m: int, beta: float):
    """Σ (W h)^β over the valid entries of one (block_rows, block_cols)
    block whose first column is `col0`, in column panels of 2048; pad
    rows (`rows` False) and columns (≥ m) are masked out."""
    bc = h.shape[1]
    acc = torch.zeros((), dtype=torch.float32, device=W.device)
    for s in range(0, bc, 2048):
        e = min(s + 2048, bc)
        WH = (W @ h[:, s:e]).to(torch.float32)
        cols = (col0 + s + torch.arange(e - s, device=W.device)) < m
        acc += torch.sum(torch.where(rows[:, None] & cols[None, :],
                                     WH ** beta, 0.0))
    return acc


def build_ring_beta_error(mesh, beta: float):
    """D_β(V || WH) on the ring, sklearn's sparse-X semantics (the twin
    of ``updates.build_sharded_beta_error``): the stored-set terms over
    one rotation of H, the zero-position term Σ (WH)^β over a second,
    padding rows and columns masked."""

    def err(op, W, H):
        ring = _Ring(mesh, op)
        n, m = op.shape
        rows = (op.my * op.block_rows
                + torch.arange(op.block_rows, device=W.device)) < n
        stored = psum(ring.rotate_w(
            H, lambda l, h: _stored_terms(l.values, sddmm(l, W, h), beta)),
            mesh, AXIS_RING)
        if beta == 0.0:
            return stored - float(n) * float(m)
        acc, H_rot = None, H
        for s in range(op.p):
            col0 = ((op.my - s) % op.p) * op.block_cols
            c = _masked_sum_wh_beta(W, H_rot, rows, col0, m, beta)
            acc = c if acc is None else acc + c
            if s < op.p - 1:
                H_rot = ring.rot(H_rot)
        swb = psum(acc, mesh, AXIS_RING)
        return (stored + (beta - 1.0) * swb) / (beta * (beta - 1.0))

    return err


# ---------------------------------------------------------------------------
# Data-dependent inits on the ring
# ---------------------------------------------------------------------------


def ring_data_init(config: NmfConfig, mesh, op: RingCOO, run_idx: int):
    """(W block, H block) of mean columns or a k-means init, in the ring's
    dataflows (``nmftpu``'s `build_ring_data_init`): the centroid row
    block stays on its rank, the per-column terms (column norms, cross
    terms, WᵀV) ring-reduce to their block's owner, and the one-hot
    assignment blocks rotate for the centroid sums. The shared draws and
    the random H block are the grid init's (``init_sharded``), so both
    equal the single-device init from the same draws."""
    from nmftpu_torch.parallel.init_sharded import extract_local_columns

    method, rank = config.init_method, config.rank
    n, m = op.shape
    bm, p, my = op.block_cols, op.p, op.my
    ring = _Ring(mesh, op)
    dtype, device = op.tiles[0].values.dtype, op.tiles[0].values.device
    shared = torch.Generator().manual_seed(run_seed(config.seed, run_idx))

    def over_tiles(contrib):
        """Σ_j contrib(tile_j, j) over this rank's resident tiles."""
        acc = contrib(op.local(0), 0)
        for j in range(1, p):
            acc = acc + contrib(op.local(j), j)
        return acc

    total = over_tiles(lambda l, j: torch.sum(l.values))
    mean_v = psum(total, mesh, AXIS_RING) / (float(n) * float(m))
    scale = torch.sqrt(torch.clamp(mean_v, min=1e-12) / rank).to(dtype)

    def rand_h():
        g = block_generator(config.seed, run_idx, "H", my, device)
        u = torch.rand((rank, bm), generator=g, dtype=dtype, device=device)
        return (u + 1e-4) * scale

    if method is Initialization.MEAN_COLUMNS:
        q = int(min(max(5, m // max(rank, 1)), m))
        cols = torch.randint(0, m, (rank, q), generator=shared).to(device)
        which = torch.arange(rank, device=device).repeat_interleave(q)

        def mc(local, j):
            # A[c, k] = (# times local column c was drawn for k) / q
            loc = cols.reshape(-1) - j * bm
            own = (loc >= 0) & (loc < bm)
            A = torch.zeros((bm, rank), dtype=dtype, device=device)
            A.index_put_((loc[own], which[own]),
                         torch.tensor(1.0 / q, dtype=dtype, device=device),
                         accumulate=True)
            return project_columns(local, A)

        return over_tiles(mc), rand_h()

    if method not in (Initialization.K_MEANS_AND_RANDOM_VALUES,
                      Initialization.K_MEANS_AND_NON_NEGATIVE_WTV,
                      Initialization.K_MEANS_AND_ABSOLUTE_WTV):
        raise ValueError(f"not a data-dependent init: {method}")
    seeds = torch.randperm(m, generator=shared)[:rank]
    centroids = over_tiles(
        lambda l, j: extract_local_columns(l, seeds, j * bm))     # (bn, r)
    col_sq = ring.reduce_h(
        lambda l: col_sums(l.with_values(l.values * l.values)))    # (bm,)
    real = (my * bm + torch.arange(bm, device=device)) < m

    def assign(C):
        cross = ring.reduce_h(lambda l: wt_v(l, C)).T              # (bm, r)
        cent_sq = psum(torch.sum(C * C, dim=0), mesh, AXIS_RING)
        d2 = col_sq[:, None] - 2.0 * cross + cent_sq[None, :]
        return torch.where(real, torch.argmin(d2, dim=1), rank)

    for _ in range(config.kmeans_max_iter):
        onehot = torch.nn.functional.one_hot(
            assign(centroids), rank + 1)[:, :rank].to(dtype)       # (bm, r)
        sums = ring.rotate_w(onehot, project_columns)              # (bn, r)
        counts = psum(torch.sum(onehot, dim=0), mesh, AXIS_RING)
        new = sums / torch.clamp(counts, min=1.0)[None, :]
        centroids = torch.where(counts[None, :] > 0, new, centroids)
    W = torch.clamp(centroids, min=0.0) + 1e-6
    if method is Initialization.K_MEANS_AND_RANDOM_VALUES:
        return W, rand_h()
    WtV = ring.reduce_h(lambda l: wt_v(l, W))                      # (r, bm)
    if method is Initialization.K_MEANS_AND_NON_NEGATIVE_WTV:
        return W, torch.clamp(WtV, min=0.0) + 1e-6
    return W, torch.abs(WtV) + 1e-6
