"""Gather-based ELL sparse engine (port of ``nmftpu/sparse_ell.py``:
MU under Frobenius, KL and the beta divergence, confidence-weighted and
masked; the ALS family, GDCLS and nsNMF; iALS and masked completion ALS
on per-row Grams, built on the card by kernel #13 and bucket by bucket
off it).

* Each row of V is split into SEGMENTS of at most `seg_max` nonzeros, and
  segments are grouped into power-of-two-width BUCKETS, zero-padded to
  the bucket width (pad lanes are col 0, value 0).
* A segment's contribution Σ_k v_k · H[:, col_k] is a row gather plus a
  reduction; only the (num_segments, r) segment sums are scatter-added
  into rows (`index_add_` on `out_row`), about n + nnz/seg_max rows
  instead of nnz.
* The row-major container computes V Hᵀ; its twin built on Vᵀ computes
  (Wᵀ V)ᵀ. The SDDMM gathers both factor slices per nonzero.

The builder is ``nmftpu``'s: the native fill
(``native_loader.ell_build``) for float32 where ``native_loader.applies``
and the library is built, else the vectorised numpy path; both give
``nmftpu``'s buckets array for array. The containers hold tensors on one
device.
`_bucket_rowsums` here is plain torch; ``kernels/sparse_ell_kernel.py``
holds the hand-written CUDA kernels for the same per-segment sums, which
``nmftpu`` reaches only from MU-Frobenius with use_pallas, and for the
MU-KL numerator (`kl_numerator_ell`), which the port's single-device
engine runs on CUDA tensors with or without use_pallas.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmftpu_torch import native_loader
from nmftpu_torch import sparse as host_sparse
from nmftpu_torch.driver import _resolve_device
from nmftpu_torch.kernels import ell_gram as EG
from nmftpu_torch.linalg.dense import (
    EPSILON,
    _acc_dtype,
    _apply_order,
    _beta_apply,
    _pcg_clamped,
    beta_denom_h_blocked,
    beta_denom_w_blocked,
    beta_gamma,
    beta_sum_wh_blocked,
    row_solver,
    solve_clamped,
)
from nmftpu_torch.utils.metrics import span

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512)

# iALS's host counts (`utils.counters()` reports them as ``ials.<name>``):
# rows whose normal equations were solved, n + m an iteration, the
# segments folded into the per-row Grams, and the sparse products of the
# matrix-free CG half-steps (`cg_half_ell`, cg_steps + 1 a half-step)
IALS_COUNTS = {"rows_solved": 0, "gram_segments": 0, "cg_matvecs": 0}

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """Segments of uniform padded width. vals/cols: (nseg, width);
    out_row[s] = destination row of segment s (int32, non-decreasing)."""

    vals: torch.Tensor
    cols: torch.Tensor
    out_row: torch.Tensor
    width: int


@dataclasses.dataclass(frozen=True)
class EllRows:
    """Row-segmented ELL of a sparse matrix (for V Hᵀ style products).
    `cache` keeps what is derived once from the buckets (the per-row
    Grams' work units, ``kernels.ell_gram.units_of``)."""

    buckets: tuple
    shape: tuple[int, int]
    nnz: int
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)


@dataclasses.dataclass(frozen=True)
class EllPair:
    """Row-major ELL of V plus row-major ELL of Vᵀ: everything the MU
    family needs, gather-only."""

    rows: EllRows      # for V Hᵀ
    cols: EllRows      # ELL of Vᵀ, for (Wᵀ V)ᵀ = Vᵀ W

    @property
    def shape(self):
        return self.rows.shape


def _pad_segments(nseg: int, chunk_segments: int) -> int:
    """Segment count after padding: a bucket of more than
    `chunk_segments` segments rounds up to a multiple of it."""
    nseg_p = ((nseg + chunk_segments - 1) // chunk_segments) * (
        chunk_segments if nseg > chunk_segments else 1
    )
    return max(nseg_p, nseg)


def build_ell_rows(
    mat: host_sparse.SparseMatrix,
    dtype=torch.float32,
    seg_max: int = 512,
    buckets: tuple[int, ...] = DEFAULT_BUCKETS,
    chunk_segments: int = 2048,
    device=None,
) -> EllRows:
    """Host-side builder: CSR -> bucketed padded segments (one native pass,
    or O(nnz) numpy with no per-row Python loop), then one copy of each
    bucket to `device` (default "cuda"; raises without one). Columns
    within a segment are ascending; pad lanes are (col 0, val 0); the pad
    segments' out_row repeats the bucket's last row, so out_row stays
    non-decreasing."""
    device = _resolve_device(None, device)
    np_dtype = _NUMPY_DTYPES[dtype]
    csr = mat.to_csr()
    n, m = csr.shape
    if buckets[-1] < seg_max:
        raise ValueError(f"the widest bucket ({buckets[-1]}) is narrower "
                         f"than seg_max ({seg_max})")
    if csr.nnz and not (0 <= int(csr.indices.min())
                        and int(csr.indices.max()) < m):
        raise ValueError(f"column indices must lie in [0, {m})")

    def bucket(vals, cols, rows, width):
        return EllBucket(vals=torch.from_numpy(vals).to(device),
                         cols=torch.from_numpy(cols).to(device),
                         out_row=torch.from_numpy(rows).to(device),
                         width=int(width))

    if (dtype == torch.float32 and native_loader.applies(csr.data)
            and native_loader.has_ell_build()):
        nat = native_loader.ell_build(
            csr.indptr, csr.indices, csr.data, seg_max, buckets,
            pad_segments=lambda ns: _pad_segments(ns, chunk_segments))
        return EllRows(buckets=tuple(bucket(v, c, r, w)
                                     for v, c, r, _, w in nat),
                       shape=(n, m), nnz=csr.nnz)

    indptr = np.asarray(csr.indptr, dtype=np.int64)
    lens = np.diff(indptr)

    # one (row, offset, seg_len) triple per segment, all vectorised
    # (empty rows contribute no segments)
    nseg_row = (lens + seg_max - 1) // seg_max
    seg_row = np.repeat(np.arange(n, dtype=np.int64), nseg_row)
    starts = np.repeat(np.cumsum(nseg_row) - nseg_row, nseg_row)
    k_in_row = np.arange(seg_row.size, dtype=np.int64) - starts
    off = indptr[seg_row] + k_in_row * seg_max
    seg_len = np.minimum(indptr[seg_row + 1] - off, seg_max)

    widths = np.asarray(buckets, dtype=np.int64)
    which = np.searchsorted(widths, seg_len)       # smallest bucket >= len

    nnz_total = int(indptr[-1])
    out = []
    for bi, width in enumerate(buckets):
        sel = np.flatnonzero(which == bi)
        if sel.size == 0:
            continue
        nseg = sel.size
        nseg_p = _pad_segments(nseg, chunk_segments)
        pos = off[sel][:, None] + np.arange(width)[None, :]
        valid = np.arange(width)[None, :] < seg_len[sel][:, None]
        pos = np.where(valid, pos, 0).clip(0, max(nnz_total - 1, 0))
        vals = np.zeros((nseg_p, width), dtype=np_dtype)
        cols = np.zeros((nseg_p, width), dtype=np.int32)
        rows = np.zeros((nseg_p,), dtype=np.int32)
        if nnz_total:
            vals[:nseg] = np.where(valid, csr.data[pos], 0)
            cols[:nseg] = np.where(valid, csr.indices[pos], 0)
        rows[:nseg] = seg_row[sel]
        rows[nseg:] = rows[nseg - 1]
        out.append(bucket(vals, cols, rows, width))
    return EllRows(buckets=tuple(out), shape=(n, m), nnz=csr.nnz)


def build_ell_pair(mat: host_sparse.SparseMatrix, dtype=torch.float32,
                   **kw) -> EllPair:
    return EllPair(
        rows=build_ell_rows(mat, dtype=dtype, **kw),
        cols=build_ell_rows(mat.T, dtype=dtype, **kw),
    )


def _segment_blocks(nseg: int, chunk: int):
    """(start, stop) of consecutive blocks of at most `chunk` segments:
    the gathered (block, width, r) intermediate stays bounded."""
    return ((s, min(s + chunk, nseg)) for s in range(0, nseg, chunk))


def _rowsums(vals, cols, Ht, chunk: int, acc=None):
    """Σ_k vals[s, k] · Ht[cols[s, k], :] -> (nseg, r), over blocks of
    `chunk` segments, accumulated in `acc` (by default `_acc_dtype` of
    the table's)."""
    nseg, width = vals.shape
    r = Ht.shape[1]
    if acc is None:
        acc = _acc_dtype(Ht.dtype)
    out = torch.empty((nseg, r), dtype=acc, device=Ht.device)
    for s, e in _segment_blocks(nseg, chunk):
        g = Ht.index_select(0, cols[s:e].reshape(-1)).to(acc)
        gv = vals[s:e].reshape(-1, 1).to(acc) * g
        out[s:e] = gv.reshape(e - s, width, r).sum(dim=1)
    return out


def _bucket_rowsums(bucket: EllBucket, Ht, chunk: int, acc=None):
    """Per-segment Σ_k v_k · Ht[col_k, :] -> (nseg, r), scatter-free.
    Ht: the (m, r) row-major table."""
    return _rowsums(bucket.vals, bucket.cols, Ht, chunk, acc)


def v_ht_ell(ell: EllRows, H, chunk: int = 2048,
             gather_dtype=None) -> torch.Tensor:
    """V Hᵀ -> (n, r), in H's dtype. Gathers dominate; the only scatter
    is the per-segment row accumulation (`index_add_`; atomic, so
    unordered, on CUDA).

    gather_dtype optionally rounds the gathered table Hᵀ to that dtype
    (bfloat16, say); the sums then run in promote(gather_dtype, float32),
    and in float64 on a float64 run, which ``nmftpu`` would truncate to
    float32. This is the plain gather on every device: the ELL kernel
    (`kernels.sparse_ell_kernel`) is a separate entry and takes no
    gather_dtype."""
    gather_dtype = H.dtype if gather_dtype is None else gather_dtype
    Ht = H.T.to(gather_dtype).contiguous()
    acc = torch.promote_types(_acc_dtype(gather_dtype), H.dtype)
    out = torch.zeros((ell.shape[0], H.shape[0]), dtype=acc,
                      device=H.device)
    for bucket in ell.buckets:
        out.index_add_(0, bucket.out_row,
                       _bucket_rowsums(bucket, Ht, chunk, acc))
    return out.to(H.dtype)


def wt_v_ell(pair: EllPair, W, chunk: int = 2048) -> torch.Tensor:
    """Wᵀ V -> (r, m) via the transposed container: (Vᵀ W)ᵀ."""
    return v_ht_ell(pair.cols, W.T, chunk=chunk).T


def mu_update_frobenius_ell(pair: EllPair, W, H, eps=1e-9, order="WH"):
    """Sparse MU (Frobenius) on the gather-only layout."""

    def upd_w(W, H):
        return W * (v_ht_ell(pair.rows, H) / (W @ (H @ H.T) + eps))

    def upd_h(W, H):
        return H * (wt_v_ell(pair, W) / ((W.T @ W) @ H + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


def _bucket_sampled_rowsums(bucket: EllBucket, Ht, w_rows, coeff_fns,
                            chunk: int):
    """Fused SDDMM + per-value transform + SpMM for one bucket: gather
    g = Ht[cols] ONCE, sample s_k = <w_row, g_k>, then for each coeff fn
    emit seg = Σ_k fn(v, s)_k · g_k -> (nseg, r). Returns one (nseg, r)
    tensor per coeff fn."""
    nseg, width = bucket.vals.shape
    r = Ht.shape[1]
    acc = _acc_dtype(Ht.dtype)
    outs = [torch.empty((nseg, r), dtype=acc, device=Ht.device)
            for _ in coeff_fns]
    for s, e in _segment_blocks(nseg, chunk):
        g = Ht.index_select(0, bucket.cols[s:e].reshape(-1)).to(acc)
        g3 = g.reshape(e - s, width, r)
        samp = torch.einsum("sr,skr->sk", w_rows[s:e].to(acc), g3)
        v = bucket.vals[s:e].to(acc)
        for out, fn in zip(outs, coeff_fns):
            out[s:e] = torch.einsum("sk,skr->sr", fn(v, samp), g3)
    return tuple(outs)


def sampled_rowsums_ell(ell: EllRows, W, H, coeff_fns, chunk: int = 2048):
    """Fused gather-once 'transform(SDDMM) then SpMM' over a container:
    for each coeff fn, Σ_k fn(v, (WH)_nz)_k · H[:, col_k] accumulated
    into rows -> (n, r). W provides the row vectors sampled against the
    gathered table rows."""
    Ht = H.T.contiguous()
    n, r = ell.shape[0], H.shape[0]
    outs = [torch.zeros((n, r), dtype=_acc_dtype(H.dtype), device=H.device)
            for _ in coeff_fns]
    for bucket in ell.buckets:
        w_rows = W.index_select(0, bucket.out_row)
        segs = _bucket_sampled_rowsums(bucket, Ht, w_rows, coeff_fns, chunk)
        for o, s in zip(outs, segs):
            o.index_add_(0, bucket.out_row, s)
    return tuple(o.to(H.dtype) for o in outs)


def sddmm_ell(ell: EllRows, W, H, chunk: int = 2048) -> EllRows:
    """(W H) sampled at the nonzero positions, as an EllRows of the same
    structure whose vals are the sampled products (pad lanes hold
    W[row]·H[:, 0]; callers only use them multiplied by the stored
    values, which are 0 there)."""
    Ht = H.T.contiguous()
    new_buckets = []
    for bucket in ell.buckets:
        nseg, width = bucket.vals.shape
        w_rows = W.index_select(0, bucket.out_row)
        s = torch.empty((nseg, width), dtype=torch.promote_types(
            W.dtype, H.dtype), device=H.device)
        for a, b in _segment_blocks(nseg, chunk):
            g = Ht.index_select(0, bucket.cols[a:b].reshape(-1))
            s[a:b] = torch.einsum("sr,skr->sk", w_rows[a:b],
                                  g.reshape(b - a, width, -1))
        new_buckets.append(EllBucket(vals=s, cols=bucket.cols,
                                     out_row=bucket.out_row, width=width))
    return EllRows(buckets=tuple(new_buckets), shape=ell.shape, nnz=ell.nnz)


def map_values(ell: EllRows, fn) -> EllRows:
    """fn applied to the stored values of every bucket, the structure
    shared. Pad lanes hold fn(0): harmless wherever they are used only
    multiplied by a stored value, which is 0 there."""
    return EllRows(
        buckets=tuple(EllBucket(vals=fn(b.vals), cols=b.cols,
                                out_row=b.out_row, width=b.width)
                      for b in ell.buckets),
        shape=ell.shape, nnz=ell.nnz)


def combine_values(a: EllRows, b: EllRows, fn) -> EllRows:
    """fn(a's values, b's values) bucket by bucket, for two EllRows of
    the same structure (a's is kept)."""
    return EllRows(
        buckets=tuple(EllBucket(vals=fn(x.vals, y.vals), cols=x.cols,
                                out_row=x.out_row, width=x.width)
                      for x, y in zip(a.buckets, b.buckets)),
        shape=a.shape, nnz=a.nnz)


def kl_numerator_ell(ell: EllRows, own, table, eps=1e-9) -> torch.Tensor:
    """The MU-KL numerator of one half-step, Σ_k v_k / (<own[row],
    table[col_k]> + eps) · table[col_k] accumulated into rows -> (n, r):
    `sampled_rowsums_ell` with the ratio coefficient. own (n, r) holds
    the rows the segments sample against, table (m, r) the gathered
    rows."""
    numer, = sampled_rowsums_ell(ell, own, table.T,
                                 (lambda v, s: v / (s + eps),))
    return numer


def cg_product_ell(ell: EllRows, own, table, alpha) -> torch.Tensor:
    """The sparse term of every row's iALS system times one vector a row,
    Σ_k α · v_k · <own[row], table[col_k]> · table[col_k] accumulated into
    rows -> (n, r): `sampled_rowsums_ell` with that coefficient, the twin
    of #11's CG rule (``kernels.sparse_ell_kernel.ell_cg``). own (n, r)
    holds each row's vector, table (m, r) the gathered rows."""
    prod, = sampled_rowsums_ell(ell, own, table.T,
                                (lambda v, s: alpha * v * s,))
    return prod


def mu_update_kl_ell(pair: EllPair, W, H, eps=1e-9, order="WH",
                     numerator=kl_numerator_ell):
    """Sparse MU (KL): one fused gather-once ratio + SpMM per half-step
    (the table rows serve the (WH) sample AND the numerator).
    `numerator` computes it (`kl_numerator_ell`'s signature, own and
    table row-major; ``kernels.sparse_ell_kernel.ell_kl`` runs it on the
    CUDA kernel)."""

    def upd_w(W, H):
        numer = numerator(pair.rows, W.contiguous(), H.T.contiguous(),
                          eps)
        denom = torch.clamp(torch.sum(H, dim=1), min=eps)[None, :]
        return W * (numer / denom)

    def upd_h(W, H):
        # the container holds Vᵀ; sample (Hᵀ Wᵀ) = (WH)ᵀ at its nonzeros
        numer = numerator(pair.cols, H.T.contiguous(), W.contiguous(),
                          eps)
        denom = torch.clamp(torch.sum(W, dim=0), min=eps)[:, None]
        return H * (numer.T / denom)

    return _apply_order(upd_w, upd_h, W, H, order)


def beta_coef(beta):
    """Beta MU's per-nonzero numerator coefficient fn(v, s) = v·s^(β-2)
    of the sampled product s, in ``nmftpu``'s forms: β = 0 divides by
    s·s with s clamped up to EPSILON; β < 2 clamps s up to EPSILON,
    which keeps the pad lanes' sampled products finite (their v = 0, so
    they add exact zeros)."""
    if beta == 0.0:
        def cf(v, s):
            sc = torch.clamp(s, min=EPSILON)
            return v / (sc * sc)
    elif beta < 2.0:
        def cf(v, s):
            return v * torch.clamp(s, min=EPSILON) ** (beta - 2.0)
    else:
        def cf(v, s):
            return v * s ** (beta - 2.0)
    return cf


def mu_update_beta_ell(pair: EllPair, W, H, beta, eps=1e-9, order="WH",
                       block=2048):
    """Generalized beta-divergence MU on the gather-only layout: the
    numerator is one fused gather-once pass per half-step
    (`sampled_rowsums_ell` with the coefficient v·(WH)^(β-2)), the
    dense-in-FLOPs denominator streams panels
    (``linalg.dense.beta_denom_w_blocked`` / ``_h_blocked``). Guards, γ
    and the β < 1 stabilization are sklearn's; the coefficient is
    `beta_coef`'s. `eps` is accepted for the update signature and
    unused."""
    gamma = beta_gamma(beta)
    cf = beta_coef(beta)

    def upd_w(W, H):
        numer, = sampled_rowsums_ell(pair.rows, W, H, (cf,))
        return _beta_apply(W, numer, beta_denom_w_blocked(W, H, beta, block),
                           beta, gamma)

    def upd_h(W, H):
        numer, = sampled_rowsums_ell(pair.cols, H.T, W.T, (cf,))
        return _beta_apply(H, numer.T,
                           beta_denom_h_blocked(W, H, beta, block), beta,
                           gamma)

    return _apply_order(upd_w, upd_h, W, H, order)


def beta_divergence_ell(pair: EllPair, W, H, beta, block=2048):
    """D_β(V || WH) with sklearn's sparse-X semantics on ELL (the twin of
    ``sparse_ops.beta_divergence_sparse``; pad lanes carry v = 0 and the
    v > EPSILON filter drops them)."""
    s = sddmm_ell(pair.rows, W, H)
    acc_dt = _acc_dtype(W.dtype)
    n, m = pair.shape
    # β = 0: Σ v/wh and Σ log(v/wh); otherwise Σ v^β and Σ v·wh^(β-1)
    sum_a = sum_b = torch.zeros((), dtype=acc_dt, device=W.device)
    for orig, samp in zip(pair.rows.buckets, s.buckets):
        v = orig.vals
        keep = v > EPSILON
        wh_c = torch.clamp(samp.vals, min=EPSILON)
        if beta == 0.0:
            div = (v / wh_c).to(acc_dt)
            sum_a = sum_a + torch.sum(torch.where(keep, div, 0.0))
            sum_b = sum_b + torch.sum(torch.where(
                keep, torch.log(torch.where(keep, div, 1.0)), 0.0))
        else:
            sum_a = sum_a + torch.sum(torch.where(
                keep, (v ** beta).to(acc_dt), 0.0))
            sum_b = sum_b + torch.sum(torch.where(
                keep, (v * wh_c ** (beta - 1.0)).to(acc_dt), 0.0))
    if beta == 0.0:
        return sum_a - float(n) * float(m) - sum_b
    res = (sum_a - beta * sum_b
           + (beta - 1.0) * beta_sum_wh_blocked(W, H, beta, block))
    return res / (beta * (beta - 1.0))


def mu_update_frobenius_weighted_ell(pair: EllPair, W, H, alpha, eps=1e-9,
                                     order="WH"):
    """Confidence-weighted MU (c = 1 + alpha·v at the nonzeros, 1
    elsewhere) on ELL: one gather per half-step serves the numerator
    (C⊙V)Hᵀ and the alpha part of the denominator, (V⊙WH)_nz Hᵀ; the
    unit part is the Gram product W (H Hᵀ)."""
    fns = (
        lambda v, s: v * (1.0 + alpha * v),   # C⊙V at the nonzeros
        lambda v, s: v * s,                   # V⊙(WH) at the nonzeros
    )

    def upd_w(W, H):
        numer, alpha_part = sampled_rowsums_ell(pair.rows, W, H, fns)
        denom = W @ (H @ H.T) + alpha * alpha_part + eps
        return W * (numer / denom)

    def upd_h(W, H):
        numer, alpha_part = sampled_rowsums_ell(pair.cols, H.T, W.T, fns)
        denom = (W.T @ W) @ H + alpha * alpha_part.T + eps
        return H * (numer.T / denom)

    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# The ALS family, GDCLS and nsNMF on the gather-only layout (``nmftpu``
# runs them on its gathers, not on the ELL kernel)
# ---------------------------------------------------------------------------


def als_family_update_ell(pair: EllPair, W, H, shift_w=0.0, shift_h=0.0,
                          off_w=0.0, off_h=0.0, eps=1e-9, order="WH"):
    """ALS / ACLS / AHCLS on the gather-only layout: the right-hand sides
    are the two ELL SpMMs, the r x r solves exact
    (``linalg.dense.solve_clamped``)."""

    def upd_w(W, H):
        rhs = v_ht_ell(pair.rows, H).T                    # (r, n)
        return solve_clamped(H @ H.T, rhs, shift_w, off_w, eps).T

    def upd_h(W, H):
        return solve_clamped(W.T @ W, wt_v_ell(pair, W), shift_h, off_h, eps)

    return _apply_order(upd_w, upd_h, W, H, order)


def gdcls_update_ell(pair: EllPair, W, H, lambda_tik=0.0, eps=1e-9,
                     order="WH"):
    """GDCLS on ELL: the Frobenius MU step for W, the Tikhonov solve for
    H."""

    def upd_w(W, H):
        return W * (v_ht_ell(pair.rows, H) / (W @ (H @ H.T) + eps))

    def upd_h(W, H):
        return solve_clamped(W.T @ W, wt_v_ell(pair, W), lambda_tik, 0.0, eps)

    return _apply_order(upd_w, upd_h, W, H, order)


def nsnmf_update_kl_ell(pair: EllPair, W, H, S, eps=1e-9, order="WH"):
    """nsNMF under KL on ELL: fused gather-once ratio + SpMM half-steps
    (`sampled_rowsums_ell`) against the smoothed partners (S H stands in
    for H, W S for W)."""
    ratio = (lambda v, s: v / (s + eps),)

    def upd_w(W, H):
        SH = S @ H
        numer, = sampled_rowsums_ell(pair.rows, W, SH, ratio)
        denom = torch.clamp(torch.sum(SH, dim=1), min=eps)[None, :]
        return W * (numer / denom)

    def upd_h(W, H):
        WS = W @ S
        numer, = sampled_rowsums_ell(pair.cols, H.T, WS.T, ratio)
        denom = torch.clamp(torch.sum(WS, dim=0), min=eps)[:, None]
        return H * (numer.T / denom)

    return _apply_order(upd_w, upd_h, W, H, order)


def nsnmf_update_ell(pair: EllPair, W, H, S, eps=1e-9, order="WH"):
    """nsNMF (Frobenius) on ELL: MU against the smoothed partners."""

    def upd_w(W, H):
        SH = S @ H
        return W * (v_ht_ell(pair.rows, SH) / (W @ (SH @ SH.T) + eps))

    def upd_h(W, H):
        WS = W @ S
        return H * (wt_v_ell(pair, WS) / ((WS.T @ WS) @ H + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# Masked completion (mask="observed") on the gather-only layout. The
# observed set is the stored set, so the 0/1 mask is `vals != 0`, which
# also drops the pad lanes.
# ---------------------------------------------------------------------------


def mu_update_frobenius_masked_ell(pair: EllPair, W, H, eps=1e-9,
                                   order="WH"):
    """Completion MU under Σ_obs (v - wh)² on ELL (the semantics of
    ``sparse_ops.mu_update_frobenius_masked``):

        W <- W ⊙ (V_obs Hᵀ) / ((WH)_obs Hᵀ + eps)

    one gather per half-step for the numerator, the sample and the
    masked denominator."""
    fns = (
        lambda v, s: v,                                   # V_obs
        lambda v, s: torch.where(v != 0, s, 0.0),         # (WH)_obs
    )

    def upd_w(W, H):
        numer, den = sampled_rowsums_ell(pair.rows, W, H, fns)
        return W * (numer / (den + eps))

    def upd_h(W, H):
        numer, den = sampled_rowsums_ell(pair.cols, H.T, W.T, fns)
        return H * (numer.T / (den.T + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


def mu_update_kl_masked_ell(pair: EllPair, W, H, eps=1e-9, order="WH"):
    """Masked KL MU on ELL: the ratio SpMM over the observed row/column
    mass of the partner factor (the SpMM of the 0/1 mask), both from one
    gather."""
    fns = (
        lambda v, s: v / (s + eps),                       # ratio
        lambda v, s: (v != 0).to(s.dtype),                # mask
    )

    def upd_w(W, H):
        numer, den = sampled_rowsums_ell(pair.rows, W, H, fns)
        return W * (numer / (den + eps))

    def upd_h(W, H):
        numer, den = sampled_rowsums_ell(pair.cols, H.T, W.T, fns)
        return H * (numer.T / (den.T + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


def frobenius_error_masked_ell(pair: EllPair, W, H) -> torch.Tensor:
    """sqrt(Σ_obs (v - wh)²), as ``sparse_ops.frobenius_error_masked``."""
    s = sddmm_ell(pair.rows, W, H)
    total = torch.zeros((), dtype=_acc_dtype(W.dtype), device=W.device)
    for orig, samp in zip(pair.rows.buckets, s.buckets):
        resid = torch.where(orig.vals != 0, orig.vals - samp.vals, 0.0)
        total = total + torch.sum(resid * resid)
    return torch.sqrt(total)


def kl_error_masked_ell(pair: EllPair, W, H, eps=1e-12) -> torch.Tensor:
    """Σ_obs v log(v/wh) - v + wh over the observed set only."""
    s = sddmm_ell(pair.rows, W, H)
    total = torch.zeros((), dtype=_acc_dtype(W.dtype), device=W.device)
    for orig, samp in zip(pair.rows.buckets, s.buckets):
        v = orig.vals
        wh = torch.clamp(samp.vals, min=eps)
        term = v * torch.log(torch.clamp(v, min=eps) / wh) - v + wh
        total = total + torch.sum(torch.where(v != 0, term, 0.0))
    return total


def sum_v_sq_ell(ell: EllRows) -> torch.Tensor:
    """||V||_F² from the stored (zero-padded) values."""
    return sum(torch.sum(b.vals * b.vals) for b in ell.buckets)


def frobenius_error_ell(pair: EllPair, W, H, sum_v_sq=None,
                        wt_v=wt_v_ell) -> torch.Tensor:
    """Gram-trick ||V - WH||_F using the gather-only Wᵀ V, computed by
    `wt_v(pair, W)` (the kernel path passes its own)."""
    if sum_v_sq is None:
        sum_v_sq = sum_v_sq_ell(pair.rows)
    cross = torch.sum(wt_v(pair, W) * H)
    quad = torch.sum((W.T @ W) * (H @ H.T))
    return torch.sqrt(torch.clamp(sum_v_sq - 2.0 * cross + quad, min=0.0))


def kl_error_ell(pair: EllPair, W, H, eps=1e-12) -> torch.Tensor:
    """D_KL(V || WH) with the nonzero log terms sampled by the SDDMM."""
    s = sddmm_ell(pair.rows, W, H)
    total = torch.zeros((), dtype=_acc_dtype(W.dtype), device=W.device)
    for orig, samp in zip(pair.rows.buckets, s.buckets):
        v = orig.vals
        term = torch.where(
            v > 0,
            v * torch.log(torch.clamp(v, min=eps)
                          / torch.clamp(samp.vals, min=eps)),
            0.0,
        )
        total = total + torch.sum(term) - torch.sum(v)
    return total + torch.sum(W, dim=0) @ torch.sum(H, dim=1)


# ---------------------------------------------------------------------------
# Per-row weighted Grams on ELL: the iALS / masked-ALS hot path. On the card
# one launch of #13 (``kernels/ell_gram.py``) builds every row's Gram and
# right-hand side; the plain path makes each bucket's Gram contributions
# one batched product over the gathered rows, (block, r, w) x (block, w,
# r), and scatter-adds only the (block, r, r) segment results into rows
# (about n + nnz/seg_max of them) instead of one (r, r) outer product per
# nonzero.
# ---------------------------------------------------------------------------


def _bucket_grams_rhs(bucket: EllBucket, Ht, weight_fn, value_fn, chunk):
    """Per block of at most `chunk` segments: (first, last, Σ_k wgt_k
    t_k t_kᵀ (block, r, r), Σ_k val_k t_k (block, r)), both from ONE
    gather of the table rows t = Ht[cols]."""
    nseg, width = bucket.vals.shape
    r = Ht.shape[1]
    acc = _acc_dtype(Ht.dtype)
    for s, e in _segment_blocks(nseg, chunk):
        g3 = Ht.index_select(0, bucket.cols[s:e].reshape(-1)).to(acc) \
            .reshape(e - s, width, r)
        v = bucket.vals[s:e]
        wgt = weight_fn(v).to(acc)                        # (block, w)
        gram = torch.bmm((g3 * wgt[:, :, None]).transpose(1, 2), g3)
        rhs = torch.bmm(value_fn(v).to(acc)[:, None, :], g3)[:, 0]
        yield s, e, gram, rhs


def grams_and_rhs_ell(ell: EllRows, Ht, weight_fn, value_fn,
                      chunk: int = 1024, rule=None):
    """((n, r, r), (n, r)) float32: per row Σ weight(v) · t tᵀ (full and
    symmetric) and Σ value(v) · t over the stored set. Ht is the (m, r)
    row-major table (Hᵀ for the W half, W for the H half on the
    transposed container). Pad lanes hold v = 0, so a weight and a value
    with f(0) = 0 drop them.

    `rule` (a ``kernels.ell_gram.GramRule``, whose `weight` and `value`
    the caller passes as `weight_fn` and `value_fn`) lets the card take
    the kernel: for a CUDA float32 table and float32 values at r <= 128
    (``ell_gram.takes``) one launch of #13 builds every row's result in
    registers and writes it once (a second launch adds the partial sums
    of rows longer than one unit). Anything else takes the plain path:
    each block of `chunk` segments is gathered, weighted, multiplied by
    one `bmm` and added to its rows by `index_add_` as it is made, so no
    bucket-sized (nseg, r, r) array exists."""
    Ht = Ht.contiguous()
    n, r = ell.shape[0], Ht.shape[1]
    if rule is not None and EG.takes(Ht.device, Ht.dtype, r) and all(
            b.vals.dtype == torch.float32 for b in ell.buckets):
        return EG.grams_rhs(ell, Ht, rule)
    acc = _acc_dtype(Ht.dtype)
    grams = torch.zeros((n, r, r), dtype=acc, device=Ht.device)
    rhs = torch.zeros((n, r), dtype=acc, device=Ht.device)
    for bucket in ell.buckets:
        for s, e, gseg, rseg in _bucket_grams_rhs(bucket, Ht, weight_fn,
                                                  value_fn, chunk):
            grams.index_add_(0, bucket.out_row[s:e], gseg)
            rhs.index_add_(0, bucket.out_row[s:e], rseg)
    return grams.to(torch.float32), rhs.to(torch.float32)


def _cg_values(ell: EllRows, alpha, dtype):
    """The container with its stored values v mapped to the right-hand
    side's c·v = v(1 + αv) and to the weight αv, in `dtype`, kept in
    `ell.cache` for the CG half-steps of one alpha."""
    key = ("cg_values", float(alpha), dtype)
    if key not in ell.cache:
        rule = EG.ials_rule(alpha)
        ell.cache[key] = tuple(map_values(ell, lambda v: fn(v).to(dtype))
                               for fn in (rule.value, rule.weight))
    return ell.cache[key]


def cg_half_ell(ell: EllRows, table, x0, shift, eps, alpha, steps=3,
                product=cg_product_ell, spmm=v_ht_ell):
    """One iALS half-step's rows (n, r), clamped at 0, by `steps`
    warm-started Jacobi-preconditioned CG steps from x0 without forming a
    row's (r, r) system: `linalg.dense._pcg_clamped` (the iteration of
    `_batched_solve_clamped_cg`, with its ridge) on

        A_u p = G p + Σ_{i∈u} α v_ui (t_i · p) t_i + ridge_u p,

    G = tableᵀ table the base Gram. The right-hand sides Σ v(1 + αv) t_i
    and the diagonals diag(G) + Σ αv t_i² are `spmm` (V Hᵀ) products over
    the container with mapped values (`_cg_values`), the ridge shift +
    eps + max(eps, 100 machine eps) times each row's mean diagonal; each
    of the steps + 1 products A·p takes its sparse term from `product`
    (`cg_product_ell`'s arguments). The engine passes the kernel routes,
    ``kernels.sparse_ell_kernel.ell_cg`` (#11's CG rule) and
    ``v_ht_ell_pallas`` (#10), as it passes `mu_update_kl_ell` its
    numerator. Everything runs in the table's dtype. Two spans:
    ``nmftpu.ials.rhs`` (G, the right-hand sides and the diagonal) and
    ``nmftpu.ials.cg`` (the steps)."""
    table = table.contiguous()
    r, dtype = table.shape[1], table.dtype
    with span("nmftpu.ials.rhs"):
        G = table.T @ table
        by_value, by_weight = _cg_values(ell, alpha, dtype)
        rhs = spmm(by_value, table.T)
        diag = spmm(by_weight, (table * table).T)
        diag += torch.diagonal(G)[None, :]
        rel_floor = 100.0 * torch.finfo(dtype).eps
        ridge = shift + eps + max(eps, rel_floor) * (
            diag.sum(1, keepdim=True) / r)
        dinv = 1.0 / torch.clamp(diag + ridge, min=torch.finfo(dtype).tiny)
        del diag

    def matvec(p):
        Ap = product(ell, p, table, alpha)
        Ap.addmm_(p, G)
        return Ap.addcmul_(ridge, p)

    with span("nmftpu.ials.cg"):
        x = _pcg_clamped(matvec, dinv, rhs, x0.to(dtype).contiguous(), steps)
        IALS_COUNTS["cg_matvecs"] += steps + 1
        return x


def als_update_weighted_ell_exact(pair: EllPair, W, H, alpha, lambda_w=0.0,
                                  lambda_h=0.0, eps=1e-9, order="WH",
                                  solver="exact", cg_steps=3,
                                  product=cg_product_ell, spmm=v_ht_ell):
    """iALS on the gather-only layout, the math of
    ``sparse_ops.als_update_weighted_sparse`` (the scatter engine): per
    row the weighted normal equations

        (H Hᵀ + Σ_{i∈u} αv_ui h_i h_iᵀ + (λ + eps) I) w_u = H (c_u ⊙ v_u)

    in float32, whatever the factors' dtype. The exact solver builds the
    Gram deltas AND the right-hand sides in one pass over the stored set
    (`grams_and_rhs_ell`: #13 on the card) and solves them with
    ``linalg.dense.row_solver``: two spans a half-step,
    ``nmftpu.ials.grams`` (the base Gram and every row's Gram delta and
    right-hand side) and ``nmftpu.ials.solve`` (the rows' solves). The cg
    solver forms no row's system: `cg_half_ell`, matrix-free, on
    `product` and `spmm`, with its spans ``nmftpu.ials.rhs`` and
    ``nmftpu.ials.cg``. Each half-step counts its rows in `IALS_COUNTS`,
    and the segments of the Grams it built."""
    rule = EG.ials_rule(alpha)

    def half(ell, table, x0, shift):
        """The rows of one side, solved from the other side's `table`
        ((m, r) row-major for the W half), warm-started at x0."""
        if solver == "cg":
            out = cg_half_ell(ell, table.to(torch.float32), x0, shift, eps,
                              alpha, cg_steps, product, spmm)
        else:
            with span("nmftpu.ials.grams"):
                G = (table.T @ table).to(torch.float32)
                dG, rhs = grams_and_rhs_ell(ell, table, rule.weight,
                                            rule.value, rule=rule)
            with span("nmftpu.ials.solve"):
                out = row_solver(solver)(G, dG, rhs, shift, eps, x0)
            IALS_COUNTS["gram_segments"] += sum(b.vals.shape[0]
                                                for b in ell.buckets)
        IALS_COUNTS["rows_solved"] += ell.shape[0]
        return out

    def upd_w(W, H):
        return half(pair.rows, H.T, W, lambda_w).to(W.dtype)

    def upd_h(W, H):
        return half(pair.cols, W, H.T, lambda_h).T.contiguous().to(H.dtype)

    return _apply_order(upd_w, upd_h, W, H, order)


def als_update_masked_ell(pair: EllPair, W, H, lambda_w=0.0, lambda_h=0.0,
                          eps=1e-9, order="WH", solver="exact", cg_steps=3):
    """Completion ALS on ELL: the observed-only normal equations per row
    (0/1 weight, no base Gram), the semantics of
    ``sparse_ops.als_update_masked_sparse``."""
    solve = row_solver(solver, cg_steps)
    rule = EG.MASKED

    def upd_w(W, H):
        dG, rhs = grams_and_rhs_ell(pair.rows, H.T, rule.weight, rule.value,
                                    rule=rule)
        return solve(None, dG, rhs, lambda_w, eps, W).to(W.dtype)

    def upd_h(W, H):
        dG, rhs = grams_and_rhs_ell(pair.cols, W, rule.weight, rule.value,
                                    rule=rule)
        return solve(None, dG, rhs, lambda_h, eps, H.T).T.contiguous().to(
            H.dtype)

    return _apply_order(upd_w, upd_h, W, H, order)
