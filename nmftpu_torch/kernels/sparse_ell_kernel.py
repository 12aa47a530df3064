"""ELL sparse-times-dense product as a hand-written CUDA kernel (port of
``nmftpu/kernels/sparse_ell_kernel.py``).

One launch computes a whole product (``csrc/ell_rowsums.cu``): for every
padded segment of every `EllBucket` it gathers table rows by column
index, scales them by the stored values, reduces the segment in
registers and adds the sum straight into the segment's row of the zeroed
(n, r) output with vector atomics, so neither the (nseg, r) segment sums
nor a per-bucket ``index_add_`` reach device memory. The buckets are
passed by value, widest first (`descriptor_order`); half a warp takes a
segment, and a warp ballot skips the lanes whose value is 0 (pad lanes,
all-zero pad segments). The kernel accumulates in the table's type,
float32 or float64 (``nmftpu``'s Pallas kernel sums in float32 even
under a float64 configuration; ROADMAP queue 3).

Not carried over from the TPU version: the VMEM table budget
(``table_fits``, ``spmm_supported``), the one-step grid and the scan over
segment groups, so the functions here take no `chunk` or `interpret`
arguments.

`ell_spmm_plain` is the launch's function in torch (the buckets in
descriptor order, each segment's sum added into its row);
`ell_spmm` runs it only for CPU tensors, and for CUDA tensors launches
the kernel or raises. `bucket_rowsums` (segment sums alone, the same
launch with each segment as its own row) keeps its twin
`bucket_rowsums_plain`. ``LAUNCHES`` counts kernel launches: one per
product for up to `MAX_BUCKETS` buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from nmftpu_torch.kernels import _build
from nmftpu_torch.kernels.dense_mu import _on_cpu
from nmftpu_torch.linalg.dense import _apply_order
from nmftpu_torch.sparse_ell import EllBucket, _rowsums

LAUNCHES = {"ell_rowsums": 0}

_ENTRIES = {
    torch.float32: "nmftpu_ell_spmm_f32",
    torch.float64: "nmftpu_ell_spmm_f64",
}

# the bucket descriptors one launch takes (nmftpu's default widths are 7)
MAX_BUCKETS = 8


def _check_shapes(vals, cols, Ht):
    if vals.ndim != 2 or Ht.ndim != 2 or cols.shape != vals.shape:
        raise ValueError(
            "bucket_rowsums: expected vals and cols (nseg, w) and Ht (m, r);"
            f" got vals {tuple(vals.shape)}, cols {tuple(cols.shape)}, "
            f"Ht {tuple(Ht.shape)}"
        )


def _check_cuda_operands(vals, cols, Ht):
    """What the CUDA entries take: float32 or float64 vals and table of
    one type, int32 cols, all contiguous, every extent in [1, 2**31)."""
    _check_shapes(vals, cols, Ht)
    if Ht.dtype not in _ENTRIES or vals.dtype != Ht.dtype:
        raise TypeError(
            "bucket_rowsums: vals and Ht must both be float32 or both "
            f"float64, got {vals.dtype} and {Ht.dtype}"
        )
    if cols.dtype != torch.int32:
        raise TypeError(f"bucket_rowsums: cols must be int32, got "
                        f"{cols.dtype}")
    for name, t in (("vals", vals), ("cols", cols), ("Ht", Ht)):
        if not t.is_contiguous():
            raise ValueError(f"bucket_rowsums: {name} must be contiguous")
    (m, r), w = Ht.shape, vals.shape[1]
    if min(m, r, w) < 1 or max(m, r, w) >= 2**31:
        raise ValueError(f"bucket_rowsums: extents must lie in [1, 2**31), "
                         f"got m={m}, r={r}, w={w}")


def descriptor_order(buckets):
    """The buckets in the order one launch takes them: widest first (ties
    keep their order), so the longest segments start first and do not
    form the tail of the launch."""
    return sorted(buckets, key=lambda b: -b.vals.shape[1])


def ell_spmm_plain(buckets, Ht, out):
    """The launch's function in torch: each bucket's segment sums
    (`bucket_rowsums_plain`) added into out[out_row], in place, buckets in
    `descriptor_order`. The kernel skips lanes whose value is 0, which on
    a finite table changes no sum. Returns `out`."""
    for b in descriptor_order(buckets):
        out.index_add_(0, b.out_row, bucket_rowsums_plain(
            b.vals, b.cols, Ht).to(out.dtype))
    return out


def _check_launch(buckets, Ht, out):
    for b in buckets:
        _check_cuda_operands(b.vals, b.cols, Ht)
        if b.out_row.dtype != torch.int32 or b.out_row.shape != (
                b.vals.shape[0],) or not b.out_row.is_contiguous():
            raise ValueError("ell_spmm: out_row must be a contiguous int32 "
                             "(nseg,) tensor")
    if (out.dtype != Ht.dtype or out.ndim != 2
            or out.shape[1] != Ht.shape[1] or not out.is_contiguous()):
        raise ValueError(
            f"ell_spmm: out must be a contiguous (n, {Ht.shape[1]}) "
            f"{Ht.dtype} tensor, got {tuple(out.shape)} {out.dtype}")


def ell_spmm(buckets, Ht, out):
    """Add every segment's Σ_k vals[s, k] · Ht[cols[s, k]] into
    out[out_row[s]], in place, for all `buckets` of one container: one
    kernel launch per `MAX_BUCKETS` buckets. Ht (m, r) and out (n, r) of
    the buckets' type, float32 or float64. Returns `out`."""
    tensors = [t for b in buckets for t in (b.vals, b.cols, b.out_row)]
    if _on_cpu(Ht, out, *tensors):
        return ell_spmm_plain(buckets, Ht, out)
    _check_launch(buckets, Ht, out)
    order = [b for b in descriptor_order(buckets) if b.vals.shape[0]]
    for i in range(0, len(order), MAX_BUCKETS):
        group = order[i:i + MAX_BUCKETS]
        desc = np.array([[b.vals.data_ptr(), b.cols.data_ptr(),
                          b.out_row.data_ptr(), b.vals.shape[0],
                          b.vals.shape[1]] for b in group], dtype=np.int64)
        _build.launch(_ENTRIES[Ht.dtype], "ell_rowsums", Ht.device,
                      desc.ctypes.data, len(group), Ht.data_ptr(),
                      out.data_ptr(), Ht.shape[1])
        LAUNCHES["ell_rowsums"] += 1
    return out


def bucket_rowsums_plain(vals, cols, Ht, chunk: int = 2048):
    """(vals[..., None] * Ht[cols]).sum(1) -> (nseg, r), in torch, over
    blocks of `chunk` segments."""
    _check_shapes(vals, cols, Ht)
    return _rowsums(vals, cols, Ht, chunk)


def bucket_rowsums(vals, cols, Ht):
    """Per-segment Σ_k vals[s, k] · Ht[cols[s, k]] -> (nseg, r) for one
    ELL bucket: the product's launch with each segment as its own row.
    vals (nseg, w) float32/float64, cols (nseg, w) int32 in [0, m), Ht
    (m, r) of vals' type. Pad lanes are (col 0, val 0) and contribute
    nothing."""
    if _on_cpu(vals, cols, Ht):
        return bucket_rowsums_plain(vals, cols, Ht)
    _check_cuda_operands(vals, cols, Ht)
    nseg, w = vals.shape
    out = torch.zeros((nseg, Ht.shape[1]), dtype=Ht.dtype, device=Ht.device)
    rows = torch.arange(nseg, dtype=torch.int32, device=Ht.device)
    return ell_spmm([EllBucket(vals, cols, rows, w)], Ht, out)


def bucket_accumulate_pallas(bucket, Ht, out):
    """Add one bucket's segment sums into the rows of `out` (n, r), in
    place. Returns `out`."""
    return ell_spmm([bucket], Ht, out)


def v_ht_ell_pallas(ell, H):
    """V Hᵀ -> (n, r): every bucket in one launch, each segment's sum
    added into its row."""
    Ht = H.T.contiguous()
    out = torch.zeros((ell.shape[0], H.shape[0]), dtype=H.dtype,
                      device=H.device)
    return ell_spmm(ell.buckets, Ht, out)


def wt_v_ell_pallas(pair, W):
    """Wᵀ V -> (r, m) via the transposed container: (Vᵀ W)ᵀ."""
    return v_ht_ell_pallas(pair.cols, W.T).T


def mu_update_frobenius_ell_pallas(pair, W, H, eps=1e-9, order="WH"):
    """Sparse MU (Frobenius) with both SpMM directions on the kernel;
    denominators and Grams as in `sparse_ell.mu_update_frobenius_ell`."""

    def upd_w(W, H):
        return W * (v_ht_ell_pallas(pair.rows, H) / (W @ (H @ H.T) + eps))

    def upd_h(W, H):
        return H * (wt_v_ell_pallas(pair, W) / ((W.T @ W) @ H + eps))

    return _apply_order(upd_w, upd_h, W, H, order)
