"""ELL segment SpMM as a hand-written CUDA kernel (port of
``nmftpu/kernels/sparse_ell_kernel.py``).

Per padded segment of an `EllBucket` the kernel (``csrc/ell_rowsums.cu``)
gathers table rows by column index, scales them by the stored values
and reduces the segment, in registers: one warp per segment, coalesced
row reads, four gathers in flight. The segment sums are then
scatter-added into the (n, r) rows with ``index_add_``, as ``nmftpu``
leaves that scatter to XLA. The kernel accumulates in the table's type,
float32 or float64 (``nmftpu``'s Pallas kernel sums in float32 even
under a float64 configuration; ROADMAP queue 3).

Not carried over from the TPU version: the VMEM table budget
(``table_fits``, ``spmm_supported``), the one-step grid and the scan over
segment groups. On Hopper the table stays in global memory and L2 and one
launch covers a whole bucket, so the functions here take no `chunk` or
`interpret` arguments.

`bucket_rowsums_plain` is the same function in torch; `bucket_rowsums`
runs it only for CPU tensors, and for CUDA tensors launches the kernel or
raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from nmftpu_torch.kernels import _build
from nmftpu_torch.kernels.dense_mu import _on_cpu
from nmftpu_torch.linalg.dense import _apply_order
from nmftpu_torch.sparse_ell import _rowsums

LAUNCHES = {"ell_rowsums": 0}

_ENTRIES = {
    torch.float32: "nmftpu_ell_rowsums_f32",
    torch.float64: "nmftpu_ell_rowsums_f64",
}


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


def bucket_rowsums_plain(vals, cols, Ht, chunk: int = 2048):
    """(vals[..., None] * Ht[cols]).sum(1) -> (nseg, r), in torch, over
    blocks of `chunk` segments."""
    _check_shapes(vals, cols, Ht)
    return _rowsums(vals, cols, Ht, chunk)


def bucket_rowsums(vals, cols, Ht):
    """Per-segment Σ_k vals[s, k] · Ht[cols[s, k]] -> (nseg, r) for one
    ELL bucket, in one kernel launch. vals (nseg, w) float32/float64,
    cols (nseg, w) int32 in [0, m), Ht (m, r) of vals' type. Pad lanes
    are (col 0, val 0) and contribute nothing."""
    if _on_cpu(vals, cols, Ht):
        return bucket_rowsums_plain(vals, cols, Ht)
    _check_cuda_operands(vals, cols, Ht)
    nseg, w = vals.shape
    out = torch.empty((nseg, Ht.shape[1]), dtype=Ht.dtype, device=Ht.device)
    if nseg == 0:
        return out
    _build.launch(_ENTRIES[Ht.dtype], "ell_rowsums", Ht.device,
                  vals.data_ptr(), cols.data_ptr(), Ht.data_ptr(),
                  out.data_ptr(), nseg, w, Ht.shape[1])
    LAUNCHES["ell_rowsums"] += 1
    return out


def bucket_accumulate_pallas(bucket, Ht, out):
    """Add one bucket's segment sums into the rows of `out` (n, r), in
    place: the kernel, then ``index_add_`` on `out_row`. Returns `out`."""
    seg = bucket_rowsums(bucket.vals, bucket.cols, Ht)
    return out.index_add_(0, bucket.out_row, seg)


def v_ht_ell_pallas(ell, H):
    """V Hᵀ -> (n, r) with the kernel computing each bucket's segment
    sums; only the row accumulation is ``index_add_``."""
    Ht = H.T.contiguous()
    out = torch.zeros((ell.shape[0], H.shape[0]), dtype=H.dtype,
                      device=H.device)
    for bucket in ell.buckets:
        bucket_accumulate_pallas(bucket, Ht, out)
    return out


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
