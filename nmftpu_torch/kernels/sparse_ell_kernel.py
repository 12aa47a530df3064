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
`bucket_rowsums_plain`. ``LAUNCHES["ell_rowsums"]`` counts its launches:
one per product for up to `MAX_BUCKETS` buckets.

`ell_kl` is a second kernel of the same file (#11, ``ell_kl_kernel``),
the MU-KL half-step's numerator Σ_k v_k / (<own[row], table[col_k]> +
eps) · table[col_k] over a whole container. It replaces no TPU kernel:
``nmftpu/sparse_ell.py``'s ``mu_update_kl_ell`` leaves the step to XLA's
gathers and einsums. Each table row is gathered once, sampled against
the segment's own row held in registers (a half-warp butterfly finishes
the dot), and summed with its ratio into the output row; like #10 it is
bound by its L2 gathers, nnz · r · 4 B a half-step. Its twin is
``sparse_ell.kl_numerator_ell``, which the wrapper runs for CPU tensors
and, by shape, for rows wider than one pass (`KL_MAX_RANK`).
``LAUNCHES["ell_kl"]`` counts its launches, one per half-step; the ELL
engine passes `ell_kl` as ``sparse_ell.mu_update_kl_ell``'s numerator.

`ell_cg` is #11 under its other rule (``CgRule``): the coefficient α · v
· <own[row], table[col]> in place of the ratio, so one launch gives every
row's sparse term Σ_k α v_k (t_k · p) t_k of the iALS system's product
with a CG search direction p (own), the system never formed. Its twin is
``sparse_ell.cg_product_ell``; ``LAUNCHES["ell_cg"]`` counts its launches,
`cg_steps` + 1 per matrix-free CG half-step
(``sparse_ell.cg_half_ell``, to which the engine passes `ell_cg` and
`v_ht_ell_pallas`).
"""

from __future__ import annotations

import numpy as np
import torch

from nmftpu_torch.kernels import _build
from nmftpu_torch.kernels.dense_mu import _on_cpu
from nmftpu_torch.linalg.dense import _apply_order
from nmftpu_torch.sparse_ell import (
    EllBucket,
    _rowsums,
    cg_product_ell,
    kl_numerator_ell,
)

LAUNCHES = {"ell_rowsums": 0, "ell_kl": 0, "ell_cg": 0}

_ENTRIES = {
    torch.float32: "nmftpu_ell_spmm_f32",
    torch.float64: "nmftpu_ell_spmm_f64",
}
_KL_ENTRIES = {
    torch.float32: "nmftpu_ell_kl_f32",
    torch.float64: "nmftpu_ell_kl_f64",
}
_CG_ENTRIES = {
    torch.float32: "nmftpu_ell_cg_f32",
    torch.float64: "nmftpu_ell_cg_f64",
}

# #11 holds 64 bytes of a row a lane, 16 lanes a segment: the widest rows
# it covers in one pass
KL_MAX_RANK = {torch.float32: 256, torch.float64: 128}

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


def _check_launch(buckets, Ht, out, what="ell_spmm", name="out"):
    """The buckets against the table Ht (m, r); `out` (`name` in errors)
    a contiguous (n, r) tensor of Ht's type."""
    for b in buckets:
        _check_cuda_operands(b.vals, b.cols, Ht)
        if b.out_row.dtype != torch.int32 or b.out_row.shape != (
                b.vals.shape[0],) or not b.out_row.is_contiguous():
            raise ValueError(f"{what}: out_row must be a contiguous int32 "
                             "(nseg,) tensor")
    if (out.dtype != Ht.dtype or out.ndim != 2
            or out.shape[1] != Ht.shape[1] or not out.is_contiguous()):
        raise ValueError(
            f"{what}: {name} must be a contiguous (n, {Ht.shape[1]}) "
            f"{Ht.dtype} tensor, got {tuple(out.shape)} {out.dtype}")


def _descriptors(buckets):
    """The launches' bucket descriptors: groups of at most `MAX_BUCKETS`
    non-empty buckets in `descriptor_order`, each a host int64 array of
    (vals, cols, out_row, nseg, w) rows."""
    order = [b for b in descriptor_order(buckets) if b.vals.shape[0]]
    return [np.array([[b.vals.data_ptr(), b.cols.data_ptr(),
                       b.out_row.data_ptr(), b.vals.shape[0],
                       b.vals.shape[1]] for b in order[i:i + MAX_BUCKETS]],
                     dtype=np.int64)
            for i in range(0, len(order), MAX_BUCKETS)]


def ell_spmm(buckets, Ht, out):
    """Add every segment's Σ_k vals[s, k] · Ht[cols[s, k]] into
    out[out_row[s]], in place, for all `buckets` of one container: one
    kernel launch per `MAX_BUCKETS` buckets. Ht (m, r) and out (n, r) of
    the buckets' type, float32 or float64. Returns `out`."""
    tensors = [t for b in buckets for t in (b.vals, b.cols, b.out_row)]
    if _on_cpu(Ht, out, *tensors):
        return ell_spmm_plain(buckets, Ht, out)
    _check_launch(buckets, Ht, out)
    for desc in _descriptors(buckets):
        _build.launch(_ENTRIES[Ht.dtype], "ell_rowsums", Ht.device,
                      desc.ctypes.data, len(desc), Ht.data_ptr(),
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


def _check_kl(ell, own, table, what="ell_kl"):
    """What #11 takes: the buckets as `ell_spmm` takes them, own (n, r)
    and table (m, r) contiguous, of the buckets' type, float32 or
    float64, r within one pass."""
    if table.dtype not in KL_MAX_RANK or table.ndim != 2:
        raise TypeError(f"{what}: table must be a 2-D float32 or float64 "
                        f"tensor, got {table.ndim}-D {table.dtype}")
    if not table.is_contiguous():
        raise ValueError(f"{what}: table must be contiguous")
    _check_launch(ell.buckets, table, own, what=what, name="own")
    if own.shape[0] != ell.shape[0]:
        raise ValueError(f"{what}: own must have the container's "
                         f"{ell.shape[0]} rows, got {own.shape[0]}")
    if table.shape[1] > KL_MAX_RANK[table.dtype]:
        raise ValueError(f"{what}: r = {table.shape[1]} exceeds one pass "
                         f"({KL_MAX_RANK[table.dtype]})")


def _sampled(ell, own, table, param, entries, what, twin):
    """#11 under the rule of `entries` with its scalar `param`: one launch
    for up to `MAX_BUCKETS` buckets on CUDA tensors, counted under
    `what`; `twin()` on CPU tensors and for r beyond `KL_MAX_RANK`."""
    tensors = [t for b in ell.buckets for t in (b.vals, b.cols, b.out_row)]
    r = table.shape[-1]
    if _on_cpu(own, table, *tensors) or r > KL_MAX_RANK.get(table.dtype, r):
        return twin()
    _check_kl(ell, own, table, what)
    out = torch.zeros((ell.shape[0], r), dtype=table.dtype,
                      device=table.device)
    for desc in _descriptors(ell.buckets):
        _build.launch(entries[table.dtype], what, table.device,
                      desc.ctypes.data, len(desc), own.data_ptr(),
                      table.data_ptr(), out.data_ptr(), r, float(param))
        LAUNCHES[what] += 1
    return out


def ell_kl(ell, own, table, eps=1e-9):
    """The MU-KL numerator Σ_k v_k / (<own[row], table[col_k]> + eps) ·
    table[col_k] accumulated into rows -> (n, r) for one container, own
    (n, r) and table (m, r) contiguous and of its type, float32 or
    float64: one launch of #11 for up to `MAX_BUCKETS` buckets on CUDA
    tensors, the plain twin ``sparse_ell.kl_numerator_ell`` on CPU tensors
    and for r beyond `KL_MAX_RANK`. The kernel skips lanes whose value is
    0, which changes no sum wherever s + eps != 0; with eps = 0 a pad lane
    that samples s = 0 gives NaN in the twin and nothing in the kernel."""
    return _sampled(ell, own, table, eps, _KL_ENTRIES, "ell_kl",
                    lambda: kl_numerator_ell(ell, own, table, eps))


def ell_cg(ell, own, table, alpha):
    """The sparse term of the iALS systems' product with one vector a row,
    Σ_k α · v_k · <own[row], table[col_k]> · table[col_k] accumulated into
    rows -> (n, r), own (n, r) and table (m, r) as `ell_kl` takes them:
    #11 under its CG rule, one launch for up to `MAX_BUCKETS` buckets
    (``LAUNCHES["ell_cg"]``), or the plain twin
    ``sparse_ell.cg_product_ell`` where `ell_kl` runs its own."""
    return _sampled(ell, own, table, alpha, _CG_ENTRIES, "ell_cg",
                    lambda: cg_product_ell(ell, own, table, alpha))
