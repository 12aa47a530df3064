"""Fused GEMM + count-above-threshold: the certificate's count pass (port
of ``nmftpu/kernels/count_above.py``).

`retrieval.mips._count_above` in plain torch writes a (b, block) float32
score tile to device memory per block before its compare-reduce: 2 GB
per megablock at b = 512. The CUDA kernel (``csrc/count_above.cu``)
scores (64 queries x 64 items) tiles in registers, compares each score
with its row's theta there, and adds one integer per (query, block) to
the counts, so no score is ever written. Integer sums are order-free:
the counts are deterministic.

bf16 and int8 tables only, as in ``nmftpu``: an f32 table's scoring rule
keeps float32 queries, which the kernel's bf16 queries cannot reproduce.
A (r,) int8 scale folds into the queries (bit for bit the scan's fold); a
SCALAR scale divides theta, s > theta / hs, where the plain scan
multiplies the score, so those counts agree only up to items whose
score rounds across theta (`retrieval.mips` keeps scalar-scaled tables
on the plain path).

`count_above_fused_plain` is the same function in torch;
`count_above_fused` runs it only for CPU tensors, and for CUDA tensors
launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from nmftpu_torch._operands import _scan_operands
from nmftpu_torch.kernels import _build
from nmftpu_torch.kernels.dense_mu import _on_cpu
from nmftpu_torch.kernels.mips_reservoir import check_scan_operands

LAUNCHES = {"count_above": 0}

_ENTRIES = {
    torch.bfloat16: "nmftpu_count_above_bf16",
    torch.int8: "nmftpu_count_above_i8",
}

# the plain twin scores this many items at a time: (b, 2**18) float32
# scores is 2 GB at b = 2048
_PLAIN_BLOCK = 1 << 18


def _fold(Wq, H, theta, h_scale):
    """Validate the table and fold its scale by the scans' rule
    (`_scan_operands`): (q, theta) float32, with a (r,) scale in q and a
    scalar one dividing theta."""
    if H.dtype not in _ENTRIES:
        raise ValueError(
            "count_above_fused supports bfloat16/int8 tables only — an "
            f"{H.dtype} table's scoring rule keeps float32 queries, "
            "which this kernel's bf16 queries cannot reproduce"
        )
    q, post = _scan_operands(Wq, H.dtype, h_scale)
    theta = theta.float()
    # scalar scale: true score = hs * s  =>  s > theta / hs
    return q, (theta if post is None else theta / post)


def count_above_fused_plain(Wq, H, theta, h_scale=None, m_items=None):
    """Per-row count of items [0, m_items) whose score exceeds theta,
    in torch: bf16-rounded (scale-folded) queries times the exact table
    value, float32 sums, blocked over items."""
    Wq, theta = _fold(Wq, H, theta, h_scale)
    m = H.shape[1] if m_items is None else int(m_items)
    q = Wq.to(torch.bfloat16).float()
    count = torch.zeros(Wq.shape[0], dtype=torch.int32, device=H.device)
    for lo in range(0, m, _PLAIN_BLOCK):
        sc = q @ H[:, lo:min(lo + _PLAIN_BLOCK, m)].float()
        count += (sc > theta[:, None]).sum(dim=1, dtype=torch.int32)
    return count


def count_above_fused(Wq, H, theta, h_scale=None, m_items=None):
    """Per-row count of items scoring strictly above theta, one fused
    pass. Wq (b, r); H (r, m) bf16/int8 (int8 carries `h_scale`); theta
    (b,) float32; m_items marks the true width when H carries extra
    columns. Rows whose theta is -inf count every real item. Returns
    (b,) int32."""
    if _on_cpu(Wq, H, theta):
        return count_above_fused_plain(Wq, H, theta, h_scale, m_items)
    Wq, theta = _fold(Wq, H, theta, h_scale)
    Wq, theta = Wq.contiguous(), theta.contiguous()
    m = H.shape[1] if m_items is None else int(m_items)
    b, r = check_scan_operands("count_above", Wq, H, m,
                               tuple(_ENTRIES))
    if theta.shape != (b,):
        raise ValueError(f"count_above: theta must be ({b},), got "
                         f"{tuple(theta.shape)}")
    counts = torch.zeros(b, dtype=torch.int32, device=H.device)
    _build.launch(_ENTRIES[H.dtype], "count_above", H.device,
                  Wq.data_ptr(), H.data_ptr(), theta.data_ptr(),
                  counts.data_ptr(), b, r, m, H.shape[1])
    LAUNCHES["count_above"] += 1
    return counts
