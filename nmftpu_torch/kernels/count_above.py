"""Fused GEMM + count-above-threshold: the certificate's count pass (port
of ``nmftpu/kernels/count_above.py``).

`retrieval.mips._count_above` in plain torch writes a (b, block) float32
score tile to device memory per block before its compare-reduce: 2 GB
per megablock at b = 512. The CUDA kernel (``csrc/count_above.cu``)
scores 128 queries x 64 items a step on the bf16 tensor cores, compares
each score in registers, and adds one integer per (query, warpgroup) to
the counts, so no score is ever written.

The counts are exact against the k-ordered chain (the score
`retrieval.mips._gather_scores` forms and the certificate's theta comes
from), although the tensor cores sum in another order: the two differ by
at most tau (`band_tau`), so a tensor-core score above theta + tau
counts, one below theta - tau does not, and the few in between are
re-scored by the chain on the card (`band_limits`; `count_through_band`
is that rule in torch, for any scores within tau of the chain).
A query whose bf16 row is all zero scores exactly 0 everywhere and skips
the band. ``BAND_PAIRS`` keeps the pairs that went through the band as a
running total on each card, added to without a wait; `band_pairs` reads
it. Integer sums are order-free: the counts are deterministic.

bf16 and int8 tables only, as in ``nmftpu``: an f32 table's scoring rule
keeps float32 queries, which the kernel's bf16 queries cannot reproduce.
A (r,) int8 scale folds into the queries (bit for bit the scan's fold); a
SCALAR scale divides theta, s > theta / hs, where the plain scan
multiplies the score, so those counts agree only up to items whose
score rounds across theta (`retrieval.mips` keeps scalar-scaled tables
on the plain path).

`count_above_fused_plain` is the same function in torch (a float32
matmul, not the chain); `count_above_fused` runs it only for CPU
tensors, and for CUDA tensors launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from nmftpu_torch._operands import _scan_operands
from nmftpu_torch.kernels import _build
from nmftpu_torch.kernels.dense_mu import _on_cpu
from nmftpu_torch.kernels.mips_reservoir import _SMS, check_scan_operands

LAUNCHES = {"count_above": 0}
# device -> (1,) int64 running total of band pairs on that card
BAND_PAIRS: dict = {}

_ENTRIES = {
    torch.bfloat16: "nmftpu_count_above_bf16",
    torch.int8: "nmftpu_count_above_i8",
}

# the plain twin scores this many items at a time: (b, 2**18) float32
# scores is 2 GB at b = 2048
_PLAIN_BLOCK = 1 << 18

# tau = BAND_C r 2^-23 ||q||_1 h_max + r 2^-125: the chain and a
# truncating tensor-core sum of the same r exact products differ by at
# most 2.5 r 2^-23 ||q||_1 h_max (the derivation is csrc/count_above.cu's
# header); the last term covers products flushed below float32's normal
# range
BAND_C = 4
# every int8 value, -128 included, is at most this in magnitude
INT8_H_MAX = 128.0
# the kernel's blocks: 128 queries, 64-item tiles
_CT_QUERIES, _CT_ITEMS = 128, 64
# the device list of band pairs holds max(_BAND_LIST, 16 b); the kernel
# re-scores the pairs past it where it finds them
_BAND_LIST = 4096


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


def table_h_max(H, h_max=None, m_items=None):
    """A bound on max |H| over the items scored: INT8_H_MAX for int8, else
    `h_max` if given (a Recommender computes it once per table), else
    max |H[:, :m_items]| read from the table."""
    if H.dtype == torch.int8:
        return INT8_H_MAX
    if h_max is not None:
        return h_max
    m = H.shape[1] if m_items is None else int(m_items)
    lo, hi = torch.aminmax(H[:, :m])          # no |H| copy of the table
    return torch.maximum(-lo, hi).double()


def band_tau(q, h_max):
    """(b,) float64 tau: |tensor-core score - chain| <= tau for every item
    of a table with max |H| <= h_max, q the (b, r) scan operand (rounded
    to bf16 here, as the kernel does)."""
    r = q.shape[1]
    l1 = q.to(torch.bfloat16).double().abs().sum(dim=1)
    return BAND_C * r * 2.0**-23 * l1 * h_max + r * 2.0**-125


def band_limits(q, theta, h_max):
    """(lo, hi), (b,) float32 each, with lo <= theta - tau and hi >= theta
    + tau: computed in float64, rounded to float32 and moved one float
    further out. A score above hi proves the chain above theta; one below
    lo proves it below. A row whose bf16 query is all zero scores exactly 0
    on every item, so its limits are both -inf where 0 > theta (every item
    counts) and both +inf otherwise (none does): it never enters the
    band."""
    tau = band_tau(q, h_max)
    t = theta.double()
    up = torch.full_like(theta, float("inf"), dtype=torch.float32)
    lo = torch.nextafter((t - tau).float(), -up)
    hi = torch.nextafter((t + tau).float(), up)
    zero = q.to(torch.bfloat16).eq(0).all(dim=1)
    side = torch.where(theta < 0, -up, up)
    return torch.where(zero, side, lo), torch.where(zero, side, hi)


def chain_scores(q, H, cols):
    """(P,) chain scores of the pairs (q[p], item cols[p]): the float32 sum
    of bf16(q[p, k]) H[k, cols[p]] one product at a time in k order, bit
    for bit the kernel's fmaf chain and `retrieval.mips._gather_scores`
    (each product is exact in float32)."""
    h = H.index_select(1, cols.long()).float()            # (r, P)
    qb = q.to(torch.bfloat16).float()
    acc = torch.zeros(cols.shape[0], dtype=torch.float32, device=H.device)
    for k in range(H.shape[0]):
        acc.addcmul_(h[k], qb[:, k])
    return acc


def count_through_band(Wq, H, theta, scores, h_scale=None, h_max=None):
    """The kernel's counting rule in torch, for (b, m) `scores` that lie
    within tau of the chain (any summation order of the same products):
    count scores above hi, drop those below lo, re-score the rest by the
    chain. Returns (counts (b,) int32, number of band pairs)."""
    q, theta = _fold(Wq, H, theta, h_scale)
    lo, hi = band_limits(q, theta, table_h_max(H, h_max, scores.shape[1]))
    above = scores > hi[:, None]
    count = above.sum(dim=1, dtype=torch.int32)
    rows, cols = ((scores >= lo[:, None]) & ~above).nonzero(as_tuple=True)
    hit = chain_scores(q[rows], H, cols) > theta[rows]
    count.index_add_(0, rows, hit.to(torch.int32))
    return count, int(rows.numel())


def count_plan(b, m_items, sms=_SMS):
    """(tiles per block, item ranges) of the kernel's grid: the
    (b / 128) x ranges blocks fill one wave of one block per SM, and each
    range holds at least two 64-item tiles, one per warpgroup."""
    tiles = -(-m_items // _CT_ITEMS)
    qblocks = -(-b // _CT_QUERIES)
    ranges = max(1, min(sms // qblocks, -(-tiles // 2)))
    per = -(-tiles // ranges)
    return per, -(-tiles // per)


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


def band_pairs():
    """The pairs that went through the band on every card since the
    process started (or ``BAND_PAIRS.clear()``): reads the device totals,
    so it waits for the launches queued before it."""
    return sum(int(t.item()) for t in BAND_PAIRS.values())


def count_above_fused(Wq, H, theta, h_scale=None, m_items=None, h_max=None):
    """Per-row count of items scoring strictly above theta, one fused
    pass. Wq (b, r); H (r, m) bf16/int8 (int8 carries `h_scale`); theta
    (b,) float32; m_items marks the true width when H carries extra
    columns; h_max bounds max |H| of a bf16 table (read from H when
    None). Rows whose theta is -inf count every real item. Returns (b,)
    int32."""
    if _on_cpu(Wq, H, theta):
        return count_above_fused_plain(Wq, H, theta, h_scale, m_items)
    q, theta = _fold(Wq, H, theta, h_scale)
    q, theta = q.contiguous(), theta.contiguous()
    m = H.shape[1] if m_items is None else int(m_items)
    b, r = check_scan_operands("count_above", q, H, m, tuple(_ENTRIES))
    if theta.shape != (b,):
        raise ValueError(f"count_above: theta must be ({b},), got "
                         f"{tuple(theta.shape)}")
    lo, hi = band_limits(q, theta, table_h_max(H, h_max, m))
    lim = torch.cat([lo, hi, theta])
    cap = max(_BAND_LIST, 16 * b)
    # one zeroed buffer: the counts, then the 64-bit band count (8-byte
    # aligned)
    n = b + b % 2
    zeroed = torch.zeros(n + 2, dtype=torch.int32, device=H.device)
    counts, nband = zeroed[:b], zeroed[n:].view(torch.int64)
    pairs = torch.empty(2 * cap, dtype=torch.int32, device=H.device)
    per, _ = count_plan(b, m)
    es = H.element_size()
    g = _build.copy_alignment(H.data_ptr(), H.shape[1] * es, _CT_ITEMS * es)
    _build.launch(_ENTRIES[H.dtype], "count_above", H.device,
                  q.data_ptr(), H.data_ptr(), lim.data_ptr(),
                  counts.data_ptr(), pairs.data_ptr(), nband.data_ptr(), cap,
                  b, r, m, H.shape[1], per, g)
    LAUNCHES["count_above"] += 1
    total = BAND_PAIRS.get(H.device)
    if total is None:
        total = BAND_PAIRS[H.device] = torch.zeros_like(nband)
    total += nband
    return counts
