"""Fused GEMM + top-2-per-slot reservoir scan for top-k MIPS serving (port
of ``nmftpu/kernels/mips_reservoir.py``).

A reservoir of R slots per query, slot = item_id mod R, keeps the best
TWO (score, id) pairs per slot; the final exact top-k runs over the
(b, 2R) candidates. A rank-i item is missed only if >= 2 higher-ranked
items share its slot, so E[missed among top-k] ~= C(k, 3) / R^2: about
0.0096 items per row at k = 100, R = 4096.

The scan is one hand-written CUDA kernel (``csrc/mips_reservoir.cu``):
each block owns 64 queries x 64 consecutive slots, keeps their carry in
registers and walks the item tiles in increasing order, so no score
reaches device memory and no two blocks share a slot. The source states
the precision contract and what bounds it. `reservoir_scan_plain` is the
same function in torch (the twin of ``nmftpu``'s ``_reservoir_scan``);
`reservoir_scan` runs it only for CPU tensors, and for CUDA tensors
launches the kernel or raises. ``LAUNCHES`` counts kernel launches.

The table is never padded to a multiple of the slot count: the kernel
and the twin both mask the ragged last tile.
"""

from __future__ import annotations

import torch

from nmftpu_torch._operands import _scan_operands, _tensor
from nmftpu_torch.kernels import _build
from nmftpu_torch.kernels.dense_mu import _on_cpu

LAUNCHES = {"reservoir_scan": 0}

# the kernels keep a 64-query block as (r x 65) float32 in shared memory,
# next to an 8 KB table slice, within the 227 KB a block may use
MAX_RANK = 832

_ENTRIES = {
    torch.float32: "nmftpu_reservoir_scan_f32",
    torch.bfloat16: "nmftpu_reservoir_scan_bf16",
    torch.int8: "nmftpu_reservoir_scan_i8",
}


def check_scan_operands(what, Wq, H, m_items, table_dtypes):
    """What the scan kernels take: Wq (b, r) float32, H (r, cols) of one
    of `table_dtypes`, both contiguous; 1 <= m_items <= cols < 2**31 and
    r <= MAX_RANK. Returns (b, r)."""
    if Wq.ndim != 2 or H.ndim != 2 or Wq.shape[1] != H.shape[0]:
        raise ValueError(f"{what}: expected Wq (b, r) and H (r, m); got "
                         f"{tuple(Wq.shape)} and {tuple(H.shape)}")
    if Wq.dtype != torch.float32:
        raise TypeError(f"{what}: Wq must be float32, got {Wq.dtype}")
    if H.dtype not in table_dtypes:
        raise TypeError(f"{what}: table dtype {H.dtype} not in "
                        f"{sorted(map(str, table_dtypes))}")
    for name, t in (("Wq", Wq), ("H", H)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    b, r = Wq.shape
    if b < 1 or not 1 <= r <= MAX_RANK:
        raise ValueError(f"{what}: need b >= 1 and 1 <= r <= {MAX_RANK}, "
                         f"got b={b}, r={r}")
    if not 1 <= m_items <= H.shape[1] or H.shape[1] >= 2**31:
        raise ValueError(f"{what}: need 1 <= m_items <= {H.shape[1]} "
                         f"< 2**31, got m_items={m_items}")
    return b, r


def reservoir_scan_plain(Wq, H, m_items, slots):
    """The reservoir candidates in torch: Wq (b, r) (rounded to bf16
    here), H (r, >= m_items). Tile j scores items j*slots + slot; each
    slot keeps its best two by ``nmftpu``'s merge rule (strict ``>``, so a
    tie keeps the earlier, lower id). Returns (scores (b, 2*slots)
    float32, ids (b, 2*slots) int32): the best of each slot in columns
    [0, slots), the second in [slots, 2*slots)."""
    b = Wq.shape[0]
    dev = H.device
    q = Wq.to(torch.bfloat16).float()
    s1 = torch.full((b, slots), float("-inf"), device=dev)
    s2 = s1.clone()
    i1 = torch.zeros((b, slots), dtype=torch.int32, device=dev)
    i2 = i1.clone()
    slot = torch.arange(slots, dtype=torch.int32, device=dev)
    for lo in range(0, m_items, slots):
        hi = min(lo + slots, m_items)
        s = q @ H[:, lo:hi].float()
        if hi - lo < slots:        # items >= m_items score -inf
            s = torch.cat([s, s.new_full((b, slots - (hi - lo)),
                                         float("-inf"))], dim=1)
        gid = slot + lo
        beats1 = s > s1
        i2 = torch.where(beats1, i1, torch.where(s > s2, gid, i2))
        s2 = torch.maximum(torch.minimum(s, s1), s2)
        i1 = torch.where(beats1, gid, i1)
        s1 = torch.maximum(s, s1)
    return torch.cat([s1, s2], dim=1), torch.cat([i1, i2], dim=1)


def reservoir_scan(Wq, H, m_items, slots):
    """The (b, 2*slots) reservoir candidates of items [0, m_items) of H,
    by the CUDA kernel for CUDA tensors; see `reservoir_scan_plain`."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    b, r = check_scan_operands("reservoir_scan", Wq, H, m_items,
                               tuple(_ENTRIES))
    if _on_cpu(Wq, H):
        return reservoir_scan_plain(Wq, H, m_items, slots)
    out_s = torch.empty((b, 2 * slots), dtype=torch.float32,
                        device=H.device)
    out_i = torch.empty((b, 2 * slots), dtype=torch.int32, device=H.device)
    _build.launch(_ENTRIES[H.dtype], "reservoir_scan", H.device,
                  Wq.data_ptr(), H.data_ptr(), out_s.data_ptr(),
                  out_i.data_ptr(), b, r, m_items, H.shape[1], slots)
    LAUNCHES["reservoir_scan"] += 1
    return out_s, out_i


def reservoir_topk_mips(Wq, H, k, slots=4096, seen=None, h_scale=None,
                        m_items=None):
    """Top-k MIPS through the reservoir scan.

    Wq: (b, r) queries; H: (r, m) item table, float32, bfloat16 or int8
    (int8 carries `h_scale` as in `retrieval.mips._score_dot`: a (r,)
    vector folds into the queries, a scalar multiplies the scores).
    seen: optional (b, S) padded item ids, excluded EXACTLY by the
    oversampled drop of `topk_mips_excluded` (2*slots >= k + S
    candidates). m_items: the true item count when H carries extra
    columns, which never surface. Returns (scores (b, k), ids (b, k))."""
    from nmftpu_torch.retrieval.mips import _drop_seen

    m = H.shape[1] if m_items is None else int(m_items)
    if seen is not None:
        seen = _tensor(seen, H.device)
        if k + seen.shape[1] > 2 * slots:
            raise ValueError(
                f"k + seen width = {k + seen.shape[1]} exceeds the "
                f"2*slots = {2 * slots} reservoir candidates; raise slots "
                "or trim the per-user seen lists"
            )
    # the scan's query values (a (r,) int8 scale folded in, free on the
    # scan) and the scalar scale that multiplies its scores, if any
    q, post = _scan_operands(Wq, H.dtype, h_scale)
    cand_s, cand_i = reservoir_scan(q.contiguous(), H, m, slots)
    if post is not None:
        cand_s = cand_s * post
    if seen is not None:
        return _drop_seen(cand_s, cand_i, seen, k)
    top_s, pos = torch.topk(cand_s, k, dim=1)
    return top_s, cand_i.gather(1, pos)
