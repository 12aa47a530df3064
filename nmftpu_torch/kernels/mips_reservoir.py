"""Fused GEMM + top-2-per-slot reservoir scan for top-k MIPS serving (port
of ``nmftpu/kernels/mips_reservoir.py``).

A reservoir of R slots per query, slot = item_id mod R, keeps the best
TWO (score, id) pairs per slot; the final exact top-k runs over the
(b, 2R) candidates. A rank-i item is missed only if >= 2 higher-ranked
items share its slot, so E[missed among top-k] ~= C(k, 3) / R^2: about
0.0096 items per row at k = 100, R = 4096.

The scan is hand-written CUDA (``csrc/mips_reservoir.cu``). For bf16
and int8 tables it runs on the bf16 tensor cores (``wgmma``): each block
owns 128 queries x 64 consecutive slots, keeps their carry in registers
and walks a range of item tiles in increasing order, so no score reaches
device memory. Above r = 288 each tile's rank comes in as chunks that
accumulate into one product, so every table takes r <= MAX_RANK. When
the grid fills at most half the SMs, `tc_plan` splits the walk over the
tiles into ranges and a second small kernel merges the ranges'
candidates (`reservoir_merge_plain` is that merge in torch).
float32 tables keep the CUDA-core fmaf tile (a bf16 product would round
the table). The source states the precision contract and what bounds it.
`reservoir_scan_plain` is the same function in torch (the twin of
``nmftpu``'s ``_reservoir_scan``); `reservoir_scan` runs it only for CPU
tensors, and for CUDA tensors launches the kernels or raises.
``LAUNCHES`` counts scans; ``VARIANT_LAUNCHES`` counts which kernel ran:
the tensor-core scan with 16-byte copies of the table (``tc``) or with
narrower ones for row starts not 16-byte aligned (``tc_unaligned``), the
float32 scan (``f32``) and the merge (``merge``).

The table is never padded to a multiple of the slot count: the kernel
and the twin both mask the ragged last tile.
"""

from __future__ import annotations

import torch

from nmftpu_torch._operands import _scan_operands, _tensor
from nmftpu_torch.kernels import _build
from nmftpu_torch.kernels.dense_mu import _on_cpu

# the score of an empty slot and of an item past m_items
NEG = float("-inf")

LAUNCHES = {"reservoir_scan": 0}
VARIANT_LAUNCHES = {"tc": 0, "tc_unaligned": 0, "f32": 0, "merge": 0}

# the float32 kernel keeps a 64-query block as (r x 65) float32 in shared
# memory, next to an 8 KB table slice, within the 227 KB a block may use;
# the tensor-core kernel keeps 128 bf16 queries (256 r bytes) beside
# chunks of the table tiles
MAX_RANK = 832
_SMS = 132              # the H100's SMs: the grid the split plan fills
_TC_QUERIES, _TC_SLOTS = 128, 64

_ENTRIES = {
    torch.float32: "nmftpu_reservoir_scan_f32",
    torch.bfloat16: "nmftpu_reservoir_scan_bf16",
    torch.int8: "nmftpu_reservoir_scan_i8",
}


def check_scan_operands(what, Wq, H, m_items, table_dtypes,
                        max_rank=MAX_RANK):
    """What the scan kernels take: Wq (b, r) float32, H (r, cols) of one
    of `table_dtypes`, both contiguous; 1 <= m_items <= cols < 2**31 and
    r <= max_rank (None: any r, as the plain twins take). Returns
    (b, r)."""
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
    if b < 1 or r < 1 or (max_rank is not None and r > max_rank):
        raise ValueError(f"{what}: need b >= 1 and 1 <= r <= {max_rank}, "
                         f"got b={b}, r={r}")
    if not 1 <= m_items <= H.shape[1] or H.shape[1] >= 2**31:
        raise ValueError(f"{what}: need 1 <= m_items <= {H.shape[1]} "
                         f"< 2**31, got m_items={m_items}")
    return b, r


def reservoir_scan_plain(Wq, H, m_items, slots, tiles=None):
    """The reservoir candidates in torch: Wq (b, r) (rounded to bf16
    here), H (r, >= m_items). Tile j scores items j*slots + slot; each
    slot keeps its best two by ``nmftpu``'s merge rule (strict ``>``, so a
    tie keeps the earlier, lower id). `tiles` = (j0, j1) walks only tiles
    [j0, j1) (a range of a split walk). Returns (scores (b, 2*slots)
    float32, ids (b, 2*slots) int32): the best of each slot in columns
    [0, slots), the second in [slots, 2*slots)."""
    b = Wq.shape[0]
    j0, j1 = (0, -(-m_items // slots)) if tiles is None else tiles
    dev = H.device
    q = Wq.to(torch.bfloat16).float()
    s1 = torch.full((b, slots), NEG, device=dev)
    s2 = s1.clone()
    i1 = torch.zeros((b, slots), dtype=torch.int32, device=dev)
    i2 = i1.clone()
    slot = torch.arange(slots, dtype=torch.int32, device=dev)
    for lo in range(j0 * slots, min(j1 * slots, m_items), slots):
        hi = min(lo + slots, m_items)
        s = q @ H[:, lo:hi].float()
        if hi - lo < slots:        # items >= m_items score -inf
            s = torch.cat([s, s.new_full((b, slots - (hi - lo)), NEG)],
                          dim=1)
        gid = slot + lo
        beats1 = s > s1
        i2 = torch.where(beats1, i1, torch.where(s > s2, gid, i2))
        s2 = torch.maximum(torch.minimum(s, s1), s2)
        i1 = torch.where(beats1, gid, i1)
        s1 = torch.maximum(s, s1)
    return torch.cat([s1, s2], dim=1), torch.cat([i1, i2], dim=1)


def reservoir_merge_plain(parts_s, parts_i):
    """Merge the candidates of consecutive tile ranges of one walk,
    (splits, b, 2*slots) each, in range order: each later range's best,
    then its second, folds into the carry by the scan's rule. The result
    equals the one-pass scan: both keep, per slot, the top two by (score
    descending, id ascending)."""
    slots = parts_s.shape[-1] // 2
    s1, s2 = parts_s[0, :, :slots], parts_s[0, :, slots:]
    i1, i2 = parts_i[0, :, :slots], parts_i[0, :, slots:]
    for p in range(1, parts_s.shape[0]):
        for h in (0, 1):
            s = parts_s[p, :, h * slots:(h + 1) * slots]
            i = parts_i[p, :, h * slots:(h + 1) * slots]
            beats1 = s > s1
            i2 = torch.where(beats1, i1, torch.where(s > s2, i, i2))
            s2 = torch.maximum(torch.minimum(s, s1), s2)
            i1 = torch.where(beats1, i, i1)
            s1 = torch.maximum(s, s1)
    return torch.cat([s1, s2], dim=1), torch.cat([i1, i2], dim=1)


def tc_plan(b, slots, m_items, sms=_SMS):
    """(tiles per range, ranges) of the tensor-core scan's walk over the
    ceil(m_items / slots) tiles. The (b / 128) x (slots / 64) blocks
    times the ranges stay within one wave of one block per SM, each
    range of at least 4 tiles: a second wave of shorter ranges takes as
    long as one wave of whole walks. A block's tile index is 16-bit, so
    no range exceeds 65,536 tiles."""
    tiles = -(-m_items // slots)
    blocks = -(-b // _TC_QUERIES) * -(-slots // _TC_SLOTS)
    splits = max(1, min(sms // blocks, tiles // 4), -(-tiles // 65536))
    per = -(-tiles // splits)
    return per, -(-tiles // per)


def reservoir_scan(Wq, H, m_items, slots):
    """The (b, 2*slots) reservoir candidates of items [0, m_items) of H,
    by the CUDA kernels for CUDA tensors; see `reservoir_scan_plain`."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    cpu = _on_cpu(Wq, H)
    b, r = check_scan_operands("reservoir_scan", Wq, H, m_items,
                               tuple(_ENTRIES), None if cpu else MAX_RANK)
    if cpu:
        return reservoir_scan_plain(Wq, H, m_items, slots)
    dev = H.device
    out_s = torch.empty((b, 2 * slots), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, 2 * slots), dtype=torch.int32, device=dev)
    args = (Wq.data_ptr(), H.data_ptr())
    dims = (b, r, m_items, H.shape[1], slots)
    if H.dtype == torch.float32:
        _build.launch(_ENTRIES[H.dtype], "reservoir_scan", dev, *args,
                      out_s.data_ptr(), out_i.data_ptr(), *dims)
        VARIANT_LAUNCHES["f32"] += 1
    else:
        per, splits = tc_plan(b, slots, m_items)
        es = H.element_size()
        g = _build.copy_alignment(H.data_ptr(), H.shape[1] * es, slots * es)
        part_s, part_i = out_s, out_i
        if splits > 1:
            part_s = torch.empty((splits, b, 2 * slots), dtype=torch.float32,
                                 device=dev)
            part_i = torch.empty((splits, b, 2 * slots), dtype=torch.int32,
                                 device=dev)
        _build.launch(_ENTRIES[H.dtype], "reservoir_scan", dev, *args,
                      part_s.data_ptr(), part_i.data_ptr(), *dims, per,
                      splits, g)
        VARIANT_LAUNCHES["tc" if g == 16 else "tc_unaligned"] += 1
        if splits > 1:
            _build.launch("nmftpu_reservoir_merge", "reservoir_merge", dev,
                          part_s.data_ptr(), part_i.data_ptr(),
                          out_s.data_ptr(), out_i.data_ptr(), splits, b,
                          slots)
            VARIANT_LAUNCHES["merge"] += 1
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
