"""Top-k MIPS over an items-sharded table (port of
``nmftpu/parallel/retrieval_sharded.py``).

Two stages: every rank scans its own slice of the item table for k'
candidates (the blocked scans, or the reservoir kernel, #8, on the
card), then the candidates of the 'items' group are all-gathered and
merged by one more top-k, exactly: traffic O(pi · b · k), whatever m.
The certificate counts each slice on its rank (#9 on the card for bf16
and vector-scaled int8 tables) and sums the counts over 'items'.

Here H is THIS RANK's slice (r, m_loc), every slice of one width, in
'items' order; the queries and the global arrays (exclusion mask and
lists, seen ids) are the same on every rank, and so is the result.
"""

from __future__ import annotations

import torch

from nmftpu_torch._operands import _tensor
# AXIS_USERS is re-exported, as nmftpu's module does
from nmftpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ITEMS,
    AXIS_USERS,
    all_gather,
    psum,
)
from nmftpu_torch.retrieval.mips import (
    NEG_INF,
    _count_above,
    _drop_seen,
    _gather_scores,
    _seen_hits,
    topk_mips_blocked,
)


def topk_mips_sharded(Wq, H, k, mesh, block=4096, exclude_mask=None,
                      exclude_lists=None, seen=None, method="exact",
                      candidate_k=None, h_scale=None,
                      reservoir_slots=4096):
    """Top-k over the items-sharded table; H is this rank's slice.

    Wq: (b, r) queries; exclude_mask: optional (b, m) bool over the
    GLOBAL items, O(b·m), small m only; exclude_lists: (ex_user, ex_col)
    from `build_block_exclusion(..., shards=pi)`, block-bucketed and
    shard-major, each rank taking its own blocks; seen: (b, S) padded
    GLOBAL item ids (-1 padding), the OVERSAMPLING form: every shard
    retrieves k + S candidates, the merge keeps k + S, and one final
    compare drops the seen set. method: "exact", "approx" (each block
    keeps candidate_k, the merges stay exact) or "reservoir" (each shard
    runs the reservoir scan, #8 on the card; the merge stays exact;
    exclusion by `seen` only). Returns (scores (b, k), global item ids
    (b, k)), the same on every rank."""
    has_mask = exclude_mask is not None
    has_lists = exclude_lists is not None
    has_seen = seen is not None
    if has_seen and (has_mask or has_lists):
        raise ValueError("pass seen OR exclude_mask/exclude_lists, not both")
    if method == "reservoir" and (has_mask or has_lists):
        raise ValueError(
            "method='reservoir' excludes via `seen` (or serve without "
            "exclusion); exclude_mask/exclude_lists need the blocked "
            "scans — use method='approx'"
        )
    kk = k + (int(seen.shape[1]) if has_seen else 0)
    ck = None if candidate_k is None else candidate_k + (kk - k)
    if method == "reservoir" and kk > 2 * reservoir_slots:
        raise ValueError(
            f"k + seen width = {kk} exceeds the 2*reservoir_slots = "
            f"{2 * reservoir_slots} per-shard candidates; raise "
            "reservoir_slots or trim the seen lists"
        )
    j = mesh.get_local_rank(AXIS_ITEMS)
    pi = mesh.size(1)
    m_loc = H.shape[1]
    if method == "reservoir":
        from nmftpu_torch.kernels.mips_reservoir import reservoir_topk_mips

        # seen ids are GLOBAL: they are dropped after the merge
        s, idx = reservoir_topk_mips(Wq, H, kk, slots=reservoir_slots,
                                     h_scale=h_scale, m_items=m_loc)
    else:
        mask = lists = None
        if has_mask:
            mask = _tensor(exclude_mask, H.device, torch.bool)[
                :, j * m_loc:(j + 1) * m_loc]
        if has_lists:
            nb = exclude_lists[0].shape[0] // pi
            lists = tuple(x[j * nb:(j + 1) * nb] for x in exclude_lists)
        s, idx = topk_mips_blocked(Wq, H, kk, block=min(block, m_loc),
                                   exclude_mask=mask, exclude_lists=lists,
                                   method=method, candidate_k=ck,
                                   h_scale=h_scale)
    gidx = idx.long() + j * m_loc
    all_s = all_gather(s.contiguous(), mesh, AXIS_ITEMS)     # (pi, b, kk)
    all_i = all_gather(gidx.contiguous(), mesh, AXIS_ITEMS)
    b = all_s.shape[1]
    cand_s = all_s.permute(1, 0, 2).reshape(b, -1)
    cand_i = all_i.permute(1, 0, 2).reshape(b, -1)
    top_s, pos = torch.topk(cand_s, kk, dim=1)
    top_i = cand_i.gather(1, pos).int()
    if has_seen:
        return _drop_seen(top_s, top_i, seen, k)
    return top_s, top_i


def _owned(ids, mesh, m_loc):
    """(local ids clamped into the slice, which ids this rank owns)."""
    loc = ids.long() - mesh.get_local_rank(AXIS_ITEMS) * m_loc
    own = (ids >= 0) & (loc >= 0) & (loc < m_loc)
    return loc.clamp(0, m_loc - 1), own


def gather_scores_sharded(Wq, H, ids, mesh, h_scale=None):
    """Scores of (query, GLOBAL item id) pairs, (b, S), the same on every
    rank: each rank scores the ids in its slice (`_gather_scores`'
    k-ordered chain, so bit for bit the unsharded scores) and the others
    add exact zeros over 'items'."""
    loc, own = _owned(_tensor(ids, H.device), mesh, H.shape[1])
    sc = _gather_scores(Wq, H, loc, h_scale)
    return psum(torch.where(own, sc, 0.0), mesh, AXIS_ITEMS)


def rescore_and_sort_sharded(Wq, H, ids, mesh, h_scale=None, invalid=None,
                             seen=None):
    """`retrieval.mips.rescore_and_sort` over the sharded table: candidate
    ids (b, S) re-scored at the scan's dtype rules and sorted descending
    (ties keep the lower position); `invalid` fillers and `seen` ids stay
    -inf."""
    dev = H.device
    ids = _tensor(ids, dev)
    s = gather_scores_sharded(Wq, H, ids, mesh, h_scale)
    if invalid is not None:
        s = s.masked_fill(_tensor(invalid, dev, torch.bool), NEG_INF)
    if seen is not None:
        s = s.masked_fill(_seen_hits(ids, _tensor(seen, dev)), NEG_INF)
    top_s, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return top_s, ids.gather(1, pos)


def certify_topk_sharded(Wq, H, top_s, k, mesh, block=4096, h_scale=None,
                         seen=None, h_max=None):
    """The exactness certificate over the items-sharded table (contract
    of `retrieval.mips.certify_topk`): each rank counts the items of its
    slice scoring strictly above the kth returned score (#9 on the card
    for bf16 and vector-scaled int8 tables), discounts the seen ids it
    owns (each distinct id once), and the counts are summed over
    'items'. H holds only real items. h_max: max |H| of a bf16 slice, if
    known. Returns certified (b,) bool, the same on every rank."""
    top_s = _tensor(top_s, H.device)
    theta = top_s[:, k - 1].contiguous()
    m_loc = H.shape[1]
    cnt = _count_above(Wq, H, theta, min(block, m_loc), h_scale, h_max)
    if seen is not None:
        seen = torch.sort(_tensor(seen, H.device), dim=1).values
        once = seen >= 0
        once[:, 1:] &= seen[:, 1:] != seen[:, :-1]
        loc, own = _owned(seen, mesh, m_loc)
        sc = _gather_scores(Wq, H, loc, h_scale)
        cnt = cnt - ((sc > theta[:, None]) & own & once).sum(
            dim=1, dtype=torch.int32)
    return psum(cnt, mesh, AXIS_ITEMS) <= k - 1
