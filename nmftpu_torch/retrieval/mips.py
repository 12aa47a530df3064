"""Top-k maximum-inner-product search over the item factor table (port of
``nmftpu/retrieval/mips.py``).

The score matrix is Wq @ H, so exact MIPS is a blocked GEMM plus a running
top-k merge, never more than (batch, block) scores at a time. Two scans
have hand-written CUDA kernels: the reservoir scan
(``kernels/mips_reservoir.py``) and the certificate's count pass
(``kernels/count_above.py``, routed to from `_count_above`).

Dtype rules (`_operands._scan_operands`, shared by every scoring function
here and by both kernels):
* float32 table: float32 queries times the float32 table;
* bfloat16 table: queries rounded to bf16, the table value exact, float32
  products and sums;
* int8 table with its scale ``h_scale``: a (rank,) vector folds into the
  queries before they are rounded to bf16, a scalar multiplies the scores
  afterwards; the int8 value converts exactly.
The plain form is ``q @ H.float()`` with q already rounded, never a bf16
``torch.matmul`` (its bf16 scores would reorder the top-k). A float32
matmul on the card stays in float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False, torch's default.

``method="approx"``: ``nmftpu`` keeps ``kk`` candidates per block with
``lax.approx_max_k``, a TPU primitive with no Hopper counterpart. The port
takes the same ``kk`` per block with the exact ``torch.topk``, so its
per-block recall is 1, which meets any recall target of the approximate
scan; XLA's ``approx_max_k`` on the CPU is exact too, so ``nmftpu`` on the
CPU returns the same ids.

Ties: ``torch.topk`` does not promise ``lax.top_k``'s lower-index-first
order among equal scores, so results agree with ``nmftpu`` id for id except
where scores tie. Seen-item membership is tested per row with
``torch.searchsorted`` over the sorted seen list, never with a (b, K, S)
broadcast.
"""

from __future__ import annotations

import numpy as np
import torch

from nmftpu_torch._operands import _scan_operands, _tensor

NEG_INF = float("-inf")


def _score_dot(Wq, Hblk, h_scale=None):
    """(b, r) x (r, w) -> (b, w) float32 scores under the dtype rules of
    the module docstring."""
    q, post = _scan_operands(Wq, Hblk.dtype, h_scale)
    out = q @ Hblk.float()
    return out if post is None else out * post


def topk_mips(Wq, H, k, exclude_mask=None, h_scale=None):
    """Exact top-k inner products for a batch of query embeddings.

    Wq: (b, r) queries; H: (r, m) item table. exclude_mask: optional
    (b, m) bool, True entries excluded. Returns (scores (b, k) float32,
    indices (b, k) int32)."""
    scores = _score_dot(Wq, H, h_scale)
    if exclude_mask is not None:
        scores = scores.masked_fill(_tensor(exclude_mask, scores.device),
                                    NEG_INF)
    s, i = torch.topk(scores, k, dim=1)
    return s, i.int()


def topk_mips_blocked(Wq, H, k, block=4096, exclude_mask=None,
                      exclude_lists=None, method="exact",
                      candidate_k=None, h_scale=None):
    """Memory-bounded top-k: stream (r, block) item blocks, keep a running
    top-k. Peak memory is (b, block) scores instead of (b, m).

    Seen-item exclusion takes one of two forms: exclude_mask, a (b, m)
    bool; or exclude_lists, the (ex_user, ex_col) arrays of
    `retrieval.exclusion.build_block_exclusion`, O(total_seen).

    method="exact" keeps each block's top k; method="approx" keeps each
    block's top kk (candidate_k, default k; see the module docstring),
    and the merge across blocks is exact either way."""
    if method not in ("exact", "approx"):
        raise ValueError(
            f"method must be 'exact' or 'approx', got {method!r}"
        )
    if exclude_mask is not None and exclude_lists is not None:
        raise ValueError("pass exclude_mask or exclude_lists, not both")
    if exclude_lists is not None:
        # host-built lists: catch a block-width mismatch that the nblocks
        # count check alone would miss
        ec = exclude_lists[1]
        if isinstance(ec, np.ndarray) and ec.size and int(ec.max()) >= block:
            raise ValueError(
                f"exclude_lists contain block-local column {int(ec.max())}"
                f" >= block={block}; rebuild with this block size"
            )
    return _topk_mips_blocked(Wq, H, k, block, exclude_mask, exclude_lists,
                              method, candidate_k, h_scale)


def _topk_mips_blocked(Wq, H, k, block, exclude_mask, exclude_lists,
                       method, candidate_k, h_scale=None):
    b = Wq.shape[0]
    m = H.shape[1]
    dev = H.device
    nblocks = (m + block - 1) // block
    if exclude_mask is not None:
        exclude_mask = _tensor(exclude_mask, dev, torch.bool)
    ex_user = ex_col = None
    if exclude_lists is not None:
        ex_user, ex_col = (_tensor(x, dev, torch.int64)
                           for x in exclude_lists)
        if ex_user.shape[0] != nblocks:
            raise ValueError(
                f"exclude_lists built for {ex_user.shape[0]} blocks, "
                f"scan has {nblocks} (m={m}, block={block})"
            )
    kk = (k if method == "exact" else
          min(k, block) if candidate_k is None
          else max(1, min(candidate_k, block)))

    best_s = torch.full((b, k), NEG_INF, device=dev)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for blk in range(nblocks):
        lo = blk * block
        hi = min(lo + block, m)
        s = _score_dot(Wq, H[:, lo:hi], h_scale)          # (b, hi - lo)
        if exclude_mask is not None:
            s.masked_fill_(exclude_mask[:, lo:hi], NEG_INF)
        if ex_user is not None:
            eu, ec = ex_user[blk], ex_col[blk]
            keep = (eu >= 0) & (ec >= 0)                  # -1 is padding
            s[eu[keep], ec[keep]] = NEG_INF
        blk_s, pos = torch.topk(s, min(kk, hi - lo), dim=1)
        cand_s = torch.cat([best_s, blk_s], dim=1)
        cand_i = torch.cat([best_i, (pos + lo).int()], dim=1)
        best_s, p = torch.topk(cand_s, k, dim=1)
        best_i = cand_i.gather(1, p)
    return best_s, best_i


def topk_mips_excluded(Wq, H, k, seen, block=4096, method="exact",
                       candidate_k=None, h_scale=None):
    """Blocked top-k MIPS with seen-item exclusion by CANDIDATE
    OVERSAMPLING: the scan runs exclusion-free for k + S candidates, and
    the seen set is dropped at the end. Exact: at most S seen items can
    pollute a row, so the true post-exclusion top-k survives in the top
    k + S. seen: (b, S) int item ids per query row, padded with -1."""
    seen = _tensor(seen, H.device)
    S = seen.shape[1]
    kk = k + S
    if kk > block:
        raise ValueError(
            f"k + seen width = {kk} exceeds block={block}; raise block "
            "or trim the per-user seen lists"
        )
    ck = None if candidate_k is None else candidate_k + S
    s, i = _topk_mips_blocked(Wq, H, kk, block, None, None, method, ck,
                              h_scale)
    return _drop_seen(s, i, seen, k)


def _seen_hits(ids, seen):
    """(b, K) bool: ids[row, j] is one of seen[row] (a -1 padded (b, S)
    id array). One searchsorted per row over the sorted seen list."""
    if seen.shape[1] == 0:
        return torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    srt = torch.sort(seen.long(), dim=1).values
    ids = ids.long().contiguous()
    pos = torch.searchsorted(srt, ids).clamp_(max=srt.shape[1] - 1)
    return srt.gather(1, pos) == ids


def _drop_seen(s, i, seen, k):
    s = s.masked_fill(_seen_hits(i, _tensor(seen, i.device)), NEG_INF)
    top_s, pos = torch.topk(s, k, dim=1)
    return top_s, i.gather(1, pos)


def topk_mips_certified(Wq, H, k, block=1048576, candidate_k=None,
                        h_scale=None, seen=None):
    """Top-k with a PER-ROW exactness certificate: the blocked "approx"
    scan, then a count per row of the items scoring strictly above the
    returned kth score. A count <= k-1 proves the row IS the exact top-k
    up to ties at the kth score. seen: optional (b, S) padded ids,
    excluded exactly (oversampled candidates; their scores are discounted
    from the count). Returns (scores, indices, certified (b,) bool)."""
    if seen is not None:
        seen = _tensor(seen, H.device)
        s, i = topk_mips_excluded(Wq, H, k, seen, block=block,
                                  method="approx", candidate_k=candidate_k,
                                  h_scale=h_scale)
    else:
        s, i = topk_mips_blocked(Wq, H, k, block=block, method="approx",
                                 candidate_k=candidate_k, h_scale=h_scale)
    return s, i, _certify(Wq, H, s, block, h_scale, seen, k)


def certify_topk(Wq, H, top_s, k, block=1048576, h_scale=None, seen=None,
                 h_max=None):
    """The certificate pass alone, for candidate top-k scores from ANY
    scan: certified[u] iff at most k-1 items score strictly above
    top_s[u, k-1] (seen items discounted). H must hold only real items.
    h_max: max |H| of a bf16 table, if known (the count kernel's exact
    band needs it, and reads the table for it otherwise). Returns (b,)
    bool."""
    dev = H.device
    return _certify(Wq, H, _tensor(top_s, dev), block, h_scale,
                    None if seen is None else _tensor(seen, dev), k, h_max)


def _kernel_counts(table_dtype, h_scale) -> bool:
    """The count kernel takes bf16 tables and int8 tables with a (r,)
    scale; other tables keep the plain blocked count, and so the
    reference's rounding (a scalar scale multiplies scores there, while
    the kernel would divide theta)."""
    if table_dtype == torch.bfloat16:
        return True
    return (table_dtype == torch.int8 and h_scale is not None
            and torch.as_tensor(h_scale).ndim == 1)


def _count_above(Wq, H, theta, block, h_scale, h_max=None):
    """Per-row count of items scoring strictly above theta (b,). On the
    card bf16 and vector-scaled int8 tables go to the fused kernel, which
    never writes a score and counts exactly against the k-ordered scores
    of `_gather_scores`; otherwise a blocked GEMM + compare-reduce."""
    if H.is_cuda and _kernel_counts(H.dtype, h_scale):
        from nmftpu_torch.kernels.count_above import count_above_fused

        return count_above_fused(Wq, H, theta, h_scale=h_scale, h_max=h_max)
    m = H.shape[1]
    count = torch.zeros(Wq.shape[0], dtype=torch.int32, device=H.device)
    for lo in range(0, m, block):
        sc = _score_dot(Wq, H[:, lo:lo + block], h_scale)
        count += (sc > theta[:, None]).sum(dim=1, dtype=torch.int32)
    return count


def _certify(Wq, H, top_s, block, h_scale, seen, k, h_max=None):
    m = H.shape[1]
    theta = top_s[:, k - 1].contiguous()                  # kth-best score
    count = _count_above(Wq, H, theta, block, h_scale, h_max)
    if seen is not None:
        # discount excluded items that score above theta: gather their
        # table columns directly (b*S columns, tiny next to the scan).
        # Each distinct id once: a training CSR may repeat a (user, item)
        # pair, and discounting it twice would certify a row that missed
        # an item (nmftpu's _certify does; ROADMAP queue 3).
        seen = torch.sort(seen, dim=1).values
        once = seen >= 0
        once[:, 1:] &= seen[:, 1:] != seen[:, :-1]
        sc_seen = _gather_scores(Wq, H, seen.clamp(0, m - 1), h_scale)
        count = count - ((sc_seen > theta[:, None]) & once).sum(
            dim=1, dtype=torch.int32)
    return count <= k - 1


def rescore_and_sort(Wq, H, ids, h_scale=None, invalid=None, seen=None):
    """Re-score candidate ids (b, S) at the scan's dtype rules and sort
    each row descending; ties keep the lower position first, as
    ``lax.top_k`` does. invalid: optional (b, S) bool marking FILLER ids
    of the upstream scan, which stay -inf; seen: optional (b, S2) padded
    ids, re-masked to -inf (the gather would revive them). Returns
    (scores, ids), both (b, S)."""
    dev = H.device
    ids = _tensor(ids, dev)
    s = _gather_scores(Wq, H, ids.clamp(0, H.shape[1] - 1), h_scale)
    if invalid is not None:
        s = s.masked_fill(_tensor(invalid, dev, torch.bool), NEG_INF)
    if seen is not None:
        s = s.masked_fill(_seen_hits(ids, _tensor(seen, dev)), NEG_INF)
    top_s, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return top_s, ids.gather(1, pos)


def _gather_scores(Wq, H, ids, h_scale=None):
    """Scores for specific (query, item) pairs: (b, r) x H[:, ids] ->
    (b, S) float32 for (b, S) ids, at the dtype rules of `_score_dot`.

    The r products are summed one by one in index order. For bf16 and
    int8 tables each product is exact in float32, so these sums are bit
    for bit the fmaf chains against which the count kernel counts
    (``csrc/count_above.cu``): a threshold taken from these scores meets
    the counted scores with no rounding between them, and the kth item
    never counts as above itself."""
    q, post = _scan_operands(Wq, H.dtype, h_scale)
    b, S = ids.shape
    r = H.shape[0]
    cols = H.index_select(1, ids.reshape(-1).long()).float().view(r, b, S)
    acc = torch.zeros((b, S), dtype=torch.float32, device=H.device)
    for t in range(r):
        acc.addcmul_(cols[t], q[:, t:t + 1])
    return acc if post is None else acc * post
