"""recall@k evaluation on held-out interactions (port of
``nmftpu/retrieval/evaluate.py``)."""

from __future__ import annotations

import numpy as np
import torch

from nmftpu_torch._operands import _tensor
from nmftpu_torch.retrieval.exclusion import build_block_exclusion
from nmftpu_torch.retrieval.mips import topk_mips_blocked
from nmftpu_torch.sparse import SparseMatrix


def recall_at_k(
    W,
    H,
    test_pairs: np.ndarray,
    train: SparseMatrix | None = None,
    k: int = 100,
    batch_users: int = 1024,
    block: int = 4096,
    mesh=None,
    method: str = "exact",
) -> float:
    """Fraction of held-out (user, item) pairs whose item appears in the
    user's top-k recommendations (training items excluded from the
    candidates through block-bucketed lists, never an O(batch·m) mask).

    W: (n, r) user factors; H: (r, m) item factors, a tensor (scored on
    its device) or an array (scored on the CPU); test_pairs: (t, 2)
    [user, item]. With ``mesh`` (every rank calling alike with the full
    W and H) each rank scores its slice of H on the 'items' axis, on its
    mesh device, through the two-stage sharded top-k
    (``parallel.topk_mips_sharded``); m must divide evenly."""
    m = H.shape[1]
    shards = 1
    if mesh is not None:
        from nmftpu_torch.parallel.mesh import AXIS_ITEMS, mesh_device

        shards = mesh.size(1)
        if m % shards:
            raise ValueError(f"m={m} must divide into {shards} item shards")
        j, m_loc = mesh.get_local_rank(AXIS_ITEMS), m // shards
        H = _tensor(H[:, j * m_loc:(j + 1) * m_loc], mesh_device(mesh))
    H = H if isinstance(H, torch.Tensor) else _tensor(H, "cpu")
    W = _tensor(W, H.device, torch.float32)
    test_pairs = np.asarray(test_pairs)
    if test_pairs.size == 0:
        return float("nan")
    train_csr = train.to_csr() if train is not None else None

    users = np.unique(test_pairs[:, 0])
    by_user: dict[int, list[int]] = {}
    for u, i in test_pairs:
        by_user.setdefault(int(u), []).append(int(i))

    hits = 0
    total = 0
    for start in range(0, len(users), batch_users):
        batch = users[start:start + batch_users]
        Wq = W[_tensor(batch, H.device, torch.int64)]
        lists = (build_block_exclusion(batch, train_csr, m, block,
                                       shards=shards)
                 if train_csr is not None else None)
        if mesh is not None:
            from nmftpu_torch.parallel.retrieval_sharded import (
                topk_mips_sharded,
            )

            scr, idx = topk_mips_sharded(Wq, H, k, mesh, block=block,
                                         exclude_lists=lists, method=method)
        else:
            scr, idx = topk_mips_blocked(Wq, H, k, block=block,
                                         exclude_lists=lists, method=method)
        idx = idx.cpu().numpy()
        scr = scr.cpu().numpy()
        for bi, u in enumerate(batch):
            # -inf slots are fillers (fewer than k valid candidates):
            # counting their placeholder index would inflate recall
            valid = scr[bi] > -np.inf
            top = set(idx[bi][valid].tolist())
            for item in by_user[int(u)]:
                hits += item in top
                total += 1
    return hits / total
