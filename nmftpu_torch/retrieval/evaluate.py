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
    [user, item]. ``mesh=`` belongs to the multi-GPU path, not ported
    yet."""
    if mesh is not None:
        raise NotImplementedError(
            "recall_at_k(mesh=...) belongs to the multi-GPU path, not "
            "ported yet (ROADMAP queue 1, slice 6)"
        )
    H = H if isinstance(H, torch.Tensor) else _tensor(H, "cpu")
    W = _tensor(W, H.device, torch.float32)
    test_pairs = np.asarray(test_pairs)
    if test_pairs.size == 0:
        return float("nan")
    m = H.shape[1]
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
        lists = (build_block_exclusion(batch, train_csr, m, block)
                 if train_csr is not None else None)
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
