"""Synthetic matrices, numpy only (the port's copy of
``nmftpu/data/synthetic.py``: the dense low-rank generator and the
power-law generator that BASELINE config 3 is built with; the same seed
gives the same arrays)."""

from __future__ import annotations

import numpy as np

from nmftpu_torch.sparse import SparseCOO


def synthetic_lowrank_dense(
    n, m, rank, noise=0.01, seed=0, dtype=np.float32
):
    """Nonnegative dense n x m V with an exact nonnegative rank-`rank`
    structure W H (W, H uniform in [0.1, 1)), plus `noise` times uniform
    [0, 1) entries."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.1, 1.0, size=(n, rank)).astype(dtype)
    H = rng.uniform(0.1, 1.0, size=(rank, m)).astype(dtype)
    V = W @ H
    if noise > 0:
        V = V + noise * rng.uniform(0.0, 1.0, size=(n, m)).astype(dtype)
    return V.astype(dtype)


def synthetic_powerlaw_sparse(
    n, m, nnz, rank=16, alpha_user=1.1, alpha_item=1.1, seed=0,
    dtype=np.float32,
):
    """Sparse n x m interaction matrix with Zipf-like user and item
    popularity and a planted nonnegative rank-`rank` signal in the
    values.

    Row and column marginals follow truncated power laws (exponents
    alpha_user, alpha_item): the load imbalance of real recommender
    matrices. Duplicate (user, item) draws collapse to one entry, so the
    returned nnz is below the requested `nnz`, by much for steep laws at
    high density: read it from the result."""
    rng = np.random.default_rng(seed)

    def powerlaw_probs(k, alpha):
        p = (1.0 + np.arange(k)) ** (-alpha)
        return p / p.sum()

    users = rng.choice(n, size=nnz, p=powerlaw_probs(n, alpha_user))
    items = rng.choice(m, size=nnz, p=powerlaw_probs(m, alpha_item))
    keys = users.astype(np.int64) * m + items
    _, idx = np.unique(keys, return_index=True)
    users, items = users[idx], items[idx]

    Wp = rng.uniform(0.1, 1.0, size=(n, rank)).astype(dtype)
    Hp = rng.uniform(0.1, 1.0, size=(rank, m)).astype(dtype)
    vals = np.einsum("ij,ji->i", Wp[users], Hp[:, items]).astype(dtype)
    vals += 0.05 * rng.standard_normal(len(vals)).astype(dtype)
    vals = np.maximum(vals, 0.05).astype(dtype)

    return SparseCOO(
        row=users.astype(np.int32),
        col=items.astype(np.int32),
        data=vals,
        shape=(n, m),
    )
