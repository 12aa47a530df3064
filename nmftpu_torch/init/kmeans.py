"""Lloyd's k-means over the columns of V (port of
``nmftpu/init/kmeans.py``).

The k-means inits cluster the m columns of V (each an n-vector) into
`rank` groups, and W's columns become the centroids. The assignment is
an (m, r) distance argmin driven by the Vᵀ C product, the centroid
update a one-hot product; the loop runs `max_iter` rounds with no host
synchronization inside it.
"""

from __future__ import annotations

import torch

from nmftpu_torch.linalg.dense import LOCAL


def _lloyd(V, centroids, max_iter: int, sums=LOCAL):
    """`max_iter` Lloyd rounds from `centroids` (n, r) over the columns
    of V (n, m). Returns (centroids (n, r), assignments (m,) int64). An
    empty cluster keeps its centroid. The argmin takes the first of
    tied distances, as ``jnp.argmin`` does. `sums` (``linalg.dense.
    Sums``): V a tile of a mesh, the centroids its rows."""
    rank = centroids.shape[1]
    col_sq = sums.rows(torch.sum(V * V, dim=0))           # (m,)

    def assign(centroids):
        # dist²(j, k) = ||v_j||² - 2 v_j·c_k + ||c_k||²
        cross = sums.rows(V.T @ centroids)                # (m, r)
        cent_sq = sums.rows(torch.sum(centroids * centroids, dim=0))
        d2 = col_sq[:, None] - 2.0 * cross + cent_sq[None, :]
        return torch.argmin(d2, dim=1)

    for _ in range(max_iter):
        onehot = torch.nn.functional.one_hot(assign(centroids),
                                             rank).to(V.dtype)
        total = sums.cols(V @ onehot)                     # (n, r)
        counts = sums.cols(torch.sum(onehot, dim=0))      # (r,)
        new = total / torch.clamp(counts, min=1.0)[None, :]
        centroids = torch.where(counts[None, :] > 0, new, centroids)
    return centroids, assign(centroids)


def kmeans_columns(V, rank: int, gen: torch.Generator, max_iter: int = 25):
    """Cluster the m columns of V (n, m) into `rank` centroids, starting
    from `rank` distinct columns drawn with `gen` (a torch.Generator on
    V's device). Returns (centroids (n, rank), assignments (m,))."""
    cols = torch.randperm(V.shape[1], generator=gen, device=V.device)[:rank]
    return _lloyd(V, V[:, cols], max_iter)
