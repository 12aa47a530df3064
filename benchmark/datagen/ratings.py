"""Synthetic ratings with ML-20M's shape and skew, made on the device from
a seed (the generator of the port's ``chip_smoke.py`` `synthetic_ratings`,
emitting row-sorted COO from the same draws instead of a dense matrix).

Users rate at least `min_per_user` items with lognormal counts; items are
picked without replacement with Zipf-like popularity 1 / rank^`zipf`
(Efraimidis–Spirakis keys log(u) / w); ratings are half stars 0.5 .. 5.0.
The multiset of per-user counts comes from the configuration's fixed
`shape_seed`, and the run's seed only permutes which user gets which
count and which item gets which popularity: every seed does the same
amount of work, in another order.
"""

from __future__ import annotations

import numpy as np
import torch


def _counts(n: int, m: int, nnz: int, floor: int, shape_seed: int):
    gen = torch.Generator().manual_seed(shape_seed)
    w = torch.exp(torch.randn(n, generator=gen, dtype=torch.float64))
    extra = nnz - floor * n
    counts = floor + torch.floor(extra * w / w.sum()).long()
    short = nnz - int(counts.sum())
    counts[torch.argsort(counts)[:short]] += 1
    if int(counts.sum()) != nnz or int(counts.max()) > m:
        raise ValueError("rating counts do not fit the shape")
    return counts


def make(data: dict, seed: int, device) -> dict:
    """Row-sorted COO (rows int64, cols int64, vals float32) on `device`,
    columns ascending within a row, and the per-row counts."""
    n, m, nnz = data["n_users"], data["n_items"], data["n_ratings"]
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = _counts(n, m, nnz, data["min_per_user"], data["shape_seed"])
    counts = counts.to(device)[torch.randperm(n, generator=gen,
                                              device=device)]
    pop = 1.0 / torch.arange(1, m + 1, device=device,
                             dtype=torch.float32) ** data["zipf"]
    pop = pop[torch.randperm(m, generator=gen, device=device)]
    rows, cols, vals = [], [], []
    chunk = max(1, data.get("rows_per_chunk", 2048))
    for lo in range(0, n, chunk):
        c = counts[lo:lo + chunk]
        u = torch.rand(len(c), m, generator=gen, device=device)
        keys = torch.log(u) / pop
        kmax = int(c.max())
        top = torch.topk(keys, kmax, dim=1).indices
        del u, keys
        keep = torch.arange(kmax, device=device)[None, :] < c[:, None]
        top = torch.where(keep, top, m)
        top = torch.sort(top, dim=1).values
        stars = torch.randint(1, 11, (len(c), kmax), generator=gen,
                              device=device).float() * 0.5
        keep = top < m
        r = torch.arange(lo, lo + len(c), device=device)[:, None]
        rows.append(r.expand(-1, kmax)[keep])
        cols.append(top[keep])
        vals.append(stars[keep])
    return {"n": n, "m": m, "nnz": nnz, "counts": counts,
            "rows": torch.cat(rows), "cols": torch.cat(cols),
            "vals": torch.cat(vals)}


def host_csr(coo: dict):
    """The program's host CSR container of the ratings."""
    from nmftpu_torch.sparse import SparseCSR

    counts = coo["counts"].cpu().numpy().astype(np.int64)
    indptr = np.zeros(coo["n"] + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return SparseCSR(indptr, coo["cols"].cpu().numpy().astype(np.int32),
                     coo["vals"].cpu().numpy(), (coo["n"], coo["m"]))


def uniform_factors(n: int, m: int, r: int, seed: int, device,
                    scale: float = 1.0):
    """W (n, r) and H (r, m), (u + 1e-4) · scale with u uniform, made on
    the device from a stream of its own."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    W = torch.rand(n, r, generator=gen, device=device).add_(1e-4)
    H = torch.rand(r, m, generator=gen, device=device).add_(1e-4)
    return W.mul_(scale), H.mul_(scale)


def training(data: dict, seed: int, device) -> dict:
    """The ratings as row-sorted device COO (`make`)."""
    return make(data, seed, device)

