"""A retrieval catalog at a configuration's size and width, made on the
device (the port's ``chip_smoke.py`` `serving_data` and
`distinct_items`): the item table H (r, m) uniform times per-dimension
magnitudes from 1 down to
`h_low` (the spread that per-dimension int8 scales exist for), drawn from
the configuration's `table_seed`: one catalog, as a deployment serves
one. The run's seed draws the users' W (n, r), uniform, and their
`seen_per_user` distinct items, uniform over the catalog. Which items the
reservoir's slots make collide, and so how many rows need the exact
fallback, is the table's: a table drawn from each run's seed made that
work differ from seed to seed (4.0 to 10.3 fallback rows a request)."""

from __future__ import annotations

import numpy as np
import torch


def distinct_items(n: int, m: int, per_user: int, gen, device):
    """(n, per_user) int32 numpy array of sorted distinct item ids per
    user: draw a few spare, drop repeats (they sort last as m), keep the
    first `per_user`."""
    items = torch.randint(0, m, (n, per_user + 8), generator=gen,
                          device=device)
    items = torch.sort(items, dim=1).values
    items[:, 1:].masked_fill_(items[:, 1:] == items[:, :-1], m)
    items = torch.sort(items, dim=1).values[:, :per_user]
    if int(items.max()) >= m:
        raise ValueError("too many repeated draws for one user")
    return items.int().cpu().numpy()


def serving(data: dict, seed: int, device) -> dict:
    """W, H and the seen lists of the catalog."""
    from nmftpu_torch.sparse import SparseCSR

    n, m, r = data["n_users"], data["n_items"], data["rank"]
    per_user = data["seen_per_user"]
    chunk = data.get("columns_per_chunk", 1 << 20)
    tgen = torch.Generator(device=device).manual_seed(data["table_seed"])
    mag = torch.logspace(0, float(np.log10(data["h_low"])), r,
                         device=device)[:, None]
    H = torch.empty(r, m, device=device)
    for lo in range(0, m, chunk):
        H[:, lo:lo + chunk] = torch.rand(r, min(chunk, m - lo),
                                         generator=tgen, device=device) * mag
    gen = torch.Generator(device=device).manual_seed(seed)
    W = torch.rand(n, r, generator=gen, device=device)
    items = distinct_items(n, m, per_user, gen, device)
    indptr = np.arange(0, n * per_user + 1, per_user, dtype=np.int64)
    train = SparseCSR(indptr, items.reshape(-1),
                      np.ones(n * per_user, np.float32), (n, m))
    return {"W": W, "H": H, "train": train}
