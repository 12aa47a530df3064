"""Synthetic implicit feedback (clicks) with ML-20M-as-clicks' shape and
skew, made on the device from a seed: `ratings.py`'s draws (lognormal
counts of at least `min_per_user` a user, the multiset fixed by
`shape_seed`; items without replacement with Zipf popularity 1 /
rank^`zipf`), with `n_clicks` nonzeros and every value set to 1, as a
binarized click matrix holds."""

from __future__ import annotations

import torch

from benchmark.datagen import ratings

host_csr = ratings.host_csr
uniform_factors = ratings.uniform_factors


def make(data: dict, seed: int, device) -> dict:
    """Row-sorted COO (rows int64, cols int64, vals float32 ones) on
    `device`, columns ascending within a row, and the per-row counts."""
    coo = ratings.make(dict(data, n_ratings=data["n_clicks"]), seed, device)
    coo["vals"] = torch.ones_like(coo["vals"])
    return coo


def training(data: dict, seed: int, device) -> dict:
    """The clicks as row-sorted device COO (`make`)."""
    return make(data, seed, device)
