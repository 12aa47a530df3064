"""MovieLens loaders (port of ``nmftpu/data/movielens.py``; BASELINE
configs 1-3).

Reads both on-disk formats:
  * ML-100K  `u.data`      — tab-separated  user  item  rating  timestamp
  * ML-20M   `ratings.csv` — header line  userId,movieId,rating,timestamp

Raw ids are remapped to contiguous [0, n_users) x [0, n_items) indices in
sorted order of the original ids and returned as an `Interactions` bundle
around the port's host `SparseCOO`. The C++ parser of
``native/nmftpu_io.cc`` (``nmftpu_torch.native_loader``) reads the same
files into the same arrays; the numpy parser here is its semantic
reference.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from nmftpu_torch import native_loader
from nmftpu_torch.sparse import SparseCOO


@dataclasses.dataclass
class Interactions:
    """A user-item interaction matrix plus the id maps that produced it."""

    matrix: SparseCOO              # (n_users, n_items) ratings or clicks
    user_ids: np.ndarray           # original user id of each row index
    item_ids: np.ndarray           # original item id of each column index
    timestamps: np.ndarray | None  # per-nonzero timestamps (same order)

    @property
    def n_users(self) -> int:
        return self.matrix.shape[0]

    @property
    def n_items(self) -> int:
        return self.matrix.shape[1]


def _parse_file(path: str):
    """(users, items, ratings, timestamps) raw arrays of a ratings file."""
    with open(path, "rb") as f:
        head = f.readline()
    fields = [("u", np.int64), ("i", np.int64), ("r", np.float32),
              ("t", np.int64)]
    if b"," in head:  # ratings.csv (ML-20M style), maybe with a header
        skip = 1 if head.lower().startswith(b"userid") else 0
        raw = np.genfromtxt(path, delimiter=",", skip_header=skip,
                            dtype=fields)
    else:  # u.data (ML-100K style): tab separated, no header
        raw = np.genfromtxt(path, delimiter="\t", dtype=fields)
    return raw["u"], raw["i"], raw["r"], raw["t"]


def load_movielens(path: str, implicit: bool = False,
                   use_native: bool | None = None) -> Interactions:
    """Load a MovieLens ratings file into an Interactions bundle.

    implicit=True sets every rating to 1.0 (click or watch events, the
    confidence-weighted configs). use_native: None takes the C++ parser
    when the library is built, else the numpy parser; True requires the
    C++ parser (RuntimeError when the library is not built); False takes
    the numpy parser.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if use_native is not False:
        if native_loader.available():
            rows, cols, vals, ts, user_ids, item_ids = (
                native_loader.parse_movielens(path, implicit=implicit))
            return Interactions(
                matrix=SparseCOO(row=rows, col=cols, data=vals,
                                 shape=(len(user_ids), len(item_ids))),
                user_ids=user_ids, item_ids=item_ids, timestamps=ts)
        if use_native:
            raise RuntimeError(
                "native parser requested but libnmftpu_io.so is not built "
                "(run nmftpu_torch.native_loader.build())")

    users, items, ratings, ts = _parse_file(path)
    uniq_u, u_idx = np.unique(users, return_inverse=True)
    uniq_i, i_idx = np.unique(items, return_inverse=True)
    values = np.ones_like(ratings) if implicit else ratings
    mat = SparseCOO(row=u_idx.astype(np.int32), col=i_idx.astype(np.int32),
                    data=values.astype(np.float32),
                    shape=(len(uniq_u), len(uniq_i)))
    return Interactions(matrix=mat, user_ids=uniq_u, item_ids=uniq_i,
                        timestamps=ts)


def train_test_split_by_user(inter: Interactions, holdout_per_user: int = 1,
                             seed: int = 0, by_time: bool = True):
    """Hold out `holdout_per_user` interactions of each user for
    evaluation (the recall@k harness, BASELINE config 5).

    by_time=True holds out each user's latest interactions (leave latest
    out); otherwise a uniform draw from numpy's default_rng(seed). Users
    with at most `holdout_per_user` interactions keep all of them in
    train. Returns (train SparseCOO, test_pairs (n_test, 2) [user,
    item]).
    """
    coo = inter.matrix
    rng = np.random.default_rng(seed)
    order = np.argsort(coo.row, kind="stable")
    rows, cols, data = coo.row[order], coo.col[order], coo.data[order]
    ts = (inter.timestamps[order]
          if by_time and inter.timestamps is not None else None)

    test_mask = np.zeros(len(rows), dtype=bool)
    users = np.arange(inter.n_users)
    starts = np.searchsorted(rows, users)
    ends = np.searchsorted(rows, users + 1)
    for s, e in zip(starts, ends):
        cnt = e - s
        if cnt <= holdout_per_user:
            continue
        if ts is not None:
            local = np.argsort(ts[s:e], kind="stable")[-holdout_per_user:]
        else:
            local = rng.choice(cnt, size=holdout_per_user, replace=False)
        test_mask[s + local] = True

    train = SparseCOO(row=rows[~test_mask], col=cols[~test_mask],
                      data=data[~test_mask], shape=coo.shape)
    test_pairs = np.stack([rows[test_mask], cols[test_mask]], axis=1)
    return train, test_pairs
