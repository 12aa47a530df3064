"""Data layer: the MovieLens loaders and the synthetic generators (numpy
only)."""

from nmftpu_torch.data.movielens import (
    Interactions,
    load_movielens,
    train_test_split_by_user,
)
from nmftpu_torch.data.synthetic import (
    synthetic_lowrank_dense,
    synthetic_powerlaw_sparse,
)

__all__ = [
    "Interactions",
    "load_movielens",
    "train_test_split_by_user",
    "synthetic_lowrank_dense",
    "synthetic_powerlaw_sparse",
]
