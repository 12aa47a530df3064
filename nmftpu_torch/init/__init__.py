"""Factor initialization strategies."""

from nmftpu_torch.init.kmeans import kmeans_columns
from nmftpu_torch.init.strategies import initialize_factors, run_generator

__all__ = ["initialize_factors", "kmeans_columns", "run_generator"]
