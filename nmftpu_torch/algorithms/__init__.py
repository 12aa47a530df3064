"""Algorithm dispatch: config -> update-step callables."""

from nmftpu_torch.algorithms.registry import build_dense_update

__all__ = ["build_dense_update"]
