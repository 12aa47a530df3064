"""Factor initialization strategies."""

from nmftpu_torch.init.strategies import initialize_factors, run_generator

__all__ = ["initialize_factors", "run_generator"]
