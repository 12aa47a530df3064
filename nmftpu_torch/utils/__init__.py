"""Utilities: metrics and observability (port of ``nmftpu/utils``)."""

from nmftpu_torch.utils.metrics import (
    JsonlLogger,
    flops_per_iteration,
    trace_session,
)

__all__ = ["JsonlLogger", "flops_per_iteration", "trace_session"]
