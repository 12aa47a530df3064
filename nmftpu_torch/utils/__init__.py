"""Utilities: metrics and observability (port of ``nmftpu/utils``)."""

from nmftpu_torch.utils.metrics import (
    JsonlLogger,
    counters,
    flops_per_iteration,
    span,
    trace_session,
)

__all__ = ["JsonlLogger", "counters", "flops_per_iteration", "span",
           "trace_session"]
