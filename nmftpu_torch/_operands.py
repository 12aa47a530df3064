"""Operand helpers shared by the scan kernels' wrappers
(``kernels/mips_reservoir.py``, ``kernels/count_above.py``) and the
retrieval layer (``retrieval/mips.py``): tensor conversion, and the query
side of the scoring rule, which lives here once."""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """x (a tensor or an array-like) as a tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def _scan_operands(Wq, table_dtype, h_scale):
    """The query side of the scoring rule for a table of `table_dtype`:
    (q, post) with q (b, r) float32 holding the values the table is
    multiplied with, and post the scalar scale that multiplies the scores
    afterwards, or None."""
    if not table_dtype.is_floating_point:
        if h_scale is None:
            raise ValueError(
                "an integer item table needs its quantization scale "
                "(h_scale) — raw int scores would be off by the factor"
            )
        hs = _tensor(h_scale, Wq.device, torch.float32)
        if hs.ndim == 1:
            return (Wq.float() * hs).to(torch.bfloat16).float(), None
        return Wq.to(torch.bfloat16).float(), hs
    if h_scale is not None:
        raise ValueError(
            "h_scale is only meaningful with an integer (quantized) "
            "item table; it would be silently dropped here"
        )
    if table_dtype == torch.bfloat16:
        return Wq.to(torch.bfloat16).float(), None
    return Wq.float(), None
