"""Retrieval layer (port of ``nmftpu/retrieval``): the learned W/H factors
serve as user/item embedding tables scored by top-k maximum-inner-product
search, evaluated with recall@k on held-out interactions."""

from nmftpu_torch.kernels.mips_reservoir import reservoir_topk_mips
from nmftpu_torch.retrieval.evaluate import recall_at_k
from nmftpu_torch.retrieval.mips import (
    topk_mips,
    topk_mips_blocked,
    topk_mips_certified,
    topk_mips_excluded,
)

__all__ = ["topk_mips", "topk_mips_blocked", "topk_mips_certified",
           "topk_mips_excluded", "recall_at_k", "reservoir_topk_mips"]
