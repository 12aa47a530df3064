"""nmftpu_torch — the PyTorch/CUDA port of ``nmftpu`` for NVIDIA Hopper.

A second package beside ``nmftpu`` (the JAX reference, which it never
imports). It mirrors ``nmftpu``'s module names and public surface:

* ``nmf`` / ``compute``: dense multiplicative-update NMF under the
  Frobenius objective, with V stored as float32, bfloat16 or int8;
* ``use_pallas=True`` routes the two MU half-steps to hand-written CUDA
  kernels for sm_90a (``kernels/dense_mu.py``, ``kernels/quantized.py``,
  sources in ``csrc/``), built with nvcc at first use;
* init strategies copy / random / mean_columns, the convergence loop
  with threshold, stats and best-of-N restarts.

Configurations not ported yet raise NotImplementedError naming their
slice in ROADMAP.md.
"""

from nmftpu_torch.api import nmf
from nmftpu_torch.config import (
    Algorithm,
    Initialization,
    MatrixFormat,
    NmfConfig,
    Objective,
    ThresholdType,
)
from nmftpu_torch.driver import compute
from nmftpu_torch.loop import NmfResult, RunStats

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Initialization",
    "MatrixFormat",
    "NmfConfig",
    "NmfResult",
    "Objective",
    "RunStats",
    "ThresholdType",
    "compute",
    "nmf",
    "__version__",
]
