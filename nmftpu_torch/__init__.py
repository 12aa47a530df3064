"""nmftpu_torch — the PyTorch/CUDA port of ``nmftpu`` for NVIDIA Hopper.

A second package beside ``nmftpu`` (the JAX reference, which it never
imports). It mirrors ``nmftpu``'s module names and public surface:

* ``nmf`` / ``compute``: dense multiplicative-update NMF under the
  Frobenius and KL objectives, Gauss–Seidel or Jacobi, with V stored as
  float32, bfloat16 or int8 (int8 x int8 numerators on CUDA kernels,
  ``kernels/dual_numer.py``), and dense HALS (the column sweep on a CUDA
  kernel, ``kernels/hals_sweep.py``);
* ``use_pallas=True`` routes the two MU half-steps to hand-written CUDA
  kernels for sm_90a (``kernels/dense_mu.py``, ``kernels/quantized.py``;
  with int8 V and mu_style="jacobi", the dual-numerator kernel), sources
  in ``csrc/``, built with nvcc at first use;
* init strategies copy / random / mean_columns, the convergence loop
  with threshold, stats and best-of-N restarts;
* sparse V (``nmftpu_torch.sparse`` containers) through ``nmf`` /
  ``compute_sparse`` / ``prepare_sparse``: every algorithm of ``nmftpu``
  (MU, the ALS family, GDCLS, nsNMF, HALS, iALS and masked completion)
  and every init on the ``scatter``, ``ell`` and ``densified`` (bf16 or
  int8 V) engines; on ``ell``, ``use_pallas=True`` runs the MU SpMMs on
  the CUDA ELL segment kernel (``kernels/sparse_ell_kernel.py``);
* ``Recommender``: top-k serving from the factors (exact, approx and
  reservoir scans, certified top-k with an exact fallback, save/load),
  with the reservoir scan and the certificate's count pass as CUDA
  kernels (``kernels/mips_reservoir.py``, ``kernels/count_above.py``);
  ``recall_at_k`` on held-out interactions;
* cold users: ``transform`` (``foldin.py``: MU, ALS and HALS fold-in
  against a frozen item table, dense or sparse rows, float32, bf16 or
  int8 tables, the int8 table's Gram on the int8 kernel) and the
  Recommender's ``fold_in*`` / ``recommend_from_history*``;
* dense float32 MU under the generalized beta divergence
  (``objective="beta-divergence"``); the dense ALS family, GDCLS, nsNMF
  and iALS; the k-means and NNDSVD inits.

``vectorize_runs=True`` and ``mesh=`` raise NotImplementedError naming
their slice in ROADMAP.md (5 and 6).
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
from nmftpu_torch.foldin import TransformResult, prepare_table, transform
from nmftpu_torch.loop import NmfResult, RunStats
from nmftpu_torch.retrieval import recall_at_k
from nmftpu_torch.serving import Recommender
from nmftpu_torch.sparse_ops import compute_sparse, prepare_sparse

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Initialization",
    "MatrixFormat",
    "NmfConfig",
    "NmfResult",
    "Objective",
    "Recommender",
    "RunStats",
    "ThresholdType",
    "TransformResult",
    "compute",
    "compute_sparse",
    "nmf",
    "prepare_sparse",
    "prepare_table",
    "recall_at_k",
    "transform",
    "__version__",
]
