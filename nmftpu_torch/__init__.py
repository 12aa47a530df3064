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
  and iALS; the k-means and NNDSVD inits;
* restarts in lockstep on stacked factors (``vectorize_runs=True``) and
  ``compute_batched`` for a stack of problems (``batched.py``);
* the surfaces over all of it: the scikit-learn facade (``NMF``,
  ``MiniBatchNMF``, ``non_negative_factorization``; no sklearn needed),
  online NMF (``minibatch.py``: ``OnlineNMF``, ``minibatch_fit``),
  checkpoints (``checkpoint.py``), consensus rank selection
  (``model_selection.py``), the nmfgpu-style ``compat`` API, the CLI
  (``python -m nmftpu_torch``), its C ABI (``capi/``, driven through
  ``capi_bridge.py``) and JSONL metrics and traces (``utils/``).

* multi-GPU (``parallel/``, slices 6a and 6b): SPMD over
  ``torch.distributed``, one process per rank, on a ('users', 'items')
  mesh (``parallel.make_grid_mesh``): sparse V through ``nmf(...,
  mesh=)`` / ``parallel.compute_sharded`` (the scatter and ELL grid
  engines, and the ring engine ``parallel.ring`` over every rank), dense
  V tiled over the mesh (``parallel.dense_mesh``), ``Recommender(...,
  mesh=)`` / ``recall_at_k(mesh=)`` over an items-sharded table, fold-in
  against it, and ``mesh=`` on the online, checkpoint, facade,
  rank-selection and conversion surfaces; ``parallel.dryrun_multichip``
  drives them all at a small size.
The heavier entry points (the facade, the online and batched engines,
rank selection) load at first use; every submodule is reachable as an
attribute of the package (``nmftpu_torch.sklearn_api.NMF``).
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

_LAZY = {
    "NMF": ("nmftpu_torch.sklearn_api", "NMF"),
    "MiniBatchNMF": ("nmftpu_torch.sklearn_api", "MiniBatchNMF"),
    "non_negative_factorization": (
        "nmftpu_torch.sklearn_api", "non_negative_factorization"
    ),
    "OnlineNMF": ("nmftpu_torch.minibatch", "OnlineNMF"),
    "minibatch_fit": ("nmftpu_torch.minibatch", "minibatch_fit"),
    "rank_selection": ("nmftpu_torch.model_selection", "rank_selection"),
    "compute_batched": ("nmftpu_torch.batched", "compute_batched"),
    "BatchedNmfResult": ("nmftpu_torch.batched", "BatchedNmfResult"),
    "SparsePlan": ("nmftpu_torch.sparse_ops", "SparsePlan"),
    "compute_sharded": ("nmftpu_torch.parallel", "compute_sharded"),
    "prepare_sharded": ("nmftpu_torch.parallel", "prepare_sharded"),
    "ShardedPlan": ("nmftpu_torch.parallel", "ShardedPlan"),
    "make_grid_mesh": ("nmftpu_torch.parallel", "make_grid_mesh"),
}


def __getattr__(name):
    """Lazy re-exports of the heavier entry points; any other name that
    is a submodule is imported (``nmftpu_torch.sklearn_api`` works after
    ``import nmftpu_torch`` alone)."""
    import importlib.util

    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if not name.startswith("_") and \
            importlib.util.find_spec(f"{__name__}.{name}") is not None:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Algorithm",
    "BatchedNmfResult",
    "Initialization",
    "MatrixFormat",
    "MiniBatchNMF",
    "NMF",
    "NmfConfig",
    "NmfResult",
    "Objective",
    "OnlineNMF",
    "Recommender",
    "RunStats",
    "ShardedPlan",
    "SparsePlan",
    "ThresholdType",
    "TransformResult",
    "compute",
    "compute_batched",
    "compute_sharded",
    "compute_sparse",
    "make_grid_mesh",
    "minibatch_fit",
    "nmf",
    "non_negative_factorization",
    "prepare_sharded",
    "prepare_sparse",
    "prepare_table",
    "rank_selection",
    "recall_at_k",
    "transform",
    "__version__",
]
