"""Multi-GPU layer (port of ``nmftpu/parallel``; slices 6a and 6b): SPMD
over `torch.distributed`, one process per rank.

* A 2-D ('users', 'items') rank mesh (`mesh.make_grid_mesh`, a
  DeviceMesh): W row-sharded over 'users', H column-sharded over
  'items', V's nonzeros tiled over both.
* One iteration: rank-local SpMM/SDDMM primitives on each tile, the
  (r, r) Grams and the numerators summed over the matching axis
  (`mesh.psum`), the MPI-FAUN 2-D pattern; the scatter and ELL engines
  (`driver.compute_sharded`, `prepare_sharded`,
  `prepare_sharded_rowshards`).
* The ring engine (`ring`, ``engine="ring"``): a 1-D ring over every
  rank, H's blocks rotating (`mesh.ppermute`).
* Dense V on the mesh (`dense_mesh`, ``driver.compute(mesh=)``): V
  tiled, each route's products summed over the contracted axis.
* Sharded retrieval: a top-k per items shard (the reservoir kernel on
  the card), then an all-gather merge; the certificate's counts summed
  over 'items'.
* `dryrun_multichip`: every sharded surface at a small size on gloo
  ranks.
"""

from nmftpu_torch.parallel.mesh import (
    AXIS_ITEMS,
    AXIS_RING,
    AXIS_USERS,
    STAGED_BYTES,
    all_gather,
    axis_index,
    factor_shardings,
    make_grid_mesh,
    make_ring_mesh,
    ppermute,
    psum,
)
from nmftpu_torch.parallel.multihost import (
    initialize_distributed,
    is_multiprocess,
    launch,
)
from nmftpu_torch.parallel.sharded_coo import (
    ShardedCOO,
    balance_report,
    partition_sparse,
)
from nmftpu_torch.parallel.driver import (
    ShardedPlan,
    compute_sharded,
    prepare_sharded,
    prepare_sharded_rowshards,
)
from nmftpu_torch.parallel.retrieval_sharded import (
    certify_topk_sharded,
    topk_mips_sharded,
)
from nmftpu_torch.parallel import ring
from nmftpu_torch.parallel.dryrun import dryrun_multichip

__all__ = [
    "AXIS_ITEMS",
    "AXIS_RING",
    "AXIS_USERS",
    "STAGED_BYTES",
    "ShardedCOO",
    "ShardedPlan",
    "all_gather",
    "axis_index",
    "balance_report",
    "certify_topk_sharded",
    "compute_sharded",
    "dryrun_multichip",
    "factor_shardings",
    "initialize_distributed",
    "is_multiprocess",
    "launch",
    "make_grid_mesh",
    "make_ring_mesh",
    "partition_sparse",
    "prepare_sharded",
    "prepare_sharded_rowshards",
    "ppermute",
    "psum",
    "ring",
    "topk_mips_sharded",
]
