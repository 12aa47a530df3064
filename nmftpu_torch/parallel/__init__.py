"""Multi-GPU layer (port of ``nmftpu/parallel``; slice 6a): SPMD over
`torch.distributed`, one process per rank.

* A 2-D ('users', 'items') rank mesh (`mesh.make_grid_mesh`, a
  DeviceMesh): W row-sharded over 'users', H column-sharded over
  'items', V's nonzeros tiled over both.
* One iteration: rank-local SpMM/SDDMM primitives on each tile, the
  (r, r) Grams and the numerators summed over the matching axis
  (`mesh.psum`), the MPI-FAUN 2-D pattern; the scatter and ELL engines
  (`driver.compute_sharded`, `prepare_sharded`,
  `prepare_sharded_rowshards`).
* Sharded retrieval: a top-k per items shard (the reservoir kernel on
  the card), then an all-gather merge; the certificate's counts summed
  over 'items'.

Not ported yet (slice 6b): the ring engine, dense V on a mesh.
"""

from nmftpu_torch.parallel.mesh import (
    AXIS_ITEMS,
    AXIS_USERS,
    STAGED_BYTES,
    all_gather,
    axis_index,
    factor_shardings,
    make_grid_mesh,
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

__all__ = [
    "AXIS_ITEMS",
    "AXIS_USERS",
    "STAGED_BYTES",
    "ShardedCOO",
    "ShardedPlan",
    "all_gather",
    "axis_index",
    "balance_report",
    "certify_topk_sharded",
    "compute_sharded",
    "factor_shardings",
    "initialize_distributed",
    "is_multiprocess",
    "launch",
    "make_grid_mesh",
    "partition_sparse",
    "prepare_sharded",
    "prepare_sharded_rowshards",
    "psum",
    "topk_mips_sharded",
]
