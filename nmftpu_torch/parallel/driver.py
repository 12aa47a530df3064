"""The sharded driver (port of ``nmftpu/parallel/driver.py``):
`compute_sharded` factorizes a sparse matrix over the ('users', 'items')
rank mesh on the port's loop (`loop.build_runner`) with sharded
`LoopOps`.

SPMD: every rank calls the same entry point with the same arguments.
Rank (i, j) holds W's row block i (block_rows, r), H's column block j
(r, block_cols) and V's tile (i, j). Factor blocks are allocated at the
tile-padded shapes; padding rows and columns start at zero and stay
there under every update rule, so they never reach an error. A check
sums its scalars over the mesh (every rank gets the same numbers, so
every rank takes the same decision), then syncs with the host once.

Engines: "scatter" (chunked COO, every algorithm), "ell" (gather-only
ELL tiles, the MU family), "ring" (``parallel/ring.py``: a 1-D ring over
every rank of the mesh, H's blocks rotating) and "auto" (as ``nmftpu``
resolves it: scatter for masked runs, ell for MU, else scatter).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from nmftpu_torch import sparse as host_sparse
from nmftpu_torch.config import (
    Algorithm,
    Initialization,
    NmfConfig,
    Objective,
    resolve_dtype,
)
from nmftpu_torch.init import run_generator
from nmftpu_torch.loop import LoopOps, NmfResult, build_runner, execute
from nmftpu_torch.parallel import updates as U
from nmftpu_torch.parallel.init_sharded import (
    block_generator,
    sharded_data_init,
)
from nmftpu_torch.parallel.mesh import (
    AXIS_ITEMS,
    AXIS_RING,
    AXIS_USERS,
    all_gather,
    axis_index,
    check_mesh,
    make_grid_mesh,
    make_ring_mesh,
    mesh_device,
    grid_shape,
    psum,
)
from nmftpu_torch.parallel.sharded_coo import (
    ShardedCOO,
    _round_up,
    block_sizes,
    partition_sparse,
)

_BOTH = (AXIS_USERS, AXIS_ITEMS)
_DATA_DEP = (
    Initialization.MEAN_COLUMNS,
    Initialization.K_MEANS_AND_RANDOM_VALUES,
    Initialization.K_MEANS_AND_NON_NEGATIVE_WTV,
    Initialization.K_MEANS_AND_ABSOLUTE_WTV,
)


def _sharded_ops(config: NmfConfig, mesh, engine: str, n: int, m: int,
                 nnz: int) -> LoopOps:
    masked = config.mask == "observed"
    axes = _BOTH
    if engine == "ring":
        from nmftpu_torch.parallel import ring as RING

        make_aux, update, effective_h = RING.build_ring_update(config, mesh)
        fro, kl = RING.build_ring_errors(mesh)
        if config.objective is Objective.BETA:
            kl = RING.build_ring_beta_error(mesh, config.beta)
        axes = AXIS_RING

        def local_sq(op):
            return sum(torch.sum(t.values * t.values) for t in op.tiles)
    elif engine == "ell":
        from nmftpu_torch.parallel import sharded_ell as SEL

        make_aux, update, effective_h = SEL.build_sharded_ell_update(
            config, mesh)
        fro, kl = SEL.build_sharded_ell_errors(mesh)
        if config.objective is Objective.BETA:
            kl = SEL.build_sharded_ell_beta_error(mesh, config.beta)
        local_sq = SEL.sum_v_sq
    else:
        from nmftpu_torch.sparse_ops import _sum_v_sq

        make_aux, update, effective_h = U.build_sharded_update(config, mesh)
        fro, kl = U.build_sharded_errors(mesh, masked=masked)
        if config.objective is Objective.BETA:
            kl = U.build_sharded_beta_error(mesh, config.beta)

        def local_sq(scoo):
            return _sum_v_sq(scoo.local())

    def sum_v_sq(op):
        if masked:
            return torch.zeros((), dtype=torch.float32)
        return psum(local_sq(op), mesh, axes)

    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda V, aux, W, He, svsq: fro(V, W, He, svsq),
        kl=lambda V, aux, W, He: kl(V, W, He),
        sum_v_sq=sum_v_sq,
        # completion metrics (the RMSD's denominator too) run over the
        # observed set, as the single-device masked bundle's
        numel=lambda V: nnz if masked else n * m,
    )


def _perm_block(X, perm, padded, axis, index, block, dtype, device):
    """Block `index` (of `block` rows, or columns for axis=1) of X
    permuted and padded along `axis`: out[perm[i]] = X[i], zero in the
    padding slots. Only the block is built, on `device`; X (numpy or a
    tensor on any device) is read where it lies."""
    n = X.shape[axis]
    inv = np.full(padded, -1, np.int64)
    inv[np.asarray(perm)] = np.arange(n)
    src = inv[index * block:(index + 1) * block]
    used = np.flatnonzero(src >= 0)
    Xt = X if isinstance(X, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(X))
    if axis == 1:
        Xt = Xt.T
    out = torch.zeros((block, Xt.shape[1]), dtype=dtype, device=device)
    rows = Xt[torch.from_numpy(src[used]).to(Xt.device)]
    out[torch.from_numpy(used).to(device)] = rows.to(device=device,
                                                       dtype=dtype)
    return out if axis == 0 else out.T.contiguous()


def _used_mask(perm, padded, index, block, device):
    """(block,) 1/0: which slots of block `index` hold a real row."""
    used = np.zeros(padded, bool)
    used[np.asarray(perm)] = True
    return torch.from_numpy(used[index * block:(index + 1) * block]).to(device)


class ShardedPlan:
    """This rank's partitioned, device-resident operand, reusable across
    runs: `prepare_sharded` pays the host-side cost once (balancing,
    tile and bucket builds, the copy to the device); `.run()` executes
    the loop on it with any config of the same dtype."""

    def __init__(self, *, V, config, mesh, engine, operand, row_perm,
                 col_perm, mean_v, dtype, chunk, balance, nnz):
        self.V = V
        self.config = config
        self.mesh = mesh
        self.engine = engine
        self.operand = operand
        self.row_perm = row_perm
        self.col_perm = col_perm
        self.padded_shape = operand.padded_shape
        self.block_rows = operand.block_rows
        self.block_cols = operand.block_cols
        self.mean_v = mean_v
        self.dtype = dtype
        self.chunk = chunk
        self.balance = balance
        self.nnz = nnz
        self.shape = operand.shape
        self.coords = operand.coords
        self.device = mesh_device(mesh)
        self._init_scoo = None
        # the axes W and H are sharded over: the grid's, or the ring's
        # one axis for both
        self.row_axis, self.col_axis = ((AXIS_RING, AXIS_RING)
                                        if engine == "ring"
                                        else (AXIS_USERS, AXIS_ITEMS))

    def _data_dep_scoo(self) -> ShardedCOO:
        """The COO tile that the mesh-native data-dependent inits run on
        (built once more, from the same seed, when the plan's engine is
        ELL)."""
        if self._init_scoo is None:
            if self.engine in ("scatter", "ring"):
                self._init_scoo = self.operand
            else:
                self._init_scoo, rp, cp = partition_sparse(
                    self.V, grid_shape(self.mesh), self.coords,
                    dtype=self.dtype, chunk=self.chunk,
                    balance=self.balance, seed=self.config.seed,
                    device=self.device)
                assert np.array_equal(rp, self.row_perm)
                assert np.array_equal(cp, self.col_perm)
        return self._init_scoo

    def _init_fn(self, config: NmfConfig, W0, H0):
        """init_fn(run_idx) -> this rank's (W block, H block)."""
        n, m = self.shape
        pn, pm = self.padded_shape
        br, bc = self.block_rows, self.block_cols
        iu, ii = self.coords
        r, dtype, dev = config.rank, self.dtype, self.device
        method = config.init_method

        if method is Initialization.COPY_EXISTING:
            if W0 is None or H0 is None:
                raise ValueError("COPY_EXISTING requires both W0 and H0")

            def init_fn(run_idx):
                return (_perm_block(W0, self.row_perm, pn, 0, iu, br, dtype,
                                    dev),
                        _perm_block(H0, self.col_perm, pm, 1, ii, bc, dtype,
                                    dev))
            return init_fn

        if method is Initialization.ALL_RANDOM_VALUES:
            # rank-local randomness: W's block from a stream of its
            # 'users' coordinate, H's of its 'items' coordinate, so no
            # rank builds a full factor and each factor is equal along
            # the axis that replicates it
            scale = float(np.sqrt(max(self.mean_v, 1e-12) / r))
            rows = _used_mask(self.row_perm, pn, iu, br, dev)
            cols = _used_mask(self.col_perm, pm, ii, bc, dev)

            def init_fn(run_idx):
                gw = block_generator(config.seed, run_idx, "W", iu, dev)
                gh = block_generator(config.seed, run_idx, "H", ii, dev)
                W = (torch.rand((br, r), generator=gw, dtype=dtype,
                                device=dev) + 1e-4) * scale
                H = (torch.rand((r, bc), generator=gh, dtype=dtype,
                                device=dev) + 1e-4) * scale
                return W * rows[:, None].to(dtype), H * cols[None, :].to(dtype)
            return init_fn

        if method in _DATA_DEP:
            scoo = self._data_dep_scoo()
            if self.engine == "ring":
                from nmftpu_torch.parallel.ring import ring_data_init

                def init_fn(run_idx):
                    return ring_data_init(config, self.mesh, scoo, run_idx)
                return init_fn

            def init_fn(run_idx):
                return sharded_data_init(config, self.mesh, scoo, run_idx)
            return init_fn

        # NNDSVD family: the single-device init on the whole V (the same
        # on every rank), then this rank's blocks
        from nmftpu_torch.sparse_ops import (
            device_put_sparse,
            sparse_initialize_factors,
        )

        coo = device_put_sparse(self.V, dtype=dtype, device=dev)

        def init_fn(run_idx):
            W1, H1 = sparse_initialize_factors(
                coo, r, method, run_generator(config.seed, run_idx, dev),
                kmeans_max_iter=config.kmeans_max_iter)
            return (_perm_block(W1, self.row_perm, pn, 0, iu, br, dtype, dev),
                    _perm_block(H1, self.col_perm, pm, 1, ii, bc, dtype, dev))
        return init_fn

    def run(
        self,
        config: NmfConfig | None = None,
        W0=None,
        H0=None,
        callback: Callable[[Any, Any, Any, Any], None] | None = None,
        interrupt: Callable[[], bool] | None = None,
        unpermute: bool = True,
    ) -> NmfResult:
        """Execute the factorization loop on the prepared partition. Every
        rank calls it alike.

        On every rank the result holds the FULL factors, W (n, r) and H
        (r, m) in the original row and column order, gathered over the
        mesh. With unpermute=False it holds only this rank's blocks, W
        (block_rows, r) and H (r, block_cols), padded and in partition
        order (`row_perm` / `col_perm` attached, ORIGINAL index ->
        PERMUTED index), for callers that keep the factors sharded."""
        if config is None:
            config = self.config
        # the prepare-time checks again: a ring or ELL plan computes the
        # unmasked formula, so a masked run would report a wrong error
        _check_sharded(config, self.engine)
        n, m = self.shape
        if config.rank > min(n, m):
            raise ValueError(
                f"rank {config.rank} exceeds min(V.shape) = {min(n, m)}")
        if resolve_dtype(config.dtype) != self.dtype:
            raise ValueError(
                f"config.dtype {config.dtype} differs from the plan's "
                f"partition dtype {self.dtype}; re-run prepare_sharded")
        # the balancing permutation was drawn from the PREPARE-time seed;
        # a run-time config.seed feeds only the init
        ops = _sharded_ops(config, self.mesh, self.engine, n, m, self.nnz)
        runner = build_runner(config, ops, callback, interrupt)
        result = execute(self.operand, config, runner,
                         self._init_fn(config, W0, H0),
                         numel=(self.nnz if config.mask == "observed"
                                else n * m))
        result.row_perm, result.col_perm = self.row_perm, self.col_perm
        if not unpermute:
            return result
        W = all_gather(result.W, self.mesh, self.row_axis)
        H = all_gather(result.H, self.mesh, self.col_axis)
        W = W.reshape(-1, W.shape[-1])
        H = H.permute(1, 0, 2).reshape(H.shape[1], -1)
        result.W = W[torch.from_numpy(self.row_perm).long().to(W.device)]
        result.H = H[:, torch.from_numpy(self.col_perm).long().to(H.device)]
        return result


def _resolve_engine(config: NmfConfig, engine: str) -> str:
    if engine == "auto":
        if config.mask == "observed":
            return "scatter"
        # MU (generalized beta included, which config pins to MU) takes
        # the gather-only ELL tiles
        return "ell" if config.algorithm is Algorithm.MU else "scatter"
    if engine not in ("ell", "scatter", "ring"):
        raise ValueError(
            f"engine must be 'auto', 'ell', 'scatter' or 'ring', "
            f"got {engine!r}")
    return engine


def _check_sharded(config: NmfConfig, engine: str) -> None:
    if config.mask == "observed" and engine != "scatter":
        raise ValueError(
            "mask='observed' (matrix completion) runs the 'scatter' "
            f"grid engine on the mesh (got engine={engine!r}); the "
            "masked denominators are per-tile SDDMM+SpMM over the "
            "stored set")
    if config.v_storage != "float32":
        raise ValueError(
            f"v_storage={config.v_storage!r} is not supported by the "
            "sparse sharded engines (tile values stay at the compute "
            "dtype); use v_storage='float32' here, the single-device "
            "'densified' engine, or the dense mesh path (compute(V, "
            "cfg, mesh=...)), which do honor quantized storage.")


def prepare_sharded(
    V: host_sparse.SparseMatrix,
    config: NmfConfig,
    mesh=None,
    mesh_shape: tuple[int, int] | None = None,
    balance: bool = True,
    chunk: int = 8192,
    engine: str = "auto",
) -> ShardedPlan:
    """Partition sparse V over the mesh once (every rank passes the whole
    host matrix and keeps its own tile), returning a reusable
    :class:`ShardedPlan`. Without a mesh, one is built over the world
    (`mesh.make_grid_mesh`, CUDA). engine="ring" runs on the 1-D ring
    over all of the mesh's ranks (`mesh.make_ring_mesh`), whatever its
    2-D shape, as ``nmftpu`` does; each rank keeps its row panel."""
    if config.mu_style == "jacobi":
        raise ValueError(
            "mu_style='jacobi' is wired through the dense engine only; "
            "sharded engines run gauss-seidel half-steps")
    if mesh is None:
        mesh = make_grid_mesh(mesh_shape)
    check_mesh(mesh)
    dtype = resolve_dtype(config.dtype)
    n, m = V.shape
    if config.rank > min(n, m):
        raise ValueError(
            f"rank {config.rank} exceeds min(V.shape) = {min(n, m)}")
    engine = _resolve_engine(config, engine)
    _check_sharded(config, engine)
    device = mesh_device(mesh)
    if engine == "ring":
        from nmftpu_torch.parallel.ring import partition_for_ring

        mesh = make_ring_mesh(mesh)
        operand, row_perm, col_perm = partition_for_ring(
            V, mesh.size(0), axis_index(mesh, AXIS_RING), dtype=dtype,
            chunk=chunk, balance=balance, seed=config.seed, device=device)
        mean_v = float(psum(
            sum(torch.sum(t.values) for t in operand.tiles), mesh,
            AXIS_RING)) / (float(n) * float(m))
        return ShardedPlan(V=V, config=config, mesh=mesh, engine=engine,
                           operand=operand, row_perm=row_perm,
                           col_perm=col_perm, mean_v=mean_v, dtype=dtype,
                           chunk=chunk, balance=balance, nnz=operand.nnz)
    coords = (axis_index(mesh, AXIS_USERS), axis_index(mesh, AXIS_ITEMS))
    if engine == "ell":
        from nmftpu_torch.parallel import sharded_ell as SEL

        operand, row_perm, col_perm = SEL.partition_sparse_ell(
            V, grid_shape(mesh), coords, dtype=dtype, balance=balance,
            seed=config.seed, device=device)
        local_sum = sum(torch.sum(b.vals) for b in operand.pair.rows.buckets)
    else:
        operand, row_perm, col_perm = partition_sparse(
            V, grid_shape(mesh), coords, dtype=dtype, chunk=chunk,
            balance=balance, seed=config.seed, device=device)
        local_sum = torch.sum(operand.values)
    mean_v = float(psum(torch.as_tensor(local_sum, device=device), mesh,
                        _BOTH)) / (float(n) * float(m))
    return ShardedPlan(V=V, config=config, mesh=mesh, engine=engine,
                       operand=operand, row_perm=row_perm, col_perm=col_perm,
                       mean_v=mean_v, dtype=dtype, chunk=chunk,
                       balance=balance, nnz=operand.nnz)


def compute_sharded(
    V: host_sparse.SparseMatrix,
    config: NmfConfig,
    mesh=None,
    mesh_shape: tuple[int, int] | None = None,
    W0=None,
    H0=None,
    balance: bool = True,
    chunk: int = 8192,
    engine: str = "auto",
    callback: Callable[[Any, Any, Any, Any], None] | None = None,
    interrupt: Callable[[], bool] | None = None,
) -> NmfResult:
    """Factorize sparse V over the 2-D ('users', 'items') rank mesh (or,
    with engine="ring", over a 1-D ring of all its ranks); every rank
    calls it with the same arguments and gets the full factors in the
    ORIGINAL row and column order (see `ShardedPlan.run`). W0/H0
    (init="copy") are the full factors, numpy or tensors; each rank
    reads its blocks. Repeated factorizations of one matrix should call
    :func:`prepare_sharded` once and ``plan.run(...)`` per run."""
    plan = prepare_sharded(V, config, mesh=mesh, mesh_shape=mesh_shape,
                           balance=balance, chunk=chunk, engine=engine)
    return plan.run(W0=W0, H0=H0, callback=callback, interrupt=interrupt)


class _ShapeOnly:
    """Stands in for V where the plan needs only its shape."""

    def __init__(self, shape):
        self.shape = shape


def prepare_sharded_rowshards(
    local_mat: host_sparse.SparseMatrix,
    row_offset: int,
    global_shape: tuple[int, int],
    config: NmfConfig,
    mesh=None,
    balance: bool = True,
    chunk: int = 8192,
) -> ShardedPlan:
    """A ShardedPlan (scatter engine) where EACH RANK passes only its own
    rows of V (its file shard), so no process ever holds the whole
    nonzero set.

    local_mat: this rank's rows, with LOCAL row indices (0-based);
    row_offset: the index of its first row in the GLOBAL matrix. The
    rows must cover this rank's block on the 'users' axis, and nothing
    outside it. Rows are taken in their given order (shuffle them
    offline for balance); balance=True applies the seeded COLUMN
    permutation only, drawn from config.seed alike on every rank. The
    tile capacity is agreed by an all-reduce of the maximum, the global
    nonzero count and value mass by sums. Random and copy inits only.
    """
    from nmftpu_torch.parallel.sharded_coo import _NUMPY

    if config.init_method not in (Initialization.ALL_RANDOM_VALUES,
                                  Initialization.COPY_EXISTING):
        raise ValueError(
            "row-shard ingestion supports random/copy_existing inits "
            "only (data-dependent inits need a second global partition)")
    if mesh is None:
        mesh = make_grid_mesh()
    dtype = resolve_dtype(config.dtype)
    n, m = global_shape
    pu, pi = grid_shape(mesh)
    iu, ii = axis_index(mesh, AXIS_USERS), axis_index(mesh, AXIS_ITEMS)
    device = mesh_device(mesh)

    coo = local_mat.to_coo()
    rows = coo.row.astype(np.int64) + int(row_offset)
    if balance:
        col_perm = np.random.default_rng(config.seed).permutation(m).astype(
            np.int32)
        cols = col_perm[coo.col]
    else:
        col_perm = np.arange(m, dtype=np.int32)
        cols = coo.col
    row_perm = np.arange(n, dtype=np.int32)
    block_rows, block_cols = block_sizes((n, m), (pu, pi))

    lo, hi = row_offset, row_offset + local_mat.shape[0]
    if iu * block_rows < lo or min((iu + 1) * block_rows, n) > hi:
        raise ValueError(
            f"local row shard [{lo}, {hi}) does not cover this rank's "
            f"users-block {iu} [{iu * block_rows}, "
            f"{min((iu + 1) * block_rows, n)}); align file shards with "
            "the mesh's users-axis blocks")
    stray = np.setdiff1d(np.unique(rows // block_rows), [iu])
    if stray.size:
        raise ValueError(
            f"local row shard [{lo}, {hi}) contains rows in users-"
            f"block(s) {stray.tolist()} not owned by this rank (owned: "
            f"[{iu}]); file shards must partition the row space along "
            "the mesh's users-axis blocks")

    sel = np.flatnonzero(cols // block_cols == ii)
    own = len(sel)
    # the largest tile sets every rank's capacity
    cap = int(psum(torch.tensor(max(own, 1), device=device), mesh, _BOTH,
                   op=torch.distributed.ReduceOp.MAX))
    chunk = min(chunk, _round_up(cap, 256))
    cap = _round_up(cap, chunk)
    values = np.zeros(cap, dtype=_NUMPY[dtype])
    lrows = np.zeros(cap, dtype=np.int32)
    lcols = np.zeros(cap, dtype=np.int32)
    values[:own] = coo.data[sel]
    lrows[:own] = rows[sel] - iu * block_rows
    lcols[:own] = cols[sel] - ii * block_cols
    # per-tile stored counts and value mass, summed over the mesh
    stats = torch.zeros(pu * pi + 1, dtype=torch.float64, device=device)
    stats[iu * pi + ii] = float(np.count_nonzero(coo.data[sel]))
    stats[-1] = float(np.sum(coo.data[sel], dtype=np.float64))
    stats = psum(stats, mesh, _BOTH).cpu().numpy()
    nnz_global = int(psum(torch.tensor(own, device=device), mesh, _BOTH))

    operand = ShardedCOO(
        values=torch.from_numpy(values).to(device),
        rows=torch.from_numpy(lrows).to(device),
        cols=torch.from_numpy(lcols).to(device),
        shape=(n, m), nnz=nnz_global, chunk=chunk, mesh_shape=(pu, pi),
        block_rows=block_rows, block_cols=block_cols, coords=(iu, ii),
        tile_nnz=stats[:-1].astype(np.int64).reshape(pu, pi))
    return ShardedPlan(V=_ShapeOnly((n, m)), config=config, mesh=mesh,
                       engine="scatter", operand=operand, row_perm=row_perm,
                       col_perm=col_perm,
                       mean_v=float(stats[-1]) / (float(n) * float(m)),
                       dtype=dtype, chunk=chunk, balance=balance,
                       nnz=nnz_global)
