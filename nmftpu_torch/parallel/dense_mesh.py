"""Dense V on the ('users', 'items') rank mesh (port of the ``mesh=``
branch of ``nmftpu/driver.py``).

V is padded with zero rows and columns to a multiple of the mesh and
tiled: rank (i, j) holds V's tile (i, j), W's row block i and H's column
block j. ``nmftpu`` leaves the partitioning to GSPMD; here it is written
out. The updates are the one-device routes of ``algorithms.registry``
on the tile, given `MeshSums`: each contraction over V's columns (V Hᵀ,
H Hᵀ, H's row sums) is summed over 'items', each over V's rows over
'users', and the epilogues (the MU quotients, the r x r solves, the
HALS sweeps) run on each rank's own block, equal along the axis that
replicates it.

The kernels run where a half-step is local: with use_pallas, a mesh
whose items axis is 1 runs the W half whole on #2 (#4 for int8 V), one
whose users axis is 1 the H half on #1 (#3); a half whose sum spans
ranks sums its numerator and ends on #5 (``fused_multiply_divide``).
On int8 V the int8 x int8 numerators come from #6 per tile, summed in
int32 (they wrap as the unsharded sums do), and the scales of V, W and
H are the whole matrix's (a max over the mesh).

The inits: a copy pads W0 and H0 with zeros; random values are the
one-device run's draws, so a mesh run starts where the unsharded one
does; the data-dependent inits are ``init.initialize_factors`` of the
zero-padded V, as ``nmftpu`` runs them, in tile form (k-means and mean
columns on the tiles, NNDSVD's SVD on the host of the first rank).

Errors run on each tile's real rows and columns and are summed, so the
padding adds nothing; the RMSD divides by the true n·m.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from nmftpu_torch.algorithms.registry import build_dense_update
from nmftpu_torch.config import (
    Initialization,
    NmfConfig,
    Objective,
    resolve_dtype,
)
from nmftpu_torch.init import run_generator
from nmftpu_torch.init.kmeans import _lloyd
from nmftpu_torch.init.strategies import _random_uniform
from nmftpu_torch.linalg import dense as D
from nmftpu_torch.loop import LoopOps, NmfResult, build_runner, execute
from nmftpu_torch.parallel.mesh import (
    AXIS_ITEMS,
    AXIS_USERS,
    all_gather,
    axis_index,
    check_mesh,
    grid_shape,
    mesh_device,
    psum,
)
from nmftpu_torch.parallel.updates import frobenius_grid

_BOTH = (AXIS_USERS, AXIS_ITEMS)


@dataclasses.dataclass(frozen=True)
class DenseTile:
    """This rank's tile of V (zero padded to the block shape) and the
    layout every rank shares."""

    V: torch.Tensor               # (block_rows, block_cols)
    shape: tuple[int, int]        # the true (n, m)
    coords: tuple[int, int]       # this rank's (i, j)

    @property
    def block(self) -> tuple[int, int]:
        return tuple(self.V.shape)

    @property
    def valid(self) -> tuple[int, int]:
        """Rows and columns of the tile that hold V (the rest is pad)."""
        (n, m), (br, bc), (i, j) = self.shape, self.block, self.coords
        return (min(max(n - i * br, 0), br), min(max(m - j * bc, 0), bc))


def block_shape(shape, mesh_shape) -> tuple[int, int]:
    """V padded to a multiple of the mesh, as ``nmftpu`` pads it, then
    split evenly."""
    (n, m), (pu, pi) = shape, mesh_shape
    return -(-n // pu), -(-m // pi)


def _tile_of(V, rows: slice, cols: slice, block, dtype, device):
    """V[rows, cols] (numpy, including a memory map, or a tensor on any
    device) zero padded to `block`, on `device`: only the tile is read."""
    part = V[rows, cols]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    out = torch.zeros(block, dtype=dtype, device=device)
    out[:part.shape[0], :part.shape[1]] = part.to(device=device, dtype=dtype)
    return out


class MeshSums(D.Sums):
    """The routes' sums (``linalg.dense.Sums``) over the mesh: a W-side
    partial over 'items', an H-side one over 'users', a scalar over both.
    A half-step is local where the axis it sums over has one rank."""

    def __init__(self, mesh):
        self.mesh = mesh
        pu, pi = grid_shape(mesh)
        self.local_w, self.local_h = pi == 1, pu == 1

    def _sum(self, x, axis, maximum):
        return psum(x, self.mesh, axis,
                    dist.ReduceOp.MAX if maximum else dist.ReduceOp.SUM)

    def cols(self, x, maximum=False):
        return self._sum(x, AXIS_ITEMS, maximum)

    def rows(self, x, maximum=False):
        return self._sum(x, AXIS_USERS, maximum)

    def both(self, x, maximum=False):
        return self._sum(x, _BOTH, maximum)


def _valid(tile: DenseTile, W, H):
    vr, vc = tile.valid
    return tile.V[:vr, :vc], W[:vr], H[:, :vc]


def dense_mesh_ops(config: NmfConfig, mesh) -> LoopOps:
    """The loop's operations on a DenseTile: the registry's route with
    `MeshSums`, the errors summed over the tiles' real entries."""
    make_aux, update, effective_h = build_dense_update(config,
                                                       MeshSums(mesh))
    if config.objective is Objective.BETA:
        beta = config.beta

        def divergence(tile, aux, W, He):
            return psum(D.beta_divergence(*_valid(tile, W, He), beta), mesh,
                        _BOTH)
    else:
        def divergence(tile, aux, W, He):
            return psum(D.kl_error(*_valid(tile, W, He)), mesh, _BOTH)
    return LoopOps(
        make_aux=lambda tile: make_aux(tile.V),
        update=lambda tile, aux, W, H: update(tile.V, aux, W, H),
        effective_h=effective_h,
        frobenius=lambda tile, aux, W, He, svsq: frobenius_grid(
            mesh, W.T @ tile.V, W, He, svsq),
        kl=divergence,
        sum_v_sq=lambda tile: psum(torch.sum(tile.V * tile.V), mesh, _BOTH),
        numel=lambda tile: tile.shape[0] * tile.shape[1],
    )


_KMEANS = (Initialization.K_MEANS_AND_RANDOM_VALUES,
           Initialization.K_MEANS_AND_NON_NEGATIVE_WTV,
           Initialization.K_MEANS_AND_ABSOLUTE_WTV)
_NNDSVD = (Initialization.NNDSVD, Initialization.NNDSVDA,
           Initialization.NNDSVDAR)


def _init_fn(config: NmfConfig, tile: DenseTile, V, W0, H0, sums, device):
    """init_fn(run_idx) -> this rank's (W block, H block). Each follows
    ``init.initialize_factors`` draw for draw with the run's generator:
    random values on the true (n, m), zero in the padding; the
    data-dependent inits on the zero-padded V, the padding included."""
    n, m = tile.shape
    br, bc = tile.block
    i, j = tile.coords
    pu, pi = grid_shape(sums.mesh)
    n_pad, m_pad = br * pu, bc * pi
    r, dtype = config.rank, tile.V.dtype
    method = config.init_method

    def h_block(H):
        """This rank's block of H (r, k ≤ m_pad), zero where H ends."""
        Hb = torch.zeros((r, bc), dtype=dtype, device=device)
        h = torch.as_tensor(H[:, j * bc:(j + 1) * bc])
        Hb[:, :h.shape[1]] = h.to(device, dtype)
        return Hb

    def blocks(W, H):
        """This rank's blocks of W (k ≤ n_pad, r) and H."""
        Wb = torch.zeros((br, r), dtype=dtype, device=device)
        w = torch.as_tensor(W[i * br:(i + 1) * br])
        Wb[:w.shape[0]] = w.to(device, dtype)
        return Wb, h_block(H)

    if method is Initialization.COPY_EXISTING:
        if W0 is None or H0 is None:
            raise ValueError("COPY_EXISTING requires both W0 and H0")
        return lambda run_idx: blocks(W0, H0)
    total = sums.both(torch.sum(tile.V, dtype=torch.float64))

    def scale_of(numel):
        mean = (total / float(numel)).to(dtype)
        return torch.sqrt(torch.clamp(mean, min=1e-12) / r).to(dtype)

    if method is Initialization.ALL_RANDOM_VALUES:
        scale = scale_of(n * m)

        def init_fn(run_idx):
            gen = run_generator(config.seed, run_idx, device)
            return blocks(_random_uniform(gen, (n, r), scale, dtype, device),
                          _random_uniform(gen, (r, m), scale, dtype, device))
        return init_fn
    scale = scale_of(n_pad * m_pad)

    def pick(cols, weight):
        """(bc, r): `weight` at (local column, k) for each draw cols[k, ·]
        that falls in this tile's columns."""
        q = cols.shape[1]
        loc = cols.reshape(-1) - j * bc
        which = torch.arange(r, device=device).repeat_interleave(q)
        own = (loc >= 0) & (loc < bc)
        A = torch.zeros((bc, r), dtype=dtype, device=device)
        A.index_put_((loc[own], which[own]),
                     torch.tensor(weight, dtype=dtype, device=device),
                     accumulate=True)
        return A

    def init_fn(run_idx):
        gen = run_generator(config.seed, run_idx, device)
        if method is Initialization.MEAN_COLUMNS:
            q = int(min(max(5, m_pad // max(r, 1)), m_pad))
            cols = torch.randint(0, m_pad, (r, q), generator=gen,
                                 device=device)
            W = sums.cols(tile.V @ pick(cols, 1.0 / q))
            return W, h_block(_random_uniform(gen, (r, m_pad), scale, dtype,
                                              device))
        if method in _NNDSVD:
            from nmftpu_torch.init.nndsvd import nndsvd_init

            seed = int(torch.randint(0, 2**31 - 1, (), generator=gen,
                                     device=device))
            W = torch.zeros((n_pad, r), dtype=dtype, device=device)
            H = torch.zeros((r, m_pad), dtype=dtype, device=device)
            if (i, j) == (0, 0):
                # the SVD of the whole padded V on this rank's host; the
                # others add zeros to its factors
                Vh = _tile_of(V, slice(0, n), slice(0, m), (n_pad, m_pad),
                              dtype, "cpu").numpy()
                Wn, Hn = nndsvd_init(Vh, r, variant=method.value, seed=seed)
                W.copy_(torch.as_tensor(Wn, dtype=dtype))
                H.copy_(torch.as_tensor(Hn, dtype=dtype))
            return blocks(sums.both(W), sums.both(H))
        if method not in _KMEANS:
            raise ValueError(f"unknown initialization method: {method}")
        seeds = torch.randperm(m_pad, generator=gen, device=device)[:r]
        cent = sums.cols(tile.V @ pick(seeds[:, None], 1.0))
        cent, _ = _lloyd(tile.V, cent, config.kmeans_max_iter, sums)
        W = torch.clamp(cent, min=0.0) + 1e-6
        if method is Initialization.K_MEANS_AND_RANDOM_VALUES:
            return W, h_block(_random_uniform(gen, (r, m_pad), scale, dtype,
                                              device))
        WtV = sums.rows(W.T @ tile.V)
        if method is Initialization.K_MEANS_AND_NON_NEGATIVE_WTV:
            return W, torch.clamp(WtV, min=0.0) + 1e-6
        return W, torch.abs(WtV) + 1e-6
    return init_fn


def compute_dense_mesh(
    V,
    config: NmfConfig,
    mesh,
    W0=None,
    H0=None,
    callback: Callable[[Any, Any, Any, Any], None] | None = None,
    interrupt: Callable[[], bool] | None = None,
) -> NmfResult:
    """Factorize dense V over the ('users', 'items') mesh. SPMD: every
    rank calls it with the same V (numpy, a memory map, a tensor, or an
    object with `shape` whose V[rows, cols] gives a block as an array or
    a tensor), reads only its tile (NNDSVD's first rank reads all of V on
    its host), and gets the full factors W (n, r) and H (r, m) back."""
    check_mesh(mesh)
    dtype = resolve_dtype(config.dtype)
    if len(V.shape) != 2:
        raise ValueError(f"V must be 2-D, got shape {tuple(V.shape)}")
    n, m = V.shape
    if config.rank > min(n, m):
        raise ValueError(
            f"rank {config.rank} exceeds min(V.shape) = {min(n, m)}")
    device = mesh_device(mesh)
    br, bc = block_shape((n, m), grid_shape(mesh))
    i, j = axis_index(mesh, AXIS_USERS), axis_index(mesh, AXIS_ITEMS)
    tile = DenseTile(
        V=_tile_of(V, slice(i * br, (i + 1) * br), slice(j * bc, (j + 1) * bc),
                   (br, bc), dtype, device),
        shape=(n, m), coords=(i, j))
    runner = build_runner(config, dense_mesh_ops(config, mesh), callback,
                          interrupt)
    result = execute(tile, config, runner,
                     _init_fn(config, tile, V, W0, H0, MeshSums(mesh),
                              device),
                     numel=n * m)
    W = all_gather(result.W, mesh, AXIS_USERS)
    H = all_gather(result.H, mesh, AXIS_ITEMS)
    result.W = W.reshape(-1, W.shape[-1])[:n]
    result.H = H.permute(1, 0, 2).reshape(H.shape[1], -1)[:, :m]
    return result
