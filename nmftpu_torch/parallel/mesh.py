"""The 2-D ('users', 'items') rank mesh and its collectives (port of
``nmftpu/parallel/mesh.py``).

The port is SPMD over `torch.distributed`: one process per rank, every
rank running the same program. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the initialized world,
its dims named ('users', 'items'):

  'users' — W (n, r) is row-sharded here; the H-side numerators and
            WᵀW are summed over this axis;
  'items' — H (r, m) is column-sharded here; the W-side numerators and
            HHᵀ are summed over this axis.

Rank (i, j) holds W's row block i (replicated along 'items'), H's column
block j (replicated along 'users') and V's tile (i, j). The reference's
`lax.psum`, `lax.all_gather`, `lax.ppermute` and `lax.axis_index` inside
`shard_map` become `psum`, `all_gather`, `ppermute` and `axis_index`
here, explicit collectives on the axis groups.

The ring engine (``parallel/ring.py``) runs on a 1-D mesh, its one dim
named 'shards' (`make_ring_mesh`), over every rank of a grid mesh in
row-major order.

NCCL takes CUDA tensors as they are. A gloo group (the CPU, or several
ranks sharing one card, which NCCL refuses) takes a CUDA operand through
an explicit copy to the host and back; the choice is made from the
group's backend, and `STAGED_BYTES` counts the bytes so staged.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

AXIS_USERS = "users"
AXIS_ITEMS = "items"
AXIS_RING = "shards"

# bytes of CUDA operands copied to the host (and back) for a gloo
# collective, by collective
STAGED_BYTES = {"all_reduce": 0, "all_gather": 0, "ppermute": 0}


def _squarest_grid(ndev: int) -> tuple[int, int]:
    """Factor ndev into the most-square (pu, pi) grid."""
    best = (1, ndev)
    for pu in range(1, int(math.isqrt(ndev)) + 1):
        if ndev % pu == 0:
            best = (pu, ndev // pu)
    return best


def make_grid_mesh(mesh_shape: tuple[int, int] | None = None,
                   device_type: str = "cuda"):
    """The ('users', 'items') DeviceMesh over every rank of the
    initialized world, row-major (rank = i * pi + j). With no shape, the
    squarest grid of the world size. On one process with no process
    group yet, a world-1 group is started on an in-memory store (NCCL
    for device_type "cuda", gloo for "cpu"), so a single-card run needs
    no launcher; every collective is then a no-op."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if mesh_shape is None:
        mesh_shape = _squarest_grid(world)
    pu, pi = mesh_shape
    if pu * pi != world:
        raise ValueError(
            f"mesh shape {tuple(mesh_shape)} does not cover {world} ranks")
    return DeviceMesh(device_type, torch.arange(world).reshape(pu, pi),
                      mesh_dim_names=(AXIS_USERS, AXIS_ITEMS))


def flat_mesh(mesh, name: str):
    """A 1-D DeviceMesh, its dim named `name`, over every rank of `mesh`
    in row-major order (made once per mesh and name)."""
    from torch.distributed.device_mesh import DeviceMesh

    check_mesh(mesh)
    if mesh.mesh_dim_names == (name,):
        return mesh
    flats = mesh.__dict__.setdefault("_flat_meshes", {})
    if name not in flats:
        flats[name] = DeviceMesh(mesh.device_type, mesh.mesh.reshape(-1),
                                 mesh_dim_names=(name,))
    return flats[name]


def make_ring_mesh(mesh=None, device_type: str = "cuda"):
    """The 1-D ('shards',) DeviceMesh of the ring engine: over the ranks
    of `mesh` (a grid mesh, flattened row-major) or, with none, over the
    world (started as `make_grid_mesh` starts it)."""
    if mesh is None:
        mesh = make_grid_mesh(None, device_type)
    return flat_mesh(mesh, AXIS_RING)


def check_mesh(mesh) -> None:
    """Raise TypeError unless `mesh` is a DeviceMesh (the port's meshes
    are torch's, built by `make_grid_mesh`)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "mesh must be a torch DeviceMesh (nmftpu_torch.parallel."
            f"make_grid_mesh), got {type(mesh).__name__}")


def _axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def grid_shape(mesh) -> tuple[int, int]:
    return (mesh.size(0), mesh.size(1))


def mesh_device(mesh) -> torch.device:
    """This rank's compute device: its current CUDA device on a "cuda"
    mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def factor_shardings(mesh) -> dict:
    """Which axis splits which dim of each operand (the counterpart of
    ``nmftpu``'s NamedShardings): per operand, one entry per dim, the
    mesh axis that splits it or None (replicated)."""
    return {
        "W": (AXIS_USERS, None),
        "H": (None, AXIS_ITEMS),
        "V": (AXIS_USERS, AXIS_ITEMS),
        "tile": (AXIS_USERS, AXIS_ITEMS, None),
        "replicated": (),
    }


def _axes(axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _staged(x: torch.Tensor, group) -> bool:
    """gloo groups take CUDA operands through the host."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def psum(x: torch.Tensor, mesh, axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or `op`) of x over the ranks of `axis` (a name, or a tuple of
    names reduced in turn), the same tensor on each of them. x may be
    reduced in place: pass a temporary."""
    shape = x.shape
    x = x.contiguous().reshape(-1)
    for name in _axes(axis):
        if _axis_size(mesh, name) == 1:
            continue
        group = mesh.get_group(name)
        if _staged(x, group):
            host = x.cpu()
            STAGED_BYTES["all_reduce"] += host.numel() * host.element_size()
            dist.all_reduce(host, op=op, group=group)
            x = host.to(x.device)
        else:
            dist.all_reduce(x, op=op, group=group)
    return x.reshape(shape)


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's x along `axis`, stacked in axis order -> (size,
    *x.shape), on each of them (``lax.all_gather``)."""
    if _axis_size(mesh, axis) == 1:
        return x[None]
    group = mesh.get_group(axis)
    size = dist.get_world_size(group)
    src = x.contiguous()
    if _staged(src, group):
        src = src.cpu()
        STAGED_BYTES["all_gather"] += src.numel() * src.element_size()
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(x.device)


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """x rotated by `shift` along `axis` (``lax.ppermute`` with the pairs
    (k, k + shift mod p)): the rank at coordinate k sends x to k + shift
    and returns what k - shift sent. Every rank posts its send and its
    receive together (`batch_isend_irecv`), so no ordering of the ring
    can deadlock. With p = 1, or a shift of a whole turn, x itself."""
    p = _axis_size(mesh, axis)
    if shift % p == 0:
        return x
    group = mesh.get_group(axis)
    me = dist.get_group_rank(group, dist.get_rank())
    dst = dist.get_global_rank(group, (me + shift) % p)
    src = dist.get_global_rank(group, (me - shift) % p)
    send = x.contiguous()
    staged = _staged(send, group)
    if staged:
        send = send.cpu()
        STAGED_BYTES["ppermute"] += send.numel() * send.element_size()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        req.wait()
    return recv.to(x.device) if staged else recv
