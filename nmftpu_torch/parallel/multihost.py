"""Process-group bring-up and a local rank launcher (port of
``nmftpu/parallel/multihost.py``).

Every rank runs the same program (SPMD), as ``torchrun`` starts it: call
`initialize_distributed()` first, then build the mesh
(`mesh.make_grid_mesh`) and call the entry points with ``mesh=``.

`launch` starts N ranks of one function on this machine (the tests and
``chip_smoke.py`` use it) through `torch.multiprocessing.start_processes`:
fresh interpreters (the ``spawn`` start method, so no rank inherits a
CUDA context), a `FileStore` in a temporary directory (no TCP port, so
concurrent launches never collide), all joined with one deadline. If a
rank fails or the deadline passes, every rank is killed and the parent
raises with the failing rank's traceback.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _default_backend(local_ranks: int) -> str:
    """NCCL with one card per local rank, gloo otherwise (the CPU, or
    ranks sharing a card, which NCCL refuses)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def _set_device(local_rank: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> None:
    """Join this process to the world (idempotent).

    With no arguments, reads torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
    coordinator_address "host:port" is rank 0's store address. The
    default backend is NCCL when CUDA is present with one card per local
    rank (this rank on cuda:LOCAL_RANK), gloo otherwise."""
    if dist.is_initialized():
        return
    env = os.environ
    rank = int(env.get("RANK", 0)) if process_id is None else process_id
    world = (int(env.get("WORLD_SIZE", 1)) if num_processes is None
             else num_processes)
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if backend is None:
        backend = _default_backend(local_world)
    _set_device(local_rank)
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _rank_main(rank, target, world, backend, store_path, out_dir, args,
               kwargs, threads):
    """One rank of `launch`: join the world, run target(*args, **kwargs),
    leave its pickled return value in out_dir."""
    if threads:
        torch.set_num_threads(threads)
    _set_device(rank)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    out = target(*args, **kwargs)
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def launch(target, nprocs: int, args=(), kwargs=None,
           backend: str | None = None, timeout: float = 300.0,
           threads: int | None = None) -> list:
    """Run target(*args, **kwargs) on `nprocs` new ranks of one world;
    return their results, in rank order.

    target must be importable by name (a module-level function of a
    module the ranks can import). Each rank sets its CUDA device to
    cuda:(rank mod device count) where there is one. backend: by default
    NCCL with a card for each rank, gloo otherwise. `threads` caps each
    rank's intra-op threads. Raises RuntimeError with the first failing
    rank's traceback, or TimeoutError after `timeout` seconds; either way
    no rank is left running."""
    if backend is None:
        backend = _default_backend(nprocs)
    with tempfile.TemporaryDirectory(prefix="nmftpu_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=nprocs, join=False, start_method="spawn",
            args=(target, nprocs, backend, os.path.join(tmp, "store"), tmp,
                  tuple(args), dict(kwargs or {}), threads))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0),
                               grace_period=1):
                if time.monotonic() >= deadline:
                    hung = [r for r, p in enumerate(ctx.processes)
                            if p.is_alive()]
                    raise TimeoutError(
                        f"ranks {hung} of {nprocs} still running after "
                        f"{timeout} s; all were killed")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(
                f"rank {e.error_index} of {nprocs} failed:{e}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for rank in range(nprocs):
            with open(os.path.join(tmp, f"{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
