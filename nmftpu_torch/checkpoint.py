"""Checkpoint / resume (port of ``nmftpu/checkpoint.py``).

A checkpoint is a directory holding ``factors.npz`` (W, H) and
``meta.json`` (the iteration count and the config's fingerprint): the
layout ``nmftpu`` writes when orbax is absent, so each package reads the
other's. `resume` continues from it through the CopyExisting warm start
with the remaining iteration budget. A directory that holds an orbax
``factors/`` tree (``nmftpu`` with orbax installed) is refused with an
error that names it: the port has no orbax reader.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from nmftpu_torch.config import Initialization, NmfConfig
from nmftpu_torch.convert import _numpy


def _config_fingerprint(config: NmfConfig) -> str:
    """The config's fields as sorted JSON, enums by value: the same string
    as ``nmftpu``'s for the same settings (the two NmfConfigs have the
    same fields)."""
    d = dataclasses.asdict(config)
    d = {k: (v.value if hasattr(v, "value") else v) for k, v in d.items()}
    return json.dumps(d, sort_keys=True)


@dataclasses.dataclass
class Checkpoint:
    W: Any
    H: Any
    iteration: int
    config_fingerprint: str


def save(path: str, W, H, iteration: int, config: NmfConfig) -> None:
    """Write the factors (tensors on any device, or arrays) and the
    progress to the directory `path`, creating it."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "factors.npz"), W=_numpy(W), H=_numpy(H))
    meta = {
        "iteration": int(iteration),
        "config_fingerprint": _config_fingerprint(config),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load(path: str) -> Checkpoint:
    """Read a checkpoint; W and H come back as numpy arrays."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    npz = os.path.join(path, "factors.npz")
    if not os.path.exists(npz) and os.path.isdir(os.path.join(path,
                                                              "factors")):
        raise ValueError(
            f"{os.path.join(path, 'factors')} is an orbax checkpoint "
            "(nmftpu with orbax installed); nmftpu_torch reads the "
            "factors.npz layout only: re-save it from nmftpu without "
            "orbax, or save W and H with nmftpu_torch.checkpoint.save"
        )
    data = np.load(npz)
    return Checkpoint(
        W=data["W"], H=data["H"],
        iteration=meta["iteration"],
        config_fingerprint=meta["config_fingerprint"],
    )


def resume(path: str, V, config: NmfConfig, strict: bool = True, **kwargs):
    """Continue a factorization from a checkpoint: CopyExisting warm start
    with the remaining iteration budget. `V` may be dense (array or
    tensor) or one of the port's sparse containers; extra kwargs (device,
    callback, strategy for sparse V, ...) forward to the driver. An
    exhausted budget runs zero update steps: the stored factors come back
    with their real errors and converged=False. mesh= (every rank
    calling alike) routes sparse V through ``parallel.compute_sharded``
    (kwargs such as engine= forward to it) and dense V through the
    dense mesh path of ``driver.compute``."""
    from nmftpu_torch import driver, sparse_ops
    from nmftpu_torch.sparse import SparseMatrix

    mesh = kwargs.pop("mesh", None)
    ck = load(path)
    if strict and ck.config_fingerprint != _config_fingerprint(config):
        raise ValueError(
            "checkpoint was written under a different NmfConfig; pass "
            "strict=False to resume anyway"
        )
    remaining = max(0, config.num_iterations - ck.iteration)
    cfg = dataclasses.replace(
        config,
        init_method=Initialization.COPY_EXISTING,
        num_iterations=remaining,
        num_runs=1,
    )
    if mesh is not None and isinstance(V, SparseMatrix):
        from nmftpu_torch.parallel import compute_sharded

        return compute_sharded(V, cfg, mesh=mesh, W0=ck.W, H0=ck.H,
                               **kwargs)
    if isinstance(V, (SparseMatrix, sparse_ops.DeviceCOO)):
        return sparse_ops.compute_sparse(V, cfg, W0=ck.W, H0=ck.H, **kwargs)
    return driver.compute(V, cfg, W0=ck.W, H0=ck.H, mesh=mesh, **kwargs)
