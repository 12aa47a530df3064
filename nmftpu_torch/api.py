"""High-level convenience API (port of ``nmftpu/api.py``): accepts strings
for all enums, routes dense inputs to the driver and the port's sparse
containers to the sparse engines, and returns an NmfResult."""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from nmftpu_torch import driver, sparse_ops
from nmftpu_torch.sparse import SparseMatrix
from nmftpu_torch.config import (
    Algorithm,
    Initialization,
    NmfConfig,
    Objective,
    ThresholdType,
)

_INIT_ALIASES = {
    "copy": Initialization.COPY_EXISTING,
    "random": Initialization.ALL_RANDOM_VALUES,
    "mean_columns": Initialization.MEAN_COLUMNS,
    "kmeans": Initialization.K_MEANS_AND_RANDOM_VALUES,
}

_OBJ_ALIASES = {
    "kl": Objective.KL,
    "is": Objective.ITAKURA_SAITO,
    "beta": Objective.BETA,       # pair with the beta= knob
}


def _coerce(enum_cls, value, aliases=None):
    if isinstance(value, enum_cls):
        return value
    if aliases and value in aliases:
        return aliases[value]
    return enum_cls(value)


def nmf(
    data: Any,
    rank: int,
    algorithm: str | Algorithm = Algorithm.MU,
    objective: str | Objective = Objective.FROBENIUS,
    init: str | Initialization = Initialization.ALL_RANDOM_VALUES,
    seed: int = 0,
    num_iterations: int = 200,
    num_runs: int = 1,
    threshold: float = 0.0,
    threshold_type: str | ThresholdType = ThresholdType.FROBENIUS,
    W0=None,
    H0=None,
    callback=None,
    interrupt=None,
    mesh=None,
    strategy: str = "auto",
    device=None,
    **knobs,
) -> "driver.NmfResult":
    """Factorize `data` ≈ W H with rank `rank`.

    `data` is a numpy array, a torch tensor, or one of the port's sparse
    containers (`nmftpu_torch.sparse.SparseCSR`/`SparseCSC`/`SparseCOO`,
    or a `sparse_ops.DeviceCOO`), which routes through the sparse
    engines. Extra keyword knobs (check_interval, eps, dtype, v_storage,
    use_pallas, update_order, ...) forward into NmfConfig. strategy: the
    sparse engine (auto | densified | ell | scatter; ignored for dense
    data). device: where to run; by default a tensor's own device, else
    "cuda". mesh: a ('users', 'items') rank mesh
    (`parallel.make_grid_mesh`), every rank calling alike: sparse V on
    the sharded engines (strategy "ring" for the ring engine), dense V
    tiled over the mesh (`parallel.dense_mesh`).
    """
    init_method = _coerce(Initialization, init, _INIT_ALIASES)
    if (W0 is not None or H0 is not None) and \
            init_method is not Initialization.COPY_EXISTING:
        warnings.warn(
            "W0/H0 are ignored unless init='copy' (CopyExisting); the "
            "run starts from the configured init instead of the given "
            "warm start",
            RuntimeWarning, stacklevel=2,
        )
    config = NmfConfig(
        rank=rank,
        algorithm=_coerce(Algorithm, algorithm),
        objective=_coerce(Objective, objective, _OBJ_ALIASES),
        init_method=init_method,
        seed=seed,
        num_iterations=num_iterations,
        num_runs=num_runs,
        threshold_value=threshold,
        threshold_type=_coerce(ThresholdType, threshold_type),
        **knobs,
    )
    return dispatch(
        data, config, W0=W0, H0=H0, mesh=mesh, strategy=strategy,
        callback=callback, interrupt=interrupt, device=device,
    )


def dispatch(
    data,
    config: NmfConfig,
    *,
    W0=None,
    H0=None,
    mesh=None,
    strategy: str = "auto",
    callback=None,
    interrupt=None,
    device=None,
) -> "driver.NmfResult":
    """Route (data, config) to an engine: the port's sparse containers →
    sparse_ops.compute_sparse, or with a mesh the sharded driver
    (`parallel.compute_sharded`, strategy naming its per-tile engine);
    dense → driver.compute. Other sparse types (scipy.sparse, torch
    sparse tensors) raise TypeError."""
    if isinstance(data, (SparseMatrix, sparse_ops.DeviceCOO)):
        if mesh is not None:
            return _sharded(data, config, W0, H0, mesh, strategy, callback,
                            interrupt)
        return sparse_ops.compute_sparse(
            data, config, W0=W0, H0=H0, strategy=strategy,
            callback=callback, interrupt=interrupt, device=device,
        )
    is_torch_sparse = (isinstance(data, torch.Tensor)
                       and data.layout != torch.strided)
    if is_torch_sparse or (not isinstance(data, (torch.Tensor, np.ndarray))
                           and hasattr(data, "nnz")):
        raise TypeError(
            "sparse V must be one of nmftpu_torch.sparse's containers: "
            "convert a scipy.sparse matrix with "
            "nmftpu_torch.sparse.from_scipy (a torch sparse tensor with "
            "from_scipy of its scipy form, or pass it dense)"
        )
    return driver.compute(
        data, config, W0=W0, H0=H0, mesh=mesh,
        callback=callback, interrupt=interrupt, device=device,
    )


def _sharded(data, config, W0, H0, mesh, strategy, callback, interrupt):
    """Sparse V on a mesh: strategy names the per-tile engine, as in
    ``nmftpu.api.dispatch``."""
    from nmftpu_torch.parallel import compute_sharded

    if isinstance(data, sparse_ops.DeviceCOO):
        raise ValueError(
            "mesh= takes a host sparse container (each rank keeps its own "
            "tile); a DeviceCOO already lies on one device")
    if strategy == "densified":
        raise ValueError(
            "strategy='densified' is single-device only; the sharded "
            "engines are 'ell', 'scatter', 'ring' (or 'auto')"
        )
    if strategy not in ("auto", "ell", "scatter", "ring"):
        raise ValueError(
            f"unknown strategy {strategy!r}; sharded engines are "
            "'ell', 'scatter', 'ring' (or 'auto')"
        )
    return compute_sharded(data, config, mesh=mesh, W0=W0, H0=H0,
                           engine=strategy, callback=callback,
                           interrupt=interrupt)
