"""Reference-API compatibility shim (port of ``nmftpu/compat.py``).

The reference exposes a flat C surface — `nmfgpu_initialize`,
`nmfgpu_finalize`, `nmfgpu_version`, GPU selection, and `nmfgpu_compute`
taking an `NmfDescription` struct. This module mirrors that surface 1:1
in Python so code structured around the reference's call sequence ports
mechanically:

    import nmftpu_torch.compat as nmfgpu
    nmfgpu.initialize()
    nmfgpu.choose_device(0)
    result = nmfgpu.compute(NmfDescription(
        algorithm="mu", num_iterations=500, rank=32,
        input_matrix=V, threshold_value=1e-3, seed=42,
    ))
    nmfgpu.finalize()

Devices are the CUDA devices of ``torch.cuda``; `choose_device` makes its
choice the current CUDA device, which the port's entry points use when
no `device` is given. initialize/finalize only validate and mark the API
open or closed (the CUDA context is process-global). With
``NMFTPU_PLATFORM=cpu`` in the environment (the variable the CLI and the
C ABI read) the one device is the CPU and `compute` runs there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

import nmftpu_torch
from nmftpu_torch.config import (
    Algorithm,
    Initialization,
    NmfConfig,
    Objective,
    ThresholdType,
)

_initialized = False
_chosen_device = None


class ResultType:
    """Reference-style status codes (the python API raises instead; these
    exist for ported code that pattern-matches on them)."""

    SUCCESS = 0
    ERROR_NOT_INITIALIZED = 1
    ERROR_INVALID_ARGUMENT = 2
    ERROR_NO_DEVICE = 3


def _on_cpu() -> bool:
    return os.environ.get("NMFTPU_PLATFORM", "").lower() == "cpu"


def version() -> str:
    return nmftpu_torch.__version__


def initialize() -> int:
    """Reference: nmfgpu_initialize — bring up the accelerator runtime."""
    global _initialized
    if not _on_cpu() and not torch.cuda.is_available():
        return ResultType.ERROR_NO_DEVICE
    _initialized = True
    return ResultType.SUCCESS


def finalize() -> int:
    global _initialized
    _initialized = False
    return ResultType.SUCCESS


def device_count() -> int:
    return 1 if _on_cpu() else torch.cuda.device_count()


def device_info(index: int) -> dict:
    """Reference: device enumeration (name / memory queries)."""
    if _on_cpu():
        if index != 0:
            raise IndexError(f"device index {index} out of range")
        return {"index": 0, "kind": "cpu", "platform": "cpu",
                "bytes_in_use": None, "bytes_limit": None}
    props = torch.cuda.get_device_properties(index)
    return {
        "index": index,
        "kind": props.name,
        "platform": "gpu",
        "bytes_in_use": torch.cuda.memory_allocated(index),
        "bytes_limit": props.total_memory,
    }


def choose_device(index: int | None = None) -> int:
    """Reference: nmfgpu_choose_gpu — select by index, or auto-select the
    device with the most free memory when index is None."""
    global _chosen_device
    count = device_count()
    if not count:
        return ResultType.ERROR_NO_DEVICE
    if index is None:
        if _on_cpu():
            index = 0
        else:
            index = max(range(count),
                        key=lambda i: torch.cuda.mem_get_info(i)[0])
    elif not 0 <= index < count:
        return ResultType.ERROR_INVALID_ARGUMENT
    if _on_cpu():
        _chosen_device = torch.device("cpu")
    else:
        _chosen_device = torch.device("cuda", index)
        torch.cuda.set_device(_chosen_device)
    return ResultType.SUCCESS


@dataclasses.dataclass
class NmfDescription:
    """The reference's single computation struct, field for field."""

    input_matrix: Any = None               # dense array or sparse container
    rank: int = 16
    algorithm: str = "mu"
    objective: str = "frobenius"
    init_method: str = "all_random_values"
    seed: int = 0
    num_iterations: int = 200
    num_runs: int = 1
    threshold_type: str = "frobenius"
    threshold_value: float = 0.0
    check_interval: int = 10
    # the reference's key/value algorithm parameter list:
    parameters: dict = dataclasses.field(default_factory=dict)
    # warm start (CopyExisting):
    initial_w: Any = None
    initial_h: Any = None
    callback: Any = None
    # reference C17/§3.2: the user-interrupt flag polled at every
    # convergence check — a zero-arg callable; truthy return cancels
    interrupt: Any = None


def compute(desc: NmfDescription):
    """Reference: nmfgpu_compute(NmfDescription) -> best W/H + stats, on
    the chosen device (the current CUDA device by default)."""
    if not _initialized:
        raise RuntimeError(
            "compat.initialize() must be called first "
            "(ResultType.ERROR_NOT_INITIALIZED)"
        )
    knobs = dict(desc.parameters)
    config = NmfConfig(
        rank=desc.rank,
        algorithm=Algorithm(desc.algorithm),
        objective=Objective(desc.objective),
        init_method=Initialization(desc.init_method),
        seed=desc.seed,
        num_iterations=desc.num_iterations,
        num_runs=desc.num_runs,
        threshold_type=ThresholdType(desc.threshold_type),
        threshold_value=desc.threshold_value,
        check_interval=desc.check_interval,
        **knobs,
    )
    from nmftpu_torch import driver, sparse as host_sparse, sparse_ops

    if _chosen_device is not None:
        device = _chosen_device
    elif _on_cpu():
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", torch.cuda.current_device())
    V = desc.input_matrix
    if isinstance(V, (host_sparse.SparseMatrix, sparse_ops.DeviceCOO)):
        return sparse_ops.compute_sparse(
            V, config, W0=desc.initial_w, H0=desc.initial_h,
            callback=desc.callback, interrupt=desc.interrupt,
            device=device,
        )
    return driver.compute(
        V, config, W0=desc.initial_w, H0=desc.initial_h,
        callback=desc.callback, interrupt=desc.interrupt, device=device,
    )
