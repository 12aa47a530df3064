"""Dense driver (port of ``nmftpu/driver.py``): validate → init → loop
(`nmftpu_torch.loop`) → best-of-N restarts."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nmftpu_torch.algorithms import build_dense_update
from nmftpu_torch.config import NmfConfig, resolve_dtype
from nmftpu_torch.init import initialize_factors, run_generator
from nmftpu_torch.linalg import dense as D
from nmftpu_torch.loop import (
    LoopOps,
    NmfResult,
    RunStats,
    build_runner,
    execute,
)

__all__ = ["compute", "NmfResult", "RunStats"]


def _dense_ops(config: NmfConfig) -> LoopOps:
    make_aux, update, effective_h = build_dense_update(config)
    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda V, aux, W, He, svsq: D.frobenius_error(
            V, W, He, svsq
        ),
        kl=lambda V, aux, W, He: D.kl_error(V, W, He),
        sum_v_sq=lambda V: torch.sum(V * V),
        numel=lambda V: V.shape[0] * V.shape[1],
    )


def _resolve_device(V, device) -> torch.device:
    """`device` if given, else a tensor V's own device, else CUDA. The
    port never moves to the CPU on its own: with no `device`, a numpy V
    needs a CUDA device."""
    if device is not None:
        return torch.device(device)
    if isinstance(V, torch.Tensor):
        return V.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain torch "
            "path on the CPU, or pass V as a tensor on its device"
        )
    return torch.device("cuda")


def compute(
    V,
    config: NmfConfig,
    W0=None,
    H0=None,
    mesh=None,
    callback: Callable[[int, int, float, float], None] | None = None,
    interrupt: Callable[[], bool] | None = None,
    device=None,
) -> NmfResult:
    """Factorize dense V ≈ W H under `config` (reference: nmfgpu_compute).

    V is a numpy array or a torch tensor. device: where the computation
    runs; by default a tensor V's device, else "cuda" (raises without
    one). callback, if given, is called at every convergence check with
    (run_index, iteration, error, delta); interrupt, if given, is polled
    at every check and a truthy return stops the run with the current
    factors.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (multi-device runs) is not ported to nmftpu_torch yet "
            "(ROADMAP.md slice 6)"
        )
    if config.mask == "observed":
        raise ValueError(
            "mask='observed' needs a sparse container (the stored "
            "nonzeros ARE the observed set); a dense V has no mask "
            "structure"
        )
    dtype = resolve_dtype(config.dtype)
    device = _resolve_device(V, device)
    if not isinstance(V, torch.Tensor):
        V = np.asarray(V)
    V = torch.as_tensor(V, dtype=dtype, device=device)
    if V.ndim != 2:
        raise ValueError(f"V must be 2-D, got shape {tuple(V.shape)}")
    n, m = V.shape
    if config.rank > min(n, m):
        raise ValueError(
            f"rank {config.rank} exceeds min(V.shape) = {min(n, m)}"
        )

    runner = build_runner(config, _dense_ops(config), callback, interrupt)

    def init_fn(run_idx):
        return initialize_factors(
            V, config.rank, config.init_method,
            run_generator(config.seed, run_idx, device), W0=W0, H0=H0,
        )

    return execute(V, config, runner, init_fn, numel=n * m)
