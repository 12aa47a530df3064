"""Dense driver (port of ``nmftpu/driver.py``): validate → init → loop
(`nmftpu_torch.loop`) → best-of-N restarts."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nmftpu_torch.algorithms import build_dense_update
from nmftpu_torch.config import Algorithm, NmfConfig, Objective, resolve_dtype
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


def _stacked_update(config: NmfConfig):
    """The update on stacked factors for the routes whose math is
    batched GEMMs as it stands: plain float32 Gauss–Seidel MU under the
    Frobenius or KL objective (`linalg.dense.mu_update_frobenius` /
    `mu_update_kl` on (S, n, r) / (S, r, m)); None for every other route
    (a kernel, a low-precision V, a solver), which the lockstep runner
    updates slot by slot."""
    plain = (config.algorithm is Algorithm.MU and config.v_storage ==
             "float32" and not config.use_pallas
             and config.alpha_confidence == 0.0
             and config.mu_style != "jacobi"
             and config.objective in (Objective.FROBENIUS, Objective.KL))
    if not plain:
        return None
    eps, order = config.eps, config.update_order
    fn = (D.mu_update_kl if config.objective is Objective.KL
          else D.mu_update_frobenius)
    return lambda V, W, H: fn(V, W, H, eps=eps, order=order)


def _dense_ops(config: NmfConfig) -> LoopOps:
    make_aux, update, effective_h = build_dense_update(config)
    if config.objective is Objective.BETA:
        beta = config.beta

        def divergence(V, aux, W, He):
            return D.beta_divergence(V, W, He, beta)
    else:
        def divergence(V, aux, W, He):
            return D.kl_error(V, W, He)
    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda V, aux, W, He, svsq: D.frobenius_error(
            V, W, He, svsq
        ),
        kl=divergence,
        sum_v_sq=lambda V: torch.sum(V * V),
        numel=lambda V: V.shape[0] * V.shape[1],
        stacked_update=_stacked_update(config),
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

    mesh: a ('users', 'items') rank mesh (`parallel.make_grid_mesh`);
    every rank calls alike with the whole V, keeps its tile on the mesh's
    device (`device` is then unused) and gets the full factors back
    (`parallel.dense_mesh`).
    """
    if config.mask == "observed":
        raise ValueError(
            "mask='observed' needs a sparse container (the stored "
            "nonzeros ARE the observed set); a dense V has no mask "
            "structure"
        )
    if mesh is not None:
        from nmftpu_torch.parallel.dense_mesh import compute_dense_mesh

        # a tensor, an array, or any object with a shape whose [rows,
        # cols] slices give the tiles (each rank reads only its own)
        if not hasattr(V, "shape"):
            V = np.asarray(V)
        return compute_dense_mesh(V, config, mesh, W0=W0, H0=H0,
                                  callback=callback, interrupt=interrupt)
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
            kmeans_max_iter=config.kmeans_max_iter,
        )

    return execute(V, config, runner, init_fn, numel=n * m)
