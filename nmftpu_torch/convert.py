"""Carry configurations, factors and quantized V between ``nmftpu`` and
``nmftpu_torch``. Nothing here imports jax: the ``nmftpu`` side arrives as
objects or numpy arrays."""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from nmftpu_torch.config import NmfConfig


def config_from_nmftpu(cfg) -> NmfConfig:
    """The port's NmfConfig with every field of an ``nmftpu.NmfConfig``
    (enums carried by value)."""
    kwargs = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kwargs[f.name] = v.value if isinstance(v, enum.Enum) else v
    return NmfConfig(**kwargs)


def factors_from_numpy(W, H, *, device, dtype=torch.float32):
    """W (n, r) and H (r, m), given as numpy arrays (e.g. ``np.asarray`` of
    ``nmftpu``'s factors), as new tensors of `dtype` on `device`."""
    return (
        torch.tensor(np.asarray(W), dtype=dtype, device=device),
        torch.tensor(np.asarray(H), dtype=dtype, device=device),
    )


def quantized_from_numpy(Vq, scale, *, device):
    """``nmftpu.kernels.quantized.quantize_v``'s (Vq, scale), as numpy,
    as an int8 tensor and a float32 0-dim tensor on `device`."""
    Vq = np.asarray(Vq)
    if Vq.dtype != np.int8:
        raise TypeError(f"Vq must be int8, got {Vq.dtype}")
    return (
        torch.tensor(Vq, device=device),
        torch.tensor(np.float32(np.asarray(scale)), device=device),
    )


def result_to_numpy(res) -> dict:
    """An NmfResult as a dict of numpy arrays and Python numbers, with the
    stats rows as one (checks, 3) array of (iteration, error, delta)."""
    return {
        "W": res.W.detach().cpu().numpy(),
        "H": res.H.detach().cpu().numpy(),
        "error": res.error,
        "frobenius_error": res.frobenius_error,
        "rmsd": res.rmsd,
        "num_iterations": res.num_iterations,
        "converged": res.converged,
        "best_run": res.best_run,
        "run_errors": list(res.run_errors),
        "stats": np.stack(
            [np.asarray(res.stats.iterations, np.float64),
             np.asarray(res.stats.errors, np.float64),
             np.asarray(res.stats.deltas, np.float64)], axis=1,
        ).reshape(-1, 3),
    }
