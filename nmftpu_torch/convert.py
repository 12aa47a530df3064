"""Carry configurations, factors, quantized V and serving tables between
``nmftpu`` and ``nmftpu_torch``. Nothing here imports jax: the ``nmftpu``
side arrives as objects or numpy arrays."""

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


def recommender_from_nmftpu(rec, *, device):
    """The port's Recommender over the same tables as an ``nmftpu``
    Recommender `rec` (single device): its W, its item table taken as it
    is (bf16 values and int8 bits unchanged, with the int8 scale) minus any
    reservoir padding, its training CSR and its serving settings."""
    from nmftpu_torch.serving import Recommender
    from nmftpu_torch.sparse import SparseCSR

    if getattr(rec, "mesh", None) is not None:
        raise NotImplementedError(
            "a sharded Recommender belongs to the multi-GPU path, not "
            "ported yet (ROADMAP queue 1, slice 6)"
        )
    table = np.asarray(rec.H)[:, :rec._m_items]
    if table.dtype == np.int8:
        table = torch.tensor(table, device=device)
    else:
        # ml_dtypes' bfloat16 has no torch counterpart in numpy: go
        # through float32, which holds every bf16 value exactly
        table = torch.tensor(table.astype(np.float32), device=device).to(
            {"float32": torch.float32, "bfloat16": torch.bfloat16}[
                rec.table_dtype])
    csr = rec._train_csr
    train = None if csr is None else SparseCSR(
        csr.indptr, csr.indices, csr.data, csr.shape)
    return Recommender.from_table(
        np.asarray(rec.W, np.float32), table,
        h_scale=None if rec._h_scale is None else np.asarray(rec._h_scale),
        train=train, block=rec.block, method=rec.method,
        reservoir_slots=rec.reservoir_slots, device=device,
    )
