"""Carry configurations, factors, quantized V, serving tables, fold-in
tables, online-NMF state, sklearn estimators and batched results between
``nmftpu`` and ``nmftpu_torch``. Nothing here imports jax: the ``nmftpu``
side arrives as objects or numpy arrays (a sharded object's arrays read
whole). With ``mesh=`` (a port rank mesh; every rank converts alike)
each rank keeps its own shard, as the port's constructors shard."""

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


def sparse_from_nmftpu(mat):
    """The port's container (``nmftpu_torch.sparse``) with the fields of
    an ``nmftpu.sparse`` SparseCOO, SparseCSR or SparseCSC, given as
    numpy arrays (the arrays are shared, not copied)."""
    from nmftpu_torch import sparse as S

    fields = {
        "SparseCOO": ("row", "col", "data"),
        "SparseCSR": ("indptr", "indices", "data"),
        "SparseCSC": ("indptr", "indices", "data"),
    }
    kind = type(mat).__name__
    if kind not in fields:
        raise TypeError(f"expected an nmftpu SparseCOO/CSR/CSC, got {kind}")
    return getattr(S, kind)(
        *(np.asarray(getattr(mat, f)) for f in fields[kind]),
        shape=mat.shape,
    )


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def result_to_numpy(res) -> dict:
    """An NmfResult, the port's or ``nmftpu``'s, as a dict of numpy arrays
    and Python numbers, with the stats rows as one (checks, 3) array of
    (iteration, error, delta)."""
    return {
        "W": _numpy(res.W),
        "H": _numpy(res.H),
        "error": res.error,
        "frobenius_error": res.frobenius_error,
        "rmsd": res.rmsd,
        "kl_error": res.kl_error,
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


def recommender_from_nmftpu(rec, *, device, mesh=None):
    """The port's Recommender over the same tables as an ``nmftpu``
    Recommender `rec` (on one device or sharded): its W, its item table
    taken as it is (bf16 values and int8 bits unchanged, with the int8
    scale) minus any reservoir padding, its training CSR and its serving
    settings; with `mesh`, sharded over the mesh's 'items' axis."""
    from nmftpu_torch.serving import Recommender
    from nmftpu_torch.sparse import SparseCSR

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
        reservoir_slots=rec.reservoir_slots, device=device, mesh=mesh,
    )


def prepared_table_from_nmftpu(prep, *, device):
    """The port's ``foldin.PreparedTable`` with the arrays of an
    ``nmftpu.foldin.PreparedTable`` (as numpy): its table in its own dtype
    (float32, bfloat16 or int8), stored (r, m) as the port stores a table,
    its float32 Gram and row sums, and its int8 scale."""
    from nmftpu_torch.foldin import PreparedTable

    H = np.ascontiguousarray(np.asarray(prep.Ht).T)
    if H.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in numpy: go
        # through float32, which holds every bf16 value exactly
        table = torch.tensor(H.astype(np.float32),
                             device=device).to(torch.bfloat16)
    elif H.dtype in (np.float32, np.int8):
        table = torch.tensor(H, device=device)
    else:
        raise TypeError(f"table dtype {H.dtype} is not one of float32, "
                        "bfloat16, int8")
    return PreparedTable(
        Ht=table.T,
        G=torch.tensor(np.asarray(prep.G, np.float32), device=device),
        h_sum=torch.tensor(np.asarray(prep.h_sum, np.float32),
                           device=device),
        scale=None if prep.scale is None else torch.tensor(
            np.asarray(prep.scale, np.float32), device=device),
    )


_ONLINE_PARAMS = ("beta", "batch_size", "forget_factor", "alpha_w",
                  "alpha_h", "l1_ratio", "fresh_max_iter",
                  "transform_max_iter", "transform_tol", "seed")


def online_state_from_nmftpu(model, *, device, mesh=None):
    """The port's `minibatch.OnlineNMF` with the state of an
    ``nmftpu.minibatch.OnlineNMF`` `model` (on one device or sharded):
    its hyperparameters, its exact forgetting rate rho, its step count
    and its H, A and B (taken as numpy, placed on `device` in the model's
    dtype; with `mesh`, this rank's columns), so the stream goes on in
    the port as it would have in ``nmftpu``."""
    from nmftpu_torch.minibatch import OnlineNMF

    out = OnlineNMF(model.rank, dtype=np.dtype(model.dtype).name,
                    device=device, mesh=mesh,
                    **{k: getattr(model, k) for k in _ONLINE_PARAMS})
    out.rho = model.rho
    out.n_steps = int(model.n_steps)
    if model.H is not None:
        out.H, out._A, out._B = (
            out._place(np.asarray(x)).contiguous()
            for x in (model.H, model._A, model._B))
    return out


_FITTED = ("components_", "n_components_", "n_features_in_", "n_iter_",
           "n_steps_", "reconstruction_err_")


def estimator_from_nmftpu(est, *, device, mesh=None):
    """The port's `sklearn_api.NMF` or `MiniBatchNMF` with the parameters
    of an ``nmftpu.sklearn_api`` estimator of the same name and, if it
    was fitted, its fitted attributes (components_ as numpy) and the
    online state a MiniBatchNMF's partial_fit keeps; `device` is where
    the port's estimator runs. An estimator's jax mesh does not carry
    over: the port's runs on `mesh` (a port rank mesh), or on one device
    without one."""
    from nmftpu_torch import sklearn_api as SK

    kind = type(est).__name__
    if kind not in ("NMF", "MiniBatchNMF"):
        raise TypeError(f"expected an nmftpu NMF or MiniBatchNMF, got "
                        f"{kind}")
    params = {k: getattr(est, k)
              for k in getattr(SK, kind)._get_param_names()
              if k not in ("device", "mesh")}
    out = getattr(SK, kind)(**params, device=device, mesh=mesh)
    for name in _FITTED:
        if hasattr(est, name):
            value = getattr(est, name)
            # components_ copied: nmftpu's may be a read-only view
            setattr(out, name, np.array(value) if name == "components_"
                    else value)
    if getattr(est, "_online", None) is not None:
        out._online = online_state_from_nmftpu(est._online, device=device,
                                               mesh=mesh)
        out._components_view = out.components_
    return out


def batched_result_to_numpy(res) -> dict:
    """A BatchedNmfResult, the port's or ``nmftpu``'s, as a dict of numpy
    arrays: W (B, n, r), H (B, r, m), the per-problem metrics as (B,)
    arrays, and each problem's stats as a (checks, 3) array of
    (iteration, error, delta)."""
    return {
        "W": _numpy(res.W),
        "H": _numpy(res.H),
        "error": np.asarray(res.error),
        "frobenius_error": np.asarray(res.frobenius_error),
        "rmsd": np.asarray(res.rmsd),
        "kl_error": (None if res.kl_error is None
                     else np.asarray(res.kl_error)),
        "num_iterations": np.asarray(res.num_iterations),
        "converged": np.asarray(res.converged),
        "stats": [
            np.stack([np.asarray(s.iterations, np.float64),
                      np.asarray(s.errors, np.float64),
                      np.asarray(s.deltas, np.float64)],
                     axis=1).reshape(-1, 3)
            for s in res.stats
        ],
    }
