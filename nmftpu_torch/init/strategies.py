"""Initialization strategies (port of ``nmftpu/init/strategies.py``):
the reference's six (CopyExisting, AllRandomValues, MeanColumns and the
three k-means-seeded ones, `init.kmeans`) and the NNDSVD family
(nndsvd, nndsvda, nndsvdar; `init.nndsvd`, on the host).

Random magnitudes follow the sklearn 'random' convention — uniform scaled
by sqrt(mean(V) / rank) — as in ``nmftpu``. The draws come from a
``torch.Generator`` on V's device (see :func:`run_generator` for the
seeding rule), so they are not ``jax.random``'s bits: tests that compare
the two packages pass W0/H0 explicitly.
"""

from __future__ import annotations

import torch

from nmftpu_torch.config import Initialization
from nmftpu_torch.init.kmeans import kmeans_columns


def run_seed(seed: int, run_idx: int) -> int:
    """The seed of restart `run_idx` of a computation seeded with `seed`:
    (seed * 1_000_003 + run_idx) mod 2**64, so each (seed, run) pair has
    its own stream and a run is reproducible on its own."""
    return (int(seed) * 1_000_003 + int(run_idx)) % 2**64


def run_generator(seed: int, run_idx: int, device) -> torch.Generator:
    """The generator of restart `run_idx`: a torch.Generator on `device`
    seeded with `run_seed(seed, run_idx)`."""
    g = torch.Generator(device=device)
    g.manual_seed(run_seed(seed, run_idx))
    return g


def _random_uniform(gen, shape, scale, dtype, device):
    # Strictly positive (avoids exact zeros, which MU can never leave).
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return (u + 1e-4) * scale


def initialize_factors(V, rank: int, method: Initialization, gen,
                       W0=None, H0=None, kmeans_max_iter: int = 25):
    """Produce initial (W, H) on V's device in V's dtype; `gen` is the
    run's torch.Generator (on V's device)."""
    n, m = V.shape
    dtype, device = V.dtype, V.device

    if method is Initialization.COPY_EXISTING:
        if W0 is None or H0 is None:
            raise ValueError("COPY_EXISTING requires both W0 and H0")
        # Always copy: the user's warm-start buffers must survive
        # multi-run restarts untouched.
        return (
            torch.as_tensor(W0, dtype=dtype, device=device).clone(),
            torch.as_tensor(H0, dtype=dtype, device=device).clone(),
        )

    scale = torch.sqrt(torch.clamp(torch.mean(V), min=1e-12) / rank).to(dtype)

    if method is Initialization.ALL_RANDOM_VALUES:
        W = _random_uniform(gen, (n, rank), scale, dtype, device)
        H = _random_uniform(gen, (rank, m), scale, dtype, device)
        return W, H

    if method is Initialization.MEAN_COLUMNS:
        # Each W column = mean of `q` random columns of V (the paper's
        # MeanColumns strategy; q = max(5, m // rank) bounded by m).
        q = int(min(max(5, m // max(rank, 1)), m))
        cols = torch.randint(0, m, (rank, q), generator=gen, device=device)
        W = V[:, cols.reshape(-1)].reshape(n, rank, q).mean(dim=2)
        H = _random_uniform(gen, (rank, m), scale, dtype, device)
        return W, H

    if method in (Initialization.NNDSVD, Initialization.NNDSVDA,
                  Initialization.NNDSVDAR):
        from nmftpu_torch.init.nndsvd import nndsvd_init

        # host-side one-time SVD seeding (deterministic; the 'ar'
        # variant's fill noise is seeded from the run's generator)
        seed = int(torch.randint(0, 2**31 - 1, (), generator=gen,
                                 device=device))
        W, H = nndsvd_init(V.cpu().numpy(), rank, variant=method.value,
                           seed=seed)
        return (torch.as_tensor(W, dtype=dtype, device=device),
                torch.as_tensor(H, dtype=dtype, device=device))

    if method in (Initialization.K_MEANS_AND_RANDOM_VALUES,
                  Initialization.K_MEANS_AND_NON_NEGATIVE_WTV,
                  Initialization.K_MEANS_AND_ABSOLUTE_WTV):
        centroids, _ = kmeans_columns(V, rank, gen, max_iter=kmeans_max_iter)
        W = torch.clamp(centroids, min=0.0) + 1e-6
        if method is Initialization.K_MEANS_AND_RANDOM_VALUES:
            H = _random_uniform(gen, (rank, m), scale, dtype, device)
        elif method is Initialization.K_MEANS_AND_NON_NEGATIVE_WTV:
            H = torch.clamp(W.T @ V, min=0.0) + 1e-6
        else:  # K_MEANS_AND_ABSOLUTE_WTV
            H = torch.abs(W.T @ V) + 1e-6
        return W, H

    raise ValueError(f"unknown initialization method: {method}")
