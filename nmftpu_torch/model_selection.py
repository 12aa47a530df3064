"""Rank selection by consensus clustering (Brunet et al. 2004, PNAS;
the cophenetic-correlation method every NMF suite ships for choosing
the factorization rank), plus Kim & Park's dispersion coefficient.

For each candidate rank, the matrix is factorized from `n_runs` random
restarts; each run clusters the rows by their dominant factor
(argmax over W's columns), giving a boolean connectivity matrix; the
run-average is the consensus matrix C. If the rank matches real
structure, restarts agree and C's entries concentrate at {0, 1}:

* cophenetic correlation rho(k): correlation between consensus
  distances (1 - C) and the cophenetic distances of their
  average-linkage dendrogram — near 1 for stable clusterings; pick the
  largest k before rho drops.
* dispersion(k) = (1/n^2) sum 4 (C_ij - 1/2)^2 — 1 iff C is binary.

The restarts run through the port's drivers on the device (CUDA unless
``device="cpu"``), and the O(n^2) connectivity accumulation is a
device-side label-equality outer compare. For large n pass `sample` to
estimate C on a seeded row subset (standard practice — consensus
concentration is a global property). Port of
``nmftpu/model_selection.py``; the cophenetic correlation uses scipy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmftpu_torch.config import Initialization, NmfConfig

__all__ = [
    "RankSelection",
    "connectivity",
    "consensus_matrix",
    "cophenetic_correlation",
    "dispersion",
    "rank_selection",
]


def connectivity(W):
    """Boolean co-clustering matrix: rows i, j connected iff their
    dominant factor (argmax over W's r columns, the first on a tie)
    agrees. W: a tensor (the result stays on its device) or an array."""
    W = torch.as_tensor(W)
    labels = torch.argmax(W, dim=1)
    return labels[:, None] == labels[None, :]


def consensus_matrix(V, config: NmfConfig, n_runs: int = 10, *,
                     cluster_w: bool = True, sample=None,
                     compute_fn=None, device=None):
    """Average connectivity over `n_runs` random restarts of `config`
    (seed + run per run). cluster_w=True clusters rows via W;
    False clusters columns via H^T (Brunet's sample clustering).
    `sample`: optional int — estimate C on that many seeded random
    rows/columns. compute_fn(V, config) runs one restart (by default
    `api.dispatch` on `device`). Returns (C, errors): C the (s, s)
    consensus float32 numpy matrix, errors the per-run final errors."""
    if compute_fn is None:
        from nmftpu_torch.api import dispatch

        def compute_fn(v, c):
            return dispatch(v, c, device=device)
    n_axis = V.shape[0] if cluster_w else V.shape[1]
    idx = None
    if sample is not None and sample < n_axis:
        idx = np.sort(
            np.random.default_rng(config.seed).choice(
                n_axis, size=int(sample), replace=False
            )
        )
    C = None
    errors = []
    for run in range(int(n_runs)):
        cfg = dataclasses.replace(config, seed=config.seed + run)
        res = compute_fn(V, cfg)
        F = torch.as_tensor(res.W if cluster_w else res.H.T)
        if idx is not None:
            F = F[torch.as_tensor(idx, device=F.device)]
        conn = connectivity(F).to(torch.float32)
        C = conn if C is None else C + conn
        errors.append(float(res.error))
    return C.cpu().numpy() / float(n_runs), errors


def cophenetic_correlation(C) -> float:
    """rho between the consensus distance (1 - C) and the cophenetic
    distance of its average-linkage dendrogram (scipy)."""
    from scipy.cluster.hierarchy import cophenet, linkage
    from scipy.spatial.distance import squareform

    C = np.asarray(C, np.float64)
    C = (C + C.T) / 2.0
    np.fill_diagonal(C, 1.0)
    d = squareform(1.0 - C, checks=False)
    if not d.any():  # perfectly stable: every run identical
        return 1.0
    Z = linkage(d, method="average")
    rho, _ = cophenet(Z, d)
    if not np.isfinite(rho):
        # constant nonzero distances (e.g. a maximally unstable
        # consensus, every entry 0.5): pearson is 0/0 — report "no
        # stable structure" instead of propagating NaN
        return 0.0
    return float(rho)


def dispersion(C) -> float:
    """Kim & Park dispersion: 1 iff the consensus is binary."""
    C = np.asarray(C, np.float64)
    return float(np.mean(4.0 * (C - 0.5) ** 2))


@dataclasses.dataclass
class RankSelection:
    """Per-rank consensus metrics. `best_rank` follows Brunet's
    reading — the LARGEST k whose consensus quality (rho x dispersion)
    stays within tolerance of the best observed — because
    under-fitting ranks are also perfectly stable (rho = 1 at k too
    small), so a plain argmax would tie toward the smallest rank.
    Always inspect the full curves."""

    ranks: list
    cophenetic: list
    dispersion: list
    mean_error: list
    std_error: list
    best_rank: int

    def as_dict(self):
        return {
            int(k): {
                "cophenetic": self.cophenetic[i],
                "dispersion": self.dispersion[i],
                "mean_error": self.mean_error[i],
                "std_error": self.std_error[i],
            }
            for i, k in enumerate(self.ranks)
        }


def rank_selection(
    V,
    ranks,
    n_runs: int = 10,
    *,
    num_iterations: int = 100,
    cluster_w: bool = True,
    sample=None,
    seed: int = 0,
    mesh=None,
    strategy: str = "auto",
    device=None,
    **config_knobs,
) -> RankSelection:
    """Consensus rank selection over `ranks` (dense array or tensor, or
    one of the port's sparse containers; extra knobs forward into
    NmfConfig — algorithm, objective, eps, ...). Random-restart init is
    forced (consensus is meaningless under deterministic seeding).
    device: where the restarts run (default CUDA). mesh: every restart
    runs sharded over the rank mesh (``api.dispatch``), every rank
    calling alike."""
    from nmftpu_torch.api import dispatch

    ranks = [int(k) for k in ranks]
    cards, disps, means, stds = [], [], [], []
    for k in ranks:
        cfg = NmfConfig(
            rank=k,
            init_method=Initialization.ALL_RANDOM_VALUES,
            seed=seed,
            num_iterations=int(num_iterations),
            **config_knobs,
        )
        C, errs = consensus_matrix(
            V, cfg, n_runs=n_runs, cluster_w=cluster_w, sample=sample,
            compute_fn=lambda v, c: dispatch(
                v, c, mesh=mesh, strategy=strategy, device=device
            ),
        )
        cards.append(cophenetic_correlation(C))
        disps.append(dispersion(C))
        means.append(float(np.mean(errs)))
        stds.append(float(np.std(errs)))
    score = np.nan_to_num(np.asarray(cards) * np.asarray(disps))
    stable = np.flatnonzero(score >= score.max() - 0.01)
    best = max(ranks[i] for i in stable)
    return RankSelection(
        ranks=ranks, cophenetic=cards, dispersion=disps,
        mean_error=means, std_error=stds, best_rank=best,
    )
