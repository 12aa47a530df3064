"""NNDSVD initialization (Boutsidis & Gallopoulos, Pattern Recognition
2008): W and H from the nonnegative parts of the truncated SVD (a numpy
copy of ``nmftpu/init/nndsvd.py``, operation for operation).

sklearn's default init (`_initialize_nmf`, init=None -> 'nndsvda').
Deterministic: the SVD is exact, and NNDSVD's per-component choice of
the positive or the negative part makes the result invariant to the
SVD's sign ambiguity. It runs once on the host before the device loop,
through LAPACK (sparse V refuses NNDSVD until the sparse engines take
the ALS family and these inits).
"""

from __future__ import annotations

import numpy as np

_VARIANTS = ("nndsvd", "nndsvda", "nndsvdar")


def _truncated_svd(X, rank: int):
    """(U[:, :r], S[:r], Vt[:r]) of a dense ndarray, through LAPACK."""
    X = np.asarray(X)
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    return U[:, :rank], S[:rank], Vt[:rank]


def nndsvd_init(X, rank: int, variant: str = "nndsvda", eps: float = 1e-6,
                seed: int = 0):
    """Return (W, H) numpy float64 factors; the semantics of sklearn's
    `_initialize_nmf(init=variant)`.

    variant: "nndsvd" keeps the structural zeros; "nndsvda" fills them
    with mean(X); "nndsvdar" with small random values seeded by `seed`.
    """
    if variant not in _VARIANTS:
        raise ValueError(f"variant must be one of {_VARIANTS}")
    n, m = X.shape
    if rank > min(n, m):
        raise ValueError(
            f"nndsvd requires rank <= min(shape) = {min(n, m)}, got {rank}"
        )
    return _nndsvd_from_svd(X, *_truncated_svd(X, rank), variant=variant,
                            eps=eps, seed=seed)


def _nndsvd_from_svd(X, U, S, Vt, variant: str, eps: float, seed: int):
    """`nndsvd_init` from X's truncated SVD (U, S, Vt), so that the
    three variants can share one SVD."""
    n, m = X.shape
    rank = S.shape[0]
    W = np.zeros((n, rank))
    H = np.zeros((rank, m))

    # The per-component loop follows the published algorithm (Boutsidis &
    # Gallopoulos 2008, Algorithm NNDSVD) in sklearn's formulation
    # (sklearn.decomposition._nmf `_initialize_nmf`, BSD-3), kept close to
    # it on purpose: the norms, the tie-break and the /100 fill must come
    # in the same order for the result to equal sklearn's.

    # the leading singular triplet is nonnegative up to sign
    W[:, 0] = np.sqrt(S[0]) * np.abs(U[:, 0])
    H[0, :] = np.sqrt(S[0]) * np.abs(Vt[0, :])

    for j in range(1, rank):
        x, y = U[:, j], Vt[j, :]
        x_p, y_p = np.maximum(x, 0.0), np.maximum(y, 0.0)
        x_n, y_n = np.abs(np.minimum(x, 0.0)), np.abs(np.minimum(y, 0.0))
        x_p_nrm, y_p_nrm = np.linalg.norm(x_p), np.linalg.norm(y_p)
        x_n_nrm, y_n_nrm = np.linalg.norm(x_n), np.linalg.norm(y_n)
        m_p, m_n = x_p_nrm * y_p_nrm, x_n_nrm * y_n_nrm
        if m_p > m_n:
            u, v, sigma = x_p / max(x_p_nrm, 1e-30), \
                y_p / max(y_p_nrm, 1e-30), m_p
        else:
            u, v, sigma = x_n / max(x_n_nrm, 1e-30), \
                y_n / max(y_n_nrm, 1e-30), m_n
        lbd = np.sqrt(S[j] * sigma)
        W[:, j] = lbd * u
        H[j, :] = lbd * v

    W[W < eps] = 0.0
    H[H < eps] = 0.0

    if variant != "nndsvd":
        avg = float(np.mean(np.asarray(X)))
    if variant == "nndsvda":
        W[W == 0.0] = avg
        H[H == 0.0] = avg
    elif variant == "nndsvdar":
        rng = np.random.default_rng(seed)
        W[W == 0.0] = np.abs(
            avg * rng.standard_normal(int((W == 0.0).sum())) / 100.0
        )
        H[H == 0.0] = np.abs(
            avg * rng.standard_normal(int((H == 0.0).sum())) / 100.0
        )
    return W, H

