"""NNDSVD initialization (Boutsidis & Gallopoulos, Pattern Recognition
2008): W and H from the nonnegative parts of the truncated SVD (a numpy
copy of ``nmftpu/init/nndsvd.py``, operation for operation).

sklearn's default init (`_initialize_nmf`, init=None -> 'nndsvda').
Deterministic: the SVD is exact, and NNDSVD's per-component choice of
the positive or the negative part makes the result invariant to the
SVD's sign ambiguity. It runs once on the host before the device loop:
a dense V through LAPACK, a sparse one (scipy sparse, or one of the
port's containers) through scipy's `svds`, never densified unless every
start vector fails and the matrix holds at most 50M cells.
"""

from __future__ import annotations

import numpy as np

_VARIANTS = ("nndsvd", "nndsvda", "nndsvdar")


# a sparse V whose svds fails from every start vector is densified for
# LAPACK only up to this many cells
DENSIFY_MAX_CELLS = 50_000_000


def _truncated_svd(X, rank: int):
    """(U[:, :r], S[:r], Vt[:r]) of a dense ndarray through LAPACK, or of
    a sparse V (scipy sparse or a port container) through `svds`, from
    three start vectors in turn: ones, then two seeded normal draws (a
    constant v0 can stall ARPACK). Only ARPACK's own failures move on to
    the next start (``nmftpu`` catches every Exception there); when all
    fail, V is densified if it has at most DENSIFY_MAX_CELLS cells, else
    RuntimeError. rank = min(V.shape) is out of `svds`' reach and goes
    dense."""
    from nmftpu_torch.sparse import SparseMatrix

    if isinstance(X, SparseMatrix):
        import scipy.sparse as sps

        csr = X.to_csr()
        X = sps.csr_matrix((csr.data, csr.indices, csr.indptr),
                           shape=csr.shape)
    if hasattr(X, "tocsr") and hasattr(X, "nnz"):  # scipy.sparse
        from scipy.sparse import linalg as spla

        if rank < min(X.shape):
            if not np.issubdtype(X.dtype, np.floating):
                X = X.astype(np.float64)
            k = min(X.shape)
            starts = [np.ones(k, dtype=np.float64)] + [
                np.random.default_rng(s).standard_normal(k) for s in (0, 1)]
            err = None
            for v0 in starts:
                try:
                    U, S, Vt = spla.svds(X, k=rank, v0=v0)
                except (spla.ArpackNoConvergence, spla.ArpackError) as e:
                    err = e
                    continue
                if np.all(np.isfinite(S)) and np.all(S >= 0):
                    order = np.argsort(S)[::-1]  # svds returns ascending
                    return U[:, order], S[order], Vt[order]
            if X.shape[0] * X.shape[1] > DENSIFY_MAX_CELLS:
                raise RuntimeError(
                    "nndsvd: truncated svds failed to converge on all "
                    "start vectors and the matrix is too large to "
                    "densify; use init_method='kmeans*' or 'random' "
                    f"instead (last error: {err})")
        X = np.asarray(X.todense())
    X = np.asarray(X)
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    return U[:, :rank], S[:rank], Vt[:rank]


def _mean(X) -> float:
    """mean(V) for the nndsvda/ar fill: Σ stored values / (n m) for a
    sparse V, as ``nmftpu`` takes it, np.mean for a dense one."""
    if hasattr(X, "nnz"):
        data = X.data if hasattr(X, "data") else X.to_csr().data
        return float(np.sum(data)) / (X.shape[0] * X.shape[1])
    return float(np.mean(np.asarray(X)))


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
        avg = _mean(X)
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

