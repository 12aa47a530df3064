"""The k-means and NNDSVD inits of nmftpu_torch against nmftpu's.

* `_lloyd` started from the columns that ``jax.random.choice`` picks for
  ``nmftpu.init.kmeans_columns`` (the same key): on columns drawn around
  well-separated centres, the assignments equal and the centroids at
  1e-10 (float64) and 1e-5 (float32) relative to the largest entry; in
  float32 from starting columns in distinct clusters only (two starts in
  one cluster split it into near-ties that float32 may break either
  way);
* `nndsvd_init`'s three variants bit-equal to
  ``nmftpu.init.nndsvd.nndsvd_init`` (both numpy), and equal when built
  from one shared SVD (`_nndsvd_from_svd`); nndsvd and
  nndsvda within 1e-6 of sklearn's `_initialize_nmf` (absolute, on
  entries of order 1) on a rank-r matrix plus 1e-3 noise, where the
  randomized SVD that sklearn runs converges to the exact one (its error
  falls as (σ_{r+11} / σ_r)^(2q+1)); nndsvdar's structural entries as
  nndsvd's (its fill comes from another generator than sklearn's);
* `_truncated_svd` on a dense array bit-equal to nmftpu's;
* each of the six new `init_method`s through ``nmftpu_torch.nmf(...,
  device="cpu")`` with no iteration: shapes, nonnegativity, W equal to
  max(centroids, 0) + 1e-6 for the k-means inits, and H equal to
  max(WᵀV, 0) + 1e-6 and |WᵀV| + 1e-6 given W (1e-6 relative: the
  same product); the NNDSVD variants equal to `nndsvd_init` in V's
  dtype, nndsvdar with the seed the run's generator draws.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nmftpu_torch as nt  # noqa: E402
from nmftpu.init import kmeans as JK  # noqa: E402
from nmftpu.init import nndsvd as JN  # noqa: E402
from nmftpu_torch.init import initialize_factors, run_generator  # noqa
from nmftpu_torch.init import kmeans as TK  # noqa: E402
from nmftpu_torch.init import nndsvd as TN  # noqa: E402

VARIANTS = ("nndsvd", "nndsvda", "nndsvdar")
KMEANS = ("kmeans_random", "kmeans_nonnegative_wtv", "kmeans_absolute_wtv")


def _clustered(n, m, k, dtype, seed=0, spread=0.05, labels=False):
    """m columns of length n drawn around k well-separated centres (and
    each column's centre, with `labels`)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.0, 10.0, (n, k))
    lab = rng.integers(0, k, m)
    V = np.abs(centres[:, lab] + spread * rng.standard_normal((n, m)))
    return (V.astype(dtype), lab) if labels else V.astype(dtype)


def _lowrank(n, m, r, seed=0, noise=1e-3):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0, 1, (n, r)) @ rng.uniform(0, 1, (r, m))
    return V + noise * rng.uniform(0, 1, (n, m))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,n,m,rank,k,max_iter", [
    (np.float64, 30, 200, 5, 5, 25), (np.float64, 64, 300, 8, 6, 10),
    (np.float64, 12, 90, 4, 9, 25), (np.float64, 50, 400, 16, 16, 3),
    (np.float32, 30, 200, 4, 12, 25), (np.float32, 64, 300, 3, 9, 10),
    (np.float32, 12, 90, 4, 16, 25), (np.float32, 50, 400, 5, 20, 3),
])
def test_lloyd_matches_nmftpu(dtype, n, m, rank, k, max_iter):
    """Two starting columns in one cluster split it, and the columns
    between them are near-ties that float32 may break either way: the
    float32 cases take the first key whose starting columns lie in
    distinct clusters, and then no distance is near a tie."""
    V, lab = _clustered(n, m, k, dtype, seed=n + m, labels=True)
    seed = rank + max_iter
    while True:
        key = jax.random.PRNGKey(seed)
        cols = np.array(jax.random.choice(key, m, shape=(rank,),
                                          replace=False))
        if dtype == np.float64 or len(set(lab[cols])) == rank:
            break
        seed += 1000
    c_j, a_j = JK.kmeans_columns(jnp.asarray(V), rank, key,
                                 max_iter=max_iter)
    Vt = torch.tensor(V)
    c_t, a_t = TK._lloyd(Vt, Vt[:, torch.as_tensor(cols)], max_iter)
    assert c_t.dtype == Vt.dtype and a_t.shape == (m,)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert _max_rel(c_t.numpy(), c_j) <= (1e-10 if dtype == np.float64
                                          else 1e-5)


def test_lloyd_keeps_an_empty_clusters_centroid():
    """A centroid far from every column gets no column and stays."""
    V = _clustered(10, 60, 3, np.float64, seed=1)
    far = np.full((10, 1), 1e3)
    c0 = torch.tensor(np.hstack([V[:, :2], far]))
    c, a = TK._lloyd(torch.tensor(V), c0, 5)
    assert not (a == 2).any()
    np.testing.assert_array_equal(c[:, 2].numpy(), far[:, 0])


def test_lloyd_within_cluster_sum_never_rises():
    V = torch.tensor(_clustered(20, 500, 12, np.float64, seed=4,
                                spread=3.0))
    gen = torch.Generator().manual_seed(0)
    c = V[:, torch.randperm(500, generator=gen)[:8]]
    last = np.inf
    for _ in range(10):
        c, a = TK._lloyd(V, c, 1)
        wcss = float(((V - c[:, a]) ** 2).sum())
        assert wcss <= last * (1 + 1e-12)
        last = wcss


def test_kmeans_columns_starts_from_distinct_columns():
    V = torch.tensor(_clustered(8, 40, 4, np.float64))
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        c, a = TK.kmeans_columns(V, 40, gen, max_iter=0)
        # rank = m columns, none repeated: every column is its own centre
        assert torch.unique(c, dim=1).shape[1] == 40
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    assert torch.equal(TK.kmeans_columns(V, 5, g1)[0],
                       TK.kmeans_columns(V, 5, g2)[0])


# ---------------------------------------------------------------------------
# NNDSVD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape,rank", [((30, 24), 6), ((50, 70), 12),
                                        ((9, 9), 9)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nndsvd_bit_equal_to_nmftpu(variant, shape, rank, dtype):
    rng = np.random.default_rng(rank)
    X = rng.uniform(0.0, 3.0, shape).astype(dtype)
    Wj, Hj = JN.nndsvd_init(X, rank, variant=variant, seed=11)
    Wt, Ht = TN.nndsvd_init(X, rank, variant=variant, seed=11)
    np.testing.assert_array_equal(Wt, Wj)
    np.testing.assert_array_equal(Ht, Hj)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variants_share_one_svd(variant):
    """`_nndsvd_from_svd` on an SVD computed once gives `nndsvd_init`'s
    factors for each variant."""
    X = _lowrank(40, 30, 4, seed=2)
    svd = TN._truncated_svd(X, 4)
    W, H = TN._nndsvd_from_svd(X, *svd, variant=variant, eps=1e-6, seed=5)
    Wi, Hi = TN.nndsvd_init(X, 4, variant=variant, seed=5)
    np.testing.assert_array_equal(W, Wi)
    np.testing.assert_array_equal(H, Hi)


@pytest.mark.parametrize("shape,rank", [((30, 24), 6), ((60, 45), 3)])
def test_nndsvd_matches_sklearn(shape, rank):
    from sklearn.decomposition._nmf import _initialize_nmf

    X = _lowrank(*shape, rank, seed=rank)
    for variant in ("nndsvd", "nndsvda"):
        W_sk, H_sk = _initialize_nmf(X, rank, init=variant, random_state=0)
        W, H = TN.nndsvd_init(X, rank, variant=variant)
        np.testing.assert_allclose(W, W_sk, rtol=0, atol=1e-6)
        np.testing.assert_allclose(H, H_sk, rtol=0, atol=1e-6)
    W_sk, H_sk = _initialize_nmf(X, rank, init="nndsvdar", random_state=0)
    W0, H0 = TN.nndsvd_init(X, rank, variant="nndsvd")
    W, H = TN.nndsvd_init(X, rank, variant="nndsvdar")
    for got, sk, core in ((W, W_sk, W0), (H, H_sk, H0)):
        kept = core > 0
        np.testing.assert_allclose(got[kept], sk[kept], rtol=0, atol=1e-6)
        # the fill: small, nonnegative (|avg · N(0, 1)| / 100)
        assert (got[~kept] >= 0).all() and (got[~kept] < X.mean()).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_truncated_svd_bit_equal_to_nmftpu(dtype):
    X = _lowrank(50, 35, 5, seed=7).astype(dtype)
    got = TN._truncated_svd(X, 5)
    want = JN._truncated_svd(X, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.all(np.diff(got[1]) <= 0)


def test_nndsvd_refuses_what_nmftpu_refuses():
    X = np.ones((5, 4))
    with pytest.raises(ValueError, match="variant"):
        TN.nndsvd_init(X, 2, variant="svd")
    with pytest.raises(ValueError, match="rank <= min"):
        TN.nndsvd_init(X, 5)


# ---------------------------------------------------------------------------
# the six inits through nmf
# ---------------------------------------------------------------------------


def _fixture(dtype=np.float32):
    return _clustered(60, 80, 6, dtype, seed=9, spread=0.5)


@pytest.mark.parametrize("init", KMEANS + VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_new_inits_through_nmf(init, dtype):
    V = _fixture(np.dtype(dtype))
    res = nt.nmf(V, 5, init=init, num_iterations=0, seed=3, dtype=dtype,
                 device="cpu", kmeans_max_iter=7)
    W, H = res.W, res.H
    assert W.shape == (60, 5) and H.shape == (5, 80)
    assert W.dtype == H.dtype == getattr(torch, dtype)
    assert (W >= 0).all() and (H >= 0).all()
    assert torch.isfinite(W).all() and torch.isfinite(H).all()
    Vt = torch.tensor(V)
    if init in KMEANS:
        gen = run_generator(3, 0, "cpu")
        c, _ = TK.kmeans_columns(Vt, 5, gen, max_iter=7)
        torch.testing.assert_close(W, torch.clamp(c, min=0.0) + 1e-6,
                                   rtol=0, atol=0)
        WtV = W.T @ Vt
        if init == "kmeans_nonnegative_wtv":
            torch.testing.assert_close(H, torch.clamp(WtV, min=0.0) + 1e-6,
                                       rtol=1e-6, atol=0)
        elif init == "kmeans_absolute_wtv":
            torch.testing.assert_close(H, WtV.abs() + 1e-6, rtol=1e-6,
                                       atol=0)
        else:
            scale = float(np.sqrt(V.mean() / 5))
            assert float(H.min()) >= 1e-4 * scale * (1 - 1e-6)
            assert float(H.max()) <= 1.0001 * scale * (1 + 1e-6)
    else:
        gen = run_generator(3, 0, "cpu")
        seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        Wn, Hn = TN.nndsvd_init(V, 5, variant=init, seed=seed)
        np.testing.assert_array_equal(W.numpy(), Wn.astype(dtype))
        np.testing.assert_array_equal(H.numpy(), Hn.astype(dtype))


@pytest.mark.parametrize("init", KMEANS + VARIANTS)
def test_new_inits_start_the_algorithms(init):
    """Each init feeds every algorithm; the first error is the init's."""
    V = _fixture()
    for algorithm in ("mu", "als", "gdcls", "nsnmf"):
        res = nt.nmf(V, 5, init=init, algorithm=algorithm, num_iterations=3,
                     check_interval=1, device="cpu")
        assert np.isfinite(res.stats.errors).all(), algorithm


def test_nndsvd_beats_random_on_a_lowrank_matrix():
    """nndsvd and nndsvdar start below the random init's error; nndsvda
    fills every structural zero with mean(V) (for MU, which cannot leave
    a zero), which puts its start far above it, as in sklearn."""
    V = _lowrank(80, 60, 6, seed=3).astype(np.float32)
    e = {init: nt.nmf(V, 6, init=init, num_iterations=0,
                      device="cpu").error
         for init in ("random", *VARIANTS)}
    assert max(e["nndsvd"], e["nndsvdar"]) < e["random"], e
    W0, H0 = TN.nndsvd_init(V, 6, variant="nndsvd")
    Wa, Ha = TN.nndsvd_init(V, 6, variant="nndsvda")
    for core, filled in ((W0, Wa), (H0, Ha)):
        np.testing.assert_array_equal(filled[core > 0], core[core > 0])
        assert (filled[core == 0] == float(np.mean(V))).all()


def test_initialize_factors_rejects_an_unknown_method():
    V = torch.ones(4, 5)
    with pytest.raises(ValueError, match="unknown initialization"):
        initialize_factors(V, 2, "kmeans", torch.Generator())

