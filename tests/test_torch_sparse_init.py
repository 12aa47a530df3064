"""The k-means and NNDSVD inits on sparse V in the port against nmftpu on
the same numpy inputs, V never densified:

* `extract_columns` (a per-column slot map) equal to nmftpu's masked
  scatter;
* sparse Lloyd (`_lloyd_sparse`) started from the columns that
  ``jax.random.choice`` picks for ``nmftpu.sparse_ops.
  kmeans_columns_sparse`` (the same key): the assignments equal, the
  centroids at 1e-10 (float64) and 1e-5 (float32) relative to the
  largest entry, on columns drawn around well-separated sparse centres
  (float32 from starting columns in distinct clusters only, as
  `tests/test_torch_init.py` takes them); and the port's dense `_lloyd`
  on the densified V from the same columns, equal to the same limits;
* `nndsvd_init` on the port's containers (and scipy CSR) bit-equal to
  nmftpu's on its containers with the same seed: the same `svds` calls
  from the same start vectors, the same sparse mean; the sparse start
  error within 1e-3 relative of the dense LAPACK one (ARPACK converges
  to the truncated SVD, float32 data); the `svds` catch: only ARPACK's
  failures move on to the next start vector;
* every init through `sparse_initialize_factors` and `nmf` on each
  engine: shapes, dtype, nonnegativity, the k-means W and H built from
  the centroids as the dense inits build them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sps  # noqa: E402
from scipy.sparse import linalg as spla  # noqa: E402

import nmftpu_torch as nt  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ops as JS  # noqa: E402
from nmftpu.init import nndsvd as JN  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.config import Initialization  # noqa: E402
from nmftpu_torch.convert import sparse_from_nmftpu  # noqa: E402
from nmftpu_torch.init import kmeans as TK  # noqa: E402
from nmftpu_torch.init import nndsvd as TN  # noqa: E402
from nmftpu_torch.init import run_generator  # noqa: E402

VARIANTS = ("nndsvd", "nndsvda", "nndsvdar")
KMEANS = (Initialization.K_MEANS_AND_RANDOM_VALUES,
          Initialization.K_MEANS_AND_NON_NEGATIVE_WTV,
          Initialization.K_MEANS_AND_ABSOLUTE_WTV)
NNDSVDS = (Initialization.NNDSVD, Initialization.NNDSVDA,
           Initialization.NNDSVDAR)


def _tdtype(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def _containers(dense):
    jsp = js.from_dense(dense)
    return jsp, sparse_from_nmftpu(jsp)


def _coos(dense, dtype):
    jsp, tsp = _containers(dense)
    return (JS.device_put_sparse(jsp, dtype=jnp.dtype(dtype)),
            TS.device_put_sparse(tsp, dtype=_tdtype(dtype), device="cpu"))


def _clustered_sparse(n, m, k, dtype, seed=0, support=0.3, spread=0.05):
    """m columns around k sparse centres (each nonzero on a random 30% of
    the rows, values 1..10), a column nonzero on its centre's support
    only; returns (V, labels)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, k)) < support
    centres = np.where(mask, rng.uniform(1.0, 10.0, (n, k)), 0.0)
    lab = rng.integers(0, k, m)
    noise = spread * rng.standard_normal((n, m))
    V = np.where(mask[:, lab], np.abs(centres[:, lab] + noise), 0.0)
    return V.astype(dtype), lab


def _ratings(seed=0, n=200, m=150, density=0.1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < density,
                     rng.uniform(0.5, 5.0, (n, m)), 0.0).astype(dtype)
    dense[5, :] = 0.0
    dense[:, 7] = 0.0
    return dense


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _start_columns(key_seed, m, rank, lab, dtype):
    """The columns ``jax.random.choice`` draws from the key of
    `key_seed` (float32: the first key whose columns lie in distinct
    clusters)."""
    seed = key_seed
    while True:
        key = jax.random.PRNGKey(seed)
        cols = np.array(jax.random.choice(key, m, shape=(rank,),
                                          replace=False))
        if dtype == np.float64 or len(set(lab[cols])) == rank:
            return key, cols
        seed += 1000


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 5, 40])
def test_extract_columns_matches(k, dtype):
    dense = _ratings(dtype=dtype)
    jc, tc = _coos(dense, dtype)
    cols = np.random.default_rng(k).choice(dense.shape[1], k, replace=False)
    got = TS.extract_columns(tc, torch.as_tensor(cols))
    want = JS.extract_columns(jc, jnp.asarray(cols))
    assert got.dtype == _tdtype(dtype) and got.shape == (dense.shape[0], k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), dense[:, cols])


@pytest.mark.parametrize("dtype,n,m,rank,k,max_iter", [
    (np.float64, 40, 200, 5, 5, 25), (np.float64, 60, 300, 8, 6, 10),
    (np.float64, 30, 120, 4, 9, 25),
    (np.float32, 40, 200, 4, 12, 25), (np.float32, 60, 300, 3, 9, 10),
    (np.float32, 30, 120, 4, 16, 25),
])
def test_sparse_lloyd_matches_nmftpu(dtype, n, m, rank, k, max_iter):
    V, lab = _clustered_sparse(n, m, k, dtype, seed=n + m)
    jc, tc = _coos(V, dtype)
    key, cols = _start_columns(rank + max_iter, m, rank, lab, dtype)
    c_j, a_j = JS.kmeans_columns_sparse(jc, rank, key, max_iter=max_iter)
    c_t, a_t = TS._lloyd_sparse(tc, TS.extract_columns(tc, cols), max_iter)
    assert c_t.dtype == _tdtype(dtype) and a_t.shape == (m,)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert _max_rel(c_t, c_j) <= (1e-10 if dtype == np.float64 else 1e-5)
    # the dense Lloyd on the densified V, from the same columns
    Vt = torch.tensor(V)
    c_d, a_d = TK._lloyd(Vt, Vt[:, torch.as_tensor(cols)], max_iter)
    np.testing.assert_array_equal(a_t.numpy(), a_d.numpy())
    assert _max_rel(c_t, c_d) <= (1e-10 if dtype == np.float64 else 1e-5)


def test_sparse_lloyd_within_cluster_sum_never_rises():
    V, _ = _clustered_sparse(30, 400, 10, np.float64, seed=4, spread=3.0)
    _, tc = _coos(V, np.float64)
    gen = torch.Generator().manual_seed(0)
    c = TS.extract_columns(tc, torch.randperm(400, generator=gen)[:8])
    Vt = torch.tensor(V)
    last = np.inf
    for _ in range(10):
        c, a = TS._lloyd_sparse(tc, c, 1)
        wcss = float(((Vt - c[:, a]) ** 2).sum())
        assert wcss <= last * (1 + 1e-12)
        last = wcss


def test_kmeans_columns_sparse_starts_from_distinct_columns():
    V, _ = _clustered_sparse(12, 40, 4, np.float64)
    _, tc = _coos(V, np.float64)
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        c, _ = TS.kmeans_columns_sparse(tc, 40, gen, max_iter=0)
        # rank = m columns, none repeated: every column is its own centre
        np.testing.assert_array_equal(np.sort(c.numpy(), axis=1),
                                      np.sort(V, axis=1))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    assert torch.equal(TS.kmeans_columns_sparse(tc, 5, g1)[0],
                       TS.kmeans_columns_sparse(tc, 5, g2)[0])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("init", KMEANS, ids=lambda i: i.value)
def test_kmeans_inits_build_w_and_h_from_the_centroids(init, dtype):
    dense = _ratings(seed=1, dtype=dtype)
    _, tc = _coos(dense, dtype)
    W, H = TS.sparse_initialize_factors(tc, 6, init, run_generator(3, 0,
                                                                   "cpu"),
                                        kmeans_max_iter=7)
    c, _ = TS.kmeans_columns_sparse(tc, 6, run_generator(3, 0, "cpu"),
                                    max_iter=7)
    assert W.dtype == H.dtype == _tdtype(dtype)
    assert W.shape == (200, 6) and H.shape == (6, 150)
    assert (W > 0).all() and (H > 0).all()
    np.testing.assert_array_equal(W.numpy(),
                                  (torch.clamp(c, min=0.0) + 1e-6).numpy())
    WtV = W.T.double() @ torch.tensor(dense).double()
    if init is Initialization.K_MEANS_AND_NON_NEGATIVE_WTV:
        assert _max_rel(H, torch.clamp(WtV, min=0.0) + 1e-6) <= 1e-6
    elif init is Initialization.K_MEANS_AND_ABSOLUTE_WTV:
        assert _max_rel(H, WtV.abs() + 1e-6) <= 1e-6


def test_kmeans_max_iter_reaches_the_init(monkeypatch):
    """A plan's run passes config.kmeans_max_iter to the sparse init."""
    seen = []
    real = TS.kmeans_columns_sparse

    def spy(coo, rank, gen, max_iter=25):
        seen.append(max_iter)
        return real(coo, rank, gen, max_iter=max_iter)

    monkeypatch.setattr(TS, "kmeans_columns_sparse", spy)
    _, tsp = _containers(_ratings())
    nt.nmf(tsp, 4, init="kmeans_random", kmeans_max_iter=3,
           num_iterations=1, strategy="scatter", device="cpu")
    assert seen == [3]


# ---------------------------------------------------------------------------
# NNDSVD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant", VARIANTS)
def test_sparse_nndsvd_bit_equal_to_nmftpu(variant, dtype):
    dense = _ratings(seed=2, dtype=dtype)
    jsp, tsp = _containers(dense)
    Wj, Hj = JN.nndsvd_init(jsp, 8, variant=variant, seed=11)
    for X in (tsp, sps.csr_matrix(dense)):
        Wt, Ht = TN.nndsvd_init(X, 8, variant=variant, seed=11)
        np.testing.assert_array_equal(Wt, Wj)
        np.testing.assert_array_equal(Ht, Hj)


def test_sparse_mean_is_nmftpus():
    dense = _ratings(seed=3)
    jsp, tsp = _containers(dense)
    want = float(np.sum(jsp.to_csr().data)) / dense.size
    assert TN._mean(tsp) == TN._mean(sps.csr_matrix(dense)) == want
    assert TN._mean(dense) == float(np.mean(dense))


@pytest.mark.parametrize("variant", VARIANTS)
def test_sparse_nndsvd_starts_near_the_dense_one(variant):
    """svds on float32 data against LAPACK on the densified V: the start
    errors ||V - W H|| within 1e-3 relative."""
    dense = _ratings(seed=4)
    _, tsp = _containers(dense)
    V = dense.astype(np.float64)
    errs = []
    for X in (tsp, dense):
        W, H = TN.nndsvd_init(X, 8, variant=variant, seed=5)
        errs.append(np.linalg.norm(V - W @ H))
    np.testing.assert_allclose(errs[0], errs[1], rtol=1e-3)


def _failing_svds(fail, real=spla.svds):
    """svds that raises `fail` for its first len(fail) calls."""
    calls = []

    def svds(X, k, v0):
        calls.append(v0)
        if len(calls) <= len(fail):
            raise fail[len(calls) - 1]
        return real(X, k=k, v0=v0)

    return svds, calls


def test_an_arpack_failure_moves_to_the_next_start(monkeypatch):
    dense = _ratings(seed=6, dtype=np.float64)
    want = TN._truncated_svd(sps.csr_matrix(dense), 6)
    svds, calls = _failing_svds([spla.ArpackNoConvergence("x", [], []),
                                 spla.ArpackError(-9999)])
    monkeypatch.setattr(spla, "svds", svds)
    got = TN._truncated_svd(sps.csr_matrix(dense), 6)
    assert len(calls) == 3
    np.testing.assert_array_equal(calls[1],
                                  np.random.default_rng(0).standard_normal(
                                      150))
    np.testing.assert_allclose(got[1], want[1], rtol=1e-10)


def test_only_arpack_failures_are_caught(monkeypatch):
    """nmftpu catches every Exception around svds (and densifies a small
    V); the port lets any other error through."""
    svds, _ = _failing_svds([ValueError("bad k")])
    monkeypatch.setattr(spla, "svds", svds)
    with pytest.raises(ValueError, match="bad k"):
        TN._truncated_svd(sps.csr_matrix(_ratings(seed=7)), 6)


def test_every_start_failing_densifies_a_small_v(monkeypatch):
    dense = _ratings(seed=8, dtype=np.float64)
    svds, calls = _failing_svds([spla.ArpackError(-9999)] * 3)
    monkeypatch.setattr(spla, "svds", svds)
    _, S, _ = TN._truncated_svd(sps.csr_matrix(dense), 6)
    assert len(calls) == 3
    np.testing.assert_allclose(S, np.linalg.svd(dense, compute_uv=False)[:6],
                               rtol=1e-10)


def test_every_start_failing_refuses_to_densify_a_large_v(monkeypatch):
    X = sps.random(10_000, 6_000, density=1e-5, format="csr",
                   random_state=0)
    svds, _ = _failing_svds([spla.ArpackError(-9999)] * 3)
    monkeypatch.setattr(spla, "svds", svds)
    with pytest.raises(RuntimeError, match="too large to densify"):
        TN._truncated_svd(X, 4)


@pytest.mark.parametrize("init", NNDSVDS, ids=lambda i: i.value)
def test_nndsvd_inits_through_sparse_initialize_factors(init):
    """The host CSR of the device COO (padding stripped), the nndsvdar
    seed drawn from the run's generator as the dense init draws it."""
    dense = _ratings(seed=9)
    _, tc = _coos(dense, np.float32)
    W, H = TS.sparse_initialize_factors(tc, 6, init, run_generator(4, 0,
                                                                   "cpu"))
    seed = int(torch.randint(0, 2**31 - 1, (),
                             generator=run_generator(4, 0, "cpu")))
    Wn, Hn = TN.nndsvd_init(sps.csr_matrix(dense), 6, variant=init.value,
                            seed=seed)
    assert W.dtype == torch.float32 and (W >= 0).all() and (H >= 0).all()
    np.testing.assert_array_equal(W.numpy(), Wn.astype(np.float32))
    np.testing.assert_array_equal(H.numpy(), Hn.astype(np.float32))


# ---------------------------------------------------------------------------
# every init through nmf, on every engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["scatter", "ell", "densified"])
@pytest.mark.parametrize("init", ["kmeans_random", "kmeans_nonnegative_wtv",
                                  "kmeans_absolute_wtv", "nndsvd", "nndsvda",
                                  "nndsvdar"])
def test_every_init_runs_on_every_engine(init, strategy):
    """The start is the same on every engine (the init runs on the
    plan's COO); ten iterations lower the error."""
    dense = _ratings(seed=10)
    _, tsp = _containers(dense)
    kw = dict(init=init, device="cpu", seed=2)
    ref = nt.nmf(tsp, 6, num_iterations=0, strategy="scatter", **kw)
    start = nt.nmf(tsp, 6, num_iterations=0, strategy=strategy, **kw)
    res = nt.nmf(tsp, 6, num_iterations=10, strategy=strategy, **kw)
    assert torch.equal(start.W, ref.W) and torch.equal(start.H, ref.H)
    assert res.error < start.error
    assert (res.W >= 0).all() and (res.H >= 0).all()
