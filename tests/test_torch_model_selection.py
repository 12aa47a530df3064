"""Consensus rank selection in the port (nmftpu_torch.model_selection)
against nmftpu.model_selection on the same numpy inputs, on the CPU.

The restarts' random inits come from different streams in the two
packages, so the consensus matrices are compared through a compute_fn
that starts every restart from the same numpy W0/H0 (seeded by the
restart's seed): C equal exactly (connectivity is a 0/1 label compare of
factors that agree to 1e-4, on rows whose dominant factor is not a near
tie), the metrics to 1e-12 (the same scipy and numpy code). The whole
rank_selection is held to the true rank on block-structured data, as
nmftpu's test holds its own."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmftpu  # noqa: E402
from nmftpu import model_selection as JMS  # noqa: E402
from nmftpu.sparse import from_dense as j_from_dense  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import model_selection as TMS  # noqa: E402
from nmftpu_torch.sparse import from_dense  # noqa: E402


def _block_matrix(seed=31, k_true=3, rows_per=20, m=24, noise=0.02):
    """Clearly k_true-clustered rows: each block loads one factor."""
    rng = np.random.default_rng(seed)
    n = k_true * rows_per
    W = np.zeros((n, k_true), np.float32)
    for b in range(k_true):
        W[b * rows_per:(b + 1) * rows_per, b] = \
            1.0 + rng.random(rows_per).astype(np.float32)
    H = np.abs(rng.normal(size=(k_true, m))).astype(np.float32) + 0.2
    V = W @ H + noise * np.abs(rng.normal(size=(n, m))).astype(np.float32)
    return V.astype(np.float32)


def test_connectivity_matches_nmftpu():
    rng = np.random.default_rng(0)
    for W in (np.array([[2.0, 0.1], [1.5, 0.2], [0.1, 3.0]], np.float32),
              rng.uniform(size=(40, 5)).astype(np.float32),
              np.ones((4, 3), np.float32)):             # ties: first index
        got = TMS.connectivity(torch.tensor(W))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(JMS.connectivity(W)))
        np.testing.assert_array_equal(TMS.connectivity(W).numpy(),
                                      got.numpy())


@pytest.mark.parametrize("C_kind", ["binary", "half", "random", "stable"])
def test_metrics_match_nmftpu(C_kind):
    rng = np.random.default_rng(1)
    n = 30
    if C_kind == "binary":
        lab = rng.integers(0, 3, n)
        C = (lab[:, None] == lab[None, :]).astype(np.float64)
    elif C_kind == "half":
        C = np.full((n, n), 0.5)
    elif C_kind == "stable":
        C = np.ones((n, n))
    else:
        A = rng.uniform(size=(n, n))
        C = (A + A.T) / 2
    np.testing.assert_allclose(TMS.cophenetic_correlation(C),
                               JMS.cophenetic_correlation(C), rtol=1e-12)
    np.testing.assert_allclose(TMS.dispersion(C), JMS.dispersion(C),
                               rtol=1e-12)


def _start(cfg, n, m):
    rng = np.random.default_rng(1000 + cfg.seed)
    return (rng.uniform(0.1, 1.0, (n, cfg.rank)).astype(np.float32),
            rng.uniform(0.1, 1.0, (cfg.rank, m)).astype(np.float32))


@pytest.mark.parametrize("cluster_w,sample", [(True, None), (False, None),
                                              (True, 25)])
def test_consensus_matrix_matches_nmftpu(cluster_w, sample):
    import dataclasses

    V = _block_matrix()
    n, m = V.shape

    def j_fn(v, c):
        W0, H0 = _start(c, n, m)
        return nmftpu.driver.compute(v, dataclasses.replace(
            c, init_method="copy_existing"), W0=W0, H0=H0)

    def t_fn(v, c):
        W0, H0 = _start(c, n, m)
        return nt.compute(v, dataclasses.replace(
            c, init_method="copy_existing"), W0=W0, H0=H0, device="cpu")

    kw = dict(n_runs=4, cluster_w=cluster_w, sample=sample)
    Cj, ej = JMS.consensus_matrix(V, nmftpu.NmfConfig(
        rank=3, num_iterations=60, seed=2), compute_fn=j_fn, **kw)
    Ct, et = TMS.consensus_matrix(V, nt.NmfConfig(
        rank=3, num_iterations=60, seed=2), compute_fn=t_fn, **kw)
    assert isinstance(Ct, np.ndarray) and Ct.dtype == np.float32
    assert Ct.shape == Cj.shape
    np.testing.assert_array_equal(Ct, Cj)
    # the final residuals lie far below ||V|| (an exactly low-rank V), so
    # their float32 difference is held against ||V||_F
    np.testing.assert_allclose(et, ej, rtol=0,
                               atol=1e-4 * np.linalg.norm(V))


def test_rank_selection_finds_true_rank():
    """On 3-block data both packages' consensus is perfect (cophenetic
    and dispersion 1) at ranks 2 and 3, and the port's best_rank is
    Brunet's reading of its own curves (the largest rank within 0.01 of
    the best rho x dispersion; past the true rank that depends on the
    restarts' random streams, which differ between the packages); the
    port's consensus matrices behave (symmetric, unit diagonal, in
    [0, 1]) and its metrics lie in their ranges."""
    V = _block_matrix()
    kw = dict(n_runs=4, num_iterations=150, seed=0)
    want = JMS.rank_selection(V, [2, 3, 4], **kw)
    got = TMS.rank_selection(V, [2, 3, 4], device="cpu", **kw)
    for res in (got, want):
        assert res.cophenetic[:2] == [1.0, 1.0]
        assert res.dispersion[:2] == [1.0, 1.0]
    assert want.best_rank == 3
    score = np.asarray(got.cophenetic) * np.asarray(got.dispersion)
    assert got.best_rank == max(k for k, s in zip(got.ranks, score)
                                if s >= score.max() - 0.01)
    assert got.best_rank >= 3
    assert got.ranks == [2, 3, 4]
    for rho, d in zip(got.cophenetic, got.dispersion):
        assert -1.0 <= rho <= 1.0 and 0.0 <= d <= 1.0
    assert set(got.as_dict()) == {2, 3, 4}
    C, errs = TMS.consensus_matrix(V, nt.NmfConfig(rank=3,
                                                   num_iterations=50),
                                   n_runs=3, device="cpu")
    np.testing.assert_array_equal(C, C.T)
    np.testing.assert_array_equal(np.diag(C), 1.0)
    assert C.min() >= 0.0 and C.max() <= 1.0 and len(errs) == 3


def test_rank_selection_sparse_and_refusals():
    V = _block_matrix(seed=5)
    V[V < 0.6] = 0.0
    got = TMS.rank_selection(from_dense(V), [2, 3], n_runs=3,
                             num_iterations=60, device="cpu",
                             strategy="scatter", sample=30)
    want = JMS.rank_selection(j_from_dense(V), [2, 3], n_runs=3,
                              num_iterations=60, strategy="scatter",
                              sample=30)
    assert len(got.cophenetic) == len(want.cophenetic) == 2
    assert np.isfinite(got.mean_error).all()
    # mesh= is ported (test_torch_surfaces_mesh.py); what is not a
    # DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        TMS.rank_selection(V, [2], n_runs=2, num_iterations=2,
                           mesh=object(), device="cpu")
