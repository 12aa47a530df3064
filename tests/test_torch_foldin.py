"""Cold-user fold-in in the port (nmftpu_torch.foldin, the least-squares
solvers of nmftpu_torch.linalg.dense, and the Recommender's fold_in* /
recommend_from_history*) against nmftpu's on the same numpy inputs, on
the CPU, where the kernels' wrappers run their plain twins.

Tolerances: float64 solves rtol 1e-10; float32 solves of well-conditioned
systems (κ ≲ 100) rtol 1e-4; fold-ins max|a − b| / max|b| ≤ 1e-4 (float32
sums in another order, compounded over 20 iterations; one Cholesky of
κ ≲ 1e3 at 2⁻²⁴); objectives rtol 1e-4; serving scores rtol 1e-5 with ids
equal except at near-ties."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmftpu import foldin as JF  # noqa: E402
from nmftpu.linalg import dense as JD  # noqa: E402
from nmftpu.serving import Recommender as JRec  # noqa: E402
from nmftpu.sparse import from_dense as j_from_dense  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import foldin as PF  # noqa: E402
from nmftpu_torch.convert import (  # noqa: E402
    prepared_table_from_nmftpu,
    recommender_from_nmftpu,
)
from nmftpu_torch.kernels import dual_numer as DN  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402
from nmftpu_torch.sparse import from_dense  # noqa: E402

FOLD_RTOL = 1e-4
SCORE_RTOL = 1e-5
TABLES = ["float32", "bfloat16", "int8_vector", "int8_scalar"]


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _problem(b=24, m=40, r=5, seed=0, sparsity=0.0):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1.0, (b, m)).astype(np.float32)
    if sparsity:
        V[rng.uniform(size=V.shape) < sparsity] = 0.0
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (b, r)).astype(np.float32)
    return V, H, W0


def _tables(kind, H):
    """(nmftpu table, port table, scale as numpy or None): the same values
    on both sides (the same bf16 roundings, the same int8 bits)."""
    if kind == "float32":
        return H, torch.tensor(H), None
    if kind == "bfloat16":
        return (jnp.asarray(H, jnp.bfloat16),
                torch.tensor(H).to(torch.bfloat16), None)
    if kind == "int8_vector":
        sc = (np.abs(H).max(axis=1) / 127.0).astype(np.float32)
        Hq = np.clip(np.round(H / sc[:, None]), -127, 127).astype(np.int8)
    else:
        sc = np.float32(np.abs(H).max() / 127.0)
        Hq = np.clip(np.round(H / sc), -127, 127).astype(np.int8)
    return Hq, torch.tensor(Hq), sc


def _prepared(kind, H):
    jt, pt, sc = _tables(kind, H)
    return (JF.prepare_table(jt, scale=sc),
            PF.prepare_table(pt, scale=sc, device="cpu"))


# ---------------------------------------------------------------------------
# least-squares solvers
# ---------------------------------------------------------------------------


def _spd(r, seed, batch=None, dtype=np.float64):
    rng = np.random.default_rng(seed)
    shape = (r, r + 3) if batch is None else (batch, r, r + 3)
    X = rng.uniform(0.0, 1.0, shape)
    A = X @ np.swapaxes(X, -1, -2) + np.eye(r)
    return A.astype(dtype)


SOLVE_RTOL = {np.float64: 1e-10, np.float32: 1e-4}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batch", [None, 6])
def test_spd_solve_matches(batch, dtype):
    A = _spd(12, 1, batch, dtype)
    rng = np.random.default_rng(2)
    rhs = rng.uniform(-1, 1, A.shape[:-1] + (9,)).astype(dtype)
    got = TD.spd_solve(torch.tensor(A), torch.tensor(rhs))
    want = (JD.spd_solve(A, rhs) if batch is None
            else jax.vmap(JD.spd_solve)(A, rhs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SOLVE_RTOL[dtype],
                               atol=SOLVE_RTOL[dtype] * 1e-2)


def test_spd_solve_of_an_indefinite_matrix_is_nan():
    """A failed factorization gives NaN, as XLA's Cholesky does, and
    raises nothing (the status is never read on the host)."""
    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    assert torch.isnan(TD.spd_solve(A, torch.ones(2, 1,
                                                  dtype=A.dtype))).all()
    assert np.isnan(np.asarray(JD.spd_solve(A.numpy(), np.ones((2, 1))))
                    ).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("off", [0.0, 0.25])
def test_solve_clamped_and_solve_h_match(off, dtype):
    gram = _spd(10, 3, dtype=dtype)
    rhs = np.random.default_rng(4).uniform(-1, 1, (10, 30)).astype(dtype)
    got = TD.solve_clamped(torch.tensor(gram), torch.tensor(rhs), 0.1, off,
                           1e-9)
    want = JD.solve_clamped(gram, rhs, 0.1, off, 1e-9)
    assert (got >= 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SOLVE_RTOL[dtype], atol=1e-6)
    np.testing.assert_allclose(
        TD._solve_h(torch.tensor(gram), torch.tensor(rhs), 1e-3).numpy(),
        np.asarray(JD._solve_h(gram, rhs, 1e-3)), rtol=SOLVE_RTOL[dtype],
        atol=1e-6)


def _weighted_grams(seed, b, r, m, constant=False, dtype=np.float64):
    rng = np.random.default_rng(seed)
    H = (np.full((r, m), 0.5) if constant
         else rng.uniform(0.05, 1.0, (r, m)))
    C = 1.0 + 40.0 * (rng.random((b, m)) < 0.3)
    Gb = np.einsum("rm,um,sm->urs", H, C, H)
    rhs = rng.uniform(0.0, 5.0, (b, r))
    return Gb.astype(dtype), rhs.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("constant", [False, True],
                         ids=["full-rank", "rank-deficient"])
def test_batched_solve_clamped_matches(constant, dtype):
    """The scale-aware ridge keeps a rank-1 weighted Gram (a constant
    table) finite and nonnegative. Against a float64 LU solve of the same
    ridged systems, the port's error is at most twice nmftpu's, or within
    10 κ u (u the unit roundoff of `dtype`): the explicit inverse
    L^-T L^-1 is not backward stable, and against an arbitrary rhs its
    error passes κ u in both packages."""
    Gb, rhs = _weighted_grams(5, 7, 6, 30, constant, dtype)
    got = TD._batched_solve_clamped(torch.tensor(Gb), torch.tensor(rhs),
                                    1e-3, 1e-9)
    assert torch.isfinite(got).all() and (got >= 0).all()
    want = JD._batched_solve_clamped(Gb, rhs, 1e-3, 1e-9)
    A = TD._ridged(torch.tensor(Gb).double(), 1e-3, 1e-9)
    exact = torch.clamp(torch.linalg.solve(
        A, torch.tensor(rhs).double()), min=0.0)
    kappa = float(torch.linalg.cond(A).max())
    u = float(np.finfo(dtype).eps) / 2
    err, ref_err = _rel(got, exact), _rel(np.asarray(want), exact)
    assert err <= max(2 * ref_err, 10 * kappa * u), (err, ref_err, kappa)
    if dtype == np.float64 and not constant:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("steps", [1, 3, 20])
def test_batched_cg_matches(steps, dtype):
    """Warm-started CG against nmftpu's; after enough steps it reaches the
    Cholesky solution; a row that starts converged stays frozen."""
    Gb, rhs = _weighted_grams(6, 5, 6, 30, dtype=dtype)
    x0 = np.random.default_rng(7).uniform(0, 1, rhs.shape).astype(dtype)
    exact = TD._batched_solve_clamped(torch.tensor(Gb), torch.tensor(rhs),
                                      0.0, 1e-9)
    x0[0] = exact[0].numpy()
    got = TD._batched_solve_clamped_cg(torch.tensor(Gb), torch.tensor(rhs),
                                       0.0, 1e-9, torch.tensor(x0), steps)
    want = JD._batched_solve_clamped_cg(Gb, rhs, 0.0, 1e-9, x0, steps)
    rtol = 1e-8 if dtype == np.float64 else 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=rtol * 1e-2)
    if steps == 20:
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=rtol,
                                   atol=rtol * 1e-2)


# ---------------------------------------------------------------------------
# prepare_table and the int8 Gram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", TABLES)
def test_prepare_table_matches(kind):
    """G and the row sums against nmftpu's, each scale folded in; the
    port keeps the table as stored (Ht is the transposed view)."""
    _, H, _ = _problem(m=300, r=6, seed=1)
    jp, pp = _prepared(kind, H)
    assert pp.shape == jp.shape == (6, 300)
    assert pp.G.dtype == pp.h_sum.dtype == torch.float32
    np.testing.assert_allclose(pp.G.numpy(), np.asarray(jp.G), rtol=1e-6)
    np.testing.assert_allclose(pp.h_sum.numpy(), np.asarray(jp.h_sum),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        pp.Ht.float().numpy(), np.asarray(jp.Ht).astype(np.float32))
    if kind.startswith("int8"):
        np.testing.assert_allclose(pp.scale.numpy(), np.asarray(jp.scale),
                                   rtol=0)
    else:
        assert pp.scale is None and jp.scale is None


def test_prepare_table_panels():
    """The float Gram over 1,000-item panels (a ragged last one) equals
    the one of a single panel."""
    _, H, _ = _problem(m=2500, r=7, seed=2)
    whole = PF.prepare_table(torch.tensor(H).to(torch.bfloat16),
                             device="cpu")
    G, h_sum = PF._float_gram(torch.tensor(H).to(torch.bfloat16), 1000)
    np.testing.assert_allclose(G.numpy(), whole.G.numpy(), rtol=1e-6)
    np.testing.assert_allclose(h_sum.numpy(), whole.h_sum.numpy(),
                               rtol=1e-6)


def test_int8_gram_panels_are_exact(monkeypatch):
    """int8_gram (the plain twin of #6's one-sided entry per panel, added
    in int64) equals the exact integer product, one vht_int8 call per
    panel."""
    rng = np.random.default_rng(3)
    Hq = rng.integers(-127, 128, (9, 1000)).astype(np.int8)
    calls = []
    real = DN.vht_int8
    monkeypatch.setattr(DN, "vht_int8",
                        lambda V, X: calls.append(V.shape) or real(V, X))
    G = PF.int8_gram(torch.tensor(Hq), panel=128)
    exact = Hq.astype(np.int64) @ Hq.T.astype(np.int64)
    assert G.dtype == torch.int64
    np.testing.assert_array_equal(G.numpy(), exact)
    assert len(calls) == 8 and calls[-1] == (9, 1000 - 7 * 128)
    # prepare_table's row sums go over the same panels
    monkeypatch.setattr(PF, "GRAM_PANEL_INT8", 128)
    prep = PF.prepare_table(torch.tensor(Hq), scale=np.float32(1.0))
    np.testing.assert_array_equal(prep.h_sum.numpy(),
                                  Hq.astype(np.int64).sum(axis=1))
    np.testing.assert_array_equal(prep.G.numpy(), exact)


def test_int8_gram_panel_cannot_wrap():
    """The panel width is pinned below the int32 limit of #6's sums: at
    131,072 items of ±127 a sum is 2,114,060,288 < 2³¹, while 133,145
    items (one past the limit) wrap in the kernel's twin, and int8_gram
    still gives their exact Gram."""
    assert PF.GRAM_PANEL_INT8 == 131_072
    assert PF.GRAM_PANEL_INT8 * 127 ** 2 < 2 ** 31
    assert (2 ** 31 - 1) // 127 ** 2 == 133_144
    Hq = torch.full((1, 133_145), 127, dtype=torch.int8)
    exact = 133_145 * 127 ** 2
    assert int(DN.vht_int8(Hq, Hq)) == exact - 2 ** 32
    assert int(PF.int8_gram(Hq)) == exact


def test_prepare_table_refuses_bad_tables():
    with pytest.raises(ValueError, match="scale"):
        PF.prepare_table(torch.zeros((3, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="rank, n_items"):
        PF.prepare_table(torch.zeros(4), device="cpu")


def test_prepared_table_from_nmftpu():
    """convert.prepared_table_from_nmftpu carries nmftpu's arrays as they
    are: the table's bits, G, h_sum and the scale."""
    _, H, _ = _problem(m=64, r=4, seed=4)
    for kind in TABLES:
        jt, _, sc = _tables(kind, H)
        jp = JF.prepare_table(jt, scale=sc)
        pp = prepared_table_from_nmftpu(jp, device="cpu")
        assert pp.Ht.T.is_contiguous() and pp.shape == jp.shape
        np.testing.assert_array_equal(
            pp.Ht.float().numpy(), np.asarray(jp.Ht).astype(np.float32))
        np.testing.assert_array_equal(pp.G.numpy(), np.asarray(jp.G))
        np.testing.assert_array_equal(pp.h_sum.numpy(),
                                      np.asarray(jp.h_sum))


# ---------------------------------------------------------------------------
# transform: algorithm x objective x input x table
# ---------------------------------------------------------------------------


CASES = [
    ("mu", "frobenius", {}),
    ("mu", "kl", {}),
    ("mu", "beta", {"beta": 0.5}),
    ("mu", "beta", {"beta": 0.0}),
    ("mu", "beta", {"beta": 1.5}),
    ("als", "frobenius", {}),
    ("als", "frobenius", {"alpha_confidence": 4.0}),
    ("als", "frobenius", {"lambda_w": 0.1}),
    ("hals", "frobenius", {}),
    ("hals", "frobenius", {"lambda_w": 0.1}),
]


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("algorithm,objective,kw", CASES,
                         ids=[f"{a}-{o}-{k}" for a, o, k in CASES])
def test_transform_matches(algorithm, objective, kw, sparse, kind):
    """Every combination against nmftpu's transform on the same table;
    those nmftpu refuses (dense rows against an int8 table, the beta
    objective on sparse rows) the port refuses with it."""
    V, H, W0 = _problem(sparsity=0.6, seed=5)
    jp, pp = _prepared(kind, H)
    args = dict(algorithm=algorithm, objective=objective, num_iterations=20,
                W0=W0, **kw)
    jdata, pdata = (j_from_dense(V), from_dense(V)) if sparse else (V, V)
    refused = (not sparse and kind.startswith("int8")) or (
        sparse and objective == "beta")
    if refused:
        with pytest.raises(ValueError):
            JF.transform(jdata, jp, **args)
        with pytest.raises(ValueError):
            PF.transform(pdata, pp, **args)
        return
    want = JF.transform(jdata, jp, **args)
    got = PF.transform(pdata, pp, **args)
    assert got.W.shape == (24, 5) and (got.W >= 0).all()
    assert got.num_iterations == want.num_iterations
    assert _rel(got.W, want.W) <= FOLD_RTOL
    np.testing.assert_allclose(got.error, want.error, rtol=FOLD_RTOL)
    np.testing.assert_allclose(got.rmsd, want.rmsd, rtol=FOLD_RTOL)


def test_transform_default_w0_is_nmftpus_draw():
    """Without W0, MU and HALS start from np.random.default_rng(seed)'s
    draw in both packages, so their results agree."""
    V, H, _ = _problem(seed=6)
    for algorithm in ("mu", "hals"):
        want = JF.transform(V, H, algorithm=algorithm, num_iterations=5,
                            seed=3)
        got = PF.transform(V, H, algorithm=algorithm, num_iterations=5,
                           seed=3, device="cpu")
        assert _rel(got.W, want.W) <= FOLD_RTOL


def _sklearn_mu_w(V, H, W0, beta_loss, k):
    """sklearn's transform: k W-only MU steps (update_H=False), with the
    gamma exponent and beta < 1 stabilization of _fit_multiplicative_
    update."""
    from sklearn.decomposition._nmf import _multiplicative_update_w

    W = W0.astype(np.float64).copy()
    H, V = H.astype(np.float64), V.astype(np.float64)
    gamma = TD.beta_gamma(beta_loss)
    H_sum = HHt = XHt = None
    for _ in range(k):
        W, H_sum, HHt, XHt = _multiplicative_update_w(
            V, W, H, beta_loss=beta_loss, l1_reg_W=0, l2_reg_W=0,
            gamma=gamma, H_sum=H_sum, HHt=HHt, XHt=XHt, update_H=False,
        )
        if beta_loss < 1:
            W[W < np.finfo(np.float64).eps] = 0.0
    return W


@pytest.mark.parametrize("beta,objective", [
    (2, "frobenius"), (1, "kl"), (0.5, "beta"), (1.5, "beta")])
def test_mu_matches_sklearn_transform(beta, objective):
    V, H, W0 = _problem(seed=7)
    expected = _sklearn_mu_w(V, H, W0, beta, k=10)
    res = PF.transform(V, H, algorithm="mu", objective=objective,
                       num_iterations=10, W0=W0, beta=float(beta),
                       device="cpu")
    np.testing.assert_allclose(res.W.numpy(), expected, rtol=2e-3,
                               atol=1e-5)


@pytest.mark.parametrize("objective", ["frobenius", "kl"])
def test_sparse_matches_dense(objective):
    V, H, W0 = _problem(sparsity=0.6, seed=8)
    kw = dict(algorithm="mu", objective=objective, num_iterations=15,
              W0=W0, device="cpu")
    dense = PF.transform(V, H, **kw)
    sparse = PF.transform(from_dense(V), H, **kw)
    assert _rel(sparse.W, dense.W.numpy()) <= 2e-4
    np.testing.assert_allclose(sparse.error, dense.error, rtol=1e-3)


def test_als_exact_on_realizable_data():
    """V = W_true H exactly with H of full row rank: the one-shot solve
    recovers W_true, dense or sparse. The exit error of an exact fit is
    the Gram trick's cancellation noise, ‖V‖² − 2⟨V, WH⟩ + ‖WH‖² in
    float32: a few ulps of ‖V‖² under the square root (nmftpu's reads
    0.022 here on sparse rows)."""
    rng = np.random.default_rng(2)
    H = rng.uniform(0.1, 1.0, (4, 32)).astype(np.float32)
    W_true = rng.uniform(0.0, 2.0, (10, 4)).astype(np.float32)
    V = W_true @ H
    noise = np.sqrt(8 * 2.0 ** -24 * float((V.astype(np.float64) ** 2).sum()))
    for data in (V, from_dense(V)):
        res = PF.transform(data, H, algorithm="als", device="cpu")
        np.testing.assert_allclose(res.W.numpy(), W_true, rtol=1e-3,
                                   atol=1e-3)
        assert res.error <= noise, (res.error, noise)


def test_empty_rows_and_batches():
    """A row with no interactions folds in to zeros under ALS and stays
    finite under MU; an empty batch gives (0, r), as in nmftpu."""
    V, H, _ = _problem(b=6, seed=10)
    V[2] = 0.0
    sp = from_dense(V)
    assert np.allclose(PF.transform(sp, H, algorithm="als",
                                    device="cpu").W[2].numpy(), 0.0)
    res = PF.transform(sp, H, algorithm="mu", num_iterations=5,
                       device="cpu")
    assert torch.isfinite(res.W).all()
    empty = PF.transform(np.zeros((0, 40), np.float32), H, device="cpu")
    want = JF.transform(np.zeros((0, 40), np.float32), H)
    assert tuple(empty.W.shape) == want.W.shape == (0, 5)
    assert empty.num_iterations == want.num_iterations == 0


def _coo_past_the_table(sparse_mod, V):
    """V's nonzeros plus one entry at item m, the container still (b, m)."""
    coo = sparse_mod.from_dense(V).to_coo()
    return sparse_mod.SparseCOO(np.append(coo.row, 0),
                                np.append(coo.col, V.shape[1]),
                                np.append(coo.data, 1.0), V.shape)


def _bad_call(case, sparse_mod):
    """(data, table, scale, kwargs) of a call nmftpu's transform refuses,
    its containers from `sparse_mod` (nmftpu's or the port's)."""
    V, H, _ = _problem(b=6, seed=11)
    neg = V.copy()
    neg[0, 0] = -1.0
    Hq = np.ones((5, 40), np.int8)
    sp = sparse_mod.from_dense
    return {
        "algorithm": (V, H, None, dict(algorithm="nope")),
        "als-kl": (V, H, None, dict(algorithm="als", objective="kl")),
        "hals-kl": (V, H, None, dict(algorithm="hals", objective="kl")),
        "mu-alpha": (V, H, None, dict(algorithm="mu",
                                      alpha_confidence=1.0)),
        "objective": (V, H, None, dict(objective="bogus")),
        "beta-needs-value": (V, H, None, dict(objective="beta")),
        "sparse-beta": (sp(V), H, None, dict(objective="beta", beta=0.5)),
        "width": (V[:, :-1], H, None, dict()),
        "sparse-width": (sp(V[:, :-1]), H, None, dict()),
        "W0-shape": (V, H, None, dict(W0=np.zeros((2, 2)))),
        "W0-negative": (V, H, None, dict(W0=-np.ones((6, 5)))),
        "negative-dense": (neg, H, None, dict()),
        "negative-sparse": (sp(neg), H, None, dict()),
        "item-out-of-range": (_coo_past_the_table(sparse_mod, V), H, None,
                              dict()),
        "dense-quantized": (V, Hq, 0.1, dict()),
        "int-table-no-scale": (V, Hq, None, dict()),
    }[case]


BAD_CASES = ["algorithm", "als-kl", "hals-kl", "mu-alpha", "objective",
             "beta-needs-value", "sparse-beta", "width", "sparse-width",
             "W0-shape", "W0-negative", "negative-dense", "negative-sparse",
             "item-out-of-range", "dense-quantized", "int-table-no-scale"]


@pytest.mark.parametrize("case", BAD_CASES)
def test_value_errors_match(case):
    """Every ValueError nmftpu's transform raises, the port raises on the
    same call (a table that prepare_table refuses included)."""
    import nmftpu.sparse as JS

    import nmftpu_torch.sparse as PS

    jd, H, sc, kw = _bad_call(case, JS)
    with pytest.raises(ValueError):
        JF.transform(jd, JF.prepare_table(H, scale=sc), **kw)
    pd, H, sc, kw = _bad_call(case, PS)
    with pytest.raises(ValueError):
        PF.transform(pd, PF.prepare_table(torch.tensor(H), scale=sc,
                                          device="cpu"), **kw)


def test_transform_without_cuda_needs_a_device(monkeypatch):
    """An array table goes to CUDA unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V, H, _ = _problem(seed=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PF.transform(V, H)


# ---------------------------------------------------------------------------
# Recommender: fold_in* and recommend_from_history*
# ---------------------------------------------------------------------------


def _factors(seed=0, n=40, m=1000, r=8):
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (n, r)).astype(np.float32)
    mag = np.logspace(0, -2, r).astype(np.float32)[:, None]
    H = (rng.uniform(0.0, 1.0, (r, m)) * mag).astype(np.float32)
    return W, H


def _histories(m, seed, b=7, width=20):
    rng = np.random.default_rng(seed)
    hists = [rng.choice(m, width, replace=False) for _ in range(b - 2)]
    hists.append((rng.choice(m, 3, replace=False),
                  np.array([2.0, 4.5, 1.0], np.float32)))
    hists.append(np.array([m - 1]))
    return hists


def assert_same_rows(s, i, s_ref, i_ref, rtol=SCORE_RTOL):
    """Scores within rtol; ids equal wherever no other score of the row
    ties within rtol (the last slot may tie the next item)."""
    np.testing.assert_allclose(s, s_ref, rtol=rtol, atol=0)
    for row in range(len(s)):
        fin = np.isfinite(s_ref[row])
        for p in np.flatnonzero(fin & (i[row] != i_ref[row])):
            close = np.abs(s_ref[row] - s_ref[row, p]) <= \
                rtol * abs(s_ref[row, p])
            assert close.sum() > 1 or p == fin.sum() - 1, (row, p)


FOLD_KW = [{}, {"alpha_confidence": 40.0}, {"algorithm": "mu"},
           {"algorithm": "mu", "objective": "kl"}, {"algorithm": "hals"}]


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("method", ["exact", "approx", "reservoir"])
def test_recommender_fold_in_matches_nmftpu(method, table_dtype):
    """fold_in_batch (every fold-in rule) and recommend_from_history_batch
    against nmftpu's Recommender over the same tables: no history item is
    returned."""
    W, H = _factors(1)
    jr = JRec(W, H, method=method, table_dtype=table_dtype,
              reservoir_slots=128, block=256)
    pr = recommender_from_nmftpu(jr, device="cpu")
    hists = _histories(1000, 2)
    for kw in FOLD_KW:
        got = pr.fold_in_batch(hists, **kw)
        assert got.shape == (7, 8) and (got >= 0).all()
        assert _rel(got, jr.fold_in_batch(hists, **kw)) <= FOLD_RTOL, kw
    s, i = pr.recommend_from_history_batch(hists, k=10)
    s_ref, i_ref = jr.recommend_from_history_batch(hists, k=10)
    # a bf16 or int8 table's scan rounds the queries to bf16: embeddings
    # that differ by float32 roundoff can round one entry an ulp apart
    rtol = SCORE_RTOL if table_dtype == "float32" else 2.0 ** -8
    assert_same_rows(s, i, s_ref, i_ref, rtol=rtol)
    for u, h in enumerate(hists):
        ids = h[0] if isinstance(h, tuple) else h
        assert not set(np.asarray(ids).tolist()) & set(i[u].tolist())
    s1, i1 = pr.recommend_from_history(hists[0], k=10)
    np.testing.assert_array_equal(i1, i[0])
    s, i = pr.recommend_from_history_batch(hists, k=10,
                                           exclude_history=False,
                                           algorithm="hals")
    s_ref, i_ref = jr.recommend_from_history_batch(
        hists, k=10, exclude_history=False, algorithm="hals")
    assert_same_rows(s, i, s_ref, i_ref, rtol=max(rtol, FOLD_RTOL))


def test_wide_history_takes_the_scatter_lists():
    """A history too wide for the oversampling form (k + S above the
    cap) is excluded by scatter lists, as in nmftpu."""
    W, H = _factors(3, m=3000)
    jr = JRec(W, H, method="approx", block=512)
    pr = recommender_from_nmftpu(jr, device="cpu")
    hist = np.arange(0, 3000, 2)[:600]
    s, i = pr.recommend_from_history(hist, k=10)
    s_ref, i_ref = jr.recommend_from_history(hist, k=10)
    assert_same_rows(s[None], i[None], s_ref[None], i_ref[None])
    assert not set(hist.tolist()) & set(i.tolist())


def test_fold_in_reuses_prepared_table():
    """Repeated fold-ins reuse the cached table invariants (no per-call
    Gram) and stay consistent; a bf16 table against the float32 one."""
    W, H = _factors(4, m=64, r=4)
    rec = nt.Recommender(W, H, table_dtype="bfloat16", device="cpu")
    w1 = rec.fold_in([1, 5, 9])
    prep = rec._prepared
    assert prep is not None
    w2 = rec.fold_in([1, 5, 9])
    assert rec._prepared is prep
    np.testing.assert_array_equal(w1, w2)
    w32 = nt.Recommender(W, H, device="cpu").fold_in([1, 5, 9])
    np.testing.assert_allclose(w1, w32, rtol=5e-2, atol=1e-3)


def test_batched_fold_in_equals_single_and_sorts_histories():
    """fold_in_batch row u equals fold_in of history u; unsorted ids fold
    in as sorted ones do."""
    W, H = _factors(5, m=40, r=4)
    rec = nt.Recommender(W, H, block=8, method="exact", device="cpu")
    hists = [np.array([1, 5, 9]),
             (np.array([2, 30]), np.array([2.0, 4.5], np.float32)),
             np.array([7])]
    Wb = rec.fold_in_batch(hists)
    for u, h in enumerate(hists):
        ids, vals = h if isinstance(h, tuple) else (h, None)
        np.testing.assert_allclose(Wb[u], rec.fold_in(ids, vals),
                                   rtol=1e-5, atol=1e-7)
    a = rec.fold_in(np.array([20, 3, 11]), np.array([1.0, 2.0, 3.0]))
    b = rec.fold_in(np.array([3, 11, 20]), np.array([2.0, 3.0, 1.0]))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_fold_in_rejects_bad_histories():
    W, H = _factors(6, m=20, r=3)
    rec = nt.Recommender(W, H, block=8, method="exact", device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        rec.fold_in([3, 25])
    with pytest.raises(ValueError, match="tuple history"):
        rec.fold_in_batch([(3, 7)])
    with pytest.raises(ValueError, match="values must match"):
        rec.fold_in([1, 2], [1.0])
    assert rec.fold_in_batch([]).shape == (0, 3)
    # a generator is read once, its histories still excluded
    sb, ib = rec.recommend_from_history_batch(
        (h for h in [np.array([1, 9]), np.array([4])]), k=5)
    assert not {1, 9} & set(ib[0].tolist()) and 4 not in ib[1].tolist()


def test_foldin_on_an_unpadded_reservoir_table():
    """nmftpu pads a reservoir table to a multiple of the slots and folds
    in against the unpadded one; the port never pads, and folds in against
    the table as it is: the same embeddings, only real items returned."""
    W, H = _factors(7, m=50, r=4)
    jr = JRec(W, H, method="reservoir", reservoir_slots=128)
    assert np.asarray(jr.H).shape[1] == 128 and jr.n_items == 50
    pr = recommender_from_nmftpu(jr, device="cpu")
    assert tuple(pr.H.shape) == (4, 50)
    w = pr.fold_in([3, 7, 12])
    assert _rel(w, jr.fold_in([3, 7, 12])) <= FOLD_RTOL
    assert _rel(w, JRec(W, H).fold_in([3, 7, 12])) <= FOLD_RTOL
    s, i = pr.recommend_from_history([3, 7, 12], k=5)
    assert (i < 50).all()
    assert pr._prepared.Ht.shape == (50, 4)
