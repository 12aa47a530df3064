"""The port's sparse driver against nmftpu on the same numpy inputs: the
scatter-COO primitives, metrics and update rules, sparse initialization,
strategy resolution, what still raises, and nmf on sparse V end to end
through every engine (scatter, ell with and without the kernel module,
densified, auto) under the Frobenius and KL objectives."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ops as JS  # noqa: E402
from nmftpu.config import NmfConfig as JConfig  # noqa: E402
from nmftpu_torch import sparse as ts  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.config import Initialization, NmfConfig  # noqa: E402
from nmftpu_torch.convert import (  # noqa: E402
    config_from_nmftpu,
    result_to_numpy,
    sparse_from_nmftpu,
)
from nmftpu_torch.linalg import dense as TD  # noqa: E402

# float64: the same sums in another order, to roundoff
RTOL_F64 = 1e-10
# one float32 primitive, update or metric: sums of a few hundred
# nonnegative terms in another order, ~sqrt(K) * 2^-24 ~ 1e-6
RTOL_F32 = 1e-5
# KL: a log and a ratio on top of the float32 sums
RTOL_KL = 1e-4
RANK = 6
DTYPES = [np.float32, np.float64]


def _matrix(seed=0, n=257, m=311, density=0.06):
    """Nonnegative n x m at `density` with an empty row (5), an empty
    column (7) and a few long rows, as nmftpu's container and the
    port's, built from the same arrays."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < density,
                     rng.uniform(0.5, 5.0, (n, m)), 0.0).astype(np.float32)
    for row, k in ((3, 40), (11, 17), (200, 70)):
        dense[row, rng.choice(m, k, replace=False)] = rng.uniform(0.5, 5.0, k)
    dense[5, :] = 0.0
    dense[:, 7] = 0.0
    jsp = js.from_dense(dense)
    return dense, jsp, sparse_from_nmftpu(jsp)


def _factors(n, m, r=RANK, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (n, r)).astype(dtype),
            rng.uniform(0.1, 1.0, (r, m)).astype(dtype))


def _coos(dtype=np.float32, chunk=TS.DEFAULT_CHUNK):
    dense, jsp, tsp = _matrix()
    jc = JS.device_put_sparse(jsp, dtype=jnp.dtype(dtype), chunk=chunk)
    tc = TS.device_put_sparse(tsp, dtype=_tdtype(dtype), chunk=chunk,
                              device="cpu")
    return dense, jc, tc


def _tdtype(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _tol(dtype, kl=False):
    if dtype == np.float64:
        return RTOL_F64
    return RTOL_KL if kl else RTOL_F32


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["coo", "csr", "csc"])
def test_sparse_from_nmftpu_keeps_every_field(kind):
    dense, jsp, _ = _matrix()
    jmat = {"coo": jsp, "csr": jsp.to_csr(), "csc": jsp.to_csc()}[kind]
    tmat = sparse_from_nmftpu(jmat)
    assert type(tmat).__name__ == type(jmat).__name__
    assert tmat.shape == jmat.shape and tmat.nnz == jmat.nnz
    np.testing.assert_array_equal(tmat.todense(), dense)
    with pytest.raises(TypeError, match="SparseCOO/CSR/CSC"):
        sparse_from_nmftpu(dense)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [TS.DEFAULT_CHUNK, 300, 256])
def test_device_put_sparse_matches_nmftpu(dtype, chunk):
    """Same row-sorted order, chunk size and zero padding."""
    _, jc, tc = _coos(dtype, chunk)
    assert (tc.nnz, tc.chunk, tc.shape, tc.n_chunks) == \
        (jc.nnz, jc.chunk, jc.shape, jc.n_chunks)
    for name in ("values", "rows", "cols"):
        got, want = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_device_put_sparse_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tsp = _matrix()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.device_put_sparse(tsp)


# ---------------------------------------------------------------------------
# scatter primitives and metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [TS.DEFAULT_CHUNK, 256])
def test_primitives_match_nmftpu(dtype, chunk):
    dense, jc, tc = _coos(dtype, chunk)
    W, H = _factors(*dense.shape, dtype=dtype)
    tol = _tol(dtype)
    pairs = [
        (TS.wt_v(tc, torch.tensor(W)), JS.wt_v(jc, jnp.asarray(W))),
        (TS.v_ht(tc, torch.tensor(H)), JS.v_ht(jc, jnp.asarray(H))),
        (TS.sddmm(tc, torch.tensor(W), torch.tensor(H)),
         JS.sddmm(jc, jnp.asarray(W), jnp.asarray(H))),
        (TS.col_sums(tc), JS.col_sums(jc)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        assert got.dtype == _tdtype(dtype)
        assert _rel(got, want) < tol
    # and against the dense products
    assert _rel(pairs[0][0], W.T.astype(np.float64) @ dense) < tol * 10
    assert _rel(pairs[1][0], dense.astype(np.float64) @ H.T) < tol * 10


@pytest.mark.parametrize("dtype", DTYPES)
def test_project_columns_matches_nmftpu(dtype):
    dense, jc, tc = _coos(dtype)
    A = np.random.default_rng(3).uniform(0, 1, (dense.shape[1], 4))
    A = A.astype(dtype)
    got = TS.project_columns(tc, torch.tensor(A))
    want = JS.project_columns(jc, jnp.asarray(A))
    assert got.shape == (dense.shape[0], 4)
    assert _rel(got, want) < _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("given_svsq", [False, True])
def test_frobenius_error_matches_nmftpu(dtype, given_svsq):
    dense, jc, tc = _coos(dtype)
    W, H = _factors(*dense.shape, dtype=dtype)
    svsq_t, svsq_j = TS._sum_v_sq(tc), jnp.sum(jnp.square(jc.values))
    got = TS.frobenius_error(tc, torch.tensor(W), torch.tensor(H),
                             svsq_t if given_svsq else None)
    want = JS.frobenius_error(jc, jnp.asarray(W), jnp.asarray(H),
                              svsq_j if given_svsq else None)
    np.testing.assert_allclose(float(got), float(want), rtol=_tol(dtype))
    np.testing.assert_allclose(
        float(got), np.linalg.norm(dense - W.astype(np.float64) @ H),
        rtol=_tol(dtype) * 10)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kl_error_matches_nmftpu(dtype):
    dense, jc, tc = _coos(dtype)
    W, H = _factors(*dense.shape, dtype=dtype)
    got = float(TS.kl_error(tc, torch.tensor(W), torch.tensor(H)))
    want = float(JS.kl_error(jc, jnp.asarray(W), jnp.asarray(H)))
    np.testing.assert_allclose(got, want, rtol=_tol(dtype, kl=True))


def test_scatter_accumulates_float32_for_bfloat16():
    """Below float32 the accumulators promote to float32; the result
    comes back in the factors' type."""
    assert TD._acc_dtype(torch.bfloat16) == torch.float32
    assert TD._acc_dtype(torch.float64) == torch.float64
    dense, _, tc = _coos()
    W, _ = _factors(*dense.shape)
    got = TS.wt_v(tc, torch.tensor(W).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("objective", ["frobenius", "kl"])
def test_scatter_update_matches_nmftpu(dtype, order, objective):
    dense, jc, tc = _coos(dtype)
    W, H = _factors(*dense.shape, dtype=dtype)
    t_fn, j_fn = ((TS.mu_update_frobenius_sparse, JS.mu_update_frobenius_sparse)
                  if objective == "frobenius"
                  else (TS.mu_update_kl_sparse, JS.mu_update_kl_sparse))
    tW, tH = t_fn(tc, torch.tensor(W), torch.tensor(H), order=order)
    jW, jH = j_fn(jc, jnp.asarray(W), jnp.asarray(H), order=order)
    tol = _tol(dtype, kl=objective == "kl")
    assert _rel(tW, jW) < tol and _rel(tH, jH) < tol


# ---------------------------------------------------------------------------
# sparse initialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_mean_columns_with_the_same_picks_matches_nmftpu(dtype, monkeypatch):
    """Both packages draw their column picks from their own generators;
    fed the same picks, W = V A is the same."""
    dense, jc, tc = _coos(dtype)
    n, m = dense.shape
    q = int(min(max(5, m // RANK), m))
    picks = np.random.default_rng(9).integers(0, m, (RANK, q))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(picks))
    monkeypatch.setattr(torch, "randint",
                        lambda *a, **k: torch.tensor(picks))
    jW, _ = JS.sparse_initialize_factors(
        jc, RANK, JS.Initialization.MEAN_COLUMNS, jax.random.PRNGKey(0))
    tW, tH = TS.sparse_initialize_factors(
        tc, RANK, Initialization.MEAN_COLUMNS, torch.Generator())
    assert tW.dtype == _tdtype(dtype) and tH.shape == (RANK, m)
    assert _rel(tW, jW) < _tol(dtype)
    A = np.zeros((m, RANK))
    np.add.at(A, (picks.reshape(-1), np.repeat(np.arange(RANK), q)), 1.0 / q)
    assert _rel(tW, dense.astype(np.float64) @ A) < _tol(dtype) * 10


@pytest.mark.parametrize("dtype", DTYPES)
def test_random_init_shape_scale_and_sign(dtype):
    dense, _, tc = _coos(dtype)
    n, m = dense.shape
    W, H = TS.sparse_initialize_factors(
        tc, RANK, Initialization.ALL_RANDOM_VALUES,
        nt.init.run_generator(0, 0, "cpu"))
    assert W.shape == (n, RANK) and H.shape == (RANK, m)
    assert W.dtype == H.dtype == _tdtype(dtype)
    scale = np.sqrt(dense.astype(np.float64).mean() / RANK)
    for X in (W, H):
        x = X.double().numpy()
        assert x.min() >= 1e-4 * scale and x.max() <= (1 + 1e-4) * scale
        # uniform on [1e-4, 1 + 1e-4] * scale: mean 0.5 * scale
        assert abs(x.mean() / scale - 0.5) < 0.05
    W2, _ = TS.sparse_initialize_factors(
        tc, RANK, Initialization.ALL_RANDOM_VALUES,
        nt.init.run_generator(0, 0, "cpu"))
    assert torch.equal(W, W2)


def test_copy_init_copies_and_casts():
    dense, _, tc = _coos(np.float64)
    W0, H0 = _factors(*dense.shape)
    W, H = TS.sparse_initialize_factors(tc, RANK,
                                        Initialization.COPY_EXISTING, None,
                                        W0=W0, H0=H0)
    assert W.dtype == torch.float64 and np.array_equal(W.numpy(), W0)
    W[0, 0] = -1.0
    assert W0[0, 0] != -1.0
    with pytest.raises(ValueError, match="requires both W0 and H0"):
        TS.sparse_initialize_factors(tc, RANK, Initialization.COPY_EXISTING,
                                     None, W0=W0)


@pytest.mark.parametrize("init", [Initialization.NNDSVD,
                                  Initialization.K_MEANS_AND_RANDOM_VALUES])
def test_unported_inits_raise(init):
    """Both inits are ported on sparse V (slice 4b-ii,
    `tests/test_torch_sparse_init.py`): nonnegative factors of the
    requested shapes in V's dtype, NNDSVD equal to nmftpu's (the same
    svds of the same host CSR); with vectorize_runs (slice 5) two
    restarts in lockstep give the sequential restarts' errors (rtol
    1e-5)."""
    dense, jc, tc = _coos()
    W, H = TS.sparse_initialize_factors(tc, RANK, init, torch.Generator())
    assert W.shape == (dense.shape[0], RANK) and H.shape == (RANK,
                                                             dense.shape[1])
    assert W.dtype == H.dtype == torch.float32
    assert (W >= 0).all() and (H >= 0).all()
    if init is Initialization.NNDSVD:
        jW, jH = JS.sparse_initialize_factors(
            jc, RANK, JS.Initialization.NNDSVD, jax.random.PRNGKey(0))
        np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
        np.testing.assert_array_equal(H.numpy(), np.asarray(jH))
    _, _, tsp = _matrix()
    seq = nt.nmf(tsp, RANK, init=init, num_runs=2, device="cpu",
                 num_iterations=1)
    vec = nt.nmf(tsp, RANK, init=init, num_runs=2, vectorize_runs=True,
                 device="cpu", num_iterations=1)
    np.testing.assert_allclose(vec.run_errors, seq.run_errors, rtol=1e-5)
    assert vec.best_run == seq.best_run


# ---------------------------------------------------------------------------
# strategy resolution and what raises
# ---------------------------------------------------------------------------


def _resolution_grid():
    for dtype in ("float32", "float64"):
        for objective, beta in (("frobenius", None), ("kullback-leibler",
                                                       None),
                                ("beta-divergence", 0.5)):
            for algorithm, alpha in (("mu", 0.0), ("hals", 0.0),
                                     ("als", 0.0), ("als", 2.0),
                                     ("mu", 2.0)):
                if objective != "frobenius" and algorithm != "mu":
                    continue
                for v_storage in ("float32", "int8"):
                    if v_storage == "int8" and (
                            dtype == "float64" or algorithm != "mu"
                            or alpha > 0 or objective != "frobenius"):
                        continue
                    for mask in ("none", "observed"):
                        yield dict(dtype=dtype, objective=objective,
                                   beta=beta, algorithm=algorithm,
                                   alpha_confidence=alpha,
                                   v_storage=v_storage, mask=mask)


@pytest.mark.parametrize("nm", [1000, 2**32, 2**34])
def test_resolve_strategy_matches_nmftpu(nm):
    """Every (dtype, objective, algorithm, weighting, storage, mask)
    combination, below and above the densify budget (2^33 bytes), for a
    host container, a DeviceCOO and an explicit strategy."""
    n, m = 1000, nm // 1000
    host = ts.SparseCOO([0], [0], [1.0], (n, m))
    coo = TS.DeviceCOO(values=torch.zeros(256), rows=torch.zeros(256),
                       cols=torch.zeros(256), shape=(n, m), nnz=1,
                       chunk=256)
    checked = 0
    for kw in _resolution_grid():
        try:
            jcfg = JConfig(rank=4, **kw)
        except ValueError:
            continue
        tcfg = config_from_nmftpu(jcfg)
        for V in (host, coo):
            for strategy in ("auto", "ell", "scatter"):
                want = JS._resolve_strategy(
                    V if V is host else JS.DeviceCOO(
                        values=None, rows=None, cols=None, shape=(n, m),
                        nnz=1, chunk=256),
                    jcfg, strategy, n, m)
                got = TS._resolve_strategy(V, tcfg, strategy, n, m)
                assert got == want, (kw, strategy, type(V))
                checked += 1
    assert checked == 126   # 21 valid configurations


def test_densify_budget_reads_the_environment():
    out = subprocess.run(
        [sys.executable, "-c", "import nmftpu_torch.sparse_ops as S; "
         "print(S.DENSIFY_BUDGET_BYTES)"],
        env={**os.environ, "NMFTPU_DENSIFY_BUDGET_BYTES": "12345"},
        capture_output=True, text=True, check=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "12345"
    assert TS.DENSIFY_BUDGET_BYTES == JS.DENSIFY_BUDGET_BYTES


@pytest.mark.parametrize("knobs,match", [
    # confidence weighting, masked completion and int8 densified storage
    # are ported in slice 8 (test_torch_weighted.py, test_torch_masked.py,
    # test_torch_int8_densified.py), the beta divergence on every engine
    # in slice 10 (test_torch_beta_engines.py), every other algorithm and
    # init on sparse V in slices 4b-ii and 4c (test_torch_sparse_
    # algorithms.py, test_torch_ials.py, test_torch_sparse_init.py),
    # vectorize_runs in slice 5 (test_torch_batched.py), sparse V on a
    # mesh in slice 6a (test_torch_parallel.py), the ring engine in slice
    # 6b (test_torch_ring.py); these ids now hold the refusal of a mesh
    # that is not a DeviceMesh
    pytest.param(dict(algorithm="als", alpha_confidence=2.0,
                      vectorize_runs=True, num_runs=2, mesh=object(), strategy="ring"),
                 "DeviceMesh", id="knobs0-confidence weighting"),
    pytest.param(dict(algorithm="als", mask="observed", mesh=object(), strategy="ring"),
                 "DeviceMesh", id="knobs1-masked completion"),
    pytest.param(dict(objective="beta", beta=0.5, init="nndsvd",
                      vectorize_runs=True, num_runs=2, mesh=object(), strategy="ring"),
                 "DeviceMesh", id="knobs2-beta-divergence"),
    pytest.param(dict(v_storage="int8", objective="beta", beta=0.5,
                      init="kmeans_random", mesh=object(), strategy="ring"), "DeviceMesh",
                 id="knobs3-int8"),
    pytest.param(dict(algorithm="hals", vectorize_runs=True, num_runs=2,
                      mesh=object(), strategy="ring"), "DeviceMesh", id="knobs4-hals"),
    pytest.param(dict(algorithm="als", mesh=object(), strategy="ring"), "DeviceMesh",
                 id="knobs5-als"),
    pytest.param(dict(algorithm="nsnmf", vectorize_runs=True, num_runs=2,
                      mesh=object(), strategy="ring"), "DeviceMesh", id="knobs6-nsnmf"),
    pytest.param(dict(algorithm="gdcls", mesh=object(), strategy="ring"), "DeviceMesh",
                 id="knobs7-gdcls"),
])
def test_unported_sparse_configs_raise(knobs, match):
    _, _, tsp = _matrix()
    with pytest.raises(TypeError, match=match):
        nt.nmf(tsp, RANK, device="cpu", num_iterations=2, **knobs)


def test_sparse_driver_rejects_what_nmftpu_rejects():
    _, _, tsp = _matrix()
    with pytest.raises(ValueError, match="jacobi"):
        nt.nmf(tsp, RANK, device="cpu", mu_style="jacobi")
    with pytest.raises(ValueError, match="strategy must be"):
        nt.nmf(tsp, RANK, device="cpu", strategy="pallas")
    with pytest.raises(ValueError, match="exceeds min"):
        nt.nmf(tsp, 400, device="cpu")
    with pytest.raises(ValueError, match="only honored by the 'densified'"):
        nt.nmf(tsp, RANK, device="cpu", strategy="ell",
               v_storage="bfloat16")
    # the ring engine is ported (slice 6b, test_torch_ring.py); what is
    # not a DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        nt.nmf(tsp, RANK, device="cpu", mesh=object(), strategy="ring")
    coo = TS.device_put_sparse(tsp, device="cpu")
    with pytest.raises(ValueError, match="needs a host sparse container"):
        nt.nmf(coo, RANK, strategy="ell")
    with pytest.raises(ValueError, match="config.dtype"):
        nt.nmf(coo, RANK, dtype="float64")


def test_sparse_v_without_a_device_needs_cuda(monkeypatch):
    """A host container with no device= goes to CUDA, and raises here
    rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tsp = _matrix()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.nmf(tsp, RANK, num_iterations=2)


def test_other_sparse_types_point_to_from_scipy():
    sp = pytest.importorskip("scipy.sparse")
    dense, _, _ = _matrix()
    with pytest.raises(TypeError, match="from_scipy"):
        nt.nmf(sp.csr_matrix(dense), RANK, device="cpu")
    # and the conversion it points to runs
    res = nt.nmf(ts.from_scipy(sp.csr_matrix(dense)), RANK, device="cpu",
                 num_iterations=4, check_interval=2, strategy="scatter")
    assert res.W.shape == (dense.shape[0], RANK)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

# 20 float32 MU iterations: per-step reordering differences (~1e-6)
# compound over the run
RTOL_E2E = 1e-4
# densified: both packages contract bf16-rounded operands, and W, H are
# rounded to bf16 afresh in every contraction, so a float32 ulp of
# reordering can flip one factor entry's bf16 rounding (2^-9 = 2e-3
# relative) and the flips compound over the run; the errors, sums over
# all entries, stay within RTOL_E2E
RTOL_E2E_DENSIFIED = 2e-2

E2E_CASES = [
    (s, o, k)
    for s, k in (("ell", {}), ("ell", {"use_pallas": True}),
                 ("densified", {}), ("scatter", {}), ("auto", {}))
    for o in ("frobenius", "kl")
]


@pytest.mark.parametrize("strategy,objective,knobs", E2E_CASES)
def test_nmf_sparse_matches_nmftpu(strategy, objective, knobs):
    """nmf on sparse V, same W0/H0, two runs (best-of-N compares the
    divergence under KL): iterations, convergence, stats rows, best run,
    errors and final factors."""
    dense, jsp, tsp = _matrix()
    W0, H0 = _factors(*dense.shape, seed=4)
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=20,
              check_interval=5, num_runs=2, objective=objective,
              strategy=strategy, **knobs)
    want = result_to_numpy(nmftpu.nmf(jsp, RANK, **kw))
    got_res = nt.nmf(tsp, RANK, device="cpu", **kw)
    got = result_to_numpy(got_res)
    densified = strategy in ("densified", "auto")
    tol = RTOL_E2E_DENSIFIED if densified else RTOL_E2E
    for key in ("num_iterations", "converged", "best_run"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["stats"][:, 0], want["stats"][:, 0])
    np.testing.assert_allclose(got["stats"][:, 1], want["stats"][:, 1],
                               rtol=RTOL_E2E)
    for key in ("error", "frobenius_error", "rmsd"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL_E2E)
    np.testing.assert_allclose(got["run_errors"], want["run_errors"],
                               rtol=RTOL_E2E)
    if objective == "kl":
        np.testing.assert_allclose(got["kl_error"], want["kl_error"],
                                   rtol=RTOL_E2E)
        assert got["run_errors"] == [got["kl_error"]] * 2
    else:
        assert got["kl_error"] is None and want["kl_error"] is None
    assert _rel(got["W"], want["W"]) < tol
    assert _rel(got["H"], want["H"]) < tol
    assert got_res.W.dtype == torch.float32


def test_nmf_sparse_float64_scatter_matches_nmftpu():
    """float64 resolves to the scatter engine in both packages and agrees
    to roundoff."""
    dense, jsp, tsp = _matrix()
    W0, H0 = _factors(*dense.shape, seed=4, dtype=np.float64)
    for objective in ("frobenius", "kl"):
        kw = dict(init="copy", W0=W0, H0=H0, num_iterations=10,
                  check_interval=5, dtype="float64", objective=objective)
        want = result_to_numpy(nmftpu.nmf(jsp, RANK, **kw))
        got = result_to_numpy(nt.nmf(tsp, RANK, device="cpu", **kw))
        assert got["W"].dtype == np.float64
        assert _rel(got["W"], want["W"]) < RTOL_F64
        assert _rel(got["H"], want["H"]) < RTOL_F64
        np.testing.assert_allclose(got["error"], want["error"],
                                   rtol=RTOL_F64)


def test_prepare_sparse_plan_runs_other_configs():
    """One layout, several runs: the plan takes any config of its dtype,
    and its results equal a one-shot compute_sparse."""
    dense, _, tsp = _matrix()
    W0, H0 = _factors(*dense.shape, seed=4)
    cfg = NmfConfig(rank=RANK, init_method=Initialization.COPY_EXISTING,
                    num_iterations=10, check_interval=5)
    plan = nt.prepare_sparse(tsp, cfg, strategy="ell", device="cpu")
    assert plan.strategy == "ell" and plan.shape == dense.shape
    a = plan.run(W0=W0, H0=H0)
    b = nt.compute_sparse(tsp, cfg, W0=W0, H0=H0, strategy="ell",
                          device="cpu")
    assert torch.equal(a.W, b.W) and a.error == b.error
    kl = plan.run(NmfConfig(rank=RANK, objective="kullback-leibler",
                            init_method=Initialization.COPY_EXISTING,
                            num_iterations=10, check_interval=5),
                  W0=W0, H0=H0)
    assert kl.kl_error is not None and np.isfinite(kl.kl_error)
    with pytest.raises(ValueError, match="re-run prepare_sparse"):
        plan.run(NmfConfig(rank=RANK, dtype="float64"))


def test_densified_plan_pads_rows_and_returns_n():
    """The densified layout pads n to the 4096-row panel; the result has
    n rows and the random init runs on the sparse COO."""
    dense, _, tsp = _matrix()
    cfg = NmfConfig(rank=RANK, num_iterations=6, check_interval=3,
                    init_method=Initialization.MEAN_COLUMNS)
    plan = nt.prepare_sparse(tsp, cfg, strategy="auto", device="cpu")
    assert plan.strategy == "densified" and plan.n_pad == 4096
    assert plan.operand.shape == (4096, dense.shape[1])
    assert plan.operand.dtype == torch.bfloat16
    res = plan.run()
    assert res.W.shape == (dense.shape[0], RANK)
    assert bool(torch.isfinite(res.W).all())
    assert res.stats.errors[-1] < res.stats.errors[0]


def test_device_coo_input_runs_on_its_device():
    dense, _, tsp = _matrix()
    coo = TS.device_put_sparse(tsp, device="cpu")
    W0, H0 = _factors(*dense.shape, seed=4)
    res = nt.nmf(coo, RANK, init="copy", W0=W0, H0=H0, num_iterations=6,
                 check_interval=3, strategy="scatter")
    ref = nt.nmf(tsp, RANK, init="copy", W0=W0, H0=H0, num_iterations=6,
                 check_interval=3, strategy="scatter", device="cpu")
    assert res.W.device.type == "cpu"
    assert torch.equal(res.W, ref.W)
    # device= names where the layout lives; a DeviceCOO already there stays
    again = nt.nmf(coo, RANK, init="copy", W0=W0, H0=H0, num_iterations=6,
                   check_interval=3, strategy="scatter", device="cpu")
    assert torch.equal(again.W, ref.W)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ell_error_check_takes_the_update_s_spmm(use_pallas, monkeypatch):
    """With use_pallas=True the Frobenius check's Wᵀ V runs through the
    kernel module as the updates do; without it, the plain gathers."""
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK

    used = []

    def spy(name, fn):
        return lambda *a, **k: used.append(name) or fn(*a, **k)

    monkeypatch.setattr(SE, "wt_v_ell", spy("plain", SE.wt_v_ell))
    monkeypatch.setattr(SEK, "wt_v_ell_pallas",
                        spy("kernel", SEK.wt_v_ell_pallas))
    dense, _, tsp = _matrix()
    W, H = _factors(*dense.shape)
    cfg = NmfConfig(rank=RANK, use_pallas=use_pallas)
    ops = TS._ell_ops_bundle(cfg)
    pair = SE.build_ell_pair(tsp, device="cpu")
    err = ops.frobenius(pair, (), torch.tensor(W), torch.tensor(H),
                        ops.sum_v_sq(pair))
    assert used == ["kernel" if use_pallas else "plain"]
    np.testing.assert_allclose(
        float(err), np.linalg.norm(dense - W.astype(np.float64) @ H),
        rtol=RTOL_F32 * 10)
