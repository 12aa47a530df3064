"""HALS in the port against nmftpu on the same numpy inputs: the three
half-sweeps (sequential, blocked, the CUDA kernel's plain twin), the
update with L1/L2, the registry route and the whole slice through
nmftpu_torch.nmf on the ML-100K fixture, plus sklearn's coordinate-descent
step as an independent oracle.

Tolerances: float64 to 1e-10 (the same operations in both packages, up
to summation order); float32 sweeps to 1e-5 of max|W| (float32 sums of
at most r = 37 terms, amplified by the division by the hessian); the
kernel twin against nmftpu's Pallas sweep to 3e-5 * max|W|, the bound
nmftpu's own tests put on that kernel (tests/test_hals.py)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu.kernels import hals_sweep as JH  # noqa: E402
from nmftpu.linalg import dense as JD  # noqa: E402
from nmftpu_torch.algorithms import build_dense_update  # noqa: E402
from nmftpu_torch.kernels import hals_sweep as HS  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_ATOL = 3e-5          # times max|W|, nmftpu's bound for its kernel


def _sweep_inputs(n, r, dtype, seed=0, zero_col=None):
    """XHt (n, r), a positive-definite G (r, r) and W >= 0, as nmftpu's
    own sweep test draws them; `zero_col` zeroes one row and column of G,
    so that column's hessian is 0 and the sweep must skip it."""
    rng = np.random.default_rng(seed)
    XHt = rng.normal(size=(n, r))
    A = rng.normal(size=(r, r))
    G = A @ A.T + np.eye(r)
    if zero_col is not None:
        G[zero_col, :] = 0.0
        G[:, zero_col] = 0.0
    W = np.abs(rng.normal(size=(n, r)))
    return XHt.astype(dtype), G.astype(dtype), W.astype(dtype)


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the half-sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(70, 24), (33, 37), (5, 3)])
def test_sequential_sweep_matches_nmftpu(shape):
    X, G, W = _sweep_inputs(*shape, np.float64)
    want = JD._hals_half_sweep(*_j(X, G, W))
    got = TD._hals_half_sweep(*_t(X, G, W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("block", [1, 8, 16, 24, 7])
@pytest.mark.parametrize("r", [24, 37])
def test_blocked_sweep_matches_nmftpu_float64(block, r):
    """Blocks that divide r and blocks with a shorter tail (r = 37, and
    block 7 or 16 at r = 24)."""
    X, G, W = _sweep_inputs(70, r, np.float64, seed=r + block)
    want = JD._hals_half_sweep_blocked(*_j(X, G, W), block=block)
    got = TD._hals_half_sweep_blocked(*_t(X, G, W), block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)
    # and the blocked sweep is the sequential one in exact arithmetic
    seq = TD._hals_half_sweep(*_t(X, G, W))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("block", [8, 16])
def test_blocked_sweep_matches_nmftpu_float32(block):
    X, G, W = _sweep_inputs(70, 37, np.float32, seed=block)
    want = np.asarray(JD._hals_half_sweep_blocked(*_j(X, G, W), block=block))
    got = TD._hals_half_sweep_blocked(*_t(X, G, W), block=block).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,r,zero_col", [(70, 24, None), (40, 37, 5),
                                          (300, 16, None), (9, 40, 39)])
def test_kernel_twin_matches_nmftpu_kernel(n, r, zero_col):
    """hals_sweep_plain (the CPU route of hals_sweep) against nmftpu's
    Pallas sweep in interpret mode; a zero-hessian column stays as it
    was in both."""
    X, G, W = _sweep_inputs(n, r, np.float32, seed=n + r,
                            zero_col=zero_col)
    want = np.asarray(JH.hals_sweep(*_j(X, G, W), block=16, interpret=True))
    got = HS.hals_sweep(*_t(X, G, W), block=16).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=KERNEL_ATOL * np.abs(want).max())
    if zero_col is not None:
        np.testing.assert_array_equal(got[:, zero_col], W[:, zero_col])


@pytest.mark.parametrize("impl", ["auto", "kernel", "blocked", "seq"])
@pytest.mark.parametrize("r", [8, 24])
def test_hals_half_sweep_impls_match_nmftpu(impl, r):
    X, G, W = _sweep_inputs(50, r, np.float64, seed=3)
    want = JD._hals_half_sweep(*_j(X, G, W))
    if impl == "kernel":      # the kernel route takes float32
        X32, G32, W32 = (a.astype(np.float32) for a in (X, G, W))
        got = TD.hals_half_sweep(*_t(X32, G32, W32), impl=impl).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-4 * np.abs(got).max())
        return
    got = TD.hals_half_sweep(*_t(X, G, W), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


def test_hals_half_sweep_auto_choices(monkeypatch):
    """auto: seq below r = 16, else blocked on CPU tensors (the kernel is
    chosen only for float32 on the card); nmftpu's rule with the card in
    place of the TPU."""
    chosen = []
    for name in ("_hals_half_sweep", "_hals_half_sweep_blocked"):
        real = getattr(TD, name)
        monkeypatch.setattr(TD, name, lambda *a, _n=name, _r=real, **k:
                            chosen.append(_n) or _r(*a, **k))
    for r, dtype in ((8, np.float32), (16, np.float32), (20, np.float64)):
        TD.hals_half_sweep(*_t(*_sweep_inputs(10, r, dtype)))
    assert chosen == ["_hals_half_sweep", "_hals_half_sweep_blocked",
                      "_hals_half_sweep_blocked"]
    with pytest.raises(ValueError, match="impl"):
        TD.hals_half_sweep(*_t(*_sweep_inputs(10, 4, np.float32)),
                           impl="pallas")


def test_sweep_does_not_touch_its_inputs():
    X, G, W = _t(*_sweep_inputs(30, 20, np.float32))
    before = W.clone()
    for impl in ("seq", "blocked", "kernel"):
        TD.hals_half_sweep(X, G, W, impl=impl)
    assert torch.equal(W, before)


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------


def _factors(n, m, r, dtype, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.0, 5.0, (n, m)).astype(dtype)
    W = rng.uniform(0.05, 1.0, (n, r)).astype(dtype)
    H = rng.uniform(0.05, 1.0, (r, m)).astype(dtype)
    return V, W, H


@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("reg", [{}, {"l2_w": 0.3, "l2_h": 0.1},
                                 {"l1_w": 0.2, "l1_h": 0.05},
                                 {"l2_w": 0.1, "l1_h": 0.4}])
@pytest.mark.parametrize("r", [6, 20])
def test_hals_update_matches_nmftpu_float64(order, reg, r):
    V, W, H = _factors(60, 45, r, np.float64, seed=r)
    want = JD.hals_update(*_j(V, W, H), order=order, **reg)
    got = TD.hals_update(*_t(V, W, H), order=order, **reg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    assert got[1].is_contiguous()


@pytest.mark.parametrize("order", ["WH", "HW"])
def test_hals_update_matches_nmftpu_float32(order):
    V, W, H = _factors(80, 64, 20, np.float32, seed=1)
    want = JD.hals_update(*_j(V, W, H), order=order, l2_w=0.1, l1_h=0.2)
    got = TD.hals_update(*_t(V, W, H), order=order, l2_w=0.1, l1_h=0.2)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_hals_update_block_one_is_the_sequential_sweep():
    V, W, H = _t(*_factors(30, 25, 18, np.float64, seed=2))
    a = TD.hals_update(V, W, H, block=1)
    b = TD.hals_update(V, W, H, block=16)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.05, 0.02)])
def test_half_step_matches_sklearn_cd(l1, l2):
    """One W half-step against sklearn's _update_coordinate_descent
    (Cython _update_cdnmf_fast, identity permutation) in float64."""
    from sklearn.decomposition._nmf import _update_coordinate_descent

    V, W, H = _factors(40, 30, 5, np.float64, seed=4)
    W_sk = W.copy()
    _update_coordinate_descent(V, W_sk, H.T.copy(), l1, l2, False, None)
    eye = torch.eye(5, dtype=torch.float64)
    Vt, Wt, Ht = _t(V, W, H)
    got = TD.hals_half_sweep(Vt @ Ht.T - l1, Ht @ Ht.T + l2 * eye, Wt)
    np.testing.assert_allclose(got.numpy(), W_sk, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# the slice: nmf(V, r, algorithm="hals")
# ---------------------------------------------------------------------------


def _fixture_matrix():
    rows = np.loadtxt(os.path.join(REPO, "tests", "fixtures",
                                   "ml100k_u.data")).astype(np.int64)
    V = np.zeros((rows[:, 0].max(), rows[:, 1].max()), np.float32)
    V[rows[:, 0] - 1, rows[:, 1] - 1] = rows[:, 2]
    return V


V_FIX = _fixture_matrix()


@pytest.mark.parametrize("rank,knobs", [
    (8, {}),                                   # r < 16: the sequential sweep
    (20, {}),                                  # the blocked sweep
    (20, {"update_order": "HW", "lambda_w": 0.5, "l1_h": 0.1}),
])
def test_slice_matches_nmftpu(rank, knobs):
    """nmf(..., algorithm="hals") on the ML-100K fixture from the same
    W0/H0 in float32: the same iterations and stats rows, errors to 1e-5
    relative; factors to 1e-3 of their max (15 sweeps of float32
    roundoff, amplified by the hessian divisions; measured below 1e-4)."""
    rng = np.random.default_rng(rank)
    W0 = rng.uniform(0.1, 1.0, (V_FIX.shape[0], rank)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (rank, V_FIX.shape[1])).astype(np.float32)
    kw = dict(algorithm="hals", init="copy", W0=W0, H0=H0,
              num_iterations=15, check_interval=5, **knobs)
    j = nmftpu.nmf(V_FIX, rank, **kw)
    t = nt.nmf(V_FIX, rank, device="cpu", **kw)
    assert t.num_iterations == j.num_iterations == 15
    np.testing.assert_array_equal(t.stats.iterations, j.stats.iterations)
    np.testing.assert_allclose(t.stats.errors, j.stats.errors, rtol=1e-5)
    np.testing.assert_allclose(t.error, j.error, rtol=1e-5)
    for a, b in ((t.W, j.W), (t.H, j.H)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-3 * np.abs(b).max())
    assert t.kl_error is None


def test_slice_float64_matches_nmftpu():
    rng = np.random.default_rng(9)
    V = rng.uniform(0.1, 2.0, (40, 30))
    W0 = rng.uniform(0.1, 1.0, (40, 5))
    H0 = rng.uniform(0.1, 1.0, (5, 30))
    kw = dict(algorithm="hals", init="copy", W0=W0, H0=H0,
              num_iterations=25, dtype="float64", eps=0.0)
    j = nmftpu.nmf(V, 5, **kw)
    t = nt.nmf(V, 5, device="cpu", **kw)
    assert t.W.dtype == torch.float64
    np.testing.assert_allclose(t.W.numpy(), np.asarray(j.W), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(t.H.numpy(), np.asarray(j.H), rtol=1e-9,
                               atol=1e-12)


def test_hals_converges_faster_than_mu():
    """HALS's selling point, as nmftpu's tests/test_hals.py holds it:
    lower Frobenius error than MU at an equal small iteration budget."""
    rng = np.random.default_rng(0)
    V = rng.uniform(0.1, 2.0, (40, 30)).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (40, 5)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (5, 30)).astype(np.float32)
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=10,
              check_interval=5, device="cpu")
    e_hals = nt.nmf(V, 5, algorithm="hals", **kw).frobenius_error
    e_mu = nt.nmf(V, 5, **kw).frobenius_error
    assert e_hals <= e_mu * 1.001, (e_hals, e_mu)


def test_registry_routes_hals(monkeypatch):
    called = []
    real = TD.hals_update
    monkeypatch.setattr(TD, "hals_update",
                        lambda *a, **k: called.append(k) or real(*a, **k))
    make_aux, update, effective_h = build_dense_update(nt.NmfConfig(
        rank=2, algorithm="hals", lambda_w=0.1, l1_h=0.2,
        update_order="HW"))
    V = torch.rand(6, 5) + 0.1
    aux = make_aux(V)
    W, H = update(V, aux, torch.rand(6, 2) + 0.1, torch.rand(2, 5) + 0.1)
    assert aux == () and effective_h(aux, H) is H
    assert called[0]["order"] == "HW" and called[0]["l2_w"] == 0.1
    assert called[0]["l1_h"] == 0.2 and called[0]["l2_h"] == 0.0


# ---------------------------------------------------------------------------
# the kernel wrapper on the CPU
# ---------------------------------------------------------------------------


def test_cpu_wrapper_runs_the_twin_and_counts_nothing():
    X, G, W = _t(*_sweep_inputs(20, 18, np.float32))
    before = dict(HS.LAUNCHES)
    assert torch.equal(HS.hals_sweep(X, G, W),
                       HS.hals_sweep_plain(X, G, W))
    assert HS.LAUNCHES == before


@pytest.mark.parametrize("bad,error", [
    ("dtype", TypeError), ("strided", ValueError), ("block", ValueError),
    ("shape", ValueError),
])
def test_cuda_operand_checks(bad, error):
    """The checks a CUDA launch passes first (run here on CPU tensors)."""
    X, G, W = _t(*_sweep_inputs(20, 18, np.float32))
    block = 16
    if bad == "dtype":
        G = G.double()
    elif bad == "strided":
        W = W.T.contiguous().T
    elif bad == "block":
        block = 17
    elif bad == "shape":
        with pytest.raises(error):
            HS._check_shapes(X, G[:3], W)
        return
    with pytest.raises(error):
        HS._check_cuda_operands(X, G, W, block)
    HS._check_cuda_operands(*_t(*_sweep_inputs(20, 18, np.float32)), 16)


# ---------------------------------------------------------------------------
# the kernel's summation order (csrc/hals_sweep.cu), modelled in torch
# ---------------------------------------------------------------------------


def _fma32(a, b, c):
    """float32 fmaf: the exact product plus c, rounded once (through
    float64, which holds a float32 product exactly)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_order_sweep(XHt, G, W, block=16, rows=32):
    """The blocked sweep in the CUDA kernel's order: a block of `rows`
    rows sums each base over KS = 256 / rows slices of the depth (the
    depth quads k // 4 = ks mod KS, each slice's fmaf in increasing k),
    adds the slices in order, then runs the chain as max(fmaf(-grad,
    1/hess, old), 0) with fmaf rank-1 corrections."""
    n, r = W.shape
    ks_count = 256 // rows
    W = W.clone()
    for s in range(0, r, block):
        b = min(block, r - s)
        Gb = G[:, s:s + b]
        partial = []
        for ks in range(ks_count):
            acc = torch.zeros(n, b)
            for k in (k for k in range(r) if (k // 4) % ks_count == ks):
                acc = _fma32(W[:, k:k + 1], Gb[k][None, :], acc)
            partial.append(acc)
        base = partial[0]
        for p in partial[1:]:
            base = base + p
        base = base - XHt[:, s:s + b]
        Gbb = Gb[s:s + b]
        old_cols = W[:, s:s + b].clone()
        for j in range(b):
            old, hess = old_cols[:, j], Gbb[j, j]
            if hess != 0:
                rh = torch.reciprocal(hess)
                new = torch.clamp(_fma32(-base[:, j], rh, old), min=0.0)
            else:
                new = old
            W[:, s + j] = new
            base = _fma32((new - old)[:, None], Gbb[j][None, :], base)
    return W


@pytest.mark.parametrize("rows", [32, 4])
@pytest.mark.parametrize("n,r,zero_col,block", [(70, 24, None, 16),
                                                (40, 37, 5, 16),
                                                (33, 40, 39, 7)])
def test_kernel_order_matches_nmftpu_kernel(rows, n, r, zero_col, block):
    """The CUDA kernel's order of sums (sliced depth, slices added in
    order, fmaf chain by the reciprocal hessian) against nmftpu's Pallas
    sweep in interpret mode,
    at the bound the card holds the kernel to (3e-5 * max|W|), for the
    largest and the smallest row tile (8 and 64 depth slices)."""
    X, G, W = _sweep_inputs(n, r, np.float32, seed=n + r + rows,
                            zero_col=zero_col)
    want = np.asarray(JH.hals_sweep(*_j(X, G, W), block=block,
                                    interpret=True))
    got = _kernel_order_sweep(*_t(X, G, W), block=block, rows=rows).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=KERNEL_ATOL * np.abs(want).max())
    if zero_col is not None:
        np.testing.assert_array_equal(got[:, zero_col], W[:, zero_col])


def test_cuda_operand_checks_refuse_ranks_past_the_kernels():
    W = torch.zeros(4, HS.MAX_RANK + 1)
    with pytest.raises(ValueError, match="rank"):
        HS._check_cuda_operands(W, torch.eye(2), W, 16)
    W = torch.zeros(4, HS.MAX_RANK)
    HS._check_cuda_operands(W, torch.eye(2), W, 16)
