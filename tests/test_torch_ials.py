"""iALS (confidence-weighted ALS) and masked completion ALS in the port
against nmftpu on the same numpy inputs: the per-row Gram builders of the
scatter (`_weighted_row_grams`) and ELL (`grams_and_rhs_ell`) engines,
the row solvers (exact and warm-started CG), one step of each engine
against nmftpu and against float64 normal equations solved by LU, the
dense iALS, `nmf` end to end on every engine, and the guards (the Gram
budget, the engines iALS runs on).

Tolerances:
* a Gram or right-hand side: float32 sums of at most a few hundred
  nonnegative terms in another order, RTOL_SUM = 1e-5;
* a float32 row solve: the explicit-inverse batched solve is not
  backward stable (ROADMAP queue 3), so against a float64 LU solve of
  the same equations the port's error is at most twice nmftpu's, or
  within 10 kappa u (u = 2^-24, kappa the largest condition number of
  the rows' systems); the row solvers' CG steps likewise against the
  same steps in float64; 10 kappa u between two float32 solves of the
  port (ELL against scatter) and between the two packages' CG half-steps
  from the same warm start;
* runs of several iterations: the error after each at RTOL_ERR = 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ell as JE  # noqa: E402
from nmftpu import sparse_ops as JS  # noqa: E402
from nmftpu.config import NmfConfig as JConfig  # noqa: E402
from nmftpu.linalg import dense as JD  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.config import NmfConfig  # noqa: E402
from nmftpu_torch.convert import sparse_from_nmftpu  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402

RTOL_SUM = 1e-5
RTOL_ERR = 1e-4
U32 = 2.0 ** -24
RANK, ALPHA = 8, 5.0
LAM = 0.05


def _matrix(seed=0, n=200, m=150, density=0.1):
    """Ratings 1..5 at `density` (about 3,000 nonzeros), an empty row (5)
    and column (7), a few long rows; both packages' containers."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < density,
                     rng.integers(1, 6, (n, m)), 0).astype(np.float32)
    for row, k in ((3, 2 * m // 5), (3 * n // 4, 3 * m // 5)):
        dense[row, rng.choice(m, k, replace=False)] = rng.integers(1, 6, k)
    dense[5, :] = 0.0
    dense[:, 7] = 0.0
    jsp = js.from_dense(dense)
    return dense, jsp, sparse_from_nmftpu(jsp)


def _factors(n, m, r=RANK, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (n, r)).astype(np.float32),
            rng.uniform(0.1, 1.0, (r, m)).astype(np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _coos(dense, jsp, tsp, chunk=TS.DEFAULT_CHUNK):
    return (JS.device_put_sparse(jsp, chunk=chunk),
            TS.device_put_sparse(tsp, chunk=chunk, device="cpu"))


def _exact_half(dense, P, alpha, lam, masked, eps=1e-9):
    """One half-step's per-row normal equations in float64 from the dense
    V (n, m) and the partner P (r, m), solved by LU and clamped, with the
    float32 path's ridge (shift + eps + max(eps, 100 u32 2) mean diag):
    returns (solutions (n, r), the largest kappa)."""
    V = dense.astype(np.float64)
    P = P.astype(np.float64)
    if masked:
        C = (V != 0).astype(np.float64)
        A = np.einsum("rm,um,sm->urs", P, C, P)
        rhs = (C * V) @ P.T
    else:
        C = 1.0 + alpha * V
        A = np.einsum("rm,um,sm->urs", P, C, P)
        rhs = (C * V) @ P.T
    r = P.shape[0]
    diag = np.trace(A, axis1=1, axis2=2)[:, None, None] / r
    A = A + (lam + eps + max(eps, 100 * np.finfo(np.float32).eps) * diag
             ) * np.eye(r)
    x = np.linalg.solve(A, rhs[..., None])[..., 0]
    return np.maximum(x, 0.0), float(np.linalg.cond(A).max())


def _check_solve(got, ref, exact, kappa):
    err, ref_err = _rel(got, exact), _rel(ref, exact)
    assert err <= max(2 * ref_err, 10 * kappa * U32), (err, ref_err, kappa)


# ---------------------------------------------------------------------------
# the Gram builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("by_cols", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("weight", ["alpha", "indicator"])
@pytest.mark.parametrize("chunk,sub", [(TS.DEFAULT_CHUNK, 4096),
                                       (1024, 300)],
                         ids=["one-chunk", "tail-slices"])
def test_weighted_row_grams_match(chunk, sub, weight, by_cols):
    """sub = 300 does not divide the 1024-nonzero chunks: each chunk's
    tail slice must be summed too."""
    dense, jsp, tsp = _matrix()
    jc, tc = _coos(dense, jsp, tsp, chunk=chunk)
    W, H = _factors(*dense.shape)
    T = W if by_cols else H.T
    rows = dense.shape[1] if by_cols else dense.shape[0]
    if weight == "indicator":
        kw = dict(weight_fn=lambda v: v != 0)
    else:
        kw = {}
    want = JS._weighted_row_grams(jc, jnp.asarray(T), ALPHA, rows,
                                  by_cols=by_cols, sub=sub, **kw)
    got = TS._weighted_row_grams(tc, torch.tensor(T), ALPHA, rows,
                                 by_cols=by_cols, sub=sub, **kw)
    assert got.dtype == torch.float32 and got.shape == (rows, RANK, RANK)
    assert _rel(got, want) <= RTOL_SUM
    # the sums themselves, from the dense V
    V = dense.T if by_cols else dense
    Wt = (V != 0) if weight == "indicator" else ALPHA * V
    exact = np.einsum("uk,kr,kq->urq", Wt.astype(np.float64),
                      T.astype(np.float64), T.astype(np.float64))
    assert _rel(got, exact) <= RTOL_SUM


@pytest.mark.parametrize("side", ["rows", "cols"])
@pytest.mark.parametrize("chunk", [1024, 7])
def test_grams_and_rhs_ell_match(side, chunk):
    """chunk = 7 segments: every bucket in several blocks, each block's
    segments added as they are made."""
    dense, jsp, tsp = _matrix(seed=2)
    jp = JE.build_ell_pair(jsp)
    tp = TE.build_ell_pair(tsp, device="cpu")
    W, H = _factors(*dense.shape, seed=3)
    T = H.T if side == "rows" else W

    def w_fn(v):
        return ALPHA * v

    def cv_fn(v):
        return v * (1.0 + ALPHA * v)

    jg, jr = JE.grams_and_rhs_ell(getattr(jp, side), jnp.asarray(T), w_fn,
                                  cv_fn)
    tg, tr = TE.grams_and_rhs_ell(getattr(tp, side), torch.tensor(T), w_fn,
                                  cv_fn, chunk=chunk)
    assert tg.dtype == tr.dtype == torch.float32
    assert _rel(tg, jg) <= RTOL_SUM and _rel(tr, jr) <= RTOL_SUM


def test_ell_and_scatter_grams_agree():
    dense, _, tsp = _matrix(seed=4)
    tc = TS.device_put_sparse(tsp, device="cpu")
    tp = TE.build_ell_pair(tsp, device="cpu")
    _, H = _factors(*dense.shape, seed=5)
    Ht = torch.tensor(H.T)
    g_ell, _ = TE.grams_and_rhs_ell(tp.rows, Ht, lambda v: ALPHA * v,
                                    lambda v: v)
    g_sc = TS._weighted_row_grams(tc, Ht, ALPHA, dense.shape[0])
    assert _rel(g_ell, g_sc) <= RTOL_SUM


# ---------------------------------------------------------------------------
# the row solvers
# ---------------------------------------------------------------------------


def _systems(seed=6, b=40, r=RANK):
    rng = np.random.default_rng(seed)
    P = rng.uniform(0.1, 1.0, (r, 60))
    G = (P @ P.T).astype(np.float32)
    C = ALPHA * (rng.random((b, 60)) < 0.2)
    dG = np.einsum("rm,um,sm->urs", P, C, P).astype(np.float32)
    rhs = rng.uniform(0.0, 5.0, (b, r)).astype(np.float32)
    x0 = rng.uniform(0.0, 1.0, (b, r)).astype(np.float32)
    return G, dG, rhs, x0


@pytest.mark.parametrize("base", [True, False], ids=["ials", "masked"])
def test_exact_row_solver_matches(base):
    G, dG, rhs, x0 = _systems()
    Gj = G[None] + dG if base else dG
    want = JS._row_solver("exact", 3)(jnp.asarray(Gj), jnp.asarray(rhs), LAM,
                                      1e-9, jnp.asarray(x0))
    got = TD.row_solver("exact", 3)(torch.tensor(G) if base else None,
                                     torch.tensor(dG), torch.tensor(rhs),
                                     LAM, 1e-9, torch.tensor(x0))
    A = TD._ridged(torch.tensor(Gj).double(), LAM, 1e-9)
    exact = torch.clamp(torch.linalg.solve(A, torch.tensor(rhs).double()),
                        min=0.0)
    _check_solve(got, want, exact, float(torch.linalg.cond(A).max()))


def _cg64(Gb, rhs, shift, x0, steps, eps=1e-9):
    """The warm-started Jacobi-preconditioned CG of
    `_batched_solve_clamped_cg` in float64 numpy, on the float32 path's
    ridged systems, then clamped."""
    Gb = Gb.astype(np.float64)
    r = Gb.shape[-1]
    diag = np.trace(Gb, axis1=1, axis2=2)[:, None, None] / r
    A = Gb + (shift + eps + max(eps, 100 * np.finfo(np.float32).eps)
              * diag) * np.eye(r)
    dinv = 1.0 / np.diagonal(A, axis1=1, axis2=2)
    x = x0.astype(np.float64)
    res = rhs - np.einsum("nij,nj->ni", A, x)
    z = dinv * res
    p = z
    rz = np.sum(res * z, axis=1, keepdims=True)
    for _ in range(steps):
        Ap = np.einsum("nij,nj->ni", A, p)
        denom = np.sum(p * Ap, axis=1, keepdims=True)
        alpha = np.where(denom > 0, rz / np.where(denom > 0, denom, 1), 0)
        x = x + alpha * p
        res = res - alpha * Ap
        z = dinv * res
        rz2 = np.sum(res * z, axis=1, keepdims=True)
        p = z + np.where(rz > 0, rz2 / np.where(rz > 0, rz, 1), 0) * p
        rz = rz2
    return np.maximum(x, 0.0)


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_cg_row_solver_matches(steps):
    """The same warm start, the same number of CG steps. Finite-precision
    CG drifts from its exact-arithmetic iterates by more than kappa u as
    the steps add up, in both packages: against the same steps in
    float64, the port's error is at most twice nmftpu's, or within
    10 kappa u."""
    G, dG, rhs, x0 = _systems(seed=7)
    want = JS._row_solver("cg", steps)(jnp.asarray(G[None] + dG),
                                       jnp.asarray(rhs), LAM, 1e-9,
                                       jnp.asarray(x0))
    got = TD.row_solver("cg", steps)(torch.tensor(G), torch.tensor(dG),
                                      torch.tensor(rhs), LAM, 1e-9,
                                      torch.tensor(x0))
    kappa = float(np.linalg.cond(G[None].astype(np.float64) + dG).max())
    _check_solve(got, want, _cg64(G[None] + dG, rhs, LAM, x0, steps), kappa)


@pytest.mark.parametrize("solver", ["exact", "cg"])
def test_row_solver_panels_change_nothing(monkeypatch, solver):
    """Each row's solve is independent of the panel it falls in."""
    G, dG, rhs, x0 = (torch.tensor(x) for x in _systems(seed=8, b=37))
    whole = TD.row_solver(solver, 3)(G, dG, rhs, LAM, 1e-9, x0)
    monkeypatch.setattr(TD, "ROW_SOLVE_PANEL_BYTES", 5 * RANK * RANK * 4)
    panels = TD.row_solver(solver, 3)(G, dG, rhs, LAM, 1e-9, x0)
    np.testing.assert_allclose(panels.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# one step: against nmftpu and float64 LU
# ---------------------------------------------------------------------------


def _ials_fns(engine, masked, solver, dense, jsp, tsp):
    kw = dict(lambda_w=LAM, lambda_h=2 * LAM, solver=solver)
    if engine == "scatter":
        jc, tc = _coos(dense, jsp, tsp)
        if masked:
            return (lambda W, H, o: JS.als_update_masked_sparse(
                        jc, W, H, order=o, **kw),
                    lambda W, H, o: TS.als_update_masked_sparse(
                        tc, W, H, order=o, **kw))
        return (lambda W, H, o: JS.als_update_weighted_sparse(
                    jc, W, H, ALPHA, order=o, **kw),
                lambda W, H, o: TS.als_update_weighted_sparse(
                    tc, W, H, ALPHA, order=o, **kw))
    jp = JE.build_ell_pair(jsp)
    tp = TE.build_ell_pair(tsp, device="cpu")
    if masked:
        return (lambda W, H, o: JE.als_update_masked_ell(
                    jp, W, H, order=o, **kw),
                lambda W, H, o: TE.als_update_masked_ell(
                    tp, W, H, order=o, **kw))
    return (lambda W, H, o: JE.als_update_weighted_ell_exact(
                jp, W, H, ALPHA, order=o, **kw),
            lambda W, H, o: TE.als_update_weighted_ell_exact(
                tp, W, H, ALPHA, order=o, **kw))


@pytest.mark.parametrize("engine", ["scatter", "ell"])
@pytest.mark.parametrize("masked", [False, True], ids=["ials", "masked"])
def test_one_exact_step_against_float64(engine, masked):
    """Each half from the same (W0, H0): W by order "WH", H by "HW"."""
    dense, jsp, tsp = _matrix(seed=9)
    W, H = _factors(*dense.shape, seed=10)
    jfn, tfn = _ials_fns(engine, masked, "exact", dense, jsp, tsp)
    Wt, Ht = torch.tensor(W), torch.tensor(H)
    got_w = tfn(Wt, Ht, "WH")[0]
    got_h = tfn(Wt, Ht, "HW")[1]
    want_w = jfn(jnp.asarray(W), jnp.asarray(H), "WH")[0]
    want_h = jfn(jnp.asarray(W), jnp.asarray(H), "HW")[1]
    ex_w, k_w = _exact_half(dense, H, ALPHA, LAM, masked)
    ex_h, k_h = _exact_half(dense.T, W.T, ALPHA, 2 * LAM, masked)
    _check_solve(got_w, want_w, ex_w, k_w)
    _check_solve(got_h.T, np.asarray(want_h).T, ex_h, k_h)
    assert (got_w >= 0).all() and (got_h >= 0).all()
    assert got_h.shape == H.shape and got_h.is_contiguous()


@pytest.mark.parametrize("engine", ["scatter", "ell"])
@pytest.mark.parametrize("masked", [False, True], ids=["ials", "masked"])
def test_one_cg_step_matches(engine, masked):
    """cg against cg from the same warm start (the factors themselves)."""
    dense, jsp, tsp = _matrix(seed=11)
    W, H = _factors(*dense.shape, seed=12)
    jfn, tfn = _ials_fns(engine, masked, "cg", dense, jsp, tsp)
    got_w = tfn(torch.tensor(W), torch.tensor(H), "WH")[0]
    want_w = jfn(jnp.asarray(W), jnp.asarray(H), "WH")[0]
    _, kappa = _exact_half(dense, H, ALPHA, LAM, masked)
    assert _rel(got_w, want_w) <= 10 * kappa * U32


@pytest.mark.parametrize("masked", [False, True], ids=["ials", "masked"])
@pytest.mark.parametrize("solver", ["exact", "cg"])
def test_ell_and_scatter_steps_agree(solver, masked):
    dense, jsp, tsp = _matrix(seed=13)
    W, H = (torch.tensor(x) for x in _factors(*dense.shape, seed=14))
    _, scatter = _ials_fns("scatter", masked, solver, dense, jsp, tsp)
    _, ell = _ials_fns("ell", masked, solver, dense, jsp, tsp)
    _, kappa = _exact_half(dense, H.numpy(), ALPHA, LAM, masked)
    assert _rel(ell(W, H, "WH")[0], scatter(W, H, "WH")[0]) \
        <= 10 * kappa * U32


# ---------------------------------------------------------------------------
# dense iALS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["WH", "HW"])
def test_dense_ials_step_matches(order):
    dense, _, _ = _matrix(seed=15)
    W, H = _factors(*dense.shape, seed=16)
    kw = dict(lambda_w=LAM, lambda_h=2 * LAM, order=order)
    want = JD.als_update_weighted(jnp.asarray(dense), jnp.asarray(W),
                                  jnp.asarray(H), ALPHA, **kw)
    got = TD.als_update_weighted(torch.tensor(dense), torch.tensor(W),
                                 torch.tensor(H), ALPHA, **kw)
    idx, lam = (0, LAM) if order == "WH" else (1, 2 * LAM)
    if idx == 0:
        exact, kappa = _exact_half(dense, H, ALPHA, lam, False)
        _check_solve(got[0], want[0], exact, kappa)
    else:
        exact, kappa = _exact_half(dense.T, W.T, ALPHA, lam, False)
        _check_solve(got[1].T, np.asarray(want[1]).T, exact, kappa)


def test_dense_ials_subpanels_change_nothing(monkeypatch):
    """Panels of 7 rows and Gram sub-panels of 3 rows give the same
    step as one panel."""
    dense, _, _ = _matrix(seed=17, n=60, m=45, density=0.3)
    W, H = (torch.tensor(x) for x in _factors(60, 45, seed=18))
    V = torch.tensor(dense)
    whole = TD.als_update_weighted(V, W, H, ALPHA, lambda_w=LAM)
    monkeypatch.setattr(TD, "WEIGHTED_GRAM_SUBPANEL_BYTES",
                        3 * RANK * 60 * 4)
    parts = TD.als_update_weighted(V, W, H, ALPHA, lambda_w=LAM, block=7)
    for a, b in zip(parts, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_dense_ials_through_nmf_matches():
    """The registry's route: ALS with alpha_confidence > 0 on dense V."""
    dense, _, _ = _matrix(seed=19)
    W0, H0 = _factors(*dense.shape, seed=20)
    kw = dict(algorithm="als", alpha_confidence=ALPHA, lambda_w=LAM,
              init="copy", W0=W0, H0=H0, num_iterations=4, check_interval=1)
    jr = nmftpu.nmf(dense, RANK, **kw)
    tr = nt.nmf(dense, RANK, device="cpu", **kw)
    np.testing.assert_allclose(tr.stats.errors, np.asarray(jr.stats.errors),
                               rtol=RTOL_ERR)
    assert tr.stats.errors[-1] < tr.stats.errors[0]


# ---------------------------------------------------------------------------
# nmf end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["ell", "scatter", "auto"])
@pytest.mark.parametrize("knobs", [
    dict(alpha_confidence=ALPHA),
    dict(alpha_confidence=ALPHA, als_solver="cg", cg_steps=3),
    dict(alpha_confidence=ALPHA, update_order="HW", lambda_h=LAM),
    dict(mask="observed", lambda_w=LAM, lambda_h=LAM),
    dict(mask="observed", als_solver="cg", lambda_w=LAM, lambda_h=LAM),
], ids=["ials", "ials-cg", "ials-hw", "masked", "masked-cg"])
def test_nmf_matches(knobs, strategy):
    """Every row of the masked runs has at least 2r observations, so no
    row's system is near singular."""
    dense, jsp, tsp = (_matrix(seed=21, n=120, m=90, density=0.35)
                       if "mask" in knobs else _matrix(seed=22))
    W0, H0 = _factors(*dense.shape, seed=23)
    kw = dict(algorithm="als", init="copy", W0=W0, H0=H0, num_iterations=4,
              check_interval=1, strategy=strategy, **knobs)
    jr = nmftpu.nmf(jsp, RANK, **kw)
    tr = nt.nmf(tsp, RANK, device="cpu", **kw)
    np.testing.assert_allclose(tr.stats.errors, np.asarray(jr.stats.errors),
                               rtol=RTOL_ERR)
    np.testing.assert_allclose(tr.rmsd, jr.rmsd, rtol=RTOL_ERR)
    assert (tr.W >= 0).all() and (tr.H >= 0).all()


def test_auto_sends_ials_to_ell_and_float64_to_scatter():
    _, jsp, tsp = _matrix()
    for dtype, want in (("float32", "ell"), ("float64", "scatter")):
        kw = dict(rank=RANK, algorithm="als", alpha_confidence=ALPHA,
                  dtype=dtype)
        assert nt.prepare_sparse(tsp, NmfConfig(**kw),
                                 device="cpu").strategy == want
        assert JS.prepare_sparse(jsp, JConfig(**kw)).strategy == want


def test_float64_ials_solves_in_float32_as_nmftpu():
    """nmftpu's iALS builds and solves its Grams in float32 whatever the
    factors' dtype; the float64 factors hold the float32 solve."""
    dense, jsp, tsp = _matrix(seed=24)
    W0, H0 = (x.astype(np.float64) for x in _factors(*dense.shape,
                                                    seed=25))
    kw = dict(algorithm="als", alpha_confidence=ALPHA, init="copy", W0=W0,
              H0=H0, num_iterations=2, check_interval=1, dtype="float64",
              strategy="scatter")
    jr = nmftpu.nmf(jsp, RANK, **kw)
    tr = nt.nmf(tsp, RANK, device="cpu", **kw)
    assert tr.W.dtype == torch.float64
    np.testing.assert_allclose(tr.stats.errors, np.asarray(jr.stats.errors),
                               rtol=RTOL_ERR)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [dict(alpha_confidence=ALPHA),
                                   dict(mask="observed")],
                         ids=["ials", "masked"])
def test_weighted_and_masked_als_refuse_the_densified_engine(knobs):
    _, jsp, tsp = _matrix()
    cfg = dict(rank=RANK, algorithm="als", **knobs)
    with pytest.raises(ValueError) as want:
        JS.prepare_sparse(jsp, JConfig(**cfg), strategy="densified")
    with pytest.raises(ValueError) as got:
        nt.prepare_sparse(tsp, NmfConfig(**cfg), strategy="densified",
                          device="cpu")
    assert str(got.value) == str(want.value)


def test_a_densified_plan_refuses_an_ials_run():
    _, _, tsp = _matrix()
    plan = nt.prepare_sparse(tsp, NmfConfig(rank=RANK, algorithm="als"),
                             strategy="densified", device="cpu")
    assert plan.strategy == "densified"
    with pytest.raises(ValueError, match="'ell' .*or 'scatter'"):
        plan.run(NmfConfig(rank=RANK, algorithm="als",
                           alpha_confidence=ALPHA))


def test_gram_budget_at_config_3():
    """(138,000 + 27,000) x 128^2 x 4 bytes = 10.07 GiB: over the default
    8 GiB, with nmftpu's message; within a 16 GiB budget."""
    with pytest.raises(ValueError) as want:
        JS._check_weighted_gram_budget(138_000, 27_000, 128)
    with pytest.raises(ValueError) as got:
        TS._check_weighted_gram_budget(138_000, 27_000, 128)
    assert str(got.value) == str(want.value)
    assert "10.1 GiB" in str(got.value) and "8.0 GiB budget" in str(
        got.value)


@pytest.mark.parametrize("strategy", ["ell", "scatter"])
@pytest.mark.parametrize("knobs", [dict(alpha_confidence=ALPHA),
                                   dict(mask="observed")],
                         ids=["ials", "masked"])
def test_gram_budget_is_read_at_call_time(monkeypatch, knobs, strategy):
    """NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES set and restored around the
    call, as nmftpu reads it: prepare_sparse and a plan's run refuse a
    need above it."""
    dense, _, tsp = _matrix()
    cfg = NmfConfig(rank=RANK, algorithm="als", **knobs)
    plan = nt.prepare_sparse(tsp, NmfConfig(rank=RANK, algorithm="als"),
                             strategy=strategy, device="cpu")
    monkeypatch.setenv("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", "10")
    with pytest.raises(ValueError, match="NMFTPU_WEIGHTED_GRAM_BUDGET"):
        nt.prepare_sparse(tsp, cfg, strategy=strategy, device="cpu")
    with pytest.raises(ValueError, match="NMFTPU_WEIGHTED_GRAM_BUDGET"):
        plan.run(cfg)
    need = (sum(dense.shape)) * RANK * RANK * 4
    monkeypatch.setenv("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", str(need))
    assert np.isfinite(plan.run(NmfConfig(
        rank=RANK, algorithm="als", num_iterations=1, **knobs)).error)


def _weighted_objective(csr, W, H, alpha):
    """Σ c (v - wh)² over all n·m cells in float64 (c = 1 + alpha v at
    the nonzeros, 1 elsewhere; the zeros' (wh)² by the Gram identity)."""
    W, H = np.asarray(W, np.float64), np.asarray(H, np.float64)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    v = csr.data.astype(np.float64)
    wh = np.einsum("kr,rk->k", W[rows], H[:, csr.indices])
    return float(np.sum(v * v - 2 * v * wh + alpha * v * (v - wh) ** 2)
                 + np.sum((W.T @ W) * (H @ H.T)))


def test_clamped_ials_need_not_descend_from_a_random_start():
    """A witness, not a limit: on implicit-feedback clicks (the power-law
    generator of BASELINE config 3, values 1, alpha 40) from a random
    start, clamped iALS's weighted objective rises at its second
    iteration and ends its first above weighted MU's, in nmftpu as in the
    port (the clamp of each row's unconstrained solve is no descent
    step). chip_smoke.py phase 22 therefore prints config 3's objectives
    beside weighted MU's and holds each step against float64 instead."""
    import nmftpu_torch.data.synthetic as TSyn

    n, m, r = 2760, 540, 32
    sp = TSyn.synthetic_powerlaw_sparse(n, m, 80_000, alpha_user=0.9,
                                        alpha_item=0.9, seed=2)
    sp.data[:] = 1.0
    csr = sp.to_csr()
    jsp = js.SparseCSR(indptr=csr.indptr, indices=csr.indices,
                       data=csr.data, shape=csr.shape)
    tsp = sparse_from_nmftpu(jsp)
    rng = np.random.default_rng(5)
    scale = (csr.nnz / (n * m) / r) ** 0.5
    W0 = ((rng.random((n, r)) + 1e-4) * scale).astype(np.float32)
    H0 = ((rng.random((r, m)) + 1e-4) * scale).astype(np.float32)
    objs = {}
    for pkg, alg in (("nmftpu", "als"), ("port", "als"), ("port", "mu")):
        W, H = W0, H0
        objs[pkg, alg] = [_weighted_objective(csr, W, H, 40.0)]
        for _ in range(2):
            kw = dict(algorithm=alg, alpha_confidence=40.0, init="copy",
                      W0=W, H0=H, num_iterations=1, strategy="ell")
            res = (nmftpu.nmf(jsp, r, **kw) if pkg == "nmftpu"
                   else nt.nmf(tsp, r, device="cpu", **kw))
            W, H = np.asarray(res.W), np.asarray(res.H)
            objs[pkg, alg].append(_weighted_objective(csr, W, H, 40.0))
    np.testing.assert_allclose(objs["port", "als"], objs["nmftpu", "als"],
                               rtol=RTOL_ERR)
    for pkg in ("nmftpu", "port"):
        o = objs[pkg, "als"]
        assert o[1] < o[0] and o[2] > o[1]
        assert o[1] > 1.01 * objs["port", "mu"][1]


def test_masked_als_need_not_descend_from_a_random_start():
    """A witness, not a limit: on ratings shaped like config 2's (users
    with 20 or more ratings, fewer than r = 64 for many) from the random
    init's scale, one iteration of completion ALS (lambda 0.1) ends with
    an observed-set RMSD above the start's, in nmftpu as in the port
    (clamping an underdetermined row's solve is no descent step).
    chip_smoke.py phase 22 (c) therefore prints the RMSD and holds each
    step against float64."""
    from test_torch_sparse_algorithms import _ratings_like_ml20m

    n, m, r = 3000, 1500, 64
    V = _ratings_like_ml20m(n, m, 40, 0)
    jsp = js.from_dense(V)
    tsp = sparse_from_nmftpu(jsp)
    rng = np.random.default_rng(1)
    scale = (float(V.sum(dtype=np.float64)) / V.size / r) ** 0.5
    W0 = ((rng.random((n, r)) + 1e-4) * scale).astype(np.float32)
    H0 = ((rng.random((r, m)) + 1e-4) * scale).astype(np.float32)
    obs = V != 0
    start = np.sqrt(np.mean((V[obs] - (W0.astype(np.float64) @ H0)[obs])
                            ** 2))
    kw = dict(algorithm="als", mask="observed", lambda_w=0.1, lambda_h=0.1,
              init="copy", W0=W0, H0=H0, num_iterations=1, strategy="ell")
    jr = nmftpu.nmf(jsp, r, **kw)
    tr = nt.nmf(tsp, r, device="cpu", **kw)
    np.testing.assert_allclose(tr.rmsd, jr.rmsd, rtol=RTOL_ERR)
    assert jr.rmsd > start and tr.rmsd > start
