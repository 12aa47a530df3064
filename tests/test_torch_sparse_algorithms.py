"""The ALS family (ALS, ACLS, AHCLS), GDCLS, nsNMF (Frobenius, KL) and
HALS on sparse V in the port against nmftpu on the same numpy inputs:
each new update function of the scatter and ELL engines half by half,
each engine's bundle through `nmf` (scatter, ELL, densified bf16 and
int8, auto), and the guards that keep an algorithm to its engines.

Tolerances (each half-step from the same inputs: order "WH" gives the W
half, order "HW" the H half):
* a float32 MU-type half-step (the GDCLS W step, nsNMF): sums of at most
  a few hundred nonnegative terms in another order, ~sqrt(K) 2^-24;
  RTOL_MU = 1e-5;
* a float32 solve (the ALS family, the GDCLS H step): the right-hand
  side's reordering amplified by the solved matrix's condition number
  kappa, 10 kappa 2^-24 (kappa computed in float64 from the inputs);
* float64: the same sums in another order, RTOL_F64 = 1e-10;
* runs of several iterations: the error after each, RTOL_ERR = 1e-4;
  bf16 ALS-family runs after one iteration only (ROADMAP queue 3: a
  float32 reordering flips bf16 roundings that the clamped solves
  amplify, `test_reference_bf16_clamped_solves_drift`); int8 runs on
  errors at RTOL_INT8 = 1e-3 (each step requantizes the factors);
* HALS: the factors after one iteration at HALS_STEP_RTOL = 1e-4 (the
  hessian division amplifies the SpMM's reordering), the errors after
  more at RTOL_ERR (a later ulp can flip a clamp).
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
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.config import Initialization, NmfConfig  # noqa: E402
from nmftpu_torch.convert import sparse_from_nmftpu  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402

RTOL_MU = 1e-5
RTOL_F64 = 1e-10
RTOL_ERR = 1e-4
RTOL_INT8 = 1e-3
HALS_STEP_RTOL = 1e-4
U32 = 2.0 ** -24
RANK, HALS_RANK = 8, 16

FAMILY = {
    "als": {},
    "acls": {"lambda_w": 0.1, "lambda_h": 0.2},
    "ahcls": {"lambda_w": 0.1, "lambda_h": 0.2, "alpha_w": 0.5,
              "alpha_h": 0.3},
}
ALGORITHMS = [("als", "frobenius", {}),
              ("acls", "frobenius", FAMILY["acls"]),
              ("ahcls", "frobenius", FAMILY["ahcls"]),
              ("gdcls", "frobenius", {"lambda_tik": 0.1}),
              ("nsnmf", "frobenius", {"theta": 0.5}),
              ("nsnmf", "kullback-leibler", {"theta": 0.4})]
IDS = [f"{a}-{o[:3]}" for a, o, _ in ALGORITHMS]


def _matrix(seed=0, n=200, m=150, density=0.1, dtype=np.float32):
    """Ratings 0.5..5 at `density` (about 3,000 nonzeros) with an empty
    row (5), an empty column (7) and a few long rows; nmftpu's container
    and the port's from the same arrays."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < density,
                     rng.uniform(0.5, 5.0, (n, m)), 0.0).astype(dtype)
    for row, k in ((3, 60), (11, 40), (150, 90)):
        dense[row, rng.choice(m, k, replace=False)] = rng.uniform(0.5, 5.0, k)
    dense[5, :] = 0.0
    dense[:, 7] = 0.0
    jsp = js.from_dense(dense)
    return dense, jsp, sparse_from_nmftpu(jsp)


def _factors(n, m, r=RANK, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (n, r)).astype(dtype),
            rng.uniform(0.1, 1.0, (r, m)).astype(dtype))


def _tdtype(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _kappa(gram, shift=0.0, off=0.0, eps=1e-9):
    A = np.asarray(gram, np.float64)
    return float(np.linalg.cond(A + (shift + eps) * np.eye(A.shape[0])
                                + off))


def _shifts(alg, kn, r=RANK):
    if alg == "gdcls":
        return 0.0, kn["lambda_tik"], 0.0, 0.0
    return TD._als_family_shifts(NmfConfig(rank=r, algorithm=alg, **kn))


def _limits(alg, kn, W, H, dtype):
    """(W-half limit, H-half limit) from the same (W, H)."""
    if dtype == np.float64:
        return RTOL_F64, RTOL_F64
    W64, H64 = W.astype(np.float64), H.astype(np.float64)
    sw, sh, ow, oh = _shifts(alg, kn, W.shape[1])
    lw = (10 * _kappa(H64 @ H64.T, sw, ow) * U32
          if alg in FAMILY else RTOL_MU)
    lh = (10 * _kappa(W64.T @ W64, sh, oh) * U32
          if alg in FAMILY or alg == "gdcls" else RTOL_MU)
    return lw, lh


def _halves(jfn, tfn, W, H, dtype):
    """(W, H) first halves of both packages: W from order "WH", H from
    order "HW", each from (W, H)."""
    out = []
    for order, idx in (("WH", 0), ("HW", 1)):
        j = jfn(jnp.asarray(W), jnp.asarray(H), order)[idx]
        t = tfn(torch.tensor(W, dtype=_tdtype(dtype)),
                torch.tensor(H, dtype=_tdtype(dtype)), order)[idx]
        out.append((t.numpy(), np.asarray(j)))
    return out


def _scatter_fns(alg, obj, kn, jc, tc, dtype):
    if alg in FAMILY:
        sw, sh, ow, oh = _shifts(alg, kn)
        kw = dict(shift_w=sw, shift_h=sh, off_w=ow, off_h=oh)
        return (lambda W, H, o: JS.als_family_update_sparse(jc, W, H,
                                                            order=o, **kw),
                lambda W, H, o: TS.als_family_update_sparse(tc, W, H,
                                                            order=o, **kw))
    if alg == "gdcls":
        lt = kn["lambda_tik"]
        return (lambda W, H, o: JS.gdcls_update_sparse(jc, W, H, lt, order=o),
                lambda W, H, o: TS.gdcls_update_sparse(tc, W, H, lt, order=o))
    S = np.asarray(JS.D.nsnmf_smoothing_matrix(RANK, kn["theta"],
                                               dtype=jnp.dtype(dtype)))
    objective = "frobenius" if obj == "frobenius" else "kl"
    return (lambda W, H, o: JS.nsnmf_update_sparse(
                jc, W, H, jnp.asarray(S), objective=objective, order=o),
            lambda W, H, o: TS.nsnmf_update_sparse(
                tc, W, H, torch.tensor(S), objective=objective, order=o))


def _ell_fns(alg, obj, kn, jp, tp):
    if alg in FAMILY:
        sw, sh, ow, oh = _shifts(alg, kn)
        kw = dict(shift_w=sw, shift_h=sh, off_w=ow, off_h=oh)
        return (lambda W, H, o: JE.als_family_update_ell(jp, W, H, order=o,
                                                         **kw),
                lambda W, H, o: TE.als_family_update_ell(tp, W, H, order=o,
                                                         **kw))
    if alg == "gdcls":
        lt = kn["lambda_tik"]
        return (lambda W, H, o: JE.gdcls_update_ell(jp, W, H, lt, order=o),
                lambda W, H, o: TE.gdcls_update_ell(tp, W, H, lt, order=o))
    S = np.asarray(JS.D.nsnmf_smoothing_matrix(RANK, kn["theta"]))
    jf, tf = ((JE.nsnmf_update_ell, TE.nsnmf_update_ell)
              if obj == "frobenius"
              else (JE.nsnmf_update_kl_ell, TE.nsnmf_update_kl_ell))
    return (lambda W, H, o: jf(jp, W, H, jnp.asarray(S), order=o),
            lambda W, H, o: tf(tp, W, H, torch.tensor(S), order=o))


# ---------------------------------------------------------------------------
# the update functions, half by half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("alg,obj,kn", ALGORITHMS, ids=IDS)
def test_scatter_updates_match(alg, obj, kn, dtype):
    dense, jsp, tsp = _matrix(dtype=dtype)
    jc = JS.device_put_sparse(jsp, dtype=jnp.dtype(dtype))
    tc = TS.device_put_sparse(tsp, dtype=_tdtype(dtype), device="cpu")
    W, H = _factors(*dense.shape, dtype=dtype)
    jfn, tfn = _scatter_fns(alg, obj, kn, jc, tc, dtype)
    lw, lh = _limits(alg, kn, W, H, dtype)
    (tw, jw), (th, jh) = _halves(jfn, tfn, W, H, dtype)
    assert _rel(tw, jw) <= lw and _rel(th, jh) <= lh
    assert (tw >= 0).all() and (th >= 0).all()


@pytest.mark.parametrize("alg,obj,kn", ALGORITHMS, ids=IDS)
def test_ell_updates_match(alg, obj, kn):
    dense, jsp, tsp = _matrix(seed=2)
    jp = JE.build_ell_pair(jsp)
    tp = TE.build_ell_pair(tsp, device="cpu")
    W, H = _factors(*dense.shape, seed=3)
    jfn, tfn = _ell_fns(alg, obj, kn, jp, tp)
    lw, lh = _limits(alg, kn, W, H, np.float32)
    (tw, jw), (th, jh) = _halves(jfn, tfn, W, H, np.float32)
    assert _rel(tw, jw) <= lw and _rel(th, jh) <= lh


@pytest.mark.parametrize("alg,obj,kn", ALGORITHMS, ids=IDS)
def test_ell_and_scatter_updates_agree(alg, obj, kn):
    """Within the port: the gather-only and the scatter engine compute
    the same half-steps."""
    dense, _, tsp = _matrix(seed=4)
    tc = TS.device_put_sparse(tsp, device="cpu")
    tp = TE.build_ell_pair(tsp, device="cpu")
    W, H = _factors(*dense.shape, seed=5)
    _, ell = _ell_fns(alg, obj, kn, None, tp)
    _, scatter = _scatter_fns(alg, obj, kn, None, tc, np.float32)
    lw, lh = _limits(alg, kn, W, H, np.float32)
    Wt, Ht = torch.tensor(W), torch.tensor(H)
    assert _rel(ell(Wt, Ht, "WH")[0], scatter(Wt, Ht, "WH")[0]) <= lw
    assert _rel(ell(Wt, Ht, "HW")[1], scatter(Wt, Ht, "HW")[1]) <= lh


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("regularized", [False, True])
def test_hals_update_sparse_matches(regularized, dtype):
    """r = 16: the blocked sweep (both packages' choice on the CPU)."""
    dense, jsp, tsp = _matrix(seed=6, dtype=dtype)
    jc = JS.device_put_sparse(jsp, dtype=jnp.dtype(dtype))
    tc = TS.device_put_sparse(tsp, dtype=_tdtype(dtype), device="cpu")
    W, H = _factors(*dense.shape, r=HALS_RANK, seed=7, dtype=dtype)
    kw = (dict(l2_w=0.3, l2_h=0.1, l1_w=0.05, l1_h=0.02) if regularized
          else {})
    (tw, jw), (th, jh) = _halves(
        lambda W, H, o: JS.hals_update_sparse(jc, W, H, order=o, **kw),
        lambda W, H, o: TS.hals_update_sparse(tc, W, H, order=o, **kw),
        W, H, dtype)
    limit = RTOL_F64 if dtype == np.float64 else HALS_STEP_RTOL
    assert _rel(tw, jw) <= limit and _rel(th, jh) <= limit
    assert (tw >= 0).all() and (th >= 0).all()


def test_hals_update_sparse_is_the_dense_hals_on_the_densified_v():
    """The sweeps never touch V: sparse HALS is dense HALS on the same
    matrix (float64, the same sums to roundoff)."""
    from nmftpu_torch.linalg import dense as D

    dense, _, tsp = _matrix(seed=8, dtype=np.float64)
    tc = TS.device_put_sparse(tsp, dtype=torch.float64, device="cpu")
    W, H = (torch.tensor(x) for x in _factors(*dense.shape, r=HALS_RANK,
                                              dtype=np.float64))
    got = TS.hals_update_sparse(tc, W, H)
    want = D.hals_update(torch.tensor(dense), W, H)
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL_F64


# ---------------------------------------------------------------------------
# nmf through each engine's bundle
# ---------------------------------------------------------------------------


def _nmf_both(jsp, tsp, W0, H0, iters, **kw):
    common = dict(init="copy", W0=W0, H0=H0, num_iterations=iters,
                  check_interval=1, **kw)
    return nmftpu.nmf(jsp, W0.shape[1], **common), nt.nmf(
        tsp, W0.shape[1], device="cpu", **common)


@pytest.mark.parametrize("strategy", ["scatter", "ell", "densified"])
@pytest.mark.parametrize("alg,obj,kn", ALGORITHMS, ids=IDS)
def test_nmf_on_each_engine_matches(alg, obj, kn, strategy):
    """float32 on scatter and ELL: the errors of 5 iterations; densified
    bf16: the ALS family and GDCLS after one iteration, nsNMF after 5."""
    dense, jsp, tsp = _matrix(seed=9)
    W0, H0 = _factors(*dense.shape, seed=10)
    solves = alg in FAMILY or alg == "gdcls"
    iters = 1 if strategy == "densified" and solves else 5
    jr, tr = _nmf_both(jsp, tsp, W0, H0, iters, algorithm=alg, objective=obj,
                       strategy=strategy, **kn)
    assert tr.num_iterations == jr.num_iterations == iters
    np.testing.assert_allclose(tr.stats.errors, np.asarray(jr.stats.errors),
                               rtol=RTOL_ERR)
    if obj == "kullback-leibler":
        np.testing.assert_allclose(tr.kl_error, jr.kl_error, rtol=RTOL_ERR)
    assert tr.W.shape == (dense.shape[0], RANK)
    assert (tr.W >= 0).all() and (tr.H >= 0).all()


@pytest.mark.parametrize("alg,obj,kn", ALGORITHMS, ids=IDS)
def test_nmf_int8_densified_matches(alg, obj, kn):
    """v_storage="int8": the Frobenius family on the int8 one-sided
    entries (their plain twins here), nsNMF under KL with the scale;
    errors of 4 iterations at RTOL_INT8."""
    dense, jsp, tsp = _matrix(seed=11)
    W0, H0 = _factors(*dense.shape, seed=12)
    jr, tr = _nmf_both(jsp, tsp, W0, H0, 4, algorithm=alg, objective=obj,
                       strategy="densified", v_storage="int8", **kn)
    np.testing.assert_allclose(tr.stats.errors, np.asarray(jr.stats.errors),
                               rtol=RTOL_INT8)
    assert np.isfinite(tr.stats.errors).all()


@pytest.mark.parametrize("alg,obj,kn", ALGORITHMS, ids=IDS)
def test_nmf_float64_scatter_matches(alg, obj, kn):
    dense, jsp, tsp = _matrix(seed=13, dtype=np.float64)
    W0, H0 = _factors(*dense.shape, seed=14, dtype=np.float64)
    jr, tr = _nmf_both(jsp, tsp, W0, H0, 4, algorithm=alg, objective=obj,
                       dtype="float64", **kn)
    assert tr.W.dtype == torch.float64
    np.testing.assert_allclose(tr.stats.errors, np.asarray(jr.stats.errors),
                               rtol=RTOL_F64)
    assert _rel(tr.W, jr.W) <= 1e-9 and _rel(tr.H, jr.H) <= 1e-9


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nmf_hals_on_scatter_matches(dtype):
    """auto sends HALS to scatter; factors after one iteration, errors
    after 6."""
    dense, jsp, tsp = _matrix(seed=15, dtype=dtype)
    W0, H0 = _factors(*dense.shape, r=HALS_RANK, seed=16, dtype=dtype)
    kw = dict(algorithm="hals", lambda_w=0.1, l1_h=0.01,
              dtype=np.dtype(dtype).name)
    jr, tr = _nmf_both(jsp, tsp, W0, H0, 1, **kw)
    limit = RTOL_F64 if dtype == np.float64 else HALS_STEP_RTOL
    assert _rel(tr.W, jr.W) <= limit and _rel(tr.H, jr.H) <= limit
    jr, tr = _nmf_both(jsp, tsp, W0, H0, 6, **kw)
    np.testing.assert_allclose(tr.stats.errors, np.asarray(jr.stats.errors),
                               rtol=RTOL_F64 if dtype == np.float64
                               else RTOL_ERR)
    errs = tr.stats.errors
    assert (np.diff(errs) <= 1e-5 * errs[0]).all()   # HALS descends


def test_nsnmf_reports_the_smoothed_error():
    """nsNMF's result holds the raw H; its error is ||V - W S H|| on
    every engine."""
    from nmftpu_torch.linalg import dense as D

    dense, _, tsp = _matrix(seed=17)
    W0, H0 = _factors(*dense.shape, seed=18)
    S = D.nsnmf_smoothing_matrix(RANK, 0.5)
    for strategy in ("scatter", "ell", "densified"):
        res = nt.nmf(tsp, RANK, algorithm="nsnmf", theta=0.5, init="copy",
                     W0=W0, H0=H0, num_iterations=3, strategy=strategy,
                     device="cpu")
        V = torch.tensor(dense)
        want = float(torch.linalg.norm(V - res.W @ (S @ res.H)))
        np.testing.assert_allclose(res.frobenius_error, want, rtol=1e-3)


@pytest.mark.parametrize("alg", ["als", "gdcls", "nsnmf", "hals"])
def test_auto_picks_nmftpus_engine(alg):
    """auto: densified within the budget, except HALS (scatter); the
    prepared plan says which."""
    _, jsp, tsp = _matrix(seed=19)
    kw = dict(rank=RANK, algorithm=alg)
    jplan = JS.prepare_sparse(jsp, JConfig(**kw))
    tplan = nt.prepare_sparse(tsp, NmfConfig(**kw), device="cpu")
    assert tplan.strategy == jplan.strategy == (
        "scatter" if alg == "hals" else "densified")


def test_a_plan_runs_other_algorithms_of_its_engine():
    """One ELL plan, one scatter plan and one densified plan each run the
    family one config after another, as `SparsePlan.run` takes a new
    config."""
    dense, _, tsp = _matrix(seed=20)
    W0, H0 = _factors(*dense.shape, seed=21)
    for strategy in ("ell", "scatter", "densified"):
        plan = nt.prepare_sparse(tsp, NmfConfig(rank=RANK),
                                 strategy=strategy, device="cpu")
        for alg, obj, kn in ALGORITHMS:
            cfg = nt.NmfConfig(rank=RANK, algorithm=alg, objective=obj,
                               init_method=Initialization.COPY_EXISTING,
                               num_iterations=2, **kn)
            one = plan.run(cfg, W0=W0, H0=H0)
            direct = nt.nmf(tsp, RANK, algorithm=alg, objective=obj,
                            init="copy", W0=W0, H0=H0, num_iterations=2,
                            strategy=strategy, device="cpu", **kn)
            np.testing.assert_allclose(one.stats.errors,
                                       direct.stats.errors, rtol=1e-6)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["ell", "densified"])
def test_hals_runs_on_scatter_only(strategy):
    _, jsp, tsp = _matrix()
    cfg = dict(rank=HALS_RANK, algorithm="hals")
    with pytest.raises(ValueError, match="HALS runs on the 'scatter'"):
        JS.prepare_sparse(jsp, JConfig(**cfg), strategy=strategy)
    with pytest.raises(ValueError, match="HALS runs on the 'scatter'"):
        nt.prepare_sparse(tsp, NmfConfig(**cfg), strategy=strategy,
                          device="cpu")


@pytest.mark.parametrize("strategy", ["ell", "densified"])
def test_a_plan_refuses_a_hals_run_off_scatter(strategy):
    """nmftpu's plan would run a HALS config on such a plan as the
    engine's MU (ELL) or nsNMF (densified) update; the port raises."""
    _, _, tsp = _matrix()
    plan = nt.prepare_sparse(tsp, NmfConfig(rank=HALS_RANK),
                             strategy=strategy, device="cpu")
    with pytest.raises(ValueError, match="HALS runs on the 'scatter'"):
        plan.run(NmfConfig(rank=HALS_RANK, algorithm="hals"))


@pytest.mark.parametrize("strategy", ["scatter", "ell"])
@pytest.mark.parametrize("knobs", [{"v_storage": "bfloat16"},
                                   {"v_storage": "int8"}])
@pytest.mark.parametrize("alg", ["als", "gdcls", "nsnmf"])
def test_v_storage_is_refused_on_ell_and_scatter(alg, knobs, strategy):
    _, _, tsp = _matrix()
    with pytest.raises(ValueError, match="only honored by the 'densified'"):
        nt.nmf(tsp, RANK, algorithm=alg, strategy=strategy, device="cpu",
               num_iterations=1, **knobs)


@pytest.mark.parametrize("alg", ["als", "acls", "gdcls", "nsnmf", "hals"])
def test_cg_solver_is_refused_outside_weighted_and_masked_als(alg):
    for Config in (JConfig, NmfConfig):
        with pytest.raises(ValueError, match="als_solver='cg'"):
            Config(rank=RANK, algorithm=alg, als_solver="cg")


def _ratings_like_ml20m(n, m, per_user, seed):
    """Half-star ratings, lognormal ratings a user (at least 20; ML-20M
    has about 144), items by Zipf-like popularity (exponent 0.9)."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(m, np.maximum(20, (per_user * rng.lognormal(
        0.0, 1.0, n) / np.exp(0.5)).astype(int)))
    pop = 1.0 / np.arange(1, m + 1) ** 0.9
    pop = pop[rng.permutation(m)]
    V = np.zeros((n, m), np.float32)
    for i, c in enumerate(counts):
        keys = np.log(rng.random(m)) / pop
        V[i, np.argpartition(-keys, c - 1)[:c]] = rng.integers(1, 11, c) * 0.5
    return V


@pytest.mark.parametrize("alg,kn", [("als", {}), ("acls", FAMILY["acls"]),
                                    ("ahcls", FAMILY["ahcls"]),
                                    ("gdcls", {"lambda_tik": 0.1})])
def test_clamped_als_family_need_not_descend(alg, kn):
    """A witness, not a limit: on ratings shaped like config 2's (6,000
    users x 2,674 items, about 43 ratings a user, r = 64) from the random
    init's scale, one iteration of a clamped solve rule ends above the
    start's Frobenius error, in nmftpu as in the port (clamping a row's
    unconstrained solve is no descent step), while the two agree.
    chip_smoke.py phase 22 therefore holds these rules' steps against
    float64 and prints their errors."""
    V = _ratings_like_ml20m(6000, 2674, 40, 0)
    jsp = js.from_dense(V)
    tsp = sparse_from_nmftpu(jsp)
    r = 64
    rng = np.random.default_rng(1)
    scale = (float(V.sum(dtype=np.float64)) / V.size / r) ** 0.5
    W0 = ((rng.random((6000, r)) + 1e-4) * scale).astype(np.float32)
    H0 = ((rng.random((r, 2674)) + 1e-4) * scale).astype(np.float32)
    start = np.linalg.norm(V.astype(np.float64) - W0.astype(np.float64) @ H0)
    jr, tr = _nmf_both(jsp, tsp, W0, H0, 2, algorithm=alg, strategy="ell",
                       **kn)
    np.testing.assert_allclose(tr.stats.errors, np.asarray(jr.stats.errors),
                               rtol=RTOL_ERR)
    assert jr.stats.errors[0] > start and tr.stats.errors[0] > start
