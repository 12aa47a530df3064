"""Batched problems and vectorized restarts in the port
(nmftpu_torch.batched.compute_batched, loop.build_batched_runner behind
vectorize_runs=True) against nmftpu's on the same numpy inputs, on the
CPU, where the kernels' wrappers run their plain twins.

The two packages draw different random streams, so factors are compared
from explicit W0/H0 (init="copy"). Tolerances: float32 after 20
iterations rtol 1e-4 (sums in another order, compounded), the port's
lockstep runner against its own sequential runs rtol 1e-5 (the same
operations slot by slot; batched GEMMs where the route has them)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmftpu  # noqa: E402
from nmftpu.batched import compute_batched as j_compute_batched  # noqa: E402
from nmftpu.sparse import from_dense as j_from_dense  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import loop as TL  # noqa: E402
from nmftpu_torch.batched import compute_batched  # noqa: E402
from nmftpu_torch.convert import (  # noqa: E402
    batched_result_to_numpy,
    config_from_nmftpu,
)
from nmftpu_torch.driver import _dense_ops  # noqa: E402
from nmftpu_torch.sparse import from_dense  # noqa: E402

B, N, M, R, ITERS = 3, 64, 48, 6, 20
RTOL = 1e-4
SELF_RTOL = 1e-5


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _stack(seed=3, b=B, n=N, m=M, r=R):
    rng = np.random.default_rng(seed)
    Vs = rng.uniform(0.05, 1.0, (b, n, m)).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (b, n, r)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (b, r, m)).astype(np.float32)
    return Vs, W0, H0


CASES = {
    "mu": dict(),
    "mu_kl": dict(objective="kullback-leibler"),
    "mu_hw": dict(update_order="HW"),
    "hals": dict(algorithm="hals"),
    "als": dict(algorithm="als"),
    "acls": dict(algorithm="acls", lambda_w=0.1, lambda_h=0.1),
    "nsnmf": dict(algorithm="nsnmf"),
    "jacobi": dict(mu_style="jacobi"),
    "pallas": dict(use_pallas=True),
    "beta": dict(objective="beta-divergence", beta=1.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_matches_nmftpu(case):
    """Every problem's factors and errors against nmftpu's
    compute_batched from the same W0/H0 (rtol 1e-4 after 20
    iterations)."""
    Vs, W0, H0 = _stack()
    knobs = dict(rank=R, init_method="copy_existing", num_iterations=ITERS,
                 check_interval=5, **CASES[case])
    jres = j_compute_batched(Vs, nmftpu.NmfConfig(**knobs), W0=W0, H0=H0)
    tres = compute_batched(Vs, nt.NmfConfig(**knobs), W0=W0, H0=H0,
                           device="cpu")
    assert tres.W.shape == (B, N, R) and tres.H.shape == (B, R, M)
    assert len(tres) == B
    assert _rel(tres.W, jres.W) <= RTOL and _rel(tres.H, jres.H) <= RTOL
    np.testing.assert_allclose(tres.frobenius_error, jres.frobenius_error,
                               rtol=RTOL)
    np.testing.assert_allclose(tres.error, jres.error, rtol=RTOL)
    if jres.kl_error is None:
        assert tres.kl_error is None
    else:
        np.testing.assert_allclose(tres.kl_error, jres.kl_error, rtol=RTOL)
    np.testing.assert_array_equal(tres.num_iterations, jres.num_iterations)
    np.testing.assert_array_equal(tres.converged, jres.converged)
    for ts, js in zip(tres.stats, jres.stats):
        np.testing.assert_array_equal(ts.iterations, js.iterations)
        np.testing.assert_allclose(ts.errors, js.errors, rtol=RTOL)
    view = tres[1]
    assert view["W"].shape == (N, R) and np.isfinite(view["error"])


@pytest.mark.parametrize("case", ["mu", "pallas", "hals", "int8"])
def test_batched_matches_solo_port_runs(case):
    """Each problem equals the port's own compute from the same start:
    the lockstep runner adds nothing to a problem's trajectory (rtol
    1e-5). int8 V (use_pallas) is held here, where both sides quantize
    each problem alike (nmftpu's CPU path dequantizes to bf16)."""
    knobs = {"int8": dict(v_storage="int8", use_pallas=True),
             "pallas": dict(use_pallas=True),
             "hals": dict(algorithm="hals"), "mu": {}}[case]
    Vs, W0, H0 = _stack(seed=5)
    cfg = nt.NmfConfig(rank=R, init_method="copy_existing",
                       num_iterations=ITERS, check_interval=4, **knobs)
    res = compute_batched(Vs, cfg, W0=W0, H0=H0, device="cpu")
    for i in range(B):
        solo = nt.compute(Vs[i], cfg, W0=W0[i], H0=H0[i], device="cpu")
        assert _rel(res.W[i], solo.W) <= SELF_RTOL
        assert _rel(res.H[i], solo.H) <= SELF_RTOL
        np.testing.assert_allclose(res.error[i], solo.error, rtol=SELF_RTOL)
        np.testing.assert_allclose(res.stats[i].errors, solo.stats.errors,
                                   rtol=SELF_RTOL)


@pytest.mark.parametrize("init", ["all_random_values", "nndsvda",
                                  "mean_columns"])
def test_batched_problem_i_uses_restart_i_init(init):
    """Problem i starts from restart i's init (the host NNDSVD per
    problem), so problem 0 equals a plain compute with the config's own
    init and problem i a solo run from `init.run_generator(seed, i)`."""
    from nmftpu_torch.init import initialize_factors, run_generator

    Vs, _, _ = _stack(seed=7)
    cfg = nt.NmfConfig(rank=R, init_method=init, num_iterations=6,
                       check_interval=3, seed=11)
    res = compute_batched(Vs, cfg, device="cpu")
    solo0 = nt.compute(Vs[0], cfg, device="cpu")
    assert _rel(res.W[0], solo0.W) <= SELF_RTOL
    V2 = torch.tensor(Vs[2])
    W0, H0 = initialize_factors(V2, R, cfg.init_method,
                                run_generator(11, 2, "cpu"))
    import dataclasses

    solo2 = nt.compute(Vs[2], dataclasses.replace(
        cfg, init_method=nt.Initialization.COPY_EXISTING), W0=W0, H0=H0,
        device="cpu")
    assert _rel(res.H[2], solo2.H) <= SELF_RTOL


@pytest.mark.parametrize("bad,match", [
    (dict(num_runs=2), "one restart per problem"),
    (dict(threshold_value=1e-3), "fixed iteration budgets"),
    (dict(verbosity=2), "per-check verbosity"),
])
def test_batched_refusals_match_nmftpu(bad, match):
    """The three refusals, with nmftpu's messages word for word."""
    Vs, _, _ = _stack()
    with pytest.raises(ValueError) as jerr:
        j_compute_batched(Vs, nmftpu.NmfConfig(rank=R, **bad))
    with pytest.raises(ValueError, match=match) as terr:
        compute_batched(Vs, nt.NmfConfig(rank=R, **bad), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_batched_shape_and_rank_checks():
    Vs, _, _ = _stack()
    with pytest.raises(ValueError, match=r"\(B, n, m\)"):
        compute_batched(Vs[0], nt.NmfConfig(rank=R), device="cpu")
    with pytest.raises(ValueError, match="exceeds min problem dims"):
        compute_batched(Vs, nt.NmfConfig(rank=M + 1), device="cpu")


def test_batched_result_to_numpy_both_packages():
    Vs, W0, H0 = _stack()
    knobs = dict(rank=R, init_method="copy_existing", num_iterations=4,
                 check_interval=2)
    t = batched_result_to_numpy(compute_batched(
        Vs, nt.NmfConfig(**knobs), W0=W0, H0=H0, device="cpu"))
    j = batched_result_to_numpy(j_compute_batched(
        Vs, nmftpu.NmfConfig(**knobs), W0=W0, H0=H0))
    assert set(t) == set(j)
    assert t["W"].shape == j["W"].shape == (B, N, R)
    np.testing.assert_allclose(t["W"], j["W"], rtol=RTOL, atol=1e-6)
    assert [s.shape for s in t["stats"]] == [s.shape for s in j["stats"]]
    np.testing.assert_array_equal(t["num_iterations"], j["num_iterations"])


# ---------------------------------------------------------------------------
# vectorized restarts
# ---------------------------------------------------------------------------


def _V(seed=0, n=N, m=M):
    return np.random.default_rng(seed).uniform(0.05, 1.0,
                                               (n, m)).astype(np.float32)


VEC_CASES = {
    "mu": {},
    "mu_kl": dict(objective="kl"),
    "hals": dict(algorithm="hals"),
    "pallas": dict(use_pallas=True),
    "int8_pallas": dict(v_storage="int8", use_pallas=True),
    "als": dict(algorithm="als"),
    "gdcls_int8": dict(algorithm="gdcls", v_storage="int8"),
    "nsnmf_kl": dict(algorithm="nsnmf", objective="kl"),
    "beta": dict(objective="beta", beta=0.5),
    "jacobi": dict(mu_style="jacobi"),
    "ials": dict(algorithm="als", alpha_confidence=2.0),
}


@pytest.mark.parametrize("case", list(VEC_CASES))
def test_vectorized_matches_sequential(case):
    """vectorize_runs=True against the port's sequential restarts (each
    from init_fn(run_idx)): run errors rtol 1e-5, the same best run,
    its factors and stats."""
    V = _V()
    kw = dict(num_runs=4, num_iterations=ITERS, check_interval=5,
              device="cpu", seed=3, **VEC_CASES[case])
    seq = nt.nmf(V, R, **kw)
    vec = nt.nmf(V, R, vectorize_runs=True, **kw)
    np.testing.assert_allclose(vec.run_errors, seq.run_errors,
                               rtol=SELF_RTOL)
    assert vec.best_run == seq.best_run
    assert _rel(vec.W, seq.W) <= SELF_RTOL
    assert _rel(vec.H, seq.H) <= SELF_RTOL
    np.testing.assert_allclose(vec.error, seq.error, rtol=SELF_RTOL)
    np.testing.assert_allclose(vec.frobenius_error, seq.frobenius_error,
                               rtol=SELF_RTOL)
    assert (vec.kl_error is None) == (seq.kl_error is None)
    np.testing.assert_array_equal(vec.stats.iterations, seq.stats.iterations)
    np.testing.assert_allclose(vec.stats.errors, seq.stats.errors,
                               rtol=SELF_RTOL)
    assert vec.num_iterations == seq.num_iterations
    assert vec.converged == seq.converged


@pytest.mark.parametrize("case", ["mu", "kl", "hals"])
def test_vectorized_matches_nmftpu(case):
    """nmftpu's vmapped restarts and the port's, every run from one
    W0/H0 (init="copy"): the run errors agree (rtol 1e-4) and, all runs
    being equal, both pick the first."""
    knobs = {"mu": {}, "kl": dict(objective="kl"),
             "hals": dict(algorithm="hals")}[case]
    V = _V(seed=4)
    rng = np.random.default_rng(8)
    W0 = rng.uniform(0.1, 1.0, (N, R)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (R, M)).astype(np.float32)
    kw = dict(init="copy", W0=W0, H0=H0, num_runs=3, num_iterations=ITERS,
              check_interval=5, vectorize_runs=True, **knobs)
    want = nmftpu.nmf(V, R, **kw)
    got = nt.nmf(V, R, device="cpu", **kw)
    np.testing.assert_allclose(got.run_errors, want.run_errors, rtol=RTOL)
    assert got.best_run == want.best_run == 0
    assert _rel(got.W, want.W) <= RTOL


def test_vectorized_freezes_converged_runs():
    """Under threshold_value > 0 the restarts stop at different checks;
    each stopped run keeps its factors, count and stats while the others
    go on: every run's callback records (run, iteration, error) match
    the sequential run's, and the lockstep runner's per-run iteration
    counts are the sequential ones (two or more distinct)."""
    V = _V(seed=1)
    kw = dict(num_runs=4, num_iterations=200, check_interval=1,
              threshold=2e-3, device="cpu", seed=5)
    seq_rec, vec_rec = [], []
    seq = nt.nmf(V, R, callback=lambda *a: seq_rec.append(a), **kw)
    vec = nt.nmf(V, R, vectorize_runs=True,
                 callback=lambda *a: vec_rec.append(a), **kw)
    stops = {}
    for run, it, _, _ in seq_rec:
        stops[run] = max(stops.get(run, 0), it)
    assert len(set(stops.values())) >= 2, stops
    assert max(stops.values()) < 200
    assert sorted((r, i) for r, i, _, _ in vec_rec) == \
        sorted((r, i) for r, i, _, _ in seq_rec)
    want = {(r, i): e for r, i, e, _ in seq_rec}
    for r, i, e, _ in vec_rec:
        np.testing.assert_allclose(e, want[(r, i)], rtol=SELF_RTOL)
    np.testing.assert_allclose(vec.run_errors, seq.run_errors,
                               rtol=SELF_RTOL)
    assert vec.best_run == seq.best_run
    assert vec.converged and vec.num_iterations == seq.num_iterations

    cfg = nt.NmfConfig(rank=R, num_iterations=200, check_interval=1,
                       threshold_value=2e-3, seed=5)
    run = TL.build_batched_runner(cfg, _dense_ops(cfg))
    from nmftpu_torch.init import initialize_factors, run_generator

    Vt = torch.tensor(V)
    inits = [initialize_factors(Vt, R, cfg.init_method,
                                run_generator(5, i, "cpu"))
             for i in range(4)]
    out = run(Vt, torch.stack([w for w, _ in inits]),
              torch.stack([h for _, h in inits]), range(4))
    assert out[6] == [stops[i] for i in range(4)]
    assert out[7] == [True] * 4
    assert out[9] == [stops[i] for i in range(4)]


@pytest.mark.parametrize("strategy", ["scatter", "ell", "densified"])
def test_vectorized_sparse_matches_sequential(strategy):
    V = _V(seed=2)
    V[V < 0.5] = 0.0
    sp = from_dense(V)
    kw = dict(num_runs=3, num_iterations=10, check_interval=5,
              device="cpu", strategy=strategy, seed=1)
    seq = nt.nmf(sp, R, **kw)
    vec = nt.nmf(sp, R, vectorize_runs=True, **kw)
    np.testing.assert_allclose(vec.run_errors, seq.run_errors,
                               rtol=SELF_RTOL)
    assert vec.best_run == seq.best_run
    assert vec.W.shape == (N, R)
    assert _rel(vec.W, seq.W) <= SELF_RTOL


def test_vectorized_sparse_matches_nmftpu():
    """Sparse scatter, every run from one W0/H0: nmftpu's vmapped
    restarts and the port's agree (rtol 1e-4)."""
    V = _V(seed=6)
    V[V < 0.5] = 0.0
    rng = np.random.default_rng(9)
    W0 = rng.uniform(0.1, 1.0, (N, R)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (R, M)).astype(np.float32)
    kw = dict(init="copy", W0=W0, H0=H0, num_runs=2, num_iterations=10,
              check_interval=5, vectorize_runs=True, strategy="scatter")
    want = nmftpu.nmf(j_from_dense(V), R, **kw)
    got = nt.nmf(from_dense(V), R, device="cpu", **kw)
    np.testing.assert_allclose(got.run_errors, want.run_errors, rtol=RTOL)


def test_interrupt_with_vectorized_runs_rejected():
    """nmftpu's refusal of interrupt= with vectorized runs, word for
    word; one run (num_runs=1) is not vectorized and takes it."""
    V = _V()
    kw = dict(num_runs=2, vectorize_runs=True, num_iterations=5,
              interrupt=lambda: False)
    with pytest.raises(ValueError, match="vectorize_runs") as jerr:
        nmftpu.nmf(V, R, **kw)
    with pytest.raises(ValueError, match="vectorize_runs") as terr:
        nt.nmf(V, R, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    res = nt.nmf(V, R, device="cpu", num_runs=1, vectorize_runs=True,
                 num_iterations=5, interrupt=lambda: True,
                 check_interval=1)
    assert res.num_iterations == 1


def test_vectorized_config_roundtrip():
    """A vectorized nmftpu config carried across runs in the port."""
    cfg = config_from_nmftpu(nmftpu.NmfConfig(rank=R, num_runs=2,
                                              vectorize_runs=True,
                                              num_iterations=3))
    res = nt.compute(_V(), cfg, device="cpu")
    assert len(res.run_errors) == 2 and res.num_iterations == 3
