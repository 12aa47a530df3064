"""The dense ALS family (ALS, ACLS, AHCLS), GDCLS and nsNMF (Frobenius
and KL) of nmftpu_torch against nmftpu's, on float32, bfloat16 and int8
V, from the same numpy V, W0 and H0.

One update step (through both registries, so the routes are held too),
each half-step from the same inputs: the first factor of a step comes
from (W0, H0), and the second half-step is held from the reference's
first factor (a call with the reverse order, whose first output is
compared). Largest error over the largest entry, max|a − b| / max|b|
(a clamp at 0 leaves entries near zero whose own relative error says
nothing):

* float64 V: 1e-10;
* float32: MU-type half-steps (the GDCLS W step, nsNMF) 1e-5; solves
  10·κ·2⁻²⁴, κ the condition number of the solved Gram (float64), as a
  float32 Cholesky solve is off by about κ·2⁻²⁴;
* bfloat16 V: 1e-4 for the MU-type half-steps; the solves as float32
  (a product of two bf16 values is exact in float32, so the right-hand
  sides differ in their summation order only);
* int8 V: as float32 (the int32 right-hand sides are exact, and the
  quantization is the reference's bit for bit).

`_ls_terms_*_int8`: Grams at 1e-6, right-hand sides equal (atol 0).
`_als_family_shifts` and `_ahcls_shift`: equal.

End to end through `nmf` on the ML-100K fixture (BASELINE config 1's
data; the Gram-trick error's float32 cancellation stays far below these
limits there): the factors after one iteration, max|a − b| / max|b|,
1e-4; the errors at every check, relative: float32 over 20 iterations
1e-4; int8 over 10, 1e-3 (requantization flips); bf16 over 10, 1e-3 for
GDCLS and nsNMF. A bf16 run of the clamped solves (ALS, ACLS, AHCLS) is
held after one iteration only, on W and the error: a float32 reordering
flips some bf16 roundings of a factor and the clamped solve amplifies
the flips (the H step is held from the same W by the step test), so that
after 10 iterations the reference drifts from itself by more than 1e-3
when one column of H0 moves by a relative 1e-6
(`test_reference_bf16_clamped_solves_drift`; ROADMAP hazards "HALS
trajectories" and "Requantization flips"). Dense iALS runs as nmftpu's
(its steps are held in `tests/test_torch_ials.py`).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu import sparse_ops as JS  # noqa: E402
from nmftpu.algorithms.registry import build_dense_update as j_build  # noqa
from nmftpu.config import NmfConfig as JConfig  # noqa: E402
from nmftpu.kernels import quantized as JQ  # noqa: E402
from nmftpu.linalg import dense as JD  # noqa: E402
from nmftpu_torch.algorithms import build_dense_update as t_build  # noqa
from nmftpu_torch.config import NmfConfig  # noqa: E402
from nmftpu_torch.kernels import quantized as TQ  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U32 = 2.0 ** -24
SHAPES = [(40, 56, 4), (130, 96, 16)]
KNOBS = {
    "als": {},
    "acls": {"lambda_w": 0.1, "lambda_h": 0.2},
    "ahcls": {"lambda_w": 0.1, "lambda_h": 0.2, "alpha_w": 0.5,
              "alpha_h": 0.3},
    "gdcls": {"lambda_tik": 0.1},
    "nsnmf": {"theta": 0.5},
}
# (algorithm, objective)
ALGORITHMS = [(a, "frobenius") for a in KNOBS] + [("nsnmf",
                                                   "kullback-leibler")]
SOLVES = ("als", "acls", "ahcls")


def _inputs(shape, dtype, seed=0):
    n, m, r = shape
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.0, 5.0, (n, m)).astype(dtype)
    W = rng.uniform(0.05, 1.0, (n, r)).astype(dtype)
    H = rng.uniform(0.05, 1.0, (r, m)).astype(dtype)
    return V, W, H


def _cfg(shape, algorithm, objective, storage, order, dtype):
    return dict(rank=shape[2], algorithm=algorithm, objective=objective,
                v_storage=storage, update_order=order,
                dtype=np.dtype(dtype).name, **KNOBS[algorithm])


def _step(kw, V, W, H):
    """One update of both packages' registries from the same inputs."""
    mk, up, _ = j_build(JConfig(**kw))
    Vj = jnp.asarray(V)
    want = up(Vj, mk(Vj), jnp.asarray(W), jnp.asarray(H))
    mk, up, _ = t_build(NmfConfig(**kw))
    Vt = torch.tensor(V)
    got = up(Vt, mk(Vt), torch.tensor(W), torch.tensor(H))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _kappa(X, side):
    """Condition number of the Gram the half-step solves: X Xᵀ for H
    (W step), Xᵀ X for W (H step)."""
    X = np.asarray(X, np.float64)
    return np.linalg.cond(X @ X.T if side == "w" else X.T @ X)


def _limit(algorithm, storage, dtype, half, partner):
    """The stated limit of one half-step (`half` "w" or "h") whose
    partner factor is `partner`."""
    if dtype == np.float64:
        return 1e-10
    solve = algorithm in SOLVES or (algorithm == "gdcls" and half == "h")
    if solve:
        return 10 * _kappa(partner, half) * U32
    return 1e-4 if storage == "bfloat16" else 1e-5


def _step_cases():
    for shape in SHAPES:
        for algorithm, objective in ALGORITHMS:
            for order in ("WH", "HW"):
                yield shape, algorithm, objective, "float32", order, \
                    np.float64
                for storage in ("float32", "bfloat16", "int8"):
                    yield shape, algorithm, objective, storage, order, \
                        np.float32


@pytest.mark.parametrize(
    "shape,algorithm,objective,storage,order,dtype",
    [pytest.param(*c, id="-".join([f"{c[0][0]}x{c[0][1]}r{c[0][2]}",
                                   c[1], c[2][:3], c[3], c[4],
                                   np.dtype(c[5]).name]))
     for c in _step_cases()])
def test_one_step_matches_nmftpu(shape, algorithm, objective, storage, order,
                                 dtype):
    V, W, H = _inputs(shape, dtype)
    kw = _cfg(shape, algorithm, objective, storage, order, dtype)
    got, want = _step(kw, V, W, H)
    assert got[0].dtype == got[1].dtype == np.dtype(dtype)
    first, second = (0, 1) if order == "WH" else (1, 0)
    half = "wh"[first]
    partner = H if half == "w" else W
    lim = _limit(algorithm, storage, dtype, half, partner)
    assert _max_rel(got[first], want[first]) <= lim, (half, lim)
    # the second half-step from the reference's first factor: the reverse
    # order's first output is that half-step
    fac = [W, H]
    fac[first] = want[first].astype(dtype)
    rev = dict(kw, update_order="HW" if order == "WH" else "WH")
    got2, want2 = _step(rev, V, *fac)
    half2 = "wh"[second]
    lim2 = _limit(algorithm, storage, dtype, half2, fac[first])
    assert _max_rel(got2[second], want2[second]) <= lim2, (half2, lim2)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("side", ["w", "h"])
def test_ls_terms_int8_match(shape, side):
    """The consistent quantized pair: the Gram from the dequantized
    factor at 1e-6 (float32 sums in two orders), the int32 right-hand
    side equal; (r, n) for the W side, (r, m) for the H side."""
    V, W, H = _inputs(shape, np.float32, seed=3)
    Vq_j, sv_j = JQ.quantize_v(jnp.asarray(V))
    Vq_t, sv_t = TQ.quantize_v(torch.tensor(V))
    assert np.array_equal(Vq_t.numpy(), np.asarray(Vq_j))
    X = H if side == "w" else W
    jf = getattr(JD, f"_ls_terms_{side}_int8")
    tf = getattr(TD, f"_ls_terms_{side}_int8")
    gj, rj = jf(Vq_j, sv_j, jnp.asarray(X))
    gt, rt = tf(Vq_t, sv_t, torch.tensor(X))
    r = shape[2]
    assert gt.shape == (r, r)
    assert rt.shape == (r, shape[0] if side == "w" else shape[1])
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


@pytest.mark.parametrize("algorithm", ["als", "acls", "ahcls"])
@pytest.mark.parametrize("rank", [4, 16, 37])
def test_als_family_shifts_match(algorithm, rank):
    knobs = {"lambda_w": 0.3, "lambda_h": 0.7, "alpha_w": 0.2,
             "alpha_h": 0.9}
    want = JS._als_family_shifts(JConfig(rank=rank, algorithm=algorithm,
                                         **knobs))
    got = TD._als_family_shifts(NmfConfig(rank=rank, algorithm=algorithm,
                                          **knobs))
    assert got == want


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lam,alpha,r", [(0.1, 0.5, 16), (0.7, 0.0, 5),
                                         (2.0, 1.0, 256), (0.3, 0.25, 37)])
def test_ahcls_shift_matches(lam, alpha, r, dtype):
    """The dense float32 AHCLS shift takes its square root in V's dtype,
    so it is not the float64 shift of the int8 and bf16 routes."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    want = JD._ahcls_shift(lam, alpha, r, jnp.dtype(dtype))
    got = TD._ahcls_shift(lam, alpha, r, tdt)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        assert float(g) == float(w)


def test_nsnmf_smoothing_matrix_matches():
    for r, theta in ((4, 0.5), (16, 0.0), (37, 1.0), (7, 0.3)):
        want = JD.nsnmf_smoothing_matrix(r, theta, dtype=jnp.float32)
        got = TD.nsnmf_smoothing_matrix(r, theta)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _route_cases():
    D, DF = "nmftpu_torch.linalg.dense", "nmftpu_torch.densified"
    return [
        ("als", "frobenius", "float32", D, "als_update"),
        ("acls", "frobenius", "float32", D, "acls_update"),
        ("ahcls", "frobenius", "float32", D, "ahcls_update"),
        ("gdcls", "frobenius", "float32", D, "gdcls_update"),
        ("nsnmf", "frobenius", "float32", D, "nsnmf_update"),
        ("nsnmf", "kullback-leibler", "float32", D, "nsnmf_update"),
        ("als", "frobenius", "int8", D, "als_family_update_int8x8"),
        ("ahcls", "frobenius", "int8", D, "als_family_update_int8x8"),
        ("gdcls", "frobenius", "int8", D, "gdcls_update_int8x8"),
        ("nsnmf", "frobenius", "int8", D, "nsnmf_update_frobenius_int8x8"),
        ("acls", "frobenius", "bfloat16", DF, "als_family_update_densified"),
        ("gdcls", "frobenius", "bfloat16", DF, "gdcls_update_densified"),
        ("nsnmf", "frobenius", "bfloat16", DF, "nsnmf_update_densified"),
        ("nsnmf", "kullback-leibler", "bfloat16", DF,
         "nsnmf_update_kl_densified"),
        ("nsnmf", "kullback-leibler", "int8", DF,
         "nsnmf_update_kl_densified"),
    ]


@pytest.mark.parametrize("algorithm,objective,storage,module,route",
                         _route_cases())
def test_registry_routes(monkeypatch, algorithm, objective, storage, module,
                         route):
    """Each configuration reaches the function of nmftpu's branch, once
    per iteration, and nsNMF reports its error with S @ H."""
    import importlib

    mod = importlib.import_module(module)
    called = []
    real = getattr(mod, route)
    monkeypatch.setattr(mod, route, lambda *a, **k: called.append(1)
                        or real(*a, **k))
    make_aux, update, effective_h = t_build(NmfConfig(
        rank=3, algorithm=algorithm, objective=objective, v_storage=storage,
        **KNOBS[algorithm]))
    V, W, H = (torch.tensor(x) for x in _inputs((9, 7, 3), np.float32))
    aux = make_aux(V)
    W1, H1 = update(V, aux, W, H)
    assert called == [1]
    assert W1.shape == (9, 3) and H1.shape == (3, 7)
    if algorithm == "nsnmf":
        S = TD.nsnmf_smoothing_matrix(3, KNOBS["nsnmf"]["theta"])
        torch.testing.assert_close(effective_h(aux, H1), S @ H1)
    else:
        assert effective_h(aux, H1) is H1


def test_int8_family_runs_the_one_sided_entries(monkeypatch):
    """Every int8 half-step's right-hand side goes through
    kernels.dual_numer's one-sided entries (their plain twins on the
    CPU): ALS one vht and one wtv per iteration."""
    from nmftpu_torch.kernels import dual_numer as DN

    seen = []
    for name in ("vht_int8", "wtv_int8"):
        real = getattr(DN, name)
        monkeypatch.setattr(DN, name, lambda *a, _r=real, _n=name:
                            seen.append(_n) or _r(*a))
    V, W, H = _inputs((30, 20, 4), np.float32)
    nt.nmf(V, 4, algorithm="als", v_storage="int8", init="copy", W0=W,
           H0=H, num_iterations=3, device="cpu")
    assert seen == ["vht_int8", "wtv_int8"] * 3


# ---------------------------------------------------------------------------
# end to end through nmf on the ML-100K fixture
# ---------------------------------------------------------------------------


def _fixture_matrix():
    rows = np.loadtxt(os.path.join(REPO, "tests", "fixtures",
                                   "ml100k_u.data")).astype(np.int64)
    V = np.zeros((rows[:, 0].max(), rows[:, 1].max()), np.float32)
    V[rows[:, 0] - 1, rows[:, 1] - 1] = rows[:, 2]
    return V


V_FIX = _fixture_matrix()


def _fixture_factors(rank):
    rng = np.random.default_rng(rank)
    return (rng.uniform(0.1, 1.0, (V_FIX.shape[0], rank)).astype(np.float32),
            rng.uniform(0.1, 1.0, (rank, V_FIX.shape[1])).astype(np.float32))


def _both(rank, iterations, **kw):
    W0, H0 = _fixture_factors(rank)
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=iterations, **kw)
    return nmftpu.nmf(V_FIX, rank, **kw), nt.nmf(V_FIX, rank, device="cpu",
                                                  **kw)


def _e2e_cases():
    for rank in (8, 20):
        for algorithm, objective in ALGORITHMS:
            for storage in ("float32", "bfloat16", "int8"):
                yield rank, algorithm, objective, storage


@pytest.mark.parametrize(
    "rank,algorithm,objective,storage",
    [pytest.param(*c, id=f"r{c[0]}-{c[1]}-{c[2][:3]}-{c[3]}")
     for c in _e2e_cases()])
def test_nmf_matches_nmftpu(rank, algorithm, objective, storage):
    kn = dict(algorithm=algorithm, objective=objective, v_storage=storage,
              **KNOBS[algorithm])
    j1, t1 = _both(rank, 1, **kn)
    assert _max_rel(t1.W.numpy(), j1.W) <= 1e-4
    if storage == "bfloat16" and algorithm in SOLVES:
        # the H step reads a W whose bf16 roundings flipped in places
        # (held from the same W in test_one_step_matches_nmftpu)
        np.testing.assert_allclose(t1.error, j1.error, rtol=1e-4)
        return
    assert _max_rel(t1.H.numpy(), j1.H) <= 1e-4
    iterations, rtol = (20, 1e-4) if storage == "float32" else (10, 1e-3)
    j, t = _both(rank, iterations, check_interval=5, **kn)
    assert t.num_iterations == j.num_iterations == iterations
    np.testing.assert_array_equal(t.stats.iterations, j.stats.iterations)
    np.testing.assert_allclose(t.stats.errors, j.stats.errors, rtol=rtol)
    np.testing.assert_allclose(t.error, j.error, rtol=rtol)
    if objective == "kullback-leibler":
        np.testing.assert_allclose(t.kl_error, j.kl_error, rtol=rtol)
    else:
        assert t.kl_error is None


def test_reference_bf16_clamped_solves_drift():
    """Why bf16 ALS runs are held after one iteration: the reference's
    own bf16 ALS trajectory on the fixture moves by more than 1e-3 within
    10 iterations when one column of H0 moves by a relative 1e-6."""
    W0, H0 = _fixture_factors(20)
    H0p = H0.copy()
    H0p[:, 0] *= np.float32(1 + 1e-6)
    kw = dict(algorithm="als", v_storage="bfloat16", init="copy", W0=W0,
              num_iterations=10, check_interval=1)
    a = np.asarray(nmftpu.nmf(V_FIX, 20, H0=H0, **kw).stats.errors)
    b = np.asarray(nmftpu.nmf(V_FIX, 20, H0=H0p, **kw).stats.errors)
    assert np.max(np.abs(a - b) / a) > 1e-3


def test_nsnmf_result_is_the_raw_h():
    """The result's H is the raw H; the error is ||V − W S H||."""
    res = nt.nmf(V_FIX[:200, :300], 6, algorithm="nsnmf", theta=0.6,
                 num_iterations=4, device="cpu")
    S = TD.nsnmf_smoothing_matrix(6, 0.6)
    V = torch.tensor(V_FIX[:200, :300])
    want = float(torch.linalg.norm(V - res.W @ (S @ res.H)))
    np.testing.assert_allclose(res.frobenius_error, want, rtol=1e-5)
    assert float(torch.linalg.norm(V - res.W @ res.H)) != pytest.approx(
        want, rel=1e-3)


@pytest.mark.parametrize("knobs", [
    {"alpha_confidence": 1.0},
    {"alpha_confidence": 40.0, "lambda_w": 0.1},
    {"alpha_confidence": 2.0, "update_order": "HW"},
])
def test_ials_still_raises(knobs):
    """Dense iALS is ported (slice 4c, `tests/test_torch_ials.py`): each
    configuration runs as nmftpu's (the errors of 3 iterations, 1e-4);
    vectorize_runs is ported too (slice 5): two restarts in lockstep give
    the sequential restarts' errors (rtol 1e-5) and best run; mesh= is
    ported too (slice 6b, test_torch_dense_mesh.py), and what is not a
    DeviceMesh is refused."""
    V = V_FIX[:50, :60]
    rng = np.random.default_rng(7)
    W0 = rng.uniform(0.05, 1.0, (V.shape[0], 4)).astype(np.float32)
    H0 = rng.uniform(0.05, 1.0, (4, V.shape[1])).astype(np.float32)
    kw = dict(algorithm="als", init="copy", W0=W0, H0=H0, num_iterations=3,
              check_interval=1, **knobs)
    want = nmftpu.nmf(V, 4, **kw)
    got = nt.nmf(V, 4, device="cpu", **kw)
    np.testing.assert_allclose(got.stats.errors,
                               np.asarray(want.stats.errors), rtol=1e-4)
    seq = nt.nmf(V, 4, algorithm="als", num_iterations=2, num_runs=2,
                 device="cpu", **knobs)
    vec = nt.nmf(V, 4, algorithm="als", num_iterations=2, num_runs=2,
                 vectorize_runs=True, device="cpu", **knobs)
    np.testing.assert_allclose(vec.run_errors, seq.run_errors, rtol=1e-5)
    assert vec.best_run == seq.best_run
    with pytest.raises(TypeError, match="DeviceMesh"):
        nt.nmf(V, 4, algorithm="als", num_iterations=1, num_runs=2,
               vectorize_runs=True, device="cpu", mesh=object(), **knobs)
