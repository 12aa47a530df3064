"""The port's dense generalized beta divergence (the beta-MU helpers of
nmftpu_torch.linalg.dense, mu_update_beta, beta_divergence, and float32
beta MU through nmf) against nmftpu's on the same numpy inputs, and
against sklearn's _multiplicative_update_w/_h and _beta_divergence under
float64.

Tolerances: float64 against nmftpu or sklearn rtol 1e-10 (the same
operations, summed in another order; sklearn clamps and replaces the same
entries); float32 rtol 2e-5 per step (a power of a float32 WH carries
|beta - 2| ulps of its base's rounding into each product); runs through
nmf 1e-4 on the factors after ten steps."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmftpu  # noqa: E402
from nmftpu.linalg import dense as JD  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch.algorithms.registry import build_dense_update  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402

BETAS = [0.0, 0.5, 1.5, 3.0]
RTOL = {np.float64: 1e-10, np.float32: 2e-5}


def _problem(dtype, seed=0, n=30, m=24, r=4, zeros=True):
    """Strictly positive factors; V positive with some exact zeros (the
    guards' cases: WH stays positive, V = 0 takes the zero branches)."""
    rng = np.random.default_rng(seed)
    V = (np.abs(rng.normal(size=(n, m))) + 0.1).astype(dtype)
    if zeros:
        V[rng.random(V.shape) < 0.2] = 0.0
    W = (np.abs(rng.normal(size=(n, r))) + 0.05).astype(dtype)
    H = (np.abs(rng.normal(size=(r, m))) + 0.05).astype(dtype)
    return V, W, H


def _t(*xs):
    return [torch.tensor(x) for x in xs]


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("beta", BETAS + [1.0, 2.0, -0.5])
def test_beta_gamma_matches(beta):
    assert TD.beta_gamma(beta) == JD.beta_gamma(beta)
    assert TD.EPSILON == JD.EPSILON and TD._STAB_EPS == JD._STAB_EPS


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("beta", BETAS + [1.0])
def test_beta_powers_match(beta, dtype):
    """The two guards stay separate: the numerator's power clamps below
    EPSILON when beta < 2, the denominator's only when beta < 1."""
    rng = np.random.default_rng(1)
    WH = rng.uniform(0.0, 2.0, (20, 17)).astype(dtype)
    WH[0, :5] = [0.0, 1e-9, 1e-7, JD.EPSILON, 1.0]
    got = TD._beta_powers(torch.tensor(WH), beta)
    want = JD._beta_powers(WH, beta)
    for g, w in zip(got, want):
        _close(g, w, RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("beta", BETAS + [1.0, 2.0])
def test_half_steps_and_terms_match(beta, dtype):
    V, W, H = _problem(dtype, seed=2)
    gamma = JD.beta_gamma(beta)
    Vt, Wt, Ht = _t(V, W, H)
    _close(TD.beta_w_step(Vt, Wt, Ht, beta, gamma=gamma),
           JD.beta_w_step(V, W, H, beta, gamma=gamma), RTOL[dtype])
    _close(TD.beta_h_step(Vt, Wt, Ht, beta, gamma=gamma),
           JD.beta_h_step(V, W, H, beta, gamma=gamma), RTOL[dtype])
    for g, w in zip(TD.beta_h_terms(Vt, Wt, Ht, beta),
                    JD.beta_h_terms(V, W, H, beta)):
        _close(g, w, RTOL[dtype])
    # sklearn's regularization on the denominators
    _close(TD.beta_w_step(Vt, Wt, Ht, beta, l1_w=0.3, l2_w=0.2,
                          gamma=gamma),
           JD.beta_w_step(V, W, H, beta, l1_w=0.3, l2_w=0.2, gamma=gamma),
           RTOL[dtype])
    _close(TD.beta_h_step(Vt, Wt, Ht, beta, l1_h=0.3, l2_h=0.2,
                          gamma=gamma),
           JD.beta_h_step(V, W, H, beta, l1_h=0.3, l2_h=0.2, gamma=gamma),
           RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("beta", BETAS)
def test_mu_update_beta_matches(beta, order, dtype):
    V, W, H = _problem(dtype, seed=3)
    Wt, Ht = _t(W, H)
    Vt = torch.tensor(V)
    for _ in range(3):
        Wt, Ht = TD.mu_update_beta(Vt, Wt, Ht, beta, order=order)
        W, H = JD.mu_update_beta(V, W, H, beta, order=order)
    # three steps compound each step's rounding
    rtol = RTOL[dtype] * (1 if dtype == np.float64 else 5)
    _close(Wt, W, rtol)
    _close(Ht, H, rtol)


def test_mu_update_beta_refuses_jacobi():
    V, W, H = _t(*_problem(np.float32))
    with pytest.raises(NotImplementedError, match="order"):
        TD.mu_update_beta(V, W, H, 0.5, order="jacobi")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("beta", BETAS + [-0.5, 2.5])
def test_beta_divergence_matches(beta, dtype):
    V, W, H = _problem(dtype, seed=4)
    got = float(TD.beta_divergence(*_t(V, W, H), beta))
    want = float(JD.beta_divergence(V, W, H, beta))
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype])


# ---------------------------------------------------------------------------
# sklearn, float64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beta", BETAS)
def test_half_steps_match_sklearn(beta):
    """Three MU iterations in float64 against sklearn's own update
    functions, the stabilization of beta < 1 included."""
    from sklearn.decomposition._nmf import (
        _multiplicative_update_h,
        _multiplicative_update_w,
    )

    V, W, H = _problem(np.float64, seed=5, zeros=False)
    gamma = TD.beta_gamma(beta)
    Wt, Ht = _t(W, H)
    Vt = torch.tensor(V)
    W_sk, H_sk = W.copy(), H.copy()
    for _ in range(3):
        Wt, Ht = TD.mu_update_beta(Vt, Wt, Ht, beta)
        W_sk, *_ = _multiplicative_update_w(
            V, W_sk, H_sk, beta_loss=beta, l1_reg_W=0, l2_reg_W=0,
            gamma=gamma)
        if beta < 1:
            W_sk[W_sk < np.finfo(np.float64).eps] = 0.0
        H_sk = _multiplicative_update_h(
            V, W_sk, H_sk, beta_loss=beta, l1_reg_H=0, l2_reg_H=0,
            gamma=gamma)
        if beta < 1:
            H_sk[H_sk < np.finfo(np.float64).eps] = 0.0
    _close(Wt, W_sk, 1e-10, atol=1e-14)
    _close(Ht, H_sk, 1e-10, atol=1e-14)


@pytest.mark.parametrize("beta", BETAS + [2.5])
def test_beta_divergence_matches_sklearn(beta):
    from sklearn.decomposition._nmf import _beta_divergence

    V, W, H = _problem(np.float64, seed=6, zeros=False)
    got = float(TD.beta_divergence(*_t(V, W, H), beta))
    np.testing.assert_allclose(got, float(_beta_divergence(V, W, H, beta)),
                               rtol=1e-10)


# ---------------------------------------------------------------------------
# through the registry and nmf
# ---------------------------------------------------------------------------


def test_registry_routes_float32_beta(monkeypatch):
    called = []
    real = TD.mu_update_beta
    monkeypatch.setattr(TD, "mu_update_beta",
                        lambda *a, **k: called.append(a[3]) or real(*a, **k))
    make_aux, update, effective_h = build_dense_update(
        nt.NmfConfig(rank=2, objective="beta-divergence", beta=0.5))
    V, W, H = _t(*_problem(np.float32, r=2))
    aux = make_aux(V)
    assert aux == ()
    W1, H1 = update(V, aux, W, H)
    assert called == [0.5] and effective_h(aux, H1) is H1


@pytest.mark.parametrize("v_storage", ["bfloat16", "int8"])
@pytest.mark.parametrize("beta", [0.5, 1.5])
def test_low_precision_beta_still_raises(beta, v_storage):
    """bf16 and int8 V run beta MU (tests/test_torch_beta_engines.py holds
    them against nmftpu); what still raises there is nmftpu's refusal of
    use_pallas and of the jacobi coupling under beta."""
    make_aux, update, _ = build_dense_update(nt.NmfConfig(
        rank=2, objective="beta-divergence", beta=beta,
        v_storage=v_storage))
    V, W, H = _t(*_problem(np.float32, r=2))
    W1, H1 = update(V, make_aux(V), W, H)
    assert torch.isfinite(W1).all() and torch.isfinite(H1).all()
    for knobs, match in (({"use_pallas": True}, "use_pallas"),
                         ({"mu_style": "jacobi"}, "jacobi")):
        with pytest.raises(ValueError, match=match):
            nt.NmfConfig(rank=2, objective="beta-divergence", beta=beta,
                         v_storage=v_storage, **knobs)


def test_sparse_beta_still_raises():
    """Sparse V runs beta MU on every engine (tests/test_torch_beta_
    engines.py); masked completion and the jacobi coupling still raise
    under beta, as in nmftpu."""
    V, _, _ = _problem(np.float32)
    sp = nt.sparse.from_dense(V)
    res = nt.nmf(sp, 3, objective="beta-divergence", beta=0.5,
                 num_iterations=1, device="cpu")
    assert np.isfinite(res.kl_error)
    with pytest.raises(ValueError, match="mask='observed'"):
        nt.nmf(sp, 3, objective="beta-divergence", beta=0.5,
               mask="observed", num_iterations=1, device="cpu")
    with pytest.raises(ValueError, match="jacobi"):
        nt.nmf(sp, 3, objective="beta-divergence", beta=0.5,
               mu_style="jacobi", num_iterations=1, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("beta", BETAS)
def test_nmf_beta_matches_nmftpu(beta, dtype):
    """nt.nmf with objective='beta-divergence' against nmftpu.nmf from the
    same factors: the factors, the checked Frobenius errors and the final
    divergence (best-of-N's objective, in the kl_error slot)."""
    V, W0, H0 = _problem(np.dtype(dtype).type, seed=7, zeros=False)
    kw = dict(objective="beta-divergence", beta=beta, init="copy", W0=W0,
              H0=H0, num_iterations=10, check_interval=5, dtype=dtype)
    got = nt.nmf(V, 4, device="cpu", **kw)
    want = nmftpu.nmf(V, 4, **kw)
    rtol = 1e-10 if dtype == "float64" else 1e-4
    _close(got.W, np.asarray(want.W), rtol)
    _close(got.H, np.asarray(want.H), rtol)
    np.testing.assert_allclose(got.stats.errors, want.stats.errors,
                               rtol=rtol)
    np.testing.assert_allclose(got.kl_error, want.kl_error, rtol=rtol)
    np.testing.assert_allclose(
        got.kl_error, float(TD.beta_divergence(
            torch.tensor(V), got.W, got.H, beta)), rtol=1e-6)


@pytest.mark.parametrize("beta", BETAS)
def test_nmf_beta_divergence_falls(beta):
    """MU under the beta divergence is a descent method: D_beta falls
    every iteration (checked after each of ten steps)."""
    V, W, H = _problem(np.float64, seed=8, zeros=False)
    Vt, Wt, Ht = _t(V, W, H)
    prev = float(TD.beta_divergence(Vt, Wt, Ht, beta))
    for _ in range(10):
        Wt, Ht = TD.mu_update_beta(Vt, Wt, Ht, beta)
        cur = float(TD.beta_divergence(Vt, Wt, Ht, beta))
        assert cur <= prev * (1 + 1e-12), (prev, cur)
        prev = cur


def test_best_of_n_compares_the_divergence():
    """Among restarts, nmf keeps the run with the lowest beta divergence,
    as nmftpu does."""
    V, _, _ = _problem(np.float32, seed=9, zeros=False)
    kw = dict(objective="beta-divergence", beta=1.5, num_iterations=5,
              num_runs=3, seed=3)
    res = nt.nmf(V, 4, device="cpu", **kw)
    assert res.best_run == int(np.argmin(res.run_errors))
    np.testing.assert_allclose(min(res.run_errors), res.kl_error,
                               rtol=1e-6)
