"""The generalized beta divergence on every engine of the port against
nmftpu on the same numpy inputs: the densified row-panel update and
divergence (bf16 and int8 V), the sparse denominators and Σ(WH)^β in
panels, the scatter and ELL updates and divergences, the registry's,
the sparse driver's and the strategy's routes, nmf end to end on dense
float32 / bf16 / int8 V and on the densified, ELL, scatter and auto
engines, sklearn's NMF(solver="mu") and _beta_divergence as the
independent oracle for scatter at float64, and the config guards that
are the only refusals left on the beta path.

Tolerances (max|a - b| / max|b| unless said otherwise):
  * float64 against nmftpu or sklearn: 1e-10 per step, the same
    operations summed in another order;
  * float32 scatter and ELL, one step: 2e-5 (as tests/test_torch_beta.py:
    a power of a float32 WH carries |β - 2| ulps of its base's rounding
    into each product, and the sums run in another order);
  * densified one step: 1e-4, the same bf16 roundings as nmftpu's, but a
    float32 reordering of WH can move one rounding of (WH)^(β-2)·V or
    (WH)^(β-1) by a bf16 ulp (2^-8 of one of ~45 terms);
  * divergences: 2e-5 relative in float32 (sums of n·m terms of both
    signs, the value far from 0 on these inputs), 1e-10 in float64;
  * nmf after ten iterations: factors 1e-4 and D_β 1e-5 (float32; the
    per-step reordering compounds, and a bf16 rounding it flips moves a
    densified factor by ~2^-8 of one term), 1e-9 / 1e-10 (float64)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu import densified as JD  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ell as JE  # noqa: E402
from nmftpu import sparse_ops as JS  # noqa: E402
from nmftpu.config import NmfConfig as JConfig  # noqa: E402
from nmftpu.kernels import quantized as JQ  # noqa: E402
from nmftpu.linalg import dense as JLD  # noqa: E402
from nmftpu_torch import densified as TD  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.algorithms import registry as TR  # noqa: E402
from nmftpu_torch.convert import config_from_nmftpu  # noqa: E402
from nmftpu_torch.convert import sparse_from_nmftpu  # noqa: E402
from nmftpu_torch.kernels import quantized as TQ  # noqa: E402
from nmftpu_torch.linalg import dense as TLD  # noqa: E402

BETAS = [0.0, 0.5, 1.5, 2.5]
RTOL_F64 = 1e-10
RTOL_STEP = 2e-5
RTOL_DENSIFIED = 1e-4
RTOL_DIV = 2e-5
RTOL_RUN_W, RTOL_RUN_DIV = 1e-4, 1e-5
RTOL_RUN_F64_W, RTOL_RUN_F64_DIV = 1e-9, 1e-10
N, M, RANK = 60, 45, 5


def _data(seed=0, n=N, m=M, density=0.3, dtype=np.float32):
    """Nonnegative n x m ratings (0.5 .. 5 in half steps, exact in bf16)
    at `density`, with an empty row (3) and column (4), and positive
    factors."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 11, (n, m)) / 2.0
    V = np.where(rng.random((n, m)) < density, vals, 0.0)
    V[3, :] = 0.0
    V[:, 4] = 0.0
    W = rng.uniform(0.1, 1.0, (n, RANK))
    H = rng.uniform(0.1, 1.0, (RANK, m))
    return V.astype(dtype), W.astype(dtype), H.astype(dtype)


def _rel(a, b):
    a = np.asarray(a.double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.double() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _rel_scalar(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _tdt(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


# ---------------------------------------------------------------------------
# the densified row-panel update and divergence
# ---------------------------------------------------------------------------


def _densified(V, storage):
    """V as nmftpu's and the port's densified operand: bf16, or int8 with
    its scale (quantize_v, as the registry builds it)."""
    if storage == "bfloat16":
        return ((jnp.asarray(V).astype(jnp.bfloat16), None),
                (torch.tensor(V).to(torch.bfloat16), None))
    return JQ.quantize_v(jnp.asarray(V)), TQ.quantize_v(torch.tensor(V))


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
@pytest.mark.parametrize("block_rows", [4096, 16])
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("beta", BETAS)
def test_densified_beta_update_matches_nmftpu(storage, block_rows, order,
                                              beta):
    """One step; 16-row panels leave a 12-row tail over 60 rows. int8:
    the power multiplies the stored int8 value and the scale comes after
    the contraction, in both packages."""
    V, W, H = _data()
    (jv, jscale), (tv, tscale) = _densified(V, storage)
    want = JD.mu_update_beta_densified(
        jv, jnp.asarray(W), jnp.asarray(H), beta, order=order,
        block_rows=block_rows, scale=jscale)
    got = TD.mu_update_beta_densified(
        tv, torch.tensor(W), torch.tensor(H), beta, order=order,
        block_rows=block_rows, scale=tscale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) < RTOL_DENSIFIED


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
@pytest.mark.parametrize("beta", BETAS)
def test_densified_beta_terms_match_nmftpu(storage, beta):
    """The W and H numerators and denominators before the update."""
    V, W, H = _data(seed=1)
    (jv, jscale), (tv, tscale) = _densified(V, storage)
    for jfn, tfn in ((JD._beta_terms_w_blocked, TD._beta_terms_w_blocked),
                     (JD._beta_terms_h_blocked, TD._beta_terms_h_blocked)):
        want = jfn(jv, jnp.asarray(W), jnp.asarray(H), beta, 1e-9, 16,
                   jscale)
        got = tfn(tv, torch.tensor(W), torch.tensor(H), beta, 1e-9, 16,
                  tscale)
        for g, w in zip(got, want):
            assert _rel(g, w) < RTOL_DENSIFIED


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
@pytest.mark.parametrize("block_rows", [4096, 16])
@pytest.mark.parametrize("beta", BETAS + [-0.5])
def test_beta_divergence_densified_matches_nmftpu(storage, block_rows,
                                                  beta):
    V, W, H = _data(seed=2)
    (jv, jscale), (tv, tscale) = _densified(V, storage)
    want = JD.beta_divergence_densified(jv, jnp.asarray(W), jnp.asarray(H),
                                        beta, block_rows=block_rows,
                                        scale=jscale)
    got = TD.beta_divergence_densified(tv, torch.tensor(W), torch.tensor(H),
                                       beta, block_rows=block_rows,
                                       scale=tscale)
    assert got.dtype == torch.float32
    assert _rel_scalar(got, want) < RTOL_DIV


def test_densified_beta_holds_no_nm_float32_array(monkeypatch):
    """Every float32 intermediate is panel-sized: with 16-row panels no
    operand of a contraction has more than 16 · m elements beyond the
    factors."""
    V, W, H = _data()
    tv = torch.tensor(V).to(torch.bfloat16)
    biggest = []
    real = TD._bf16_dot

    def spy(a, b, *args):
        biggest.append(max(a.numel() if a.shape[0] != N else 0,
                           b.numel() if b.shape[0] != RANK else 0))
        return real(a, b, *args)

    monkeypatch.setattr(TD, "_bf16_dot", spy)
    TD.mu_update_beta_densified(tv, torch.tensor(W), torch.tensor(H), 0.5,
                                block_rows=16)
    TD.beta_divergence_densified(tv, torch.tensor(W), torch.tensor(H), 0.5,
                                 block_rows=16)
    assert biggest and max(biggest) <= 16 * M


# ---------------------------------------------------------------------------
# the dense denominators and Σ (WH)^β in panels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("block", [16, 2048])
@pytest.mark.parametrize("beta", BETAS)
def test_beta_denominators_match_nmftpu(dtype, block, beta):
    """16-column (row) panels over 45 columns (60 rows) leave a narrower
    last panel; nmftpu pads it with zeros."""
    _, W, H = _data(seed=3, dtype=dtype)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_STEP
    for jfn, tfn in ((JS.beta_denom_w_blocked, TS.beta_denom_w_blocked),
                     (JS.beta_denom_h_blocked, TS.beta_denom_h_blocked)):
        want = jfn(jnp.asarray(W), jnp.asarray(H), beta, block)
        got = tfn(torch.tensor(W), torch.tensor(H), beta, block)
        assert got.dtype == _tdt(dtype) and _rel(got, want) < tol
    # against the full products
    WH = W.astype(np.float64) @ H
    pw = np.maximum(WH, JLD.EPSILON) if beta < 1 else WH
    want_w = pw ** (beta - 1.0) @ H.T.astype(np.float64)
    got_w = TS.beta_denom_w_blocked(torch.tensor(W), torch.tensor(H), beta,
                                    block)
    assert _rel(got_w, want_w) < tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("block", [16, 2048])
@pytest.mark.parametrize("beta", [-0.5] + BETAS)
def test_beta_sum_wh_blocked_matches_nmftpu(dtype, block, beta):
    """45 columns are not a multiple of a 16-column block: for β < 0 a
    pad column's 0^β = +inf must not enter (nmftpu masks it; the port's
    last panel is narrower)."""
    _, W, H = _data(seed=4, dtype=dtype)
    want = JS.beta_sum_wh_blocked(jnp.asarray(W), jnp.asarray(H), beta,
                                  block)
    got = TS.beta_sum_wh_blocked(torch.tensor(W), torch.tensor(H), beta,
                                 block)
    assert torch.isfinite(got)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_DIV
    assert _rel_scalar(got, want) < tol
    exact = np.sum((W.astype(np.float64) @ H) ** beta)
    assert _rel_scalar(got, exact) < tol


# ---------------------------------------------------------------------------
# scatter and ELL
# ---------------------------------------------------------------------------


def _sparse(V):
    jsp = js.from_dense(V)
    return jsp, sparse_from_nmftpu(jsp)


def _coos(V, dtype):
    jsp, tsp = _sparse(V)
    return (JS.device_put_sparse(jsp, dtype=jnp.dtype(dtype), chunk=256),
            TS.device_put_sparse(tsp, dtype=_tdt(dtype), chunk=256,
                                 device="cpu"))


def _pairs(V, dtype):
    jsp, tsp = _sparse(V)
    return (JE.build_ell_pair(jsp, dtype=jnp.dtype(dtype), seg_max=8,
                              buckets=(2, 4, 8)),
            TE.build_ell_pair(tsp, dtype=_tdt(dtype), device="cpu",
                              seg_max=8, buckets=(2, 4, 8)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("beta", BETAS)
def test_mu_update_beta_sparse_matches_nmftpu(dtype, order, beta):
    V, W, H = _data(seed=5, dtype=dtype)
    jc, tc = _coos(V, dtype)
    want = JS.mu_update_beta_sparse(jc, jnp.asarray(W), jnp.asarray(H),
                                    beta, order=order, block=16)
    got = TS.mu_update_beta_sparse(tc, torch.tensor(W), torch.tensor(H),
                                   beta, order=order, block=16)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_STEP
    for g, w in zip(got, want):
        assert g.dtype == _tdt(dtype) and _rel(g, w) < tol
    # the dense oracle (itself held against sklearn in test_torch_beta.py)
    dense = TLD.mu_update_beta(torch.tensor(V), torch.tensor(W),
                               torch.tensor(H), beta, order=order)
    for g, w in zip(got, dense):
        assert _rel(g, w) < tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("beta", BETAS)
def test_mu_update_beta_ell_matches_nmftpu(dtype, order, beta):
    V, W, H = _data(seed=6, dtype=dtype)
    jp, tp = _pairs(V, dtype)
    want = JE.mu_update_beta_ell(jp, jnp.asarray(W), jnp.asarray(H), beta,
                                 order=order, block=16)
    got = TE.mu_update_beta_ell(tp, torch.tensor(W), torch.tensor(H), beta,
                                order=order, block=16)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_STEP
    for g, w in zip(got, want):
        assert g.dtype == _tdt(dtype) and _rel(g, w) < tol
    _, tc = _coos(V, dtype)
    for g, w in zip(got, TS.mu_update_beta_sparse(
            tc, torch.tensor(W), torch.tensor(H), beta, order=order)):
        assert _rel(g, w) < tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("beta", BETAS + [-0.5])
def test_sparse_beta_divergences_match_nmftpu(dtype, beta):
    """Scatter and ELL: sklearn's sparse-X semantics (v > EPSILON filter,
    WH clamp, Σ (WH)^β over all n·m entries)."""
    V, W, H = _data(seed=7, dtype=dtype)
    (jc, tc), (jp, tp) = _coos(V, dtype), _pairs(V, dtype)
    Wj, Hj, Wt, Ht = jnp.asarray(W), jnp.asarray(H), torch.tensor(W), \
        torch.tensor(H)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_DIV
    want = JS.beta_divergence_sparse(jc, Wj, Hj, beta, block=16)
    got = TS.beta_divergence_sparse(tc, Wt, Ht, beta, block=16)
    assert got.dtype == _tdt(dtype) and _rel_scalar(got, want) < tol
    want_e = JE.beta_divergence_ell(jp, Wj, Hj, beta, block=16)
    got_e = TE.beta_divergence_ell(tp, Wt, Ht, beta, block=16)
    assert _rel_scalar(got_e, want_e) < tol
    assert _rel_scalar(got_e, got) < tol


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.5])
def test_beta_numerator_keeps_pad_lanes_exact(beta):
    """ELL pad lanes (v = 0) and scatter pad entries sample some W·H
    product; the EPSILON clamp of β < 2 keeps its power finite, so each
    adds an exact 0 (a zero W row makes the sampled product 0)."""
    V, W, H = _data(seed=8)
    W[0] = 0.0
    _, tc = _coos(V, np.float32)
    vals = TS._beta_numer_values(tc, torch.tensor(W), torch.tensor(H),
                                 beta).values
    assert torch.isfinite(vals).all()
    assert torch.equal(vals[tc.values == 0], torch.zeros_like(
        vals[tc.values == 0]))
    _, tp = _pairs(V, np.float32)
    got = TE.mu_update_beta_ell(tp, torch.tensor(W), torch.tensor(H), beta)
    assert all(torch.isfinite(x).all() for x in got)


# ---------------------------------------------------------------------------
# sklearn, float64, zeros in V
# ---------------------------------------------------------------------------


def _sk_problem(seed=9):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 2.0, (30, 20))
    V = np.where(rng.random(V.shape) < 0.4, 0.0, V)
    V[:, 0] += 0.2
    V[0, :] += 0.2
    W0 = rng.uniform(0.1, 1.0, (30, 4))
    H0 = rng.uniform(0.1, 1.0, (4, 20))
    return V, W0, H0


@pytest.mark.parametrize("strategy", ["scatter", "auto"])
def test_scatter_float64_matches_sklearn_nmf(strategy):
    """NMF(solver='mu', beta_loss=1.5) from the same factors, ten
    iterations, float64: auto resolves float64 beta to scatter."""
    from sklearn.decomposition import NMF

    V, W0, H0 = _sk_problem()
    sk = NMF(n_components=4, solver="mu", beta_loss=1.5, init="custom",
             max_iter=10, tol=0.0)
    W_sk = sk.fit_transform(V.copy(), W=W0.copy(), H=H0.copy())
    res = nt.nmf(nt.sparse.from_dense(V), 4, objective="beta-divergence",
                 beta=1.5, init="copy", W0=W0, H0=H0, num_iterations=10,
                 check_interval=10, dtype="float64", strategy=strategy,
                 device="cpu")
    assert _rel(res.W, W_sk) < 1e-9
    assert _rel(res.H, sk.components_) < 1e-9


@pytest.mark.parametrize("beta", BETAS)
def test_sparse_beta_divergences_match_sklearn(beta):
    """_beta_divergence on a scipy CSR X (sklearn's sparse branch) against
    the scatter and ELL divergences in float64."""
    import scipy.sparse as sps
    from sklearn.decomposition._nmf import _beta_divergence

    V, W0, H0 = _sk_problem(seed=10)
    want = float(_beta_divergence(sps.csr_matrix(V), W0, H0, beta))
    tsp = nt.sparse.from_dense(V)
    tc = TS.device_put_sparse(tsp, dtype=torch.float64, device="cpu")
    tp = TE.build_ell_pair(tsp, dtype=torch.float64, device="cpu")
    Wt, Ht = torch.tensor(W0), torch.tensor(H0)
    assert _rel_scalar(TS.beta_divergence_sparse(tc, Wt, Ht, beta),
                       want) < 1e-10
    assert _rel_scalar(TE.beta_divergence_ell(tp, Wt, Ht, beta),
                       want) < 1e-10


# ---------------------------------------------------------------------------
# routes: the registry, the sparse driver, auto
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_registry_routes_low_precision_beta(monkeypatch, storage):
    calls = []
    real = TD.mu_update_beta_densified

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(TD, "mu_update_beta_densified", spy)
    make_aux, update, _ = TR.build_dense_update(nt.NmfConfig(
        rank=RANK, objective="beta-divergence", beta=0.5,
        v_storage=storage))
    V, W, H = (torch.tensor(x) + 0.1 for x in _data())
    aux = make_aux(V)
    assert aux[0].dtype == (torch.int8 if storage == "int8"
                            else torch.bfloat16)
    update(V, aux, W, H)
    assert len(calls) == 1
    assert (calls[0]["scale"] is not None) == (storage == "int8")


@pytest.mark.parametrize("strategy,route", [
    ("densified", (TD, "mu_update_beta_densified")),
    ("ell", (TE, "mu_update_beta_ell")),
    ("scatter", (TS, "mu_update_beta_sparse")),
])
def test_sparse_driver_routes_beta(monkeypatch, strategy, route):
    calls = []
    mod, name = route
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    V, W, H = _data()
    nt.nmf(_sparse(V)[1], RANK, init="copy", W0=W, H0=H, num_iterations=2,
           objective="beta-divergence", beta=1.5, strategy=strategy,
           device="cpu")
    assert len(calls) == 2


def test_auto_resolves_beta_like_nmftpu():
    """float64 -> scatter; float32 within the densify budget (bf16: 2·n·m
    bytes, int8: n·m) -> densified; beyond it -> ell; config 2's shape
    -> densified."""
    host = nt.sparse.SparseCOO([0], [0], [1.0], (1, 1))
    cases = {}
    for n, m in ((40, 30), (138_493, 26_744), (70_000, 65_536),
                 (10**6, 10**6)):
        for dtype, storage in (("float64", "float32"),
                               ("float32", "float32"),
                               ("float32", "bfloat16"),
                               ("float32", "int8")):
            jcfg = JConfig(rank=64, objective="beta-divergence", beta=0.5,
                           dtype=dtype, v_storage=storage)
            want = JS._resolve_strategy(host, jcfg, "auto", n, m)
            got = TS._resolve_strategy(host, config_from_nmftpu(jcfg),
                                       "auto", n, m)
            assert got == want
            cases[n, m, dtype, storage] = got
    assert cases[40, 30, "float64", "float32"] == "scatter"
    assert cases[138_493, 26_744, "float32", "float32"] == "densified"
    assert cases[70_000, 65_536, "float32", "bfloat16"] == "ell"
    assert cases[70_000, 65_536, "float32", "int8"] == "densified"
    assert cases[10**6, 10**6, "float32", "float32"] == "ell"


@pytest.mark.parametrize("knobs,exc", [
    ({"algorithm": "hals"}, ValueError),
    ({"algorithm": "als"}, ValueError),
    ({"use_pallas": True}, ValueError),
    ({"mu_style": "jacobi"}, ValueError),
    ({"mask": "observed"}, ValueError),
    ({"alpha_confidence": 40.0}, ValueError),
])
@pytest.mark.parametrize("beta", [0.5, 0.0])
def test_beta_config_guards_match_nmftpu(knobs, exc, beta):
    """Beta runs MU only, without use_pallas, jacobi, masking or
    weighting: both packages refuse each at construction, with the same
    exception class (itakura-saito is beta = 0)."""
    objective = "itakura-saito" if beta == 0.0 else "beta-divergence"
    kw = {} if beta == 0.0 else {"beta": beta}
    with pytest.raises(exc) as want:
        JConfig(rank=2, objective=objective, **kw, **knobs)
    with pytest.raises(exc) as got:
        nt.NmfConfig(rank=2, objective=objective, **kw, **knobs)
    assert type(got.value) is type(want.value)


# ---------------------------------------------------------------------------
# nmf end to end
# ---------------------------------------------------------------------------


RUNS = [
    # (engine, storage, dtype)
    ("dense", "bfloat16", "float32"),
    ("dense", "int8", "float32"),
    ("densified", "float32", "float32"),
    ("densified", "int8", "float32"),
    ("auto", "float32", "float32"),
    ("ell", "float32", "float32"),
    ("scatter", "float32", "float32"),
    ("scatter", "float32", "float64"),
    ("auto", "float32", "float64"),
]


@pytest.mark.parametrize("engine,storage,dtype", RUNS)
@pytest.mark.parametrize("beta", BETAS)
def test_nmf_beta_matches_nmftpu(engine, storage, dtype, beta):
    """nt.nmf against nmftpu.nmf from the same factors, ten iterations:
    the factors and the final divergence (the kl_error slot, best-of-N's
    objective under beta); objective='itakura-saito' for β = 0."""
    V, W0, H0 = _data(seed=11, dtype=np.dtype(dtype).type)
    obj = ({"objective": "itakura-saito"} if beta == 0.0 else
           {"objective": "beta-divergence", "beta": beta})
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=10,
              check_interval=5, v_storage=storage, dtype=dtype, **obj)
    if engine == "dense":
        V = V + np.asarray(0.1, V.dtype)
        want, got = nmftpu.nmf(V, RANK, **kw), nt.nmf(V, RANK, device="cpu",
                                                      **kw)
    else:
        jsp, tsp = _sparse(V)
        want = nmftpu.nmf(jsp, RANK, strategy=engine, **kw)
        got = nt.nmf(tsp, RANK, strategy=engine, device="cpu", **kw)
    assert got.num_iterations == want.num_iterations == 10
    tw, td = ((RTOL_RUN_F64_W, RTOL_RUN_F64_DIV) if dtype == "float64"
              else (RTOL_RUN_W, RTOL_RUN_DIV))
    assert _rel(got.W, want.W) < tw
    assert _rel(got.H, want.H) < tw
    assert _rel_scalar(got.kl_error, want.kl_error) < td


@pytest.mark.parametrize("engine,storage", [
    ("dense", "float32"), ("dense", "bfloat16"), ("dense", "int8"),
    ("densified", "float32"), ("densified", "int8"), ("ell", "float32"),
    ("scatter", "float32")])
@pytest.mark.parametrize("beta", [0.5, 1.5])
def test_beta_divergence_falls_on_every_engine(engine, storage, beta):
    """D_β of float32 V, recomputed by linalg.dense.beta_divergence after
    each of 8 single steps, falls at every step (MU descends; half-star
    ratings are exact in bf16, and in int8 up to scale/2)."""
    V, W, H = _data(seed=12)
    V = V + np.float32(0.05) if engine == "dense" else V
    Vt = torch.tensor(V)

    def div(W, H):
        return float(TLD.beta_divergence(Vt.double(), torch.tensor(W).double(),
                                         torch.tensor(H).double(), beta))

    divs = [div(W, H)]
    for _ in range(8):
        kw = dict(init="copy", W0=W, H0=H, num_iterations=1,
                  objective="beta-divergence", beta=beta, v_storage=storage,
                  device="cpu")
        res = (nt.nmf(V, RANK, **kw) if engine == "dense" else
               nt.nmf(_sparse(V)[1], RANK, strategy=engine, **kw))
        W, H = res.W.numpy(), res.H.numpy()
        divs.append(div(W, H))
    assert all(b < a for a, b in zip(divs[:-1], divs[1:])), divs


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_dense_low_precision_beta_reports_the_float32_divergence(storage):
    """The driver's divergence stays linalg.dense.beta_divergence on the
    float32 V it was given, whatever V's storage (as nmftpu's driver)."""
    V, W0, H0 = _data(seed=13)
    V = V + np.float32(0.1)
    res = nt.nmf(V, RANK, objective="beta-divergence", beta=1.5,
                 init="copy", W0=W0, H0=H0, num_iterations=3,
                 check_interval=3, v_storage=storage, device="cpu")
    want = TLD.beta_divergence(torch.tensor(V), res.W, res.H, 1.5)
    assert res.kl_error == pytest.approx(float(want), rel=1e-6)


def test_densified_plan_reports_the_densified_divergence():
    """On the densified engine the loop's divergence is the panel one on
    the stored (row-padded) V, as in nmftpu's plan."""
    V, W0, H0 = _data(seed=14)
    cfg = nt.NmfConfig(rank=RANK, objective="beta-divergence", beta=0.5,
                       init_method="copy_existing", num_iterations=2,
                       check_interval=2)
    plan = nt.prepare_sparse(_sparse(V)[1], cfg, strategy="densified",
                             device="cpu")
    res = plan.run(W0=W0, H0=H0)
    Wp = torch.nn.functional.pad(res.W, (0, 0, 0, plan.n_pad - N))
    want = TD.beta_divergence_densified(plan.operand, Wp, res.H, 0.5)
    assert res.kl_error == pytest.approx(float(want), rel=1e-6)
