"""int8 densified storage in the port against nmftpu on the same numpy
inputs: densify_quantized (bit for bit, on duplicate-free input), the
Gram-trick error and ||V||² with the scale, the row-panel KL numerators,
update and divergence with the scale, the dense int8 KL route, the
sparse densified int8 engine (Frobenius on the int8 x int8 numerators,
KL, weighted) end to end, and the plan's refusals."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu import densified as JD  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ops as JS  # noqa: E402
from nmftpu.linalg import dense as JLD  # noqa: E402
from nmftpu_torch import densified as TD  # noqa: E402
from nmftpu_torch import sparse as ts  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.algorithms import registry as TR  # noqa: E402
from nmftpu_torch.config import Initialization  # noqa: E402
from nmftpu_torch.convert import sparse_from_nmftpu  # noqa: E402
from nmftpu_torch.kernels import dual_numer as DN  # noqa: E402
from nmftpu_torch.linalg import dense as TLD  # noqa: E402

# one step or metric on the same int8 V: the contractions round the same
# operands to bf16 (int8 is exact in bf16) and sum in float32 in another
# order, ~sqrt(K) 2^-24 ~ 1e-6; a reordering can flip one bf16 rounding
# of a KL ratio by an ulp
RTOL_STEP = 1e-5
RTOL_KL = 1e-4
# errors after ten steps: requantization of the factors (Frobenius) and
# the bf16 flips (KL) compound in the factors, not in the error
RTOL_ERR = 1e-4
RANK = 6
COPY = Initialization.COPY_EXISTING
# 257 rows: 100-row panels leave a 57-row tail; 4096 is one short panel
BLOCKS = [4096, 100]


def _data(seed=0, n=257, m=311, density=0.06):
    """Half-star ratings (0.5 .. 5) at `density`, one empty row: no
    duplicate coordinates (densify_quantized sums duplicates in int8)."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < density,
                     rng.integers(1, 11, (n, m)) * 0.5, 0.0).astype(np.float32)
    dense[5, :] = 0.0
    jsp = js.from_dense(dense)
    W = rng.uniform(0.1, 1.0, (n, RANK)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (RANK, m)).astype(np.float32)
    return dense, jsp, sparse_from_nmftpu(jsp), W, H


def _quantized(row_multiple=1, dtype=np.float32):
    dense, jsp, tsp, W, H = _data()
    jc = JS.device_put_sparse(jsp, dtype=jnp.dtype(dtype))
    tc = TS.device_put_sparse(tsp, dtype=torch.float64 if dtype == np.float64
                              else torch.float32, device="cpu")
    return (dense, JD.densify_quantized(jc, row_multiple=row_multiple),
            TD.densify_quantized(tc, row_multiple=row_multiple), W, H)


def _rel(a, b):
    a = np.asarray(a.double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(*xs):
    return tuple(torch.tensor(np.asarray(x)) for x in xs)


# ---------------------------------------------------------------------------
# densify_quantized and the int8 metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row_multiple", [1, 64, 4096])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_densify_quantized_matches_nmftpu(row_multiple, dtype):
    dense, (jq, jscale), (tq, tscale), _, _ = _quantized(row_multiple, dtype)
    n_pad = -(-dense.shape[0] // row_multiple) * row_multiple
    assert tq.dtype == torch.int8 and tuple(tq.shape) == (n_pad, 311)
    assert tscale.dtype == torch.float32 and tscale.ndim == 0
    assert float(tscale) == float(jscale)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert not tq[dense.shape[0]:].any()
    # the symmetric grid: |v - scale q| <= scale / 2
    err = np.abs(tq[:dense.shape[0]].numpy() * float(tscale) - dense)
    assert err.max() <= float(tscale) / 2 * (1 + 1e-6)


def test_densify_quantized_keeps_the_clip_and_an_exact_grid():
    """Values on a grid of <= 255 levels are exact: 0/1 clicks quantize
    to 0/127 with scale 1/127; the padding adds nothing."""
    rows, cols = np.array([0, 2, 1]), np.array([1, 0, 3])
    vals = np.ones(3, np.float32)
    tq, tscale = TD.densify_quantized(TS.device_put_sparse(
        ts.SparseCOO(rows, cols, vals, (3, 4)), device="cpu"))
    jq, jscale = JD.densify_quantized(JS.device_put_sparse(
        js.SparseCOO(rows, cols, vals, (3, 4))))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(tscale) == float(jscale) == np.float32(1.0 / 127.0)
    assert tq.sum() == 3 * 127 and tq[0, 1] == tq[2, 0] == tq[1, 3] == 127


def test_int8_metrics_match_nmftpu():
    _, (jq, jscale), (tq, tscale), W, H = _quantized(row_multiple=1)
    want_sq = JD.sum_v_sq_int8_densified(jq, jscale, block_rows=100)
    got_sq = TD.sum_v_sq_int8_densified(tq, tscale, block_rows=100)
    assert _rel(got_sq, want_sq) < RTOL_STEP
    for block_rows in BLOCKS:
        want = JD.frobenius_error_int8_densified(jq, jscale, *_j(W, H),
                                                 want_sq,
                                                 block_rows=block_rows)
        got = TD.frobenius_error_int8_densified(tq, tscale, *_t(W, H),
                                                got_sq,
                                                block_rows=block_rows)
        assert _rel(got, want) < RTOL_STEP
        want = JD.kl_error_densified(jq, *_j(W, H), block_rows=block_rows,
                                     scale=jscale)
        got = TD.kl_error_densified(tq, *_t(W, H), block_rows=block_rows,
                                    scale=tscale)
        assert _rel(got, want) < RTOL_KL


def test_int8_frobenius_error_is_the_dequantized_error():
    """||scale Vq - WH||_F from the Gram trick against a direct float64
    computation on the dequantized V (the cross term rounds W to bf16)."""
    _, _, (tq, tscale), W, H = _quantized()
    svsq = TD.sum_v_sq_int8_densified(tq, tscale)
    got = float(TD.frobenius_error_int8_densified(tq, tscale, *_t(W, H),
                                                  svsq))
    Vd = tq.double().numpy() * float(tscale)
    want = np.linalg.norm(Vd - W.astype(np.float64) @ H)
    assert abs(got / want - 1) < 2**-9


# ---------------------------------------------------------------------------
# the KL path with the scale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_rows", BLOCKS)
def test_kl_numerators_with_the_scale_match_nmftpu(block_rows):
    _, (jq, jscale), (tq, tscale), W, H = _quantized()
    for jf, tf in ((JD._kl_numer_w_blocked, TD._kl_numer_w_blocked),
                   (JD._kl_numer_h_blocked, TD._kl_numer_h_blocked)):
        want = jf(jq, *_j(W, H), 1e-9, block_rows, jscale)
        got = tf(tq, *_t(W, H), 1e-9, block_rows, tscale)
        assert got.dtype == torch.float32 and _rel(got, want) < RTOL_STEP


@pytest.mark.parametrize("block_rows", BLOCKS)
@pytest.mark.parametrize("order", ["WH", "HW", "jacobi"])
def test_kl_update_with_the_scale_matches_nmftpu(block_rows, order):
    _, (jq, jscale), (tq, tscale), W, H = _quantized()
    want = JD.mu_update_kl_densified(jq, *_j(W, H), order=order,
                                     block_rows=block_rows, scale=jscale)
    got = TD.mu_update_kl_densified(tq, *_t(W, H), order=order,
                                    block_rows=block_rows, scale=tscale)
    for g, w in zip(got, want):
        assert _rel(g, w) < RTOL_STEP


def test_scaled_kl_update_is_the_dequantized_update():
    """Folding the scale after the contraction is exact: the int8 update
    equals the float32 densified KL update on V = scale Vq up to the
    float32 rounding of the scale (the ratio's bf16 rounding sees the
    same values scaled)."""
    _, _, (tq, tscale), W, H = _quantized()
    got = TD.mu_update_kl_densified(tq, *_t(W, H), scale=tscale)
    V = (tq.double() * float(tscale)).numpy()
    Wd, Hd = W.astype(np.float64), H.astype(np.float64)
    Wd = Wd * ((V / (Wd @ Hd + 1e-9)) @ Hd.T) / Hd.sum(1)[None, :]
    Hd = Hd * (Wd.T @ (V / (Wd @ Hd + 1e-9))) / Wd.sum(0)[:, None]
    assert _rel(got[0], Wd) < 2**-8 and _rel(got[1], Hd) < 2**-8


# ---------------------------------------------------------------------------
# the registry's dense int8 KL; the sparse densified int8 engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mu_style", ["gauss-seidel", "jacobi"])
def test_registry_dense_int8_kl_matches_nmftpu(monkeypatch, mu_style):
    """Dense int8 KL takes mu_update_kl_densified with quantize_v's
    scale, as in nmftpu, in both couplings."""
    from nmftpu.algorithms import registry as JR
    from nmftpu.config import NmfConfig as JConfig

    dense, _, _, W, H = _data()
    calls = []
    real = TD.mu_update_kl_densified
    monkeypatch.setattr(TD, "mu_update_kl_densified",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    kw = dict(rank=RANK, objective="kullback-leibler", v_storage="int8",
              mu_style=mu_style)
    jm, ju, _ = JR.build_dense_update(JConfig(**kw))
    tm, tu, _ = TR.build_dense_update(nt.NmfConfig(**kw))
    jV, tV = jnp.asarray(dense), torch.tensor(dense)
    want = ju(jV, jm(jV), *_j(W, H))
    got = tu(tV, tm(tV), *_t(W, H))
    assert len(calls) == 1 and calls[0]["scale"] is not None
    for g, w in zip(got, want):
        assert _rel(g, w) < RTOL_STEP


@pytest.mark.parametrize("objective,alpha,route", [
    ("frobenius", 0.0, (TLD, "mu_update_frobenius_int8x8")),
    ("kullback-leibler", 0.0, (TD, "mu_update_kl_densified")),
    ("frobenius", 40.0, (TD, "mu_update_frobenius_weighted_densified")),
])
def test_sparse_int8_routes(monkeypatch, objective, alpha, route):
    """The densified int8 engine's three MU routes; the Frobenius one
    reaches the one-sided int8 entries (on CPU tensors, their twins)."""
    calls, entries = [], []
    mod, name = route
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for entry in ("vht_int8", "wtv_int8"):
        real_e = getattr(DN, entry)
        monkeypatch.setattr(DN, entry, lambda *a, _e=entry, _r=real_e: (
            entries.append(_e) or _r(*a)))
    _, _, tsp, W, H = _data()
    plan = nt.prepare_sparse(tsp, nt.NmfConfig(
        rank=RANK, v_storage="int8", objective=objective,
        alpha_confidence=alpha), strategy="densified", device="cpu")
    Vq, scale = plan.operand
    assert Vq.dtype == torch.int8 and scale.dtype == torch.float32
    assert Vq.shape[0] % 4096 == 0 and plan.n_pad == Vq.shape[0]
    plan.run(nt.NmfConfig(rank=RANK, v_storage="int8", objective=objective,
                          alpha_confidence=alpha, init_method=COPY,
                          num_iterations=3), W0=W, H0=H)
    assert len(calls) == 3
    want = ["vht_int8", "wtv_int8"] * 3 if objective == "frobenius" \
        and alpha == 0.0 else []
    assert entries == want


@pytest.mark.parametrize("objective", ["frobenius", "kl"])
def test_sparse_int8_step_matches_nmftpu(objective):
    """One step on the densified int8 engine, factors against nmftpu's
    (whose Frobenius step runs mu_update_frobenius_int8x8 on the CPU)."""
    _, jsp, tsp, W, H = _data()
    kw = dict(init="copy", W0=W, H0=H, num_iterations=1, v_storage="int8",
              objective=objective, strategy="densified")
    want = nmftpu.nmf(jsp, RANK, **kw)
    got = nt.nmf(tsp, RANK, device="cpu", **kw)
    assert _rel(got.W, want.W) < RTOL_STEP
    assert _rel(got.H, want.H) < RTOL_STEP


@pytest.mark.parametrize("objective", ["frobenius", "kl"])
@pytest.mark.parametrize("engine", ["densified", "dense"])
def test_int8_nmf_matches_nmftpu(objective, engine):
    """Ten steps, on the errors and the KL divergence (auto resolves
    sparse int8 V to densified under the budget)."""
    dense, jsp, tsp, W, H = _data()
    kw = dict(init="copy", W0=W, H0=H, num_iterations=10, v_storage="int8",
              objective=objective)
    if engine == "dense" and objective == "frobenius":
        # nmftpu on the CPU runs dense int8 Frobenius as a bf16 dequantized
        # contraction; its int8 x int8 update is the reference there
        from nmftpu.kernels import quantized as JQ

        jVq, jsv = JQ.quantize_v(jnp.asarray(dense))
        Wj, Hj = jnp.asarray(W), jnp.asarray(H)
        for _ in range(10):
            Wj, Hj = JLD.mu_update_frobenius_int8x8(jVq, jsv, Wj, Hj)
        want_err = float(JLD.frobenius_error(jnp.asarray(dense), Wj, Hj))
        got = nt.nmf(dense, RANK, device="cpu", **kw)
        assert abs(got.frobenius_error / want_err - 1) < RTOL_ERR
        return
    if engine == "dense":
        want = nmftpu.nmf(dense, RANK, **kw)
        got = nt.nmf(dense, RANK, device="cpu", **kw)
    else:
        want = nmftpu.nmf(jsp, RANK, **kw)
        got = nt.nmf(tsp, RANK, device="cpu", **kw)
    assert got.num_iterations == want.num_iterations == 10
    assert abs(got.frobenius_error / want.frobenius_error - 1) < RTOL_ERR
    assert abs(got.rmsd / want.rmsd - 1) < RTOL_ERR
    if objective == "kl":
        assert abs(got.kl_error / want.kl_error - 1) < RTOL_ERR


def test_sparse_int8_auto_resolves_like_nmftpu():
    """auto: densified while n·m int8 bytes fit the budget (twice the
    bf16 reach), ell beyond."""
    from nmftpu.config import NmfConfig as JConfig
    from nmftpu_torch.convert import config_from_nmftpu

    host = ts.SparseCOO([0], [0], [1.0], (1, 1))
    for n, m in ((138_493, 26_744), (200_000, 30_000), (300_000, 30_000)):
        for objective in ("frobenius", "kullback-leibler"):
            for alpha in (0.0, 40.0):
                if alpha and objective != "frobenius":
                    continue
                jcfg = JConfig(rank=8, v_storage="int8", objective=objective,
                               alpha_confidence=alpha)
                want = JS._resolve_strategy(host, jcfg, "auto", n, m)
                got = TS._resolve_strategy(host, config_from_nmftpu(jcfg),
                                           "auto", n, m)
                assert got == want, (n, m, objective, alpha)
    assert TS._resolve_strategy(host, nt.NmfConfig(rank=8, v_storage="int8"),
                                "auto", 200_000, 30_000) == "densified"


# ---------------------------------------------------------------------------
# refusals, as nmftpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["ell", "scatter"])
def test_int8_on_ell_or_scatter_is_refused_like_nmftpu(strategy):
    _, jsp, tsp, _, _ = _data()
    kw = dict(num_iterations=1, v_storage="int8", strategy=strategy)
    with pytest.raises(ValueError, match="only honored by the 'densified'"):
        nmftpu.nmf(jsp, RANK, **kw)
    with pytest.raises(ValueError, match="only honored by the 'densified'"):
        nt.nmf(tsp, RANK, device="cpu", **kw)


@pytest.mark.parametrize("before,after", [("int8", "float32"),
                                          ("float32", "int8"),
                                          ("bfloat16", "int8")])
def test_a_plan_refuses_a_storage_change_like_nmftpu(before, after):
    """The densified layout is int8 or bf16 at prepare time; a run that
    asks for the other raises in both packages (float32 and bfloat16
    share the bf16 layout)."""
    from nmftpu.config import NmfConfig as JConfig

    _, jsp, tsp, W, H = _data()
    jplan = JS.prepare_sparse(jsp, JConfig(rank=RANK, v_storage=before),
                              strategy="densified")
    tplan = TS.prepare_sparse(tsp, nt.NmfConfig(rank=RANK, v_storage=before),
                              strategy="densified", device="cpu")
    with pytest.raises(ValueError, match="changes the densified layout"):
        jplan.run(JConfig(rank=RANK, v_storage=after), W0=W, H0=H)
    with pytest.raises(ValueError, match="changes the densified layout"):
        tplan.run(nt.NmfConfig(rank=RANK, v_storage=after), W0=W, H0=H)
    # the same storage runs
    tplan.run(nt.NmfConfig(rank=RANK, v_storage=before, init_method=COPY,
                           num_iterations=1), W0=W, H0=H)
