"""Jacobi MU, dense KL and the int8 x int8 MU path in the port against
nmftpu on the same numpy inputs: the update rules, the int8 numerators
(bit for bit), the kernel twins against nmftpu's Pallas kernels in
interpret mode, the registry's routes and what still raises, and the
slice through nmftpu_torch.nmf.

Tolerances: float64 to 1e-10; float32 one step to 1e-5 relative (float32
sums of at most a few hundred terms in two orders); integer contractions
exactly (atol 0)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu.kernels import dense_mu as JK  # noqa: E402
from nmftpu.kernels import dual_numer as JDN  # noqa: E402
from nmftpu.linalg import dense as JD  # noqa: E402
from nmftpu_torch import densified as DF  # noqa: E402
from nmftpu_torch.algorithms import build_dense_update  # noqa: E402
from nmftpu_torch.kernels import dense_mu as K  # noqa: E402
from nmftpu_torch.kernels import dual_numer as DN  # noqa: E402
from nmftpu_torch.kernels import quantized as Q  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = {np.float64: 1e-10, np.float32: 1e-5}
KL = "kullback-leibler"


def _inputs(shape, dtype, seed=0):
    n, m, r = shape
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.0, 5.0, (n, m)).astype(dtype)
    W = rng.uniform(0.05, 1.0, (n, r)).astype(dtype)
    H = rng.uniform(0.05, 1.0, (r, m)).astype(dtype)
    return V, W, H


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL[dtype], atol=0)


# ---------------------------------------------------------------------------
# Jacobi coupling and dense KL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jacobi_fro_apply_matches_nmftpu(dtype):
    V, W, H = _inputs((50, 40, 6), dtype, seed=1)
    pieces = (V @ H.T, W.T @ V, W.T @ W, H @ H.T)
    want = JD._jacobi_fro_apply(*_j(W, H, *pieces), 1e-9)
    got = TD._jacobi_fro_apply(*_t(W, H, *pieces), 1e-9)
    for a, b in zip(got, want):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fn", ["mu_update_frobenius", "mu_update_kl"])
@pytest.mark.parametrize("order", ["WH", "HW", "jacobi"])
def test_updates_match_nmftpu(fn, order, dtype):
    V, W, H = _inputs((70, 90, 8), dtype, seed=2)
    Wj, Hj = _j(W, H)
    Wt, Ht = _t(W, H)
    for _ in range(3):
        Wj, Hj = getattr(JD, fn)(jnp.asarray(V), Wj, Hj, 1e-9, order)
        Wt, Ht = getattr(TD, fn)(torch.tensor(V), Wt, Ht, 1e-9, order)
    _close(Wt, Wj, dtype)
    _close(Ht, Hj, dtype)


@pytest.mark.parametrize("fn", ["mu_update_w_kl", "mu_update_h_kl"])
def test_kl_half_steps_match_nmftpu(fn):
    V, W, H = _inputs((40, 56, 4), np.float64, seed=3)
    want = getattr(JD, fn)(*_j(V, W, H), 1e-9)
    got = getattr(TD, fn)(*_t(V, W, H), 1e-9)
    _close(got, want, np.float64)


@pytest.mark.parametrize("order", ["WH", "HW", "jacobi"])
def test_bf16v_matches_nmftpu(order):
    """bf16 operands, float32 products and sums on both sides."""
    V, W, H = _inputs((96, 120, 8), np.float32, seed=4)
    want = JD.mu_update_frobenius_bf16v(
        jnp.asarray(V).astype(jnp.bfloat16), *_j(W, H), 1e-9, order)
    got = TD.mu_update_frobenius_bf16v(
        torch.tensor(V).to(torch.bfloat16), *_t(W, H), 1e-9, order)
    for a, b in zip(got, want):
        _close(a, b, np.float32)


@pytest.mark.parametrize("order", ["WH", "HW", "jacobi"])
def test_kl_densified_matches_nmftpu(order):
    """The bf16-stored dense KL route, over row panels of 32 rows so the
    panel loop runs more than once."""
    from nmftpu import densified as JDF

    V, W, H = _inputs((100, 64, 6), np.float32, seed=5)
    V = np.round(V * 2) / 2                    # half stars: exact in bf16
    want = JDF.mu_update_kl_densified(jnp.asarray(V).astype(jnp.bfloat16),
                                      *_j(W, H), eps=1e-9, order=order,
                                      block_rows=32)
    got = DF.mu_update_kl_densified(torch.tensor(V).to(torch.bfloat16),
                                    *_t(W, H), eps=1e-9, order=order,
                                    block_rows=32)
    for a, b in zip(got, want):
        _close(a, b, np.float32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kl_error_matches_nmftpu(dtype):
    V, W, H = _inputs((60, 70, 5), dtype, seed=6)
    V[V < 1.0] = 0.0                           # zeros take the +WH branch
    want = float(JD.kl_error(*_j(V, W, H)))
    got = TD.kl_error(*_t(V, W, H))
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL[dtype])


def test_apply_order_raises_for_jacobi():
    """jacobi never routes through _apply_order; anything but WH/HW there
    is a bug."""
    with pytest.raises(NotImplementedError):
        TD._apply_order(None, None, None, None, "jacobi")


# ---------------------------------------------------------------------------
# int8 x int8
# ---------------------------------------------------------------------------


def _quant_cases():
    rng = np.random.default_rng(7)
    ties = np.arange(24, dtype=np.float64).reshape(4, 6) * 0.5 + 0.25
    ties[0, 0] = 63.5                          # scale 0.5: k + 0.5 ties
    return {
        "uniform": rng.uniform(0.0, 5.0, (50, 40)),
        "signed": rng.normal(size=(33, 70)),
        "ties": ties,
        "zeros": np.zeros((3, 5)),
    }


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(_quant_cases()))
def test_quantize_sym_bit_equal(name, dtype):
    X = _quant_cases()[name].astype(dtype)
    sj, Xj = JD.quantize_sym(jnp.asarray(X))
    st, Xt = TD.quantize_sym(torch.tensor(X))
    assert Xt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    assert st.numpy() == np.asarray(sj)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(_quant_cases()))
def test_quantize_sym_t_is_the_transposed_quantize_sym(name, dtype):
    """The int8 kernels take Wqᵀ (r, n) contiguous: quantize_sym_t emits it
    directly, with quantize_sym's scale and integers bit for bit."""
    X = torch.tensor(_quant_cases()[name].astype(dtype))
    s, Xq = TD.quantize_sym(X)
    st, XqT = TD.quantize_sym_t(X)
    assert XqT.is_contiguous() and XqT.shape == (X.shape[1], X.shape[0])
    assert XqT.dtype == torch.int8 and torch.equal(XqT, Xq.T)
    assert torch.equal(st, s)


def _int8_problem(shape, seed):
    V, W, H = _inputs(shape, np.float32, seed)
    sv, Vq = JD.quantize_sym(jnp.asarray(V))
    return (Vq, sv), _t(Vq, sv), W, H


@pytest.mark.parametrize("shape", [(64, 80, 8), (130, 97, 37), (5, 3, 2)])
def test_rhs_int8_match_nmftpu_exactly(shape):
    (Vq, sv), (Vqt, svt), W, H = _int8_problem(shape, seed=shape[2])
    np.testing.assert_array_equal(
        TD._rhs_vht_int8(Vqt, svt, torch.tensor(H)).numpy(),
        np.asarray(JD._rhs_vht_int8(Vq, sv, jnp.asarray(H))))
    np.testing.assert_array_equal(
        TD._rhs_wtv_int8(Vqt, svt, torch.tensor(W)).numpy(),
        np.asarray(JD._rhs_wtv_int8(Vq, sv, jnp.asarray(W))))


@pytest.mark.parametrize("order", ["WH", "HW", "jacobi"])
@pytest.mark.parametrize("use_fused", [False, True])
def test_int8x8_step_matches_nmftpu(order, use_fused):
    """nmftpu's use_fused=False (its fused kernel is TPU-only and gives the
    same integers): one step to float32 roundoff."""
    (Vq, sv), (Vqt, svt), W, H = _int8_problem((120, 96, 8), seed=8)
    want = JD.mu_update_frobenius_int8x8(Vq, sv, *_j(W, H), order=order)
    got = TD.mu_update_frobenius_int8x8(Vqt, svt, *_t(W, H), order=order,
                                        use_fused=use_fused)
    for a, b in zip(got, want):
        _close(a, b, np.float32)


def test_fused_and_unfused_jacobi_give_the_same_step():
    _, (Vqt, svt), W, H = _int8_problem((90, 70, 6), seed=9)
    a = TD.mu_update_frobenius_int8x8(Vqt, svt, *_t(W, H), order="jacobi",
                                      use_fused=True)
    b = TD.mu_update_frobenius_int8x8(Vqt, svt, *_t(W, H), order="jacobi")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", [(256, 1024, 128), (128, 512, 37)])
def test_dual_twin_matches_nmftpu_kernel(shape):
    """dual_numerators_int8_plain against nmftpu's Pallas kernel in
    interpret mode, atol 0 (its tiles must divide n and m)."""
    n, m, r = shape
    rng = np.random.default_rng(10)
    V = rng.uniform(0.0, 2.0, (n, m)).astype(np.float32)
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    sv, Vq = JD.quantize_sym(jnp.asarray(V))
    want = JDN.dual_numerators_int8(Vq, sv, W, H, bn=128, bm=512,
                                    interpret=True)
    got = DN.dual_numerators_int8_plain(*_t(Vq, sv, W, H))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int32_sums_wrap_like_xla():
    """Past 2**31 the int32 sum wraps modulo 2**32, in nmftpu's XLA
    contraction and in the twin (and the kernel's int32 accumulators)."""
    k = 140_000                                # > 2**31 / 127**2
    Vq = np.full((1, k), 127, np.int8)
    Xq = np.full((1, k), 127, np.int8)
    want = np.asarray(jnp.dot(jnp.asarray(Vq), jnp.asarray(Xq).T,
                              preferred_element_type=jnp.int32))
    got = DN.vht_int8_plain(*_t(Vq, Xq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 0]) == 127 * 127 * k - 2**32


def test_int8_wrappers_on_cpu_run_the_twins_and_count_nothing():
    _, (Vqt, _), W, H = _int8_problem((40, 30, 4), seed=11)
    Wq, Hq = TD.quantize_sym(torch.tensor(W))[1], \
        TD.quantize_sym(torch.tensor(H))[1]
    WqT = TD.quantize_sym_t(torch.tensor(W))[1]
    before = dict(DN.LAUNCHES)
    assert torch.equal(DN.vht_int8(Vqt, Hq), DN.vht_int8_plain(Vqt, Hq))
    assert torch.equal(DN.wtv_int8(Vqt, WqT), DN.wtv_int8_plain(Vqt, WqT))
    assert torch.equal(DN.wtv_int8(Vqt, WqT),
                       (Wq.double().T @ Vqt.double()).to(torch.int32))
    for a, b in zip(DN.dual_int8(Vqt, WqT, Hq),
                    DN.dual_int8_plain(Vqt, WqT, Hq)):
        assert torch.equal(a, b)
    assert DN.LAUNCHES == before


@pytest.mark.parametrize("call", ["wtv_int8", "dual_int8"])
def test_int8_entries_take_the_transposed_factor(call):
    """The W side comes as Wqᵀ (r, n): Wq (n, r) is refused when n != r."""
    _, (Vqt, _), W, H = _int8_problem((40, 30, 4), seed=13)
    Wq, Hq = TD.quantize_sym(torch.tensor(W))[1], \
        TD.quantize_sym(torch.tensor(H))[1]
    args = (Vqt, Wq) if call == "wtv_int8" else (Vqt, Wq, Hq)
    with pytest.raises(ValueError, match="expected Vq"):
        getattr(DN, call)(*args)


@pytest.mark.parametrize("bad", ["dtype", "strided", "shape"])
def test_int8_wrapper_checks(bad):
    _, (Vqt, _), W, H = _int8_problem((40, 30, 4), seed=12)
    Hq = TD.quantize_sym(torch.tensor(H))[1]
    if bad == "shape":
        with pytest.raises(ValueError, match="expected Vq"):
            DN.vht_int8(Vqt, Hq[:, :5])
        return
    if bad == "dtype":
        with pytest.raises(TypeError, match="int8"):
            DN._check_cuda_operands("vht_int8", Vqt, Hq.float())
    else:
        with pytest.raises(ValueError, match="contiguous"):
            DN._check_cuda_operands("vht_int8", Vqt.T.contiguous().T, Hq)


# ---------------------------------------------------------------------------
# fused_multiply_divide
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 80), (1000, 37), (7,)])
def test_fused_multiply_divide_matches_nmftpu(shape):
    rng = np.random.default_rng(13)
    X, N, Dn = (rng.uniform(0.1, 2.0, shape).astype(np.float32)
                for _ in range(3))
    want = JK.fused_multiply_divide(*_j(X, N, Dn), eps=1e-9, interpret=True)
    got = K.fused_multiply_divide(*_t(X, N, Dn), eps=1e-9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_multiply_divide_checks():
    X = torch.rand(4, 5)
    before = dict(K.LAUNCHES)
    assert torch.equal(K.fused_multiply_divide(X, X, X),
                       K.fused_multiply_divide_plain(X, X, X))
    assert K.LAUNCHES == before
    with pytest.raises(ValueError, match="one shape"):
        K.fused_multiply_divide(X, X[:2], X)


# ---------------------------------------------------------------------------
# registry routes and rejections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs,route,kwargs", [
    ({"mu_style": "jacobi"}, (TD, "mu_update_frobenius"),
     {"order": "jacobi"}),
    ({"mu_style": "jacobi", "v_storage": "bfloat16"},
     (TD, "mu_update_frobenius_bf16v"), {"order": "jacobi"}),
    ({"objective": KL}, (TD, "mu_update_kl"), {"order": "WH"}),
    ({"objective": KL, "mu_style": "jacobi"}, (TD, "mu_update_kl"),
     {"order": "jacobi"}),
    ({"objective": KL, "update_order": "HW"}, (TD, "mu_update_kl"),
     {"order": "HW"}),
    ({"objective": KL, "v_storage": "bfloat16", "mu_style": "jacobi"},
     (DF, "mu_update_kl_densified"), {"order": "jacobi"}),
    ({"objective": KL, "v_storage": "bfloat16"},
     (DF, "mu_update_kl_densified"), {"order": "WH"}),
    ({"v_storage": "int8"}, (TD, "mu_update_frobenius_int8x8"),
     {"order": "WH", "use_fused": False}),
    ({"v_storage": "int8", "update_order": "HW"},
     (TD, "mu_update_frobenius_int8x8"), {"order": "HW", "use_fused": False}),
    ({"v_storage": "int8", "mu_style": "jacobi"},
     (TD, "mu_update_frobenius_int8x8"),
     {"order": "jacobi", "use_fused": False}),
    ({"v_storage": "int8", "mu_style": "jacobi", "use_pallas": True},
     (TD, "mu_update_frobenius_int8x8"),
     {"order": "jacobi", "use_fused": True}),
    ({"v_storage": "int8", "use_pallas": True},
     (Q, "mu_update_frobenius_q"), {"order": "WH"}),
])
def test_registry_routes(monkeypatch, knobs, route, kwargs):
    mod, name = route
    called = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: called.append(k)
                        or real(*a, **k))
    make_aux, update, effective_h = build_dense_update(
        nt.NmfConfig(rank=2, **knobs))
    V = torch.rand(6, 5) + 0.1
    aux = make_aux(V)
    W, H = update(V, aux, torch.rand(6, 2) + 0.1, torch.rand(2, 5) + 0.1)
    assert len(called) == 1
    assert {k: called[0][k] for k in kwargs} == kwargs
    assert W.shape == (6, 2) and H.shape == (2, 5)
    assert effective_h(aux, H) is H


def test_jacobi_with_an_explicit_hw_order_is_refused():
    """nmftpu lets mu_style='jacobi' override update_order='HW' silently
    (nmftpu/algorithms/registry.py:32-36); the port refuses the pair.
    The config itself stays field for field nmftpu's and accepts it."""
    cfg = nt.NmfConfig(rank=2, mu_style="jacobi", update_order="HW")
    with pytest.raises(ValueError, match="update_order='HW'"):
        build_dense_update(cfg)
    rng = np.random.default_rng(14)
    V = rng.uniform(0.1, 1.0, (12, 9)).astype(np.float32)
    assert nmftpu.nmf(V, 2, num_iterations=2, mu_style="jacobi",
                      update_order="HW").num_iterations == 2
    with pytest.raises(ValueError, match="update_order"):
        nt.nmf(V, 2, num_iterations=2, mu_style="jacobi", update_order="HW",
               device="cpu")


@pytest.mark.parametrize("knobs,where", [
    ({"objective": KL, "v_storage": "int8"}, "slice 3 item 9"),
    ({"objective": KL, "v_storage": "int8", "mu_style": "jacobi"},
     "slice 3 item 9"),
    ({"algorithm": "gdcls"}, "slice 4b"),
    ({"algorithm": "nsnmf", "objective": KL}, "slice 4b"),
    ({"objective": "beta-divergence", "beta": 1.5}, "slice 4b"),
])
def test_what_still_raises(knobs, where):
    with pytest.raises(NotImplementedError, match=where):
        build_dense_update(nt.NmfConfig(rank=2, **knobs))


# ---------------------------------------------------------------------------
# the slice through nmf
# ---------------------------------------------------------------------------


def _fixture_matrix():
    rows = np.loadtxt(os.path.join(REPO, "tests", "fixtures",
                                   "ml100k_u.data")).astype(np.int64)
    V = np.zeros((rows[:, 0].max(), rows[:, 1].max()), np.float32)
    V[rows[:, 0] - 1, rows[:, 1] - 1] = rows[:, 2]
    return V


V_FIX = _fixture_matrix()
RANK = 8
_rng = np.random.default_rng(7)
W0 = _rng.uniform(0.1, 1.0, (V_FIX.shape[0], RANK)).astype(np.float32)
H0 = _rng.uniform(0.1, 1.0, (RANK, V_FIX.shape[1])).astype(np.float32)


@pytest.mark.parametrize("objective", ["frobenius", "kl"])
@pytest.mark.parametrize("v_storage", ["float32", "bfloat16"])
def test_slice_jacobi_matches_nmftpu(objective, v_storage):
    """nmf(..., mu_style="jacobi") against nmftpu.nmf from the same
    W0/H0: stats rows, errors and D_KL to 1e-4 relative (float32 roundoff
    over 20 steps), factors to 1e-3 of their max. With bf16 V both
    packages round the factors to bf16 in every contraction, and a float32
    ulp of reordering can flip one rounding (2^-9 relative) that later
    steps carry: 1e-3 on the errors and 1e-2 of max on the factors there
    (measured 1.2e-4 and 7e-3)."""
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=20,
              check_interval=5, objective=objective, mu_style="jacobi",
              v_storage=v_storage)
    j = nmftpu.nmf(V_FIX, RANK, **kw)
    t = nt.nmf(V_FIX, RANK, device="cpu", **kw)
    assert t.num_iterations == j.num_iterations == 20
    np.testing.assert_array_equal(t.stats.iterations, j.stats.iterations)
    rtol = 1e-4 if v_storage == "float32" else 1e-3
    np.testing.assert_allclose(t.stats.errors, j.stats.errors, rtol=rtol)
    if objective == "kl":
        np.testing.assert_allclose(t.kl_error, j.kl_error, rtol=rtol)
    else:
        assert t.kl_error is None
    for a, b in ((t.W, j.W), (t.H, j.H)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=10 * rtol * np.abs(b).max())


def test_slice_kl_gauss_seidel_matches_nmftpu():
    """Dense KL (float32 V) with two restarts: best-of-N compares D_KL in
    both packages."""
    kw = dict(num_iterations=15, check_interval=5, objective="kl",
              num_runs=2, seed=3)
    rng = np.random.default_rng(15)
    V = rng.uniform(0.0, 3.0, (60, 50)).astype(np.float32)
    Wc = rng.uniform(0.1, 1.0, (60, 4)).astype(np.float32)
    Hc = rng.uniform(0.1, 1.0, (4, 50)).astype(np.float32)
    j = nmftpu.nmf(V, 4, init="copy", W0=Wc, H0=Hc, **kw)
    t = nt.nmf(V, 4, init="copy", W0=Wc, H0=Hc, device="cpu", **kw)
    np.testing.assert_allclose(t.kl_error, j.kl_error, rtol=1e-5)
    np.testing.assert_allclose(t.run_errors, j.run_errors, rtol=1e-5)
    np.testing.assert_allclose(t.stats.errors, j.stats.errors, rtol=1e-5)


@pytest.mark.parametrize("knobs", [
    {},
    {"mu_style": "jacobi"},
    {"mu_style": "jacobi", "use_pallas": True},
    {"update_order": "HW"},
])
def test_slice_int8_matches_nmftpu_int8x8(knobs):
    """int8 V through nmf against a loop of nmftpu's
    mu_update_frobenius_int8x8 from the same W0/H0 (nmftpu.nmf on the CPU
    dequantizes to bf16 instead). Multi-step int8 runs are compared on
    errors, to 1e-3 relative: a float32 roundoff difference can move a
    requantized factor entry by one step (1/127 of its scale)."""
    iters = 12
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=iters,
              check_interval=4, v_storage="int8", **knobs)
    t = nt.nmf(V_FIX, RANK, device="cpu", **kw)
    order = ("jacobi" if knobs.get("mu_style") == "jacobi"
             else knobs.get("update_order", "WH"))
    sv, Vq = JD.quantize_sym(jnp.asarray(V_FIX))
    Wj, Hj = _j(W0, H0)
    errs = []
    for it in range(1, iters + 1):
        Wj, Hj = JD.mu_update_frobenius_int8x8(Vq, sv, Wj, Hj, order=order)
        if it % 4 == 0:
            errs.append(float(JD.frobenius_error(jnp.asarray(V_FIX), Wj,
                                                 Hj)))
    np.testing.assert_allclose(t.stats.errors, errs, rtol=1e-3)
    assert errs[-1] < errs[0]


def test_jacobi_tracks_gauss_seidel():
    """The coupling's point (tests/test_jacobi.py): at an equal number of
    iterations the error is within 1.10x of Gauss–Seidel's."""
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=60,
              check_interval=20, device="cpu")
    for knobs in ({}, {"v_storage": "int8"}, {"objective": "kl"}):
        gs = nt.nmf(V_FIX, RANK, **kw, **knobs)
        ja = nt.nmf(V_FIX, RANK, mu_style="jacobi", **kw, **knobs)
        metric = "kl_error" if knobs.get("objective") else "frobenius_error"
        assert getattr(ja, metric) <= getattr(gs, metric) * 1.10, knobs
