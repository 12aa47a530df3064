"""The port's fused MU kernels: their plain torch twins against nmftpu's
Pallas kernels (interpret mode on the CPU), quantize_v bit for bit, the
wrappers' checks, and the build. The CUDA kernels themselves are held
against their twins on the card by test_torch_kernels_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nmftpu.kernels import dense_mu as JK  # noqa: E402
from nmftpu.kernels import quantized as JQ  # noqa: E402
from nmftpu.linalg import dense as JD  # noqa: E402
from nmftpu_torch.convert import quantized_from_numpy  # noqa: E402
from nmftpu_torch.kernels import _build  # noqa: E402
from nmftpu_torch.kernels import dense_mu as K  # noqa: E402
from nmftpu_torch.kernels import quantized as Q  # noqa: E402

# float32 twin vs nmftpu's whole-K kernel, which interpret mode runs in
# float32 (dense_mu.py:57-59): only the summation order differs.
RTOL_F32 = 1e-5
# nmftpu's int8 kernel rounds W, H and G to bf16 even in interpret mode
# (quantized.py:52-62), the twin does not. One bf16 rounding is at most
# 2^-9 relative; the numerator carries one, the denominator two, so the
# quotient differs by at most 3 * 2^-9 = 5.9e-3. 1e-2 leaves 1.7x.
RTOL_BF16 = 1e-2

# n, m <= 256: nmftpu's wrappers take the whole-K branch there (checked
# by _whole_k below), the one that stays in float32 when interpreted.
SHAPES = [(64, 80, 8), (200, 256, 16), (256, 130, 5), (33, 47, 3)]


def _factors(shape, seed=0):
    n, m, r = shape
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.0, 5.0, (n, m)).astype(np.float32)
    W = rng.uniform(0.05, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.05, 1.0, (r, m)).astype(np.float32)
    return V, W, H


def _whole_k(length):
    """nmftpu's wrappers take the float32 whole-K branch for this
    contraction length (dense_mu.py:194-211 and :283-300)."""
    tile = min(512, JK._round_up(length, 128))
    padded = JK._round_up(length, tile)
    wk = min(256, JK._round_up(length, 128))
    return padded % wk == 0


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# plain twins vs nmftpu's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_h_update_twin_matches_nmftpu(shape):
    V, W, H = _factors(shape)
    assert _whole_k(shape[1])
    G = W.T @ W
    want = JK.h_update_fused(V, W, H, G, eps=1e-9, interpret=True)
    got = K.h_update_fused(*_t(V, W, H, G), eps=1e-9)
    assert got.shape == (shape[2], shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL_F32, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_w_update_twin_matches_nmftpu(shape):
    V, W, H = _factors(shape, seed=1)
    assert _whole_k(shape[0])
    G = H @ H.T
    want = JK.w_update_fused(V, W, H, G, eps=1e-9, interpret=True)
    got = K.w_update_fused(*_t(V, W, H, G), eps=1e-9)
    assert got.shape == (shape[0], shape[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL_F32, atol=0)


@pytest.mark.parametrize("order", ["WH", "HW"])
def test_fused_iteration_matches_nmftpu(order):
    V, W, H = _factors((150, 170, 8), seed=2)
    Wj, Hj = JK.mu_update_frobenius_fused(V, W, H, order=order,
                                          interpret=True)
    Wt, Ht = K.mu_update_frobenius_fused(*_t(V, W, H), order=order)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=RTOL_F32)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=RTOL_F32)


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("half", ["w", "h"])
def test_quantized_twins_match_nmftpu(half, shape):
    V, W, H = _factors(shape, seed=3)
    Vq_j, scale_j = JQ.quantize_v(jnp.asarray(V))
    Vq, scale = quantized_from_numpy(Vq_j, scale_j, device="cpu")
    if half == "w":
        G = H @ H.T
        want = JQ.w_update_fused_q(Vq_j, scale_j, jnp.asarray(H.T), W, G,
                                   eps=1e-9, interpret=True)
        got = Q.w_update_fused_q(Vq, scale, *_t(W, H, G), eps=1e-9)
    else:
        G = W.T @ W
        want = JQ.h_update_fused_q(Vq_j, scale_j, jnp.asarray(W.T), H, G,
                                   eps=1e-9, interpret=True)
        got = Q.h_update_fused_q(Vq, scale, *_t(W, H, G), eps=1e-9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL_BF16, atol=0)


@pytest.mark.parametrize("order", ["WH", "HW"])
def test_quantized_iteration_is_mu_on_dequantized_v(order):
    """The twin's only approximation is the quantization itself: it equals
    nmftpu's float32 MU on scale * Vq to float32 rounding."""
    V, W, H = _factors((120, 96, 8), seed=4)
    Vq, scale = Q.quantize_v(torch.tensor(V))
    V_dq = Vq.numpy().astype(np.float32) * scale.numpy()
    Wj, Hj = JD.mu_update_frobenius(jnp.asarray(V_dq), jnp.asarray(W),
                                    jnp.asarray(H), 1e-9, order)
    Wt, Ht = Q.mu_update_frobenius_q(Vq, scale, *_t(W, H), order=order)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=RTOL_F32)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=RTOL_F32)


# ---------------------------------------------------------------------------
# quantize_v
# ---------------------------------------------------------------------------


def _quant_inputs():
    rng = np.random.default_rng(5)
    stars = (np.arange(128).reshape(8, 16) % 13) * 0.5
    stars[0, 0] = 6.35
    half = np.full((4, 6), 127 * 0.5)
    # scale is exactly 0.5, so V / scale lands on k + 0.5: ties to even
    half[1:, :] = np.arange(18).reshape(3, 6) * 0.5 + 0.25
    return {
        "uniform": rng.uniform(0.0, 5.0, (50, 40)),
        "signed": rng.normal(size=(33, 70)),
        "ratings": stars,
        "ties": half,
        "zeros": np.zeros((3, 5)),
        "tall": rng.uniform(0.0, 1.0, (300, 7)),
    }


@pytest.mark.parametrize("name", list(_quant_inputs()))
def test_quantize_v_bit_equal(name, monkeypatch):
    V = _quant_inputs()[name].astype(np.float32)
    # small row blocks, so the chunked loop runs more than once
    monkeypatch.setattr(Q, "_QUANT_CHUNK", 64)
    Vq_j, scale_j = JQ.quantize_v(jnp.asarray(V))
    Vq, scale = Q.quantize_v(torch.tensor(V))
    assert Vq.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.ndim == 0
    np.testing.assert_array_equal(Vq.numpy(), np.asarray(Vq_j))
    sj = np.float32(np.asarray(scale_j))
    assert abs(np.float32(scale.numpy()) - sj) <= np.spacing(sj)


def test_round_half_to_even_in_both():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.tensor(x)).numpy(),
                                  np.asarray(jnp.round(x)))
    np.testing.assert_array_equal(np.asarray(jnp.round(x)),
                                  [0.0, 2.0, 2.0, -0.0, -2.0])


def test_quantized_from_numpy_rejects_wider_ints():
    with pytest.raises(TypeError):
        quantized_from_numpy(np.zeros((2, 2), np.int16), 1.0, device="cpu")


# ---------------------------------------------------------------------------
# wrappers: CPU route, checks, counts
# ---------------------------------------------------------------------------


def test_cpu_wrappers_run_the_twins_and_count_nothing():
    V, W, H = _t(*_factors((40, 30, 4), seed=6))
    Vq, scale = Q.quantize_v(V)
    counts = (dict(K.LAUNCHES), dict(Q.LAUNCHES))
    G = H @ H.T
    assert torch.equal(K.w_update_fused(V, W, H, G),
                       K.w_update_fused_plain(V, W, H, G))
    assert torch.equal(Q.w_update_fused_q(Vq, scale, W, H, G),
                       Q.w_update_fused_q_plain(Vq, scale, W, H, G))
    G = W.T @ W
    assert torch.equal(K.h_update_fused(V, W, H, G),
                       K.h_update_fused_plain(V, W, H, G))
    assert torch.equal(Q.h_update_fused_q(Vq, scale, W, H, G),
                       Q.h_update_fused_q_plain(Vq, scale, W, H, G))
    assert (dict(K.LAUNCHES), dict(Q.LAUNCHES)) == counts


@pytest.mark.parametrize("fn", [K.w_update_fused, K.h_update_fused])
def test_wrappers_reject_mismatched_shapes(fn):
    V, W, H = _t(*_factors((20, 30, 4)))
    with pytest.raises(ValueError):
        fn(V, W[:, :3], H, torch.ones(4, 4))
    with pytest.raises(ValueError):
        fn(V, W, H, torch.ones(3, 3))


def test_wrappers_reject_other_devices():
    V, W, H = _t(*_factors((20, 30, 4)))
    with pytest.raises(ValueError, match="unsupported device"):
        K.w_update_fused(V.to("meta"), W.to("meta"), H.to("meta"),
                         torch.ones(4, 4, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        K.h_update_fused(V.to("meta"), W, H, torch.ones(4, 4))


def _valid():
    V, W, H = _t(*_factors((20, 30, 4)))
    return V, W, H, H @ H.T


@pytest.mark.parametrize("bad,error", [
    ("v_dtype", TypeError), ("w_dtype", TypeError), ("g_dtype", TypeError),
    ("v_strided", ValueError), ("h_strided", ValueError),
    ("scale_shape", TypeError), ("shape", ValueError),
])
def test_cuda_operand_checks(bad, error):
    """The checks a CUDA launch passes first (run here on CPU tensors)."""
    V, W, H, G = _valid()
    scale = torch.tensor(0.5)
    v_dtype = torch.float32
    if bad == "v_dtype":
        V = V.double()
    elif bad == "w_dtype":
        W = W.double()
    elif bad == "g_dtype":
        G = G.half()
    elif bad == "v_strided":
        V = V.T.contiguous().T
    elif bad == "h_strided":
        H = H.T.contiguous().T
    elif bad == "scale_shape":
        V, v_dtype = Q.quantize_v(V)[0], torch.int8
        scale = torch.ones(2)
    elif bad == "shape":
        G = G[:3]
    with pytest.raises(error):
        K._check_cuda_operands("test", V, v_dtype, W, H, G, scale)


def test_cuda_operand_checks_accept_valid_operands():
    V, W, H, G = _valid()
    assert K._check_cuda_operands("test", V, torch.float32, W, H, G) == \
        (20, 30, 4)
    Vq, scale = Q.quantize_v(V)
    assert K._check_cuda_operands("test", Vq, torch.int8, W, H, G,
                                  scale) == (20, 30, 4)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_library_is_keyed_by_source_hash(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    (tmp_path / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
    assert _build.library_path().parent == _build.BUILD_DIR


def test_build_without_nvcc_raises_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_sources_declare_every_entry():
    text = "".join(p.read_text() for p in _build._sources())
    for entry in _build.ENTRIES:
        assert f"int {entry}(" in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_launch_error_is_raised(monkeypatch):
    class FakeLib:
        @staticmethod
        def nmftpu_error_string(code):
            return b"invalid configuration argument"

    monkeypatch.setattr(_build, "load", lambda: FakeLib)
    with pytest.raises(RuntimeError, match="invalid configuration"):
        _build.check(9, "w_update_fused")
    _build.check(0, "w_update_fused")


# ---------------------------------------------------------------------------
# the split-tf32 products of csrc/dense_mu.cu, modelled in torch
# ---------------------------------------------------------------------------

# one 16-deep stage of the kernel: two k8 products, each summed by the
# tensor cores into a fresh float32 accumulator, then added to the sum
STAGE, K8 = 16, 8


def _tf32(x):
    """Round float32 to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _rz32(x):
    """float64 -> float32 rounded toward zero: the tensor cores' sums are
    modelled as truncating (the worst case the kernel's design allows
    for)."""
    y = x.to(torch.float32)
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _tensor_core_product(pairs, depth, promote):
    """A · Bᵀ as the kernel issues it: per k8 step, each (A part, B part)
    of `pairs` is one product whose 8 terms are exact and whose sum with
    the accumulator is truncated to float32. With `promote`, a fresh
    accumulator per 16-deep stage, added to the sum with float32
    rounding; else one accumulator for the whole depth."""
    a0, b0 = pairs[0]
    total = torch.zeros(a0.shape[0], b0.shape[0], dtype=torch.float32)
    part = torch.zeros_like(total)
    for k0 in range(0, depth, K8):
        for a, b in pairs:
            exact = a[:, k0:k0 + K8].double() @ b[:, k0:k0 + K8].double().T
            part = _rz32(part.double() + exact)
        if promote and (k0 + K8) % STAGE == 0:
            total, part = total + part, torch.zeros_like(part)
    return total + part


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _max_rel(x, exact):
    return float(((x.double() - exact).abs() / exact.abs()).max())


@pytest.mark.parametrize("v_kind", ["float32", "int8"])
def test_split_tf32_stays_within_float32_error(v_kind):
    """At K = 4096 on nonnegative data (V about 0..5 as the kernel checks
    draw it, factors 0.05..1): the split products (3 for float32 V, 2 for
    int8 V, whose values are exact in tf32), promoted per stage, stay
    within 4x a float32 matmul's largest relative error against float64
    (the bound chip_smoke.py phases 3 and 5 hold the kernels to); one
    tf32 pass, and the split without promotion under truncating sums, do
    not. This is the argument behind the kernel's design."""
    rng = np.random.default_rng(11)
    K = 4096
    if v_kind == "float32":
        A = torch.tensor(rng.uniform(0.0, 5.0, (16, K)).astype(np.float32))
    else:
        A = torch.tensor(rng.integers(0, 128, (16, K)).astype(np.float32))
    B = torch.tensor(rng.uniform(0.05, 1.0, (16, K)).astype(np.float32))
    exact = A.double() @ B.double().T
    f32 = _max_rel(A @ B.T, exact)
    (ah, al), (bh, bl) = _split(A), _split(B)
    assert torch.equal(ah + al, A) or v_kind == "float32"
    pairs = ([(ah, bh), (ah, bl)] if v_kind == "int8"
             else [(al, bh), (ah, bl), (ah, bh)])
    split = _max_rel(_tensor_core_product(pairs, K, promote=True), exact)
    chained = _max_rel(_tensor_core_product(pairs, K, promote=False), exact)
    one_pass = _max_rel(_tensor_core_product([(ah, bh)], K, promote=True),
                        exact)
    assert split <= 4 * f32, (split, f32)
    assert one_pass > 4 * f32, (one_pass, f32)
    assert chained > 4 * f32, (chained, f32)


def test_tf32_rounding_model():
    """The model's rounding: 10 mantissa bits kept, ties away from zero,
    and hi + lo reproduces x to 2^-21."""
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-12, -(1.0 + 2.0**-11),
                      1.0 + 2.0**-12], dtype=torch.float32)
    np.testing.assert_array_equal(
        _tf32(x).numpy(), np.array([1.0 + 2.0**-10, 1.0 + 2.0**-10,
                                    -(1.0 + 2.0**-10), 1.0], np.float32))
    v = torch.tensor(np.random.default_rng(3).uniform(0.01, 5.0, 1000)
                     .astype(np.float32))
    hi, lo = _split(v)
    assert float(((hi.double() + lo.double() - v.double()).abs()
                  / v.double()).max()) <= 2.0**-21


@pytest.mark.parametrize("rows,depth,r,want", [
    (4096, 4096, 256, 2),          # 64 blocks: two splits fill one wave
    (26_744, 138_493, 64, 17),     # ML-20M H step: 8,656 stages
    (138_493, 26_744, 64, 4),      # ML-20M W step: 1,672 stages
    (2048, 2048, 512, 2),          # 64 blocks, two factor chunks
    (4096, 4096, 300, 1),          # two factor chunks, 128 blocks
    (64, 16, 8, 1),                # one stage: nothing to split
])
def test_mu_splits(rows, depth, r, want):
    assert K.mu_splits(rows, depth, r) == want


@pytest.mark.parametrize("rows,depth,r", [(943, 1682, 32), (1, 5000, 300),
                                          (1000, 1500, 37), (70, 4099, 130),
                                          (5, 1_000_000, 8)])
def test_mu_splits_are_never_empty(rows, depth, r):
    """The kernel refuses a split with no stage: every split the rule
    picks holds one, at least 16 when split, at most MU_MAX_STAGES."""
    s = K.mu_splits(rows, depth, r)
    stages = -(-depth // K.MU_STAGE)
    per = -(-stages // s)
    assert -(-stages // per) == s
    assert (s == 1 or per >= 16) and per <= K.MU_MAX_STAGES
