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
