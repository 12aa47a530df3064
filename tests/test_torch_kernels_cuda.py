"""The port's CUDA kernels on the card: each against its plain torch twin,
and the fused paths end to end against the plain path. Every test here
is marked `cuda` and skips without a CUDA device. This file imports no
jax, so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch.kernels import dense_mu as K  # noqa: E402
from nmftpu_torch.kernels import quantized as Q  # noqa: E402

pytestmark = pytest.mark.cuda

# float32 sums of up to K terms in two orders differ by ~sqrt(K) * 2^-24
# relative on nonnegative data; the quotient adds two such errors
RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _factors(shape, dev, seed=0):
    n, m, r = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    V = 5.0 * torch.rand(n, m, generator=g, device=dev)
    W = torch.rand(n, r, generator=g, device=dev) + 0.05
    H = torch.rand(r, m, generator=g, device=dev) + 0.05
    return V, W, H


SHAPES = [(943, 1682, 32), (1000, 1500, 37), (64, 65, 1), (70, 3, 130)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("v_kind", ["float32", "int8"])
def test_kernels_match_twins(dev, shape, v_kind):
    V, W, H = _factors(shape, dev)
    Gw, Gh = H @ H.T, W.T @ W
    if v_kind == "float32":
        counts, before = K.LAUNCHES, dict(K.LAUNCHES)
        pairs = [(K.w_update_fused(V, W, H, Gw),
                  K.w_update_fused_plain(V, W, H, Gw)),
                 (K.h_update_fused(V, W, H, Gh),
                  K.h_update_fused_plain(V, W, H, Gh))]
    else:
        Vq, scale = Q.quantize_v(V)
        counts, before = Q.LAUNCHES, dict(Q.LAUNCHES)
        pairs = [(Q.w_update_fused_q(Vq, scale, W, H, Gw),
                  Q.w_update_fused_q_plain(Vq, scale, W, H, Gw)),
                 (Q.h_update_fused_q(Vq, scale, W, H, Gh),
                  Q.h_update_fused_q_plain(Vq, scale, W, H, Gh))]
    torch.cuda.synchronize()
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=0)
    assert all(counts[k] == before[k] + 1 for k in counts)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    V, W, H = _factors((64, 80, 8), dev)
    G = H @ H.T
    with pytest.raises(ValueError, match="contiguous"):
        K.w_update_fused(V.T.contiguous().T, W, H, G)
    with pytest.raises(TypeError):
        K.w_update_fused(V.double(), W, H, G)
    with pytest.raises(ValueError, match="different devices"):
        K.w_update_fused(V.cpu(), W, H, G)


@pytest.mark.parametrize("knobs", [{"use_pallas": True},
                                   {"use_pallas": True, "v_storage": "int8"}])
def test_fused_paths_match_the_plain_path(dev, knobs):
    """20 MU iterations through nmf(): kernels vs torch.matmul on the same
    V (the dequantized one for int8), same W0/H0."""
    V, W0, H0 = _factors((300, 257, 12), dev, seed=1)
    V_plain = V
    if knobs.get("v_storage") == "int8":
        Vq, scale = Q.quantize_v(V)
        V_plain = Vq.float() * scale
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=20, check_interval=5)
    got = nt.nmf(V, 12, **kw, **knobs)
    want = nt.nmf(V_plain, 12, **kw, use_pallas=False)
    assert got.W.device.type == "cuda"
    torch.testing.assert_close(got.W, want.W, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(got.H, want.H, rtol=1e-3, atol=1e-6)
