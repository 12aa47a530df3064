"""The port's CUDA kernels on the card: each against its plain torch twin,
and the fused paths end to end against the plain path. Every test here
is marked `cuda` and skips without a CUDA device. This file imports no
jax, so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch.kernels import count_above as CA  # noqa: E402
from nmftpu_torch.kernels import dense_mu as K  # noqa: E402
from nmftpu_torch.kernels import mips_reservoir as MR  # noqa: E402
from nmftpu_torch.kernels import quantized as Q  # noqa: E402
from nmftpu_torch.kernels import sparse_ell_kernel as SEK  # noqa: E402

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


# ---------------------------------------------------------------------------
# serving kernels: reservoir scan and count-above
# ---------------------------------------------------------------------------

# float32 sums of r <= 256 products in two orders: ~sqrt(r) * 2^-24
SCAN_RTOL = 1e-5
SCAN_SHAPES = [(37, 37, 10007, 1024), (70, 8, 5000, 128), (1, 3, 100, 64),
               (130, 256, 70000, 4096)]


def _table(dev, r, m, dtype, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    H = torch.rand(r, m, generator=g, device=dev)
    if dtype == torch.int8:
        return (H * 127).round().to(torch.int8)
    return H.to(dtype)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_reservoir_scan_matches_twin(dev, shape, dtype):
    b, r, m, slots = shape
    g = torch.Generator(device=dev).manual_seed(b + m)
    Wq = torch.rand(b, r, generator=g, device=dev)
    H = _table(dev, r, m, dtype)
    before = MR.LAUNCHES["reservoir_scan"]
    s, i = MR.reservoir_scan(Wq, H, m, slots)
    s0, i0 = MR.reservoir_scan_plain(Wq, H, m, slots)
    torch.cuda.synchronize()
    assert MR.LAUNCHES["reservoir_scan"] == before + 1
    torch.testing.assert_close(s, s0, rtol=SCAN_RTOL, atol=0)
    # ids may differ only where the two competing items' scores (float64
    # at the kernel's operand values) lie within the tolerance
    q, c = ((i != i0) & torch.isfinite(s0)).nonzero(as_tuple=True)
    qd = Wq.to(torch.bfloat16).double()[q]
    got = (qd * H[:, i[q, c].long()].double().T).sum(1)
    want = (qd * H[:, i0[q, c].long()].double().T).sum(1)
    assert bool(((got - want).abs() <= SCAN_RTOL * want.abs()).all())


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("kind", ["bfloat16", "int8_vector"])
def test_count_above_matches_twin(dev, shape, kind):
    b, r, m, _ = shape
    g = torch.Generator(device=dev).manual_seed(b + r)
    Wq = torch.rand(b, r, generator=g, device=dev)
    if kind == "bfloat16":
        H, hs = _table(dev, r, m, torch.bfloat16), None
    else:
        H = _table(dev, r, m, torch.int8)
        hs = torch.rand(r, generator=g, device=dev) + 0.01
    theta = torch.rand(b, generator=g, device=dev) * r * 0.3
    theta[0] = float("-inf")
    before = CA.LAUNCHES["count_above"]
    got = CA.count_above_fused(Wq, H, theta, h_scale=hs)
    want = CA.count_above_fused_plain(Wq, H, theta, h_scale=hs)
    torch.cuda.synchronize()
    assert CA.LAUNCHES["count_above"] == before + 1
    assert int(got[0]) == m
    # scores within rounding of theta may fall either way
    q = (Wq * hs if hs is not None else Wq).to(torch.bfloat16).double()
    full = q @ H.double()
    near = ((full - theta[:, None].double()).abs()
            <= SCAN_RTOL * full.abs()).sum(1)
    assert bool(((got - want).abs() <= near).all())


def test_serving_wrappers_reject_what_the_kernels_do_not_take(dev):
    Wq = torch.rand(8, 16, device=dev)
    H = _table(dev, 16, 300, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        MR.reservoir_scan(Wq, H.T.contiguous().T, 300, 64)
    with pytest.raises(TypeError):
        MR.reservoir_scan(Wq.double(), H, 300, 64)
    with pytest.raises(ValueError, match="different devices"):
        MR.reservoir_scan(Wq.cpu(), H, 300, 64)
    with pytest.raises(ValueError, match="bfloat16/int8"):
        CA.count_above_fused(Wq, H.float(), torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="theta"):
        CA.count_above_fused(Wq, H, torch.zeros(7, device=dev))


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
def test_recommender_on_the_card_matches_the_cpu(dev, table_dtype):
    """The same tables served on the card (through both kernels) and on
    the CPU (through their twins): the same certified exact rows."""
    g = torch.Generator().manual_seed(3)
    W = torch.rand(64, 32, generator=g)
    H = torch.rand(32, 20000, generator=g)
    seen = (torch.rand(64, 20000, generator=g) < 0.005).float().numpy()
    from nmftpu_torch.sparse import from_dense
    kw = dict(train=from_dense(seen), method="reservoir",
              table_dtype=table_dtype, reservoir_slots=512)
    gpu = nt.Recommender(W, H, device="cuda", **kw)
    cpu = nt.Recommender(W, H, device="cpu", **kw)
    users = list(range(0, 64, 2))
    before = (MR.LAUNCHES["reservoir_scan"], CA.LAUNCHES["count_above"])
    s, i, c = gpu.recommend_certified(users, k=20, fallback="exact")
    s0, i0, c0 = cpu.recommend_certified(users, k=20, fallback="exact")
    assert MR.LAUNCHES["reservoir_scan"] > before[0]
    assert CA.LAUNCHES["count_above"] > before[1]
    np.testing.assert_allclose(s, s0, rtol=SCAN_RTOL)
    for row in range(len(users)):
        assert set(i[row].tolist()) == set(i0[row].tolist()), row


# ---------------------------------------------------------------------------
# ELL segment SpMM
# ---------------------------------------------------------------------------

# float32 sums of at most 512 nonnegative products in two orders differ by
# ~sqrt(512) * 2^-24 = 1.3e-6 relative; float64 by ~5e-15
ELL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _ell_bucket(dev, nseg, w, m, r, dtype, seed):
    """A bucket as the builder lays it out: each segment holds 1..w
    nonzeros then pad lanes (col 0, val 0), and the last segments are
    all-zero padding."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.rand(nseg, w, generator=g, device=dev, dtype=dtype) + 0.1
    cols = torch.randint(0, m, (nseg, w), generator=g, device=dev,
                         dtype=torch.int32)
    lens = torch.randint(1, w + 1, (nseg, 1), generator=g, device=dev)
    lens[-3:] = 0
    pad = torch.arange(w, device=dev)[None, :] >= lens
    vals[pad] = 0
    cols[pad] = 0
    Ht = torch.rand(m, r, generator=g, device=dev, dtype=dtype)
    return vals, cols, Ht


@pytest.mark.parametrize("w", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("r", [37, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bucket_rowsums_matches_twin(dev, w, r, dtype):
    vals, cols, Ht = _ell_bucket(dev, 3000, w, 7000, r, dtype, seed=w + r)
    before = SEK.LAUNCHES["ell_rowsums"]
    got = SEK.bucket_rowsums(vals, cols, Ht)
    want = SEK.bucket_rowsums_plain(vals, cols, Ht)
    torch.cuda.synchronize()
    assert SEK.LAUNCHES["ell_rowsums"] == before + 1
    assert got.dtype == dtype and got.shape == (3000, r)
    torch.testing.assert_close(got, want, rtol=ELL_RTOL[dtype], atol=0)
    assert bool((got[-3:] == 0).all())


@pytest.mark.parametrize("r", [1, 3, 200, 300, 520])
def test_bucket_rowsums_odd_and_wide_ranks(dev, r):
    """Scalar lanes (r not a multiple of 2), several column groups and
    several passes over a row (r > 4 * 32 * VEC)."""
    vals, cols, Ht = _ell_bucket(dev, 700, 16, 900, r, torch.float32, r)
    got = SEK.bucket_rowsums(vals, cols, Ht)
    want = SEK.bucket_rowsums_plain(vals, cols, Ht)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_ell_pallas_path_matches_the_plain_path(dev):
    """One MU-Frobenius step on an ELL pair with both SpMMs on the kernel
    against the plain torch ELL step, on the card."""
    from nmftpu_torch import sparse as S
    from nmftpu_torch import sparse_ell as SE

    rng = np.random.default_rng(4)
    a = np.where(rng.random((300, 420)) < 0.05,
                 rng.uniform(0.5, 5.0, (300, 420)), 0).astype(np.float32)
    a[7, :200] = 1.5                        # a row longer than seg_max
    pair = SE.build_ell_pair(S.from_dense(a), device=dev, seg_max=64,
                             buckets=(8, 16, 32, 64))
    g = torch.Generator(device=dev).manual_seed(5)
    W = torch.rand(300, 24, generator=g, device=dev) + 0.05
    H = torch.rand(24, 420, generator=g, device=dev) + 0.05
    before = SEK.LAUNCHES["ell_rowsums"]
    got = SEK.mu_update_frobenius_ell_pallas(pair, W, H)
    want = SE.mu_update_frobenius_ell(pair, W, H)
    torch.cuda.synchronize()
    assert SEK.LAUNCHES["ell_rowsums"] - before == \
        len(pair.rows.buckets) + len(pair.cols.buckets)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=0)


def test_ell_wrapper_rejects_what_the_kernel_does_not_take(dev):
    vals, cols, Ht = _ell_bucket(dev, 10, 8, 20, 16, torch.float32, 0)
    with pytest.raises(ValueError, match="contiguous"):
        SEK.bucket_rowsums(vals, cols, Ht.T.contiguous().T)
    with pytest.raises(TypeError, match="float32"):
        SEK.bucket_rowsums(vals.double(), cols, Ht)
    with pytest.raises(TypeError, match="float32"):
        SEK.bucket_rowsums(vals.half(), cols, Ht.half())
    with pytest.raises(TypeError, match="int32"):
        SEK.bucket_rowsums(vals, cols.long(), Ht)
    with pytest.raises(ValueError, match="different devices"):
        SEK.bucket_rowsums(vals, cols, Ht.cpu())
    with pytest.raises(ValueError, match="expected vals and cols"):
        SEK.bucket_rowsums(vals, cols[:, :4].contiguous(), Ht)


def test_sparse_nmf_on_the_card_matches_the_cpu(dev):
    """nmf on sparse V through each engine on the card and on the CPU,
    from the same W0/H0: the same errors and factors."""
    from nmftpu_torch import sparse as S

    rng = np.random.default_rng(6)
    a = np.where(rng.random((257, 311)) < 0.06,
                 rng.integers(1, 11, (257, 311)) * 0.5, 0).astype(np.float32)
    sp = S.from_dense(a)
    W0 = rng.uniform(0.1, 1.0, (257, 8)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (8, 311)).astype(np.float32)
    for strategy, knobs in (("ell", {"use_pallas": True}), ("ell", {}),
                            ("densified", {}), ("scatter", {})):
        for objective in ("frobenius", "kl"):
            if knobs and objective == "kl":
                continue
            kw = dict(init="copy", W0=W0, H0=H0, num_iterations=10,
                      check_interval=5, strategy=strategy,
                      objective=objective, **knobs)
            got = nt.nmf(sp, 8, device="cuda", **kw)
            want = nt.nmf(sp, 8, device="cpu", **kw)
            assert got.W.device.type == "cuda"
            # bf16 rounding of the factors in the densified contractions
            # can flip on an ulp of float32 reordering (2^-9 relative)
            rtol = 2e-2 if strategy == "densified" else 1e-4
            torch.testing.assert_close(got.W.cpu(), want.W, rtol=rtol,
                                       atol=1e-5)
            torch.testing.assert_close(got.H.cpu(), want.H, rtol=rtol,
                                       atol=1e-5)
            np.testing.assert_allclose(got.error, want.error, rtol=1e-4)
