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
from nmftpu_torch.kernels import _build  # noqa: E402
from nmftpu_torch.kernels import count_above as CA  # noqa: E402
from nmftpu_torch.kernels import dense_mu as K  # noqa: E402
from nmftpu_torch.kernels import dual_numer as DN  # noqa: E402
from nmftpu_torch.kernels import hals_sweep as HS  # noqa: E402
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
    assert all(counts[k] == before[k] + 1 for k in counts
               if k != "fused_multiply_divide")


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
               (130, 256, 70000, 4096), (40, 512, 3001, 256)]
# the tensor-core scan's edges: unaligned m and r = 37, R not a multiple
# of the 64-slot tile, b not a multiple of the 128-query block, a walk
# split into ranges and merged, R = 16384 (the escalation's), r = 288
# (the most a tile stages whole), r = 304, 512 and 832 (MAX_RANK: the
# rank streamed in chunks, 2, 3 and 26 of them)
TC_SCAN_SHAPES = [(37, 37, 10007, 1000), (200, 37, 10001, 100),
                  (129, 64, 100003, 16384), (300, 256, 1 << 18, 4096),
                  (5, 288, 20000, 192), (130, 16, 1 << 20, 64),
                  (70, 304, 9001, 256), (300, 512, 50000, 1024),
                  (9, 832, 5003, 128)]


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


def _same_candidates(Wq, H, s, i, s0, i0):
    torch.testing.assert_close(s, s0, rtol=SCAN_RTOL, atol=0)
    q, c = ((i != i0) & torch.isfinite(s0)).nonzero(as_tuple=True)
    qd = Wq.to(torch.bfloat16).double()[q]
    got = (qd * H[:, i[q, c].long()].double().T).sum(1)
    want = (qd * H[:, i0[q, c].long()].double().T).sum(1)
    assert bool(((got - want).abs() <= SCAN_RTOL * want.abs()).all())


@pytest.mark.parametrize("shape", TC_SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_tensor_core_scan_edges_match_twin(dev, shape, dtype):
    """The tensor-core entries at their edges, with the variant that ran:
    16-byte copies only where the table's rows and tiles are 16-byte
    aligned, a merge exactly when the plan splits the walk."""
    b, r, m, slots = shape
    g = torch.Generator(device=dev).manual_seed(b + r + m)
    Wq = torch.rand(b, r, generator=g, device=dev)
    H = _table(dev, r, m, dtype, seed=r)
    before = dict(MR.VARIANT_LAUNCHES)
    s, i = MR.reservoir_scan(Wq, H, m, slots)
    s0, i0 = MR.reservoir_scan_plain(Wq, H, m, slots)
    torch.cuda.synchronize()
    ran = {k: MR.VARIANT_LAUNCHES[k] - before[k] for k in before}
    es = H.element_size()
    aligned = _build.copy_alignment(H.data_ptr(), m * es,
                                    slots * es) == 16
    splits = MR.tc_plan(b, slots, m)[1]
    assert ran == {"tc": int(aligned), "tc_unaligned": int(not aligned),
                   "f32": 0, "merge": int(splits > 1)}
    _same_candidates(Wq, H, s, i, s0, i0)


def test_tensor_core_scan_keeps_the_lower_id_on_ties(dev):
    """Equal scores across tiles and across the ranges of a split walk:
    the kernel keeps the twin's ids exactly (ties need no tolerance)."""
    b, r, m, slots = 3, 16, 64 * 40, 64
    H = torch.zeros(r, m, device=dev, dtype=torch.int8)
    H[0, ::3] = 5                      # every third item scores the same
    H[1, 7::64] = 2                    # column 7's items score lower
    Wq = torch.ones(b, r, device=dev)
    assert MR.tc_plan(b, slots, m)[1] > 1
    s, i = MR.reservoir_scan(Wq, H, m, slots)
    s0, i0 = MR.reservoir_scan_plain(Wq, H, m, slots)
    assert torch.equal(s, s0) and torch.equal(i, i0)


def _count_inputs(dev, b, r, m, kind, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    Wq = torch.rand(b, r, generator=g, device=dev)
    if kind == "bfloat16":
        return Wq, _table(dev, r, m, torch.bfloat16, seed), None
    return (Wq, _table(dev, r, m, torch.int8, seed),
            torch.rand(r, generator=g, device=dev) + 0.01)


def _chain(Wq, H, hs):
    """The (b, m) chain scores: bf16(q[k]) H[k, j] summed in float32 one
    product at a time in k order (each product is exact), q the scan
    operand; the scores the count must be exact against."""
    from nmftpu_torch._operands import _scan_operands

    q = _scan_operands(Wq, H.dtype, hs)[0]
    acc = torch.zeros(q.shape[0], H.shape[1], device=H.device)
    for k in range(H.shape[0]):
        acc.addcmul_(q[:, k:k + 1], H[k].float()[None, :])
    return acc


def _chain_count(chain, theta):
    return (chain > theta[:, None]).sum(1, dtype=torch.int32)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("kind", ["bfloat16", "int8_vector"])
def test_count_above_matches_twin(dev, shape, kind):
    b, r, m, _ = shape
    Wq, H, hs = _count_inputs(dev, b, r, m, kind, b + r)
    g = torch.Generator(device=dev).manual_seed(b + r)
    theta = torch.rand(b, generator=g, device=dev) * r * 0.3
    theta[0] = float("-inf")
    before = CA.LAUNCHES["count_above"]
    got = CA.count_above_fused(Wq, H, theta, h_scale=hs)
    want = CA.count_above_fused_plain(Wq, H, theta, h_scale=hs)
    torch.cuda.synchronize()
    assert CA.LAUNCHES["count_above"] == before + 1
    assert int(got[0]) == m
    # exact against the chain; the twin (a float32 matmul) may differ only
    # at scores within rounding of theta
    assert torch.equal(got, _chain_count(_chain(Wq, H, hs), theta))
    q = (Wq * hs if hs is not None else Wq).to(torch.bfloat16).double()
    full = q @ H.double()
    near = ((full - theta[:, None].double()).abs()
            <= SCAN_RTOL * full.abs()).sum(1)
    assert bool(((got - want).abs() <= near).all())


@pytest.mark.parametrize("b", [37, 512])
@pytest.mark.parametrize("r", [37, 256, 512])
@pytest.mark.parametrize("kind", ["bfloat16", "int8_vector"])
def test_count_above_equals_the_chain_count(dev, b, r, kind):
    """theta is each row's 100th chain score, as the certificate takes it
    (unaligned m = 10,007): the item at theta must not count, so the
    band's exact re-score decides it. Row 1 counts nothing (+inf), row 2
    everything (-inf)."""
    m = 10_007
    Wq, H, hs = _count_inputs(dev, b, r, m, kind, b * r)
    chain = _chain(Wq, H, hs)
    theta = chain.topk(100, dim=1).values[:, -1].contiguous()
    theta[1], theta[2] = float("inf"), float("-inf")
    before = (CA.LAUNCHES["count_above"], CA.band_pairs())
    got = CA.count_above_fused(Wq, H, theta, h_scale=hs)
    assert CA.LAUNCHES["count_above"] == before[0] + 1
    assert torch.equal(got, _chain_count(chain, theta))
    assert got[1] == 0 and got[2] == m and bool((got[3:] <= 99).all())
    # at least the item at theta of every finite row went through the band
    assert CA.band_pairs() - before[1] >= b - 2


def test_count_above_all_ties_go_through_the_band(dev):
    """Every item of the table is one column repeated, so every item ties
    theta: all b * m pairs go through the band (the list of 4,096
    overflows and the kernel re-scores the rest where it finds them) and
    none counts; the -inf row counts every item."""
    b, r, m = 37, 37, 10_007
    g = torch.Generator(device=dev).manual_seed(9)
    Wq = torch.rand(b, r, generator=g, device=dev)
    col = torch.rand(r, 1, generator=g, device=dev).to(torch.bfloat16)
    H = col.expand(r, m).contiguous()
    theta = _chain(Wq, H[:, :1], None)[:, 0].contiguous()
    theta[0] = float("-inf")
    before = CA.band_pairs()
    got = CA.count_above_fused(Wq, H, theta)
    assert int(got[0]) == m and bool((got[1:] == 0).all())
    assert CA.band_pairs() - before == (b - 1) * m


@pytest.mark.parametrize("kind", ["bfloat16", "int8_vector"])
def test_count_above_zero_queries_skip_the_band(dev, kind):
    """Rows whose query is all zero score exactly 0 on every item: theta 0
    (their kth score) counts none and -1 counts all, exactly, and none of
    their m ties goes through the band, in any of the four 128-query
    blocks."""
    b, r, m = 512, 256, 10_007
    Wq, H, hs = _count_inputs(dev, b, r, m, kind, 12)
    zero = torch.tensor([3, 130, 300, 511], device=dev)
    Wq[zero] = 0.0
    chain = _chain(Wq, H, hs)
    theta = chain.topk(100, dim=1).values[:, -1].contiguous()
    theta[zero] = torch.tensor([0.0, -1.0, 0.0, 0.0], device=dev)
    before = CA.band_pairs()
    got = CA.count_above_fused(Wq, H, theta, h_scale=hs)
    band = CA.band_pairs() - before
    assert torch.equal(got, _chain_count(chain, theta))
    assert got[zero].tolist() == [0, m, 0, 0]
    assert b - len(zero) <= band < m


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
    # one launch per product: V Hᵀ, then Wᵀ V
    assert SEK.LAUNCHES["ell_rowsums"] - before == 2
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=0)


def _ell_csr(seed, n=5000, m=3000, dtype=np.float32):
    """A CSR as ratings come: most rows hold 1..8 nonzeros (over 2,048
    segments in the narrowest bucket, so it is padded to a multiple of
    2,048), a few hold 9..600 (some split over two buckets at seg_max =
    512), one holds 1,300 (three segments: 512, 512, 276), one is empty,
    and every 7th stored value is an explicit zero."""
    from nmftpu_torch.sparse import SparseCSR

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 9, n)
    lens[rng.choice(n, 40, replace=False)] = rng.integers(9, 600, 40)
    lens[3], lens[4] = 1300, 0
    lens[10:17] = (12, 24, 48, 96, 192, 384, 520)    # every width's bucket
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate([np.sort(rng.choice(m, k, replace=False))
                              for k in lens]).astype(np.int32)
    data = rng.uniform(0.5, 5.0, int(indptr[-1])).astype(dtype)
    data[::7] = 0.0
    return SparseCSR(indptr, indices, data, (n, m))


@pytest.mark.parametrize("r", [37, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_spmm_matches_the_plain_product(dev, r, dtype):
    """Both directions of one container pair in one launch each, against
    the plain ELL product; a row with one segment is bit for bit the
    segment's sum from `bucket_rowsums` (the same kernel, each segment its
    own row), since skipped zero lanes change nothing and the atomic adds
    into a zero."""
    from nmftpu_torch import sparse_ell as SE

    csr = _ell_csr(r)
    pair = SE.build_ell_pair(csr, dtype=dtype, device=dev)
    assert any(b.vals.shape[0] % 2048 == 0 and b.vals.shape[0] > 2048
               for b in pair.rows.buckets)
    g = torch.Generator(device=dev).manual_seed(r)
    W = torch.rand(csr.shape[0], r, generator=g, device=dev, dtype=dtype)
    H = torch.rand(r, csr.shape[1], generator=g, device=dev, dtype=dtype)
    before = SEK.LAUNCHES["ell_rowsums"]
    vht = SEK.v_ht_ell_pallas(pair.rows, H)
    wtv = SEK.wt_v_ell_pallas(pair, W)
    torch.cuda.synchronize()
    assert SEK.LAUNCHES["ell_rowsums"] - before == 2
    torch.testing.assert_close(vht, SE.v_ht_ell(pair.rows, H),
                               rtol=ELL_RTOL[dtype], atol=0)
    torch.testing.assert_close(wtv, SE.wt_v_ell(pair, W),
                               rtol=ELL_RTOL[dtype], atol=0)
    # rows with one real segment (pad segments repeat a row, all zero)
    Ht = H.T.contiguous()
    real = torch.zeros(csr.shape[0], dtype=torch.int64, device=dev)
    for b in pair.rows.buckets:
        real.index_add_(0, b.out_row, (b.vals != 0).any(1).long())
    checked = 0
    for b in pair.rows.buckets:
        seg = SEK.bucket_rowsums(b.vals, b.cols, Ht)
        one = ((b.vals != 0).any(1) & (real[b.out_row] == 1)).nonzero()[:, 0]
        assert torch.equal(vht[b.out_row[one]], seg[one])
        checked += one.numel()
    assert checked > csr.shape[0] // 2


def test_ell_spmm_takes_more_buckets_than_one_launch(dev):
    """Ten bucket widths: the product takes two launches of at most
    MAX_BUCKETS buckets, into the same output."""
    from nmftpu_torch import sparse_ell as SE

    csr = _ell_csr(3, n=1500)
    widths = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
    ell = SE.build_ell_rows(csr, device=dev, buckets=widths)
    assert len(ell.buckets) > SEK.MAX_BUCKETS
    H = torch.rand(64, csr.shape[1], device=dev)
    before = SEK.LAUNCHES["ell_rowsums"]
    got = SEK.v_ht_ell_pallas(ell, H)
    assert SEK.LAUNCHES["ell_rowsums"] - before == 2
    torch.testing.assert_close(got, SE.v_ht_ell(ell, H), rtol=1e-5, atol=0)


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


# ---------------------------------------------------------------------------
# slice 4a: HALS sweep, int8 numerators, fused multiply-divide
# ---------------------------------------------------------------------------

# float32 sums in another order than the blocked twin, amplified by the
# clamp and the division by the hessian; nmftpu's bound for its own kernel
HALS_ATOL = 3e-5


@pytest.mark.parametrize("n,r,zero_col", [(1000, 37, 5), (4096, 256, None),
                                          (2048, 512, None), (50, 5, 0),
                                          (33, 16, None), (70, 100, 99)])
@pytest.mark.parametrize("block", [16, 7])
def test_hals_sweep_matches_twin(dev, n, r, zero_col, block):
    g = torch.Generator(device=dev).manual_seed(n + r)
    X = torch.randn(n, r, generator=g, device=dev)
    A = torch.randn(r, r, generator=g, device=dev)
    G = A @ A.T + torch.eye(r, device=dev)
    if zero_col is not None:
        G[zero_col, :] = 0.0
        G[:, zero_col] = 0.0
    W = torch.rand(n, r, generator=g, device=dev)
    before = HS.LAUNCHES["hals_sweep"]
    got = HS.hals_sweep(X, G, W, block=block)
    want = HS.hals_sweep_plain(X, G, W, block=block)
    torch.cuda.synchronize()
    assert HS.LAUNCHES["hals_sweep"] == before + 1
    torch.testing.assert_close(got, want, rtol=0,
                               atol=HALS_ATOL * float(want.abs().max()))
    if zero_col is not None:
        assert torch.equal(got[:, zero_col], W[:, zero_col])


@pytest.mark.parametrize("shape", [(1000, 1500, 37), (4096, 4096, 256),
                                   (3, 5, 2), (130, 67, 70), (257, 4099, 64),
                                   (5000, 300, 8)])
def test_int8_numerators_match_twins(dev, shape):
    """Integer sums: the kernels equal their float64 twins exactly; the
    dual entry takes both its paths (RB = 1 and 4) across the shapes."""
    n, m, r = shape
    g = torch.Generator(device=dev).manual_seed(n + m + r)

    def q(*s):
        return torch.randint(-127, 128, s, generator=g, device=dev,
                             dtype=torch.int8)

    Vq, WqT, Hq = q(n, m), q(r, n), q(r, m)
    before = dict(DN.LAUNCHES)
    nw, nh = DN.dual_int8(Vq, WqT, Hq)
    a, b = DN.vht_int8(Vq, Hq), DN.wtv_int8(Vq, WqT)
    a0, b0 = DN.vht_int8_plain(Vq, Hq), DN.wtv_int8_plain(Vq, WqT)
    torch.cuda.synchronize()
    assert all(DN.LAUNCHES[k] == before[k] + 1 for k in DN.LAUNCHES)
    for got, want in ((nw, a0), (a, a0), (nh, b0), (b, b0)):
        assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("shape", [(40, 26744, 64), (1000, 1500, 37),
                                   (600, 26743, 70), (513, 4099, 256)])
def test_int8_numerators_at_unaligned_strides(dev, shape):
    """Row strides of 8 mod 16 bytes (ML-20M's m = 26,744), 4 mod 16
    (1,500), odd (26,743) and 3 mod 16 (4,099; Wqᵀ's stride n = 513 is
    odd too): the kernels' narrower copies, exact at atol 0."""
    n, m, r = shape
    g = torch.Generator(device=dev).manual_seed(n + m)
    Vq, WqT, Hq = (torch.randint(-127, 128, s, generator=g, device=dev,
                                 dtype=torch.int8)
                   for s in ((n, m), (r, n), (r, m)))
    nw, nh = DN.dual_int8(Vq, WqT, Hq)
    a, b = DN.vht_int8(Vq, Hq), DN.wtv_int8(Vq, WqT)
    a0, b0 = DN.vht_int8_plain(Vq, Hq), DN.wtv_int8_plain(Vq, WqT)
    torch.cuda.synchronize()
    for got, want in ((nw, a0), (a, a0), (nh, b0), (b, b0)):
        assert torch.equal(got, want)


def test_int8_numerators_wrap_like_xla(dev):
    """A contraction of 140,000 > 133,143 products of 127 * 127 leaves the
    int32 range: the kernels wrap modulo 2**32 as their twins (and XLA)
    do, for the dual entry and both one-sided ones."""
    n, m, r = 140_000, 96, 8
    Vq = torch.full((n, m), 127, dtype=torch.int8, device=dev)
    Vq[:, 1::2] = -127
    WqT = torch.full((r, n), 127, dtype=torch.int8, device=dev)
    Hq = torch.full((r, m), 127, dtype=torch.int8, device=dev)
    Vl = torch.full((8, n), 127, dtype=torch.int8, device=dev)
    Hl = torch.full((r, n), 127, dtype=torch.int8, device=dev)
    nw, nh = DN.dual_int8(Vq, WqT, Hq)
    want_h = DN.wtv_int8_plain(Vq, WqT)
    assert int(DN.wtv_exact(Vq, WqT).abs().max()) >= 2**31
    assert torch.equal(nh, want_h) and torch.equal(DN.wtv_int8(Vq, WqT),
                                                   want_h)
    assert torch.equal(DN.vht_int8(Vl, Hl), DN.vht_int8_plain(Vl, Hl))
    assert int(DN.vht_exact(Vl, Hl).abs().max()) >= 2**31
    assert torch.equal(nw, DN.vht_int8_plain(Vq, Hq))


def test_dual_numerators_match_the_one_sided_path(dev):
    V = 5.0 * torch.rand(700, 900, device=dev)
    W = torch.rand(700, 24, device=dev)
    H = torch.rand(24, 900, device=dev)
    Vq, sv = Q.quantize_v(V)
    got = DN.dual_numerators_int8(Vq, sv, W, H)
    want = DN.dual_numerators_int8_plain(Vq, sv, W, H)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", [(4096, 4096), (1000, 37), (7,), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_multiply_divide_matches_twin(dev, shape, dtype, offset):
    """Bit for bit, on 16-byte-aligned operands (vector loads) and on
    operands one element in (the scalar path)."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x, y, z = (torch.rand(*shape, generator=g, device=dev,
                          dtype=dtype).flatten()[offset:]
               for _ in range(3))
    before = K.LAUNCHES["fused_multiply_divide"]
    got = K.fused_multiply_divide(x, y, z)
    want = K.fused_multiply_divide_plain(x, y, z)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_multiply_divide"] == before + 1
    assert torch.equal(got, want)


def test_slice_4a_wrappers_reject_what_the_kernels_do_not_take(dev):
    X = torch.randn(64, 20, device=dev)
    G = torch.eye(20, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        HS.hals_sweep(X, G, X.T.contiguous().T)
    with pytest.raises(TypeError, match="float32"):
        HS.hals_sweep(X.double(), G.double(), X.double())
    with pytest.raises(ValueError, match="different devices"):
        HS.hals_sweep(X, G.cpu(), X)
    Vq = torch.zeros(30, 40, dtype=torch.int8, device=dev)
    with pytest.raises(TypeError, match="int8"):
        DN.vht_int8(Vq, torch.zeros(4, 40, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        DN.wtv_int8(Vq, torch.zeros(30, 4, dtype=torch.int8,
                                    device=dev).T)
    with pytest.raises(TypeError, match="float32"):
        K.fused_multiply_divide(X, X.double(), X)


@pytest.mark.parametrize("knobs", [
    {"algorithm": "hals"},
    {"algorithm": "hals", "update_order": "HW", "lambda_w": 0.1,
     "l1_h": 0.05},
    {"mu_style": "jacobi"},
    {"mu_style": "jacobi", "objective": "kullback-leibler"},
    {"mu_style": "jacobi", "v_storage": "bfloat16"},
])
def test_slice_4a_on_the_card_matches_the_cpu(dev, knobs):
    """nmf on the card (HALS through the sweep kernel at r = 24) and on
    the CPU (the blocked twin) from the same W0/H0. HALS factors are
    compared after one iteration only: later a float32 ulp can flip a
    clamp and move them to another point of (nearly) equal error, so the
    ten-iteration runs are compared on their errors."""
    g = torch.Generator().manual_seed(8)
    V = 5.0 * torch.rand(300, 257, generator=g)
    W0 = torch.rand(300, 24, generator=g) + 0.05
    H0 = torch.rand(24, 257, generator=g) + 0.05
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=10,
              check_interval=5, **knobs)
    before = HS.LAUNCHES["hals_sweep"]
    got = nt.nmf(V, 24, device="cuda", **kw)
    want = nt.nmf(V, 24, device="cpu", **kw)
    rtol = 2e-2 if knobs.get("v_storage") == "bfloat16" else 1e-3
    if knobs.get("algorithm") == "hals":
        assert HS.LAUNCHES["hals_sweep"] - before == 20
        np.testing.assert_allclose(got.error, want.error, rtol=1e-3)
        kw["num_iterations"] = 1
        got = nt.nmf(V, 24, device="cuda", **kw)
        want = nt.nmf(V, 24, device="cpu", **kw)
        rtol = 1e-4
    torch.testing.assert_close(got.W.cpu(), want.W, rtol=rtol, atol=1e-5)
    torch.testing.assert_close(got.H.cpu(), want.H, rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(got.error, want.error, rtol=1e-4)


@pytest.mark.parametrize("knobs,entries", [
    ({}, ("vht_int8", "wtv_int8")),
    ({"mu_style": "jacobi"}, ("vht_int8", "wtv_int8")),
    ({"mu_style": "jacobi", "use_pallas": True}, ("dual_numerators_int8",)),
])
def test_int8_nmf_on_the_card_matches_the_cpu(dev, knobs, entries):
    """int8 V through the int8 kernels on the card and through their
    twins on the CPU: the same integers, so the errors agree to float32
    roundoff of the rest of the step (factors may differ by a
    requantization step, so they are compared through the errors)."""
    g = torch.Generator().manual_seed(9)
    V = 5.0 * torch.rand(300, 257, generator=g)
    W0 = torch.rand(300, 24, generator=g) + 0.05
    H0 = torch.rand(24, 257, generator=g) + 0.05
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=10,
              check_interval=2, v_storage="int8", **knobs)
    before = dict(DN.LAUNCHES)
    got = nt.nmf(V, 24, device="cuda", **kw)
    want = nt.nmf(V, 24, device="cpu", **kw)
    assert all(DN.LAUNCHES[k] - before[k] == 10 for k in entries)
    np.testing.assert_allclose(got.stats.errors, want.stats.errors,
                               rtol=1e-3)
