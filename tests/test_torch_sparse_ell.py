"""The port's gather-only ELL engine and its SpMM kernel module against
nmftpu on the same numpy inputs: the builder bucket for bucket, the SpMM
and SDDMM primitives, the Frobenius and KL updates and metrics, and the
kernel's plain twin against nmftpu's Pallas ELL kernel in interpret mode
(the CUDA kernel itself is held against its twin on the card by
test_torch_kernels_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ell as JE  # noqa: E402
from nmftpu.kernels import sparse_ell_kernel as JK  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch.convert import sparse_from_nmftpu  # noqa: E402
from nmftpu_torch.kernels import sparse_ell_kernel as TK  # noqa: E402

# float64: the same sums in another order, to roundoff
RTOL_F64 = 1e-10
# one float32 SpMM, update or metric: sums of <= a few hundred nonnegative
# terms in another order, ~sqrt(K) * 2^-24 ~ 1e-6
RTOL_F32 = 1e-5
# KL: a log and a ratio on top of the float32 sums
RTOL_KL = 1e-4
SEG = dict(seg_max=16, buckets=(4, 8, 16))
RANK = 6


def _matrix(seed=0, n=257, m=311, density=0.06):
    """Nonnegative n x m at `density`, with an empty row (5), an empty
    column (7) and rows longer than seg_max=16 (3, 11, 200), as the
    nmftpu container and the port's, built from the same arrays."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < density,
                     rng.uniform(0.5, 5.0, (n, m)), 0.0).astype(np.float32)
    for row, k in ((3, 40), (11, 17), (200, 70)):
        dense[row, rng.choice(m, k, replace=False)] = rng.uniform(0.5, 5.0, k)
    dense[5, :] = 0.0
    dense[:, 7] = 0.0
    jsp = js.from_dense(dense)
    return dense, jsp, sparse_from_nmftpu(jsp)


def _factors(n, m, r=RANK, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (n, r)).astype(dtype),
            rng.uniform(0.1, 1.0, (r, m)).astype(dtype))


def _pairs(dtype=np.float32, **kw):
    dense, jsp, tsp = _matrix()
    kw = {**SEG, **kw}
    jp = JE.build_ell_pair(jsp, dtype=jnp.dtype(dtype), **kw)
    tp = TE.build_ell_pair(tsp, dtype=torch.float64 if dtype == np.float64
                           else torch.float32, device="cpu", **kw)
    return dense, jp, tp


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _tol(dtype):
    return RTOL_F64 if dtype == np.float64 else RTOL_F32


DTYPES = [np.float32, np.float64]
# nmftpu runs at its default chunk of 2048 segments: its scan over small
# chunks (nseg > chunk) under float64 corrupts the heap on the CPU in
# this jaxlib ("malloc(): invalid size", seen without torch in the
# process). The chunk only blocks the sums, so the port's small chunks
# are held against the same function.
REF_CHUNK = 2048


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


def _assert_same_rows(jell, tell):
    assert tell.shape == jell.shape and tell.nnz == jell.nnz
    assert len(tell.buckets) == len(jell.buckets)
    for jb, tb in zip(jell.buckets, tell.buckets):
        assert tb.width == jb.width
        for name in ("vals", "cols", "out_row"):
            got = getattr(tb, name).numpy()
            want = np.asarray(getattr(jb, name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", [
    SEG,
    dict(seg_max=16, buckets=(4, 8, 16), chunk_segments=8),
    dict(seg_max=8, buckets=(8,)),
    dict(seg_max=32, buckets=(2, 4, 8, 16, 32), chunk_segments=3),
    {},
])
def test_build_ell_pair_matches_nmftpu(dtype, kw):
    """Bucket for bucket, in both directions: widths, seg_max splits, the
    chunk_segments padding and the edge-repeated out_row tail."""
    _, jsp, tsp = _matrix()
    jp = JE.build_ell_pair(jsp, dtype=jnp.dtype(dtype), **kw)
    tp = TE.build_ell_pair(tsp, dtype=torch.float64 if dtype == np.float64
                           else torch.float32, device="cpu", **kw)
    _assert_same_rows(jp.rows, tp.rows)
    _assert_same_rows(jp.cols, tp.cols)
    assert tp.shape == jp.shape


def test_long_rows_split_and_pad_rows_repeat_the_last_row():
    dense, _, tp = _pairs(chunk_segments=8)
    widths = [b.width for b in tp.rows.buckets]
    assert widths == [4, 8, 16]
    for row in (3, 11, 200):
        # real segments (some nonzero lane) of the row: ceil(nnz / 16)
        segments = sum(int(((b.out_row == row) & (b.vals != 0).any(1)).sum())
                       for b in tp.rows.buckets)
        assert segments == -(-int((dense[row] != 0).sum()) // 16) > 1
    for b in tp.rows.buckets:
        assert bool((b.out_row[1:] >= b.out_row[:-1]).all())


def test_builder_rejects_bad_inputs():
    _, _, tsp = _matrix()
    with pytest.raises(ValueError, match="narrower"):
        TE.build_ell_rows(tsp, seg_max=32, buckets=(8, 16), device="cpu")
    from nmftpu_torch.sparse import SparseCOO
    bad = SparseCOO([0, 1], [0, 9], [1.0, 2.0], (2, 5))
    with pytest.raises(ValueError, match="column indices"):
        TE.build_ell_rows(bad, device="cpu")


def test_builder_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tsp = _matrix()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.build_ell_pair(tsp)


def test_empty_matrix_builds_no_buckets():
    from nmftpu_torch.sparse import SparseCOO
    ell = TE.build_ell_rows(SparseCOO([], [], np.zeros(0, np.float32),
                                      (4, 3)), device="cpu")
    assert ell.buckets == () and ell.nnz == 0
    H = torch.rand(2, 3)
    assert torch.equal(TE.v_ht_ell(ell, H), torch.zeros(4, 2))


# ---------------------------------------------------------------------------
# SpMM, SDDMM, metrics, updates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [2048, 5])
def test_spmm_matches_nmftpu(dtype, chunk):
    dense, jp, tp = _pairs(dtype)
    W, H = _factors(*dense.shape, dtype=dtype)
    got = TE.v_ht_ell(tp.rows, torch.tensor(H), chunk=chunk)
    want = JE.v_ht_ell(jp.rows, jnp.asarray(H), chunk=REF_CHUNK)
    assert got.dtype == torch.from_numpy(H).dtype
    assert _rel(got, want) < _tol(dtype)
    got = TE.wt_v_ell(tp, torch.tensor(W), chunk=chunk)
    want = JE.wt_v_ell(jp, jnp.asarray(W), chunk=REF_CHUNK)
    assert got.shape == (RANK, dense.shape[1])
    assert _rel(got, want) < _tol(dtype)
    # and both are the dense products
    assert _rel(got, W.T.astype(np.float64) @ dense) < _tol(dtype) * 10


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [2048, 7])
def test_sddmm_matches_nmftpu(dtype, chunk):
    dense, jp, tp = _pairs(dtype)
    W, H = _factors(*dense.shape, dtype=dtype)
    got = TE.sddmm_ell(tp.rows, torch.tensor(W), torch.tensor(H), chunk=chunk)
    want = JE.sddmm_ell(jp.rows, jnp.asarray(W), jnp.asarray(H),
                        chunk=REF_CHUNK)
    for gb, wb in zip(got.buckets, want.buckets):
        assert _rel(gb.vals, wb.vals) < _tol(dtype)
        assert gb.cols is not None and gb.width == wb.width


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [2048, 6])
def test_sampled_rowsums_match_nmftpu(dtype, chunk):
    dense, jp, tp = _pairs(dtype)
    W, H = _factors(*dense.shape, dtype=dtype)
    fns = (lambda v, s: v / (s + 1e-9), lambda v, s: v * s)
    got = TE.sampled_rowsums_ell(tp.rows, torch.tensor(W), torch.tensor(H),
                                 fns, chunk=chunk)
    want = JE.sampled_rowsums_ell(jp.rows, jnp.asarray(W), jnp.asarray(H),
                                  fns, chunk=REF_CHUNK)
    for g, w in zip(got, want):
        assert _rel(g, w) < _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("given_svsq", [False, True])
def test_frobenius_error_matches_nmftpu(dtype, given_svsq):
    dense, jp, tp = _pairs(dtype)
    W, H = _factors(*dense.shape, dtype=dtype)
    svsq_t = TE.sum_v_sq_ell(tp.rows)
    svsq_j = JE.sum_v_sq_ell(jp.rows)
    np.testing.assert_allclose(float(svsq_t), float(svsq_j),
                               rtol=_tol(dtype))
    got = TE.frobenius_error_ell(tp, torch.tensor(W), torch.tensor(H),
                                 svsq_t if given_svsq else None)
    want = JE.frobenius_error_ell(jp, jnp.asarray(W), jnp.asarray(H),
                                  svsq_j if given_svsq else None)
    np.testing.assert_allclose(float(got), float(want), rtol=_tol(dtype))
    np.testing.assert_allclose(
        float(got), np.linalg.norm(dense - W.astype(np.float64) @ H),
        rtol=_tol(dtype) * 10)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kl_error_matches_nmftpu(dtype):
    dense, jp, tp = _pairs(dtype)
    W, H = _factors(*dense.shape, dtype=dtype)
    got = float(TE.kl_error_ell(tp, torch.tensor(W), torch.tensor(H)))
    want = float(JE.kl_error_ell(jp, jnp.asarray(W), jnp.asarray(H)))
    np.testing.assert_allclose(got, want,
                               rtol=RTOL_F64 if dtype == np.float64
                               else RTOL_KL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("objective", ["frobenius", "kl"])
def test_update_matches_nmftpu(dtype, order, objective):
    dense, jp, tp = _pairs(dtype)
    W, H = _factors(*dense.shape, dtype=dtype)
    t_fn, j_fn = ((TE.mu_update_frobenius_ell, JE.mu_update_frobenius_ell)
                  if objective == "frobenius"
                  else (TE.mu_update_kl_ell, JE.mu_update_kl_ell))
    tW, tH = t_fn(tp, torch.tensor(W), torch.tensor(H), order=order)
    jW, jH = j_fn(jp, jnp.asarray(W), jnp.asarray(H), order=order)
    tol = _tol(dtype) if objective == "frobenius" or dtype == np.float64 \
        else RTOL_KL
    assert tW.dtype == torch.from_numpy(W).dtype
    assert _rel(tW, jW) < tol and _rel(tH, jH) < tol


# ---------------------------------------------------------------------------
# the kernel module: the twin against nmftpu's Pallas kernel (interpret)
# ---------------------------------------------------------------------------


def _segments(rng, nseg, w, m, r, dtype=np.float32):
    vals = rng.uniform(0.1, 1.0, (nseg, w)).astype(dtype)
    vals[:, w - 1] = 0.0                       # a pad lane in every segment
    cols = rng.integers(0, m, (nseg, w)).astype(np.int32)
    cols[:, w - 1] = 0
    Ht = rng.uniform(0.1, 1.0, (m, r)).astype(dtype)
    return vals, cols, Ht


@pytest.mark.parametrize("nseg,w,m,r", [(300, 8, 240, 16), (37, 64, 500, 37),
                                        (512, 4, 50, 1), (5, 512, 1000, 9)])
def test_bucket_rowsums_twin_matches_nmftpu(nseg, w, m, r):
    rng = np.random.default_rng(nseg + w)
    vals, cols, Ht = _segments(rng, nseg, w, m, r)
    want = JK.bucket_rowsums_pallas(jnp.asarray(vals), jnp.asarray(cols),
                                    jnp.asarray(Ht), chunk=512,
                                    interpret=True)
    before = TK.LAUNCHES["ell_rowsums"]
    got = TK.bucket_rowsums(*(torch.tensor(a) for a in (vals, cols, Ht)))
    plain = TK.bucket_rowsums_plain(*(torch.tensor(a)
                                      for a in (vals, cols, Ht)))
    assert TK.LAUNCHES["ell_rowsums"] == before   # CPU: the twin, no launch
    assert torch.equal(got, plain)
    assert _rel(got, want) < RTOL_F32
    assert _rel(got, (vals[:, :, None] * Ht[cols]).sum(1)) < RTOL_F32


def test_bucket_accumulate_multigroup_matches_nmftpu():
    """nseg > 512: nmftpu scans several kernel groups; the port launches
    once per bucket and adds the segments into rows with index_add_."""
    rng = np.random.default_rng(5)
    n, m, r, nseg, w = 150, 96, 8, 2000, 4
    vals, cols, Ht = _segments(rng, nseg, w, m, r)
    rows = np.sort(rng.integers(0, n, nseg)).astype(np.int32)
    jb = JE.EllBucket(vals=jnp.asarray(vals), cols=jnp.asarray(cols),
                      out_row=jnp.asarray(rows), width=w)
    tb = TE.EllBucket(vals=torch.tensor(vals), cols=torch.tensor(cols),
                      out_row=torch.tensor(rows), width=w)
    want = JK.bucket_accumulate_pallas(jb, jnp.asarray(Ht),
                                       jnp.zeros((n, r), jnp.float32),
                                       chunk=256, interpret=True)
    out = torch.zeros(n, r)
    got = TK.bucket_accumulate_pallas(tb, torch.tensor(Ht), out)
    assert got is out
    assert _rel(got, want) < RTOL_F32


@pytest.mark.parametrize("order", ["WH", "HW"])
def test_pallas_path_matches_nmftpu(order):
    dense, jp, tp = _pairs()
    W, H = _factors(*dense.shape)
    got = TK.v_ht_ell_pallas(tp.rows, torch.tensor(H))
    want = JK.v_ht_ell_pallas(jp.rows, jnp.asarray(H), interpret=True)
    assert _rel(got, want) < RTOL_F32
    got = TK.wt_v_ell_pallas(tp, torch.tensor(W))
    want = JK.wt_v_ell_pallas(jp, jnp.asarray(W), interpret=True)
    assert _rel(got, want) < RTOL_F32
    tW, tH = TK.mu_update_frobenius_ell_pallas(tp, torch.tensor(W),
                                               torch.tensor(H), order=order)
    jW, jH = JK.mu_update_frobenius_ell_pallas(jp, jnp.asarray(W),
                                               jnp.asarray(H), order=order,
                                               interpret=True)
    assert _rel(tW, jW) < RTOL_F32 and _rel(tH, jH) < RTOL_F32


def test_pallas_path_keeps_float64():
    """nmftpu's Pallas ELL kernel sums in float32 even for float64
    operands (sparse_ell_kernel.py:219, 224), against its own x64
    contract (sparse_ell.py:181-185); its XLA ELL update keeps float64.
    The port's kernel path follows the contract: it equals the float64
    XLA update to roundoff, while nmftpu's Pallas path does not (ROADMAP
    queue 3)."""
    dense, jp, tp = _pairs(np.float64)
    W, H = _factors(*dense.shape, dtype=np.float64)
    xla = JE.mu_update_frobenius_ell(jp, jnp.asarray(W), jnp.asarray(H))
    ref_pallas = JK.mu_update_frobenius_ell_pallas(
        jp, jnp.asarray(W), jnp.asarray(H), interpret=True)
    port = TK.mu_update_frobenius_ell_pallas(tp, torch.tensor(W),
                                             torch.tensor(H))
    assert port[0].dtype == torch.float64
    for p, x, rp in zip(port, xla, ref_pallas):
        assert _rel(p, x) < RTOL_F64
        assert _rel(rp, x) > 1e-9


def test_descriptor_order_is_widest_first():
    """One launch takes the buckets widest first, ties in their order, so
    the longest segments start first and do not form the launch's tail."""
    def bucket(w, tag):
        return TE.EllBucket(vals=torch.zeros(tag, w), cols=torch.zeros(
            tag, w, dtype=torch.int32), out_row=torch.zeros(
            tag, dtype=torch.int32), width=w)

    bs = [bucket(8, 1), bucket(512, 2), bucket(16, 3), bucket(512, 4),
          bucket(64, 5)]
    order = TK.descriptor_order(bs)
    assert [b.width for b in order] == [512, 512, 64, 16, 8]
    assert [b.vals.shape[0] for b in order] == [2, 4, 5, 3, 1]


def _with_explicit_zeros(dense, every=5):
    """The matrix as a CSR whose every `every`-th stored value is an
    explicit zero: zero lanes inside segments, besides the pad lanes."""
    csr = js.from_dense(dense).to_csr()
    data = np.asarray(csr.data).copy()
    data[::every] = 0.0
    return js.SparseCSR(csr.indptr, csr.indices, data, csr.shape)


@pytest.mark.parametrize("kw", [SEG, dict(seg_max=16, buckets=(4, 8, 16),
                                          chunk_segments=8)])
def test_ell_spmm_plain_matches_nmftpu_with_explicit_zeros(kw):
    """ell_spmm_plain (the launch's function: buckets in descriptor order,
    each segment's sum added into its row) against nmftpu's
    Pallas products in interpret mode, both directions, on a container
    with explicit zeros inside segments and padded buckets."""
    dense, _, _ = _matrix()
    jsp = _with_explicit_zeros(dense)
    jp = JE.build_ell_pair(jsp, dtype=jnp.float32, **kw)
    tp = TE.build_ell_pair(sparse_from_nmftpu(jsp), device="cpu", **kw)
    W, H = _factors(*dense.shape)
    before = TK.LAUNCHES["ell_rowsums"]
    vht = TK.ell_spmm_plain(tp.rows.buckets, torch.tensor(H.T.copy()),
                            torch.zeros(dense.shape[0], RANK))
    wtv = TK.ell_spmm_plain(tp.cols.buckets, torch.tensor(W),
                            torch.zeros(dense.shape[1], RANK))
    assert TK.LAUNCHES["ell_rowsums"] == before
    assert _rel(vht, JK.v_ht_ell_pallas(jp.rows, jnp.asarray(H),
                                        interpret=True)) < RTOL_F32
    assert _rel(wtv.T, JK.wt_v_ell_pallas(jp, jnp.asarray(W),
                                          interpret=True)) < RTOL_F32
    # the wrappers run that model on CPU tensors
    assert torch.equal(TK.v_ht_ell_pallas(tp.rows, torch.tensor(H)), vht)
    assert torch.equal(TK.wt_v_ell_pallas(tp, torch.tensor(W)), wtv.T)


def test_kernel_wrapper_checks_shapes_on_the_cpu():
    vals, cols, Ht = (torch.rand(4, 8), torch.zeros(4, 8, dtype=torch.int32),
                      torch.rand(10, 3))
    with pytest.raises(ValueError, match="expected vals and cols"):
        TK.bucket_rowsums(vals, cols[:, :4], Ht)
    with pytest.raises(ValueError, match="expected vals and cols"):
        TK.bucket_rowsums(vals, cols, Ht[0])
    with pytest.raises(ValueError, match="different devices"):
        TK.bucket_rowsums(vals, cols, Ht.to("meta"))
