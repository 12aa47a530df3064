"""The port's retrieval layer (sparse containers, exclusion lists, the MIPS
scans and the certificate) against nmftpu's on the same numpy inputs, for
float32, bfloat16 and int8 tables (scalar and per-dimension scales)."""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nmftpu import sparse as JS  # noqa: E402
from nmftpu.retrieval import exclusion as JX  # noqa: E402
from nmftpu.retrieval import mips as JM  # noqa: E402
from nmftpu_torch import sparse as PS  # noqa: E402
from nmftpu_torch.retrieval import exclusion as PX  # noqa: E402
from nmftpu_torch.retrieval import mips as PM  # noqa: E402

# Both packages sum the same float32 products in different orders:
# ~sqrt(r) * 2^-24 relative on nonnegative data at r = 16. 1e-5 leaves
# a wide margin and still catches a wrong rounding rule (bf16 is 4e-3).
RTOL = 1e-5
B, R, M, K = 24, 16, 3000, 10
BLOCK = 512                       # 3000 = 5 * 512 + 440: an uneven tail
KINDS = ["float32", "bfloat16", "int8_scalar", "int8_vector"]


def _factors(seed=0, b=B, r=R, m=M):
    rng = np.random.default_rng(seed)
    Wq = rng.uniform(0.0, 1.0, (b, r)).astype(np.float32)
    # per-dimension magnitudes over two orders, as NMF factor rows have
    mag = np.logspace(0, -2, r).astype(np.float32)[:, None]
    H = (rng.uniform(0.0, 1.0, (r, m)) * mag).astype(np.float32)
    return Wq, H


def _table(kind, H):
    """(jax table, torch table, h_scale as numpy or None, the table's
    values as float64)."""
    if kind == "float32":
        return jnp.asarray(H), torch.tensor(H), None, H.astype(np.float64)
    if kind == "bfloat16":
        Hb = jnp.asarray(H, jnp.bfloat16)
        Hv = np.asarray(Hb).astype(np.float32)
        return Hb, torch.tensor(Hv).to(torch.bfloat16), None, \
            Hv.astype(np.float64)
    if kind == "int8_scalar":
        sc = np.float32(np.abs(H).max() / 127.0)
        Hq = np.clip(np.round(H / sc), -127, 127).astype(np.int8)
    else:
        sc = np.maximum(np.abs(H).max(axis=1) / 127.0, 1e-30).astype(
            np.float32)
        Hq = np.clip(np.round(H / sc[:, None]), -127, 127).astype(np.int8)
    return (jnp.asarray(Hq), torch.tensor(Hq), sc,
            Hq.astype(np.float64))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _true_scores(Wq, kind, sc, Hv):
    """float64 scores under the scan's rounding of the queries."""
    if kind == "float32":
        return Wq.astype(np.float64) @ Hv
    if kind == "int8_vector":
        return _bf16(Wq * sc).astype(np.float64) @ Hv
    out = _bf16(Wq).astype(np.float64) @ Hv
    return out * np.float64(sc) if kind == "int8_scalar" else out


def assert_same_topk(s, i, s_ref, i_ref, rtol=RTOL):
    """Scores within rtol (-inf equal); ids equal wherever the reference
    has no near-tie (another score within rtol, or the row's last finite
    slot, beyond which the next item may tie); no duplicate ids."""
    s, i, s_ref, i_ref = (np.asarray(x) for x in (s, i, s_ref, i_ref))
    np.testing.assert_allclose(s, s_ref, rtol=rtol, atol=0)
    for row in range(s.shape[0]):
        fin = np.isfinite(s_ref[row])
        ids = i[row][fin]
        assert len(set(ids.tolist())) == len(ids), row
        last = np.flatnonzero(fin).max() if fin.any() else -1
        for p in np.flatnonzero(fin & (i[row] != i_ref[row])):
            close = np.abs(s_ref[row] - s_ref[row, p]) <= \
                rtol * abs(s_ref[row, p])
            assert p == last or close.sum() > 1, (row, p)


def _seen(rng, b, m, width):
    seen = np.full((b, width), -1, np.int32)
    for row in range(b):
        n = rng.integers(0, width + 1)
        seen[row, :n] = rng.choice(m, n, replace=False)
    return seen


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_score_dot_matches_nmftpu(kind):
    Wq, H = _factors()
    Hj, Ht, sc, _ = _table(kind, H)
    want = np.asarray(JM._score_dot(jnp.asarray(Wq), Hj, sc))
    got = PM._score_dot(torch.tensor(Wq), Ht, sc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_topk_mips_matches_nmftpu(kind):
    Wq, H = _factors(1)
    Hj, Ht, sc, _ = _table(kind, H)
    mask = np.random.default_rng(1).random((B, M)) < 0.1
    for ex in (None, mask):
        s_ref, i_ref = JM.topk_mips(jnp.asarray(Wq), Hj, K,
                                    None if ex is None else jnp.asarray(ex),
                                    h_scale=sc)
        s, i = PM.topk_mips(torch.tensor(Wq), Ht, K,
                            None if ex is None else torch.tensor(ex),
                            h_scale=sc)
        assert i.dtype == torch.int32
        assert_same_topk(s, i, s_ref, i_ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", ["exact", "approx"])
def test_topk_mips_blocked_with_exclusion_matches_nmftpu(kind, method):
    """Exclude mask and exclude lists, over an uneven tail block."""
    Wq, H = _factors(2)
    Hj, Ht, sc, _ = _table(kind, H)
    rng = np.random.default_rng(2)
    seen = rng.random((B, M)) < 0.05
    csr = PS.from_dense(seen.astype(np.float32)).to_csr()
    lists = PX.build_block_exclusion(np.arange(B), csr, M, BLOCK)
    for kw in ({"exclude_mask": seen}, {"exclude_lists": lists}):
        jkw = {k: (jnp.asarray(v) if k == "exclude_mask" else v)
               for k, v in kw.items()}
        s_ref, i_ref = JM.topk_mips_blocked(jnp.asarray(Wq), Hj, K,
                                            block=BLOCK, method=method,
                                            h_scale=sc, **jkw)
        s, i = PM.topk_mips_blocked(torch.tensor(Wq), Ht, K, block=BLOCK,
                                    method=method, h_scale=sc, **kw)
        assert_same_topk(s, i, s_ref, i_ref)
        hit = np.take_along_axis(seen, i.numpy().astype(np.int64), axis=1)
        assert not hit.any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("candidate_k", [1, 3, 2 * K])
def test_candidate_k_matches_nmftpu(kind, candidate_k):
    """method="approx" with candidate_k: the per-block candidate budget
    changes the result (candidate_k=1 keeps only each block's best), id
    for id with nmftpu, whose approx_max_k is exact on the CPU."""
    Wq, H = _factors(3)
    Hj, Ht, sc, _ = _table(kind, H)
    s_ref, i_ref = JM.topk_mips_blocked(jnp.asarray(Wq), Hj, K,
                                        block=BLOCK, method="approx",
                                        candidate_k=candidate_k, h_scale=sc)
    s, i = PM.topk_mips_blocked(torch.tensor(Wq), Ht, K, block=BLOCK,
                                method="approx", candidate_k=candidate_k,
                                h_scale=sc)
    assert_same_topk(s, i, s_ref, i_ref)


def test_approx_recall_against_the_exact_oracle():
    Wq, H = _factors(4)
    Ht = torch.tensor(H)
    full = Wq.astype(np.float64) @ H.astype(np.float64)
    exact = np.argsort(-full, axis=1)[:, :K]
    _, i = PM.topk_mips_blocked(torch.tensor(Wq), Ht, K, block=BLOCK,
                                method="approx")
    recall = np.mean([len(set(i[u].tolist()) & set(exact[u].tolist())) / K
                      for u in range(B)])
    assert recall == 1.0
    # a starved candidate budget loses recall, and only then
    _, i1 = PM.topk_mips_blocked(torch.tensor(Wq), Ht, K, block=BLOCK,
                                 method="approx", candidate_k=1)
    assert (np.asarray(i1) >= 0).all()
    recall1 = np.mean([len(set(i1[u].tolist()) & set(exact[u].tolist()))
                       / K for u in range(B)])
    assert recall1 < 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_topk_mips_excluded_matches_nmftpu(kind):
    Wq, H = _factors(5)
    Hj, Ht, sc, _ = _table(kind, H)
    seen = _seen(np.random.default_rng(5), B, M, 7)
    for method in ("exact", "approx"):
        s_ref, i_ref = JM.topk_mips_excluded(jnp.asarray(Wq), Hj, K,
                                             jnp.asarray(seen), block=BLOCK,
                                             method=method, h_scale=sc)
        s, i = PM.topk_mips_excluded(torch.tensor(Wq), Ht, K, seen,
                                     block=BLOCK, method=method,
                                     h_scale=sc)
        assert_same_topk(s, i, s_ref, i_ref)
        for row in range(B):
            assert not set(i[row].tolist()) & set(seen[row].tolist())


def test_drop_seen_never_matches_padding():
    s = torch.tensor([[5.0, 4.0, 3.0, 2.0]])
    i = torch.tensor([[0, 7, 3, 9]], dtype=torch.int32)
    seen = torch.tensor([[-1, 7, -1]])
    top_s, top_i = PM._drop_seen(s, i, seen, 3)
    assert top_i.tolist() == [[0, 3, 9]]
    assert top_s.tolist() == [[5.0, 3.0, 2.0]]
    assert PM._seen_hits(i, seen[:, :0]).sum() == 0


def test_exclusion_validation_matches_nmftpu():
    Wq, H = _factors(6)
    csr = PS.from_dense(np.eye(B, M, dtype=np.float32)).to_csr()
    lists = PX.build_block_exclusion(np.arange(B), csr, M, 1024)
    with pytest.raises(ValueError, match="block"):
        PM.topk_mips_blocked(torch.tensor(Wq), torch.tensor(H), K,
                             block=BLOCK, exclude_lists=lists)
    with pytest.raises(ValueError, match="not both"):
        PM.topk_mips_blocked(torch.tensor(Wq), torch.tensor(H), K,
                             block=BLOCK, exclude_lists=lists,
                             exclude_mask=np.zeros((B, M), bool))
    with pytest.raises(ValueError, match="method"):
        PM.topk_mips_blocked(torch.tensor(Wq), torch.tensor(H), K,
                             method="bogus")
    with pytest.raises(ValueError, match="exceeds block"):
        PM.topk_mips_excluded(torch.tensor(Wq), torch.tensor(H), K,
                              np.zeros((B, 600), np.int32), block=BLOCK)


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_scale_rules_reject_what_nmftpu_rejects(kind):
    Wq, H = _factors(7)
    _, Ht, _, _ = _table(kind, H)
    with pytest.raises(ValueError, match="h_scale"):
        PM._score_dot(torch.tensor(Wq), Ht, np.float32(0.5))
    with pytest.raises(ValueError, match="quantization scale"):
        PM._score_dot(torch.tensor(Wq), Ht.to(torch.int8))


# ---------------------------------------------------------------------------
# certificate, re-score, gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_certify_topk_matches_nmftpu_and_the_oracle(kind):
    """Thresholds at midpoints between consecutive true scores, so every
    row's count is unambiguous: row u's count is k-1 (certified) or k
    (not), less the seen items above the threshold."""
    Wq, H = _factors(8)
    Hj, Ht, sc, Hv = _table(kind, H)
    full = _true_scores(Wq, kind, sc, Hv)
    srt = -np.sort(-full, axis=1)
    rng = np.random.default_rng(8)
    d = rng.integers(-1, 1, B)                       # -1 or 0
    pos = K - 1 + d
    theta = (srt[np.arange(B), pos] + srt[np.arange(B), pos + 1]) / 2
    top_s = np.repeat(theta[:, None], K, axis=1).astype(np.float32)
    order = np.argsort(-full, axis=1)
    seen = np.full((B, 3), -1, np.int32)
    seen[::2, 0] = order[::2, 0]                     # a seen item above
    seen[1::4, 1] = order[1::4, -1]                  # a seen item below
    for sn in (None, seen):
        want = ((full > theta[:, None]).sum(1)
                - (0 if sn is None else
                   ((np.take_along_axis(full, np.maximum(sn, 0), 1)
                     > theta[:, None]) & (sn >= 0)).sum(1))) <= K - 1
        ref = JM.certify_topk(jnp.asarray(Wq), Hj, jnp.asarray(top_s), K,
                              block=BLOCK, h_scale=sc,
                              seen=None if sn is None else jnp.asarray(sn))
        got = PM.certify_topk(torch.tensor(Wq), Ht, torch.tensor(top_s), K,
                              block=BLOCK, h_scale=sc, seen=sn)
        np.testing.assert_array_equal(np.asarray(ref), want)
        np.testing.assert_array_equal(got.numpy(), want)


def test_certify_counts_a_repeated_seen_id_once():
    """A training CSR may repeat a (user, item) pair. The candidates here
    miss the 11th item, so 11 items beat the threshold, one of them seen:
    10 > k-1, not certified. nmftpu discounts the repeated seen id twice
    and certifies the row (a fault the port does not copy)."""
    Wq, H = _factors(15, b=1)
    full = Wq.astype(np.float64) @ H.astype(np.float64)
    order = np.argsort(-full[0])
    seen = np.array([[order[0], order[0], -1]], np.int32)
    top_s = full[0, order[1:11]][None, :].astype(np.float32)
    # the kth candidate is order[11] (order[10] was missed); its threshold
    # sits between the two, clear of rounding
    top_s[0, -1] = (full[0, order[10]] + full[0, order[11]]) / 2
    got = PM.certify_topk(torch.tensor(Wq), torch.tensor(H), top_s, K,
                          block=BLOCK, seen=seen)
    ref = JM.certify_topk(jnp.asarray(Wq), jnp.asarray(H), top_s, K,
                          block=BLOCK, seen=jnp.asarray(seen))
    assert not got.numpy().any()
    assert np.asarray(ref).all()          # the reference's double count
    once = PM.certify_topk(torch.tensor(Wq), torch.tensor(H), top_s, K,
                           block=BLOCK, seen=seen[:, 1:])
    np.testing.assert_array_equal(once.numpy(), got.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_topk_mips_certified_matches_nmftpu(kind):
    Wq, H = _factors(9)
    Hj, Ht, sc, _ = _table(kind, H)
    seen = _seen(np.random.default_rng(9), B, M, 4)
    for sn, ck in ((None, 2 * K), (seen, 2 * K), (None, 1)):
        s_ref, i_ref, c_ref = JM.topk_mips_certified(
            jnp.asarray(Wq), Hj, K, block=BLOCK, candidate_k=ck,
            h_scale=sc, seen=None if sn is None else jnp.asarray(sn))
        s, i, c = PM.topk_mips_certified(torch.tensor(Wq), Ht, K,
                                         block=BLOCK, candidate_k=ck,
                                         h_scale=sc, seen=sn)
        assert_same_topk(s, i, s_ref, i_ref)
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
        if ck == 1:      # 6 blocks x 1 candidate < k: nothing certifies
            assert not c.numpy().any()


@pytest.mark.parametrize("kind", KINDS)
def test_rescore_and_sort_matches_nmftpu(kind):
    Wq, H = _factors(10)
    Hj, Ht, sc, _ = _table(kind, H)
    rng = np.random.default_rng(10)
    ids = np.stack([rng.choice(M, 12, replace=False) for _ in range(B)]
                   ).astype(np.int32)
    invalid = rng.random((B, 12)) < 0.2
    seen = np.full((B, 2), -1, np.int32)
    seen[:, 0] = ids[:, 3]
    s_ref, i_ref = JM.rescore_and_sort(jnp.asarray(Wq), Hj,
                                       jnp.asarray(ids), h_scale=sc,
                                       invalid=jnp.asarray(invalid),
                                       seen=jnp.asarray(seen))
    s, i = PM.rescore_and_sort(torch.tensor(Wq), Ht, torch.tensor(ids),
                               h_scale=sc, invalid=invalid, seen=seen)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=RTOL,
                               atol=0)
    fin = np.isfinite(np.asarray(s_ref))
    np.testing.assert_array_equal(i.numpy()[fin], np.asarray(i_ref)[fin])
    assert (~fin).sum(1).min() >= 1                  # seen id masked


@pytest.mark.parametrize("kind", KINDS)
def test_gather_scores_matches_nmftpu_and_the_scan(kind):
    """The gather agrees with nmftpu's to rtol, and for bf16/int8 tables
    it is bit for bit the column of the scan's own scores (the products
    are exact; both sum them in index order on the CPU)."""
    Wq, H = _factors(11)
    Hj, Ht, sc, _ = _table(kind, H)
    ids = np.random.default_rng(11).integers(0, M, (B, 9)).astype(np.int32)
    want = np.asarray(JM._gather_scores(jnp.asarray(Wq), Hj,
                                        jnp.asarray(ids), sc))
    got = PM._gather_scores(torch.tensor(Wq), Ht, torch.tensor(ids), sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    if kind != "float32":
        full = PM._score_dot(torch.tensor(Wq), Ht, sc).numpy()
        np.testing.assert_array_equal(
            got.numpy(), np.take_along_axis(full, ids.astype(np.int64), 1))


@pytest.mark.parametrize("kind", KINDS)
def test_count_above_matches_nmftpu(kind):
    """The plain blocked count on the CPU, against nmftpu's, at random
    thresholds (no score lands within rounding of one)."""
    Wq, H = _factors(12)
    Hj, Ht, sc, _ = _table(kind, H)
    full = PM._score_dot(torch.tensor(Wq), Ht, sc).numpy()
    rng = np.random.default_rng(12)
    theta = np.array([np.quantile(row, q) for row, q in
                      zip(full, rng.uniform(0.9, 1.0, B))],
                     np.float32) * np.float32(1.0001)
    ref = JM._count_above(jnp.asarray(Wq), Hj, jnp.asarray(theta), BLOCK, sc)
    got = PM._count_above(torch.tensor(Wq), Ht, torch.tensor(theta), BLOCK,
                          sc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# host side: exclusion lists and sparse containers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [64, 512, 5000])
def test_build_block_exclusion_equals_nmftpu(block):
    rng = np.random.default_rng(13)
    dense = (rng.random((40, M)) < 0.01).astype(np.float32)
    dense[3] = 0.0                                   # an empty user
    csr_j = JS.from_dense(dense).to_csr()
    csr_p = PS.from_dense(dense).to_csr()
    users = np.array([3, 0, 17, 39, 8])
    for got, want in zip(PX.build_block_exclusion(users, csr_p, M, block),
                         JX.build_block_exclusion(users, csr_j, M, block)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    empty = PX.build_block_exclusion(np.array([3]), csr_p, M, block)
    for got, want in zip(empty, JX.build_block_exclusion(
            np.array([3]), csr_j, M, block)):
        np.testing.assert_array_equal(got, want)


def test_sharded_exclusion_raises():
    csr = PS.from_dense(np.eye(4, 8, dtype=np.float32)).to_csr()
    with pytest.raises(NotImplementedError, match="slice 6"):
        PX.build_block_exclusion(np.arange(4), csr, 8, 4, shards=2)


def test_sparse_containers_equal_nmftpu():
    rng = np.random.default_rng(14)
    dense = np.where(rng.random((30, 50)) < 0.2,
                     rng.uniform(0.5, 5.0, (30, 50)), 0.0).astype(np.float32)
    pj, pp = JS.from_dense(dense), PS.from_dense(dense)
    for conv in ("to_csr", "to_csc"):
        a, b = getattr(pj, conv)(), getattr(pp, conv)()
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            assert getattr(b, f).dtype == getattr(a, f).dtype
        np.testing.assert_array_equal(b.todense(), dense)
        np.testing.assert_array_equal(b.to_coo().todense(), dense)
    np.testing.assert_array_equal(pp.T.todense(), dense.T)
    assert pp.nnz == pj.nnz and pp.to_csr().row_lengths().sum() == pp.nnz
    for fmt in ("csr", "csc", "coo"):
        m = sp.random(20, 30, density=0.1, format=fmt, random_state=1,
                      dtype=np.float32)
        np.testing.assert_array_equal(PS.from_scipy(m).todense(),
                                      m.toarray())
    with pytest.raises(ValueError, match="indptr"):
        PS.SparseCSR(np.zeros(3), np.zeros(0), np.zeros(0), (5, 5))
    with pytest.raises(ValueError, match="length"):
        PS.SparseCOO([0, 1], [0], [1.0, 2.0], (2, 2))
