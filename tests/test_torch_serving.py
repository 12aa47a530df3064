"""The port's Recommender and recall_at_k against nmftpu's on the same
tables (carried across by convert.recommender_from_nmftpu), on the CPU.
nmftpu's reservoir scan runs in interpret mode here."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmftpu.retrieval.evaluate import recall_at_k as j_recall  # noqa: E402
from nmftpu.serving import Recommender as JRec  # noqa: E402
from nmftpu.sparse import from_dense as j_from_dense  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import serving as PSV  # noqa: E402
from nmftpu_torch.convert import recommender_from_nmftpu  # noqa: E402
from nmftpu_torch.sparse import from_dense  # noqa: E402

# scores: the same float32 products summed in two orders (r <= 8)
RTOL = 1e-5
METHODS = ["exact", "approx", "reservoir"]
DTYPES = ["float32", "bfloat16", "int8"]


def _factors(seed=0, n=40, m=1000, r=8):
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (n, r)).astype(np.float32)
    mag = np.logspace(0, -2, r).astype(np.float32)[:, None]
    H = (rng.uniform(0.0, 1.0, (r, m)) * mag).astype(np.float32)
    return W, H


def _seen_dense(n, m, frac, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, m)) < frac).astype(np.float32)


def _pair(W, H, seen=None, **kw):
    """(nmftpu Recommender, the port's over the same tables)."""
    jr = JRec(W, H, train=None if seen is None else j_from_dense(seen),
              **kw)
    return jr, recommender_from_nmftpu(jr, device="cpu")


def _exact(W, H, seen, users, k):
    """Brute-force float64 top-k sets (seen items excluded)."""
    full = W[users].astype(np.float64) @ H.astype(np.float64)
    if seen is not None:
        full = np.where(seen[users] > 0, -np.inf, full)
    return [set(np.argsort(-row, kind="stable")[:k].tolist())
            for row in full]


def assert_same_rows(s, i, s_ref, i_ref, rtol=RTOL):
    """Scores within rtol (-inf equal); finite ids equal wherever no other
    score ties within rtol."""
    np.testing.assert_allclose(s, s_ref, rtol=rtol, atol=0)
    for row in range(len(s)):
        fin = np.isfinite(s_ref[row])
        for p in np.flatnonzero(fin & (i[row] != i_ref[row])):
            close = np.abs(s_ref[row] - s_ref[row, p]) <= \
                rtol * abs(s_ref[row, p])
            assert close.sum() > 1 or p == fin.sum() - 1, (row, p)


# ---------------------------------------------------------------------------
# construction: the same tables as nmftpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table_dtype", DTYPES)
def test_tables_equal_nmftpu(table_dtype, monkeypatch):
    """Built from the same W, H, both packages hold the same table bits
    (int8 values and per-dimension scales included)."""
    monkeypatch.setattr(PSV, "_QUANT_CHUNK", 300)   # several chunks
    W, H = _factors(1)
    jr = JRec(W, H, table_dtype=table_dtype)
    pr = nt.Recommender(W, H, table_dtype=table_dtype, device="cpu")
    want = np.asarray(jr.H)
    got = pr.H.float().numpy() if table_dtype == "bfloat16" \
        else pr.H.numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    if table_dtype == "int8":
        np.testing.assert_array_equal(pr._h_scale.numpy(), jr._h_scale)
    assert pr.n_items == jr.n_items and pr.n_users == jr.n_users
    assert pr.block == jr.block
    np.testing.assert_array_equal(pr.user_embedding([3, 1]),
                                  jr.user_embedding([3, 1]))


def test_reservoir_table_is_not_padded():
    W, H = _factors(2, m=500)
    jr, pr = _pair(W, H, method="reservoir", reservoir_slots=128)
    assert jr.H.shape[1] == 512 and pr.H.shape[1] == 500
    assert pr.n_items == 500


# ---------------------------------------------------------------------------
# recommend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("exclude_seen", [False, True])
def test_recommend_matches_nmftpu(method, table_dtype, exclude_seen):
    W, H = _factors(3)
    seen = _seen_dense(40, 1000, 0.02, seed=3)
    jr, pr = _pair(W, H, seen, method=method, table_dtype=table_dtype,
                   reservoir_slots=256, block=300)
    users = np.arange(0, 40, 2)
    s_ref, i_ref = jr.recommend(users, k=10, exclude_seen=exclude_seen)
    s, i = pr.recommend(users, k=10, exclude_seen=exclude_seen)
    assert isinstance(s, np.ndarray) and i.dtype == np.int32
    assert s.shape == (20, 10) and s.dtype == np.float32
    assert_same_rows(s, i, np.asarray(s_ref), np.asarray(i_ref))
    if exclude_seen:
        for row, u in enumerate(users):
            assert not set(i[row].tolist()) & set(
                np.flatnonzero(seen[u]).tolist())


def test_reservoir_recall_against_the_exact_oracle():
    """A reservoir of 64 slots over 1000 items: recall of the top-10
    stays near 1 - C(k,3)/R^2 and the exact method is exact."""
    W, H = _factors(4)
    users = np.arange(40)
    exact = _exact(W, H, None, users, 10)
    for method, floor in (("reservoir", 0.95), ("exact", 1.0)):
        rec = nt.Recommender(W, H, method=method, reservoir_slots=64,
                             device="cpu")
        _, i = rec.recommend(users, k=10, exclude_seen=False)
        recall = np.mean([len(set(i[u].tolist()) & exact[u]) / 10
                          for u in range(40)])
        assert recall >= floor, (method, recall)


def test_exclude_everything_returns_fillers():
    W, H = _factors(5, n=4, m=50)
    rec = nt.Recommender(W, H, train=from_dense(np.ones((4, 50))),
                         device="cpu")
    s, _ = rec.recommend([1], k=5)
    assert np.isneginf(s).all()


def test_reservoir_candidate_k_warns():
    W, H = _factors(6)
    rec = nt.Recommender(W, H, method="reservoir", reservoir_slots=128,
                         device="cpu")
    with pytest.warns(UserWarning, match="reservoir_slots"):
        rec.recommend([0], k=5, exclude_seen=False, candidate_k=32)
    with pytest.warns(UserWarning, match="reservoir_slots"):
        rec.recommend_certified([0], k=5, exclude_seen=False,
                                candidate_k=32)


# ---------------------------------------------------------------------------
# recommend_certified
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("table_dtype", DTYPES)
def test_recommend_certified_matches_nmftpu(method, table_dtype):
    W, H = _factors(7)
    seen = _seen_dense(40, 1000, 0.01, seed=7)
    jr, pr = _pair(W, H, seen, method=method, table_dtype=table_dtype,
                   reservoir_slots=256, block=300)
    users = np.arange(0, 40, 3)
    kw = {} if method == "reservoir" else {"candidate_k": 16}
    s_ex, i_ex = pr._exact_rows(users, 8, True)
    for fallback in (None, "exact"):
        s_ref, i_ref, c_ref = jr.recommend_certified(
            users, k=8, fallback=fallback, **kw)
        s, i, c = pr.recommend_certified(users, k=8, fallback=fallback,
                                         **kw)
        assert c.dtype == bool and c.shape == (len(users),)
        assert_same_rows(s, i, s_ref, i_ref)
        # certificate ties: the kth item's own score can round above the
        # threshold in one package's count pass and not in the other's
        # (ROADMAP queue 3), so certificates may differ in a row or two;
        # whichever side certifies such a row holds the exact top-k
        differ = np.flatnonzero(c != c_ref)
        assert len(differ) <= 2, differ
        assert_same_rows(s[differ], i[differ], s_ex[differ], i_ex[differ])
        if fallback == "exact":
            assert_same_rows(s, i, s_ex, i_ex)


def test_certified_rows_are_exact_and_misses_never_certify():
    """A tiny reservoir (8 slots over 300 items) misses items; a row that
    misses must not certify, and fallback="exact" repairs every row."""
    W, H = _factors(8, m=300)
    users = np.arange(30)
    exact = _exact(W, H, None, users, 8)
    rec = nt.Recommender(W, H, method="reservoir", reservoir_slots=8,
                         device="cpu")
    _, i, cert = rec.recommend_certified(users, k=8, exclude_seen=False)
    assert not cert.all()
    for row in range(30):
        if set(i[row].tolist()) != exact[row]:
            assert not cert[row], row
    _, i2, cert2 = rec.recommend_certified(users, k=8, exclude_seen=False,
                                           fallback="exact")
    np.testing.assert_array_equal(cert2, cert)
    for row in range(30):
        assert set(i2[row].tolist()) == exact[row], row
    with pytest.raises(ValueError, match="fallback"):
        rec.recommend_certified([0], k=5, fallback="bogus")


@pytest.mark.parametrize("table_dtype", DTYPES)
def test_fallback_escalation_matches_nmftpu(table_dtype):
    """More than 16 uncertified rows take one 4x-slots certified pass
    first (m = 320 is a multiple of 4 * 8, so nmftpu escalates too), and
    only its residue reaches the exact scan; every row ends exact."""
    W, H = _factors(9, n=80, m=320)
    jr, pr = _pair(W, H, method="reservoir", table_dtype=table_dtype,
                   reservoir_slots=8)
    calls = {}
    for name, rec in (("j", jr), ("p", pr)):
        orig = rec._exact_rows
        calls[name] = []

        def spy(users, k, ex, orig=orig, log=calls[name]):
            log.append(len(users))
            return orig(users, k, ex)

        rec._exact_rows = spy
    users = np.arange(80)
    s_ref, i_ref, c_ref = jr.recommend_certified(users, k=10,
                                                 exclude_seen=False,
                                                 fallback="exact")
    s, i, c = pr.recommend_certified(users, k=10, exclude_seen=False,
                                     fallback="exact")
    n_unc = int((~c).sum())
    assert n_unc > 16, n_unc
    # certificates may differ only in tie rows (see the test above)
    assert (c != c_ref).sum() <= 2
    assert len(calls["p"]) <= 1 and len(calls["j"]) <= 1
    residue = calls["p"][0] if calls["p"] else 0
    assert residue <= max(1, n_unc // 3), (residue, n_unc)
    assert residue <= (calls["j"][0] if calls["j"] else 0) + 2
    assert_same_rows(s, i, s_ref, i_ref)


def test_escalation_oom_only_in_its_scan_falls_back(monkeypatch):
    """Out of memory in the escalated 4x-slot scan leaves its rows to the
    exact scan with a RuntimeWarning; every row still ends exact. The
    same error from the escalation's certify pass propagates."""
    W, H = _factors(9, n=80, m=320)
    rec = nt.Recommender(W, H, method="reservoir", reservoir_slots=8,
                         table_dtype="bfloat16", device="cpu")
    users = np.arange(80)
    s_ex, i_ex = rec._exact_rows(users, 10, False)
    scan = PSV.reservoir_topk_mips

    def scan_oom_at_4x(*args, slots, **kw):
        if slots == 32:
            raise torch.cuda.OutOfMemoryError("test")
        return scan(*args, slots=slots, **kw)

    monkeypatch.setattr(PSV, "reservoir_topk_mips", scan_oom_at_4x)
    with pytest.warns(RuntimeWarning, match="out of device memory"):
        s, i, c = rec.recommend_certified(users, k=10, exclude_seen=False,
                                          fallback="exact")
    assert (~c).sum() > 16
    assert_same_rows(s, i, s_ex, i_ex)

    monkeypatch.setattr(PSV, "reservoir_topk_mips", scan)

    def certify_oom(*args, **kw):
        raise torch.cuda.OutOfMemoryError("test")

    monkeypatch.setattr(PSV, "certify_topk", certify_oom)
    monkeypatch.setattr(rec, "_certified_scan",
                        lambda *a: (torch.zeros(80, 10),
                                    torch.zeros(80, 10, dtype=torch.int32),
                                    torch.zeros(80, dtype=torch.bool)))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        rec.recommend_certified(users, k=10, exclude_seen=False,
                                fallback="exact")


def test_escalation_skipped_where_nmftpu_skips_it():
    """m = 300 pads to 304 with 8 slots, not a multiple of 32: no
    escalated pass, every uncertified row goes to the exact scan."""
    W, H = _factors(10, n=40, m=300)
    rec = nt.Recommender(W, H, method="reservoir", reservoir_slots=8,
                         device="cpu")
    rows = np.arange(20)
    assert rec._escalate_rows(None, None, rows, np.arange(40), 8,
                              False) is rows


def test_certified_wide_seen_degrades():
    """A seen list too wide for oversampling takes the scatter-list scan
    plus the wide-seen certify discount: exact, no error."""
    W, H = _factors(11, n=20, m=300, r=4)
    rng = np.random.default_rng(11)
    seen = np.zeros((20, 300), np.float32)
    wide = rng.choice(300, 150, replace=False)
    seen[0, wide] = 1.0
    seen[1, [5, 6]] = 1.0
    jr, pr = _pair(W, H, seen, method="approx", block=64)
    assert pr._seen_padded(pr._train_csr, np.array([0, 1]), k=5) is None
    for fallback in (None, "exact"):
        s_ref, i_ref, c_ref = jr.recommend_certified(
            [0, 1], k=5, candidate_k=64, fallback=fallback)
        s, i, c = pr.recommend_certified([0, 1], k=5, candidate_k=64,
                                         fallback=fallback)
        np.testing.assert_array_equal(c, c_ref)
        assert_same_rows(s, i, s_ref, i_ref)
    exact = _exact(W, H, seen, np.array([0, 1]), 5)
    for row in range(2):
        assert set(i[row].tolist()) == exact[row]


def test_reservoir_certified_tiny_catalog():
    """k beyond the unseen catalog: the re-score revives no filler or
    seen id; the tail stays -inf."""
    W, H = _factors(12, n=10, m=20, r=3)
    seen = np.zeros((10, 20), np.float32)
    seen[0, :10] = 1.0
    rec = nt.Recommender(W, H, train=from_dense(seen), method="reservoir",
                         reservoir_slots=32, device="cpu")
    s, i, _ = rec.recommend_certified([0], k=15)
    fin = np.isfinite(s[0])
    ids = i[0][fin]
    assert fin.sum() == 10
    assert len(set(ids.tolist())) == 10
    assert not set(ids.tolist()) & set(range(10))


# ---------------------------------------------------------------------------
# score, persistence, recall, what raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table_dtype", DTYPES)
def test_score_matches_nmftpu(table_dtype):
    W, H = _factors(13)
    jr, pr = _pair(W, H, table_dtype=table_dtype)
    ids = [0, 17, 999, 500]
    np.testing.assert_array_equal(pr.score(3, ids), jr.score(3, ids))
    with pytest.raises(ValueError, match="out of range"):
        pr.score(0, [1000])


@pytest.mark.parametrize("table_dtype", DTYPES)
def test_save_load_round_trip_both_ways(tmp_path, table_dtype):
    """A bundle saved by either package loads in the other and serves the
    same recommendations."""
    W, H = _factors(14, m=500)
    seen = _seen_dense(40, 500, 0.02, seed=14)
    jr, pr = _pair(W, H, seen, method="reservoir", table_dtype=table_dtype,
                   reservoir_slots=128, block=200)
    pr.save(str(tmp_path / "p"))
    jr.save(str(tmp_path / "j"))
    meta_p = json.loads((tmp_path / "p" / "meta.json").read_text())
    meta_j = json.loads((tmp_path / "j" / "meta.json").read_text())
    assert meta_p == meta_j
    for f in ("W.npy", "H.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "p" / f),
                                      np.load(tmp_path / "j" / f))
    p2 = nt.Recommender.load(str(tmp_path / "j"), device="cpu")
    j2 = JRec.load(str(tmp_path / "p"))
    assert (p2.method, p2.reservoir_slots, p2.block, p2.table_dtype) == \
        ("reservoir", 128, 200, table_dtype)
    s1, i1 = p2.recommend([2, 5], k=4)
    s2, i2 = j2.recommend([2, 5], k=4)
    assert_same_rows(s1, i1, np.asarray(s2), np.asarray(i2))
    assert p2._train_csr is not None


def test_recall_at_k_matches_nmftpu():
    W, H = _factors(15, n=60, m=800)
    rng = np.random.default_rng(15)
    train = _seen_dense(60, 800, 0.02, seed=16)
    test_pairs = np.stack([rng.integers(0, 60, 200),
                           rng.integers(0, 800, 200)], axis=1)
    for method in ("exact", "approx"):
        want = j_recall(W, H, test_pairs, train=j_from_dense(train), k=50,
                        batch_users=16, block=300, method=method)
        got = nt.recall_at_k(W, torch.tensor(H), test_pairs,
                             train=from_dense(train), k=50,
                             batch_users=16, block=300, method=method)
        assert got == want
    assert np.isnan(nt.recall_at_k(W, H, np.zeros((0, 2), int)))
    # mesh= is ported (slice 6a, held against nmftpu in
    # test_torch_retrieval_sharded.py); what still raises with it is a
    # catalog that the items axis does not divide
    with pytest.raises(ValueError, match="must divide into 3 item shards"):
        nt.recall_at_k(W, H, test_pairs, mesh=_ItemShards(3))


class _ItemShards:
    """The two questions a Recommender or recall_at_k asks a mesh before
    any collective: the items axis's size and this rank's place on it
    (a collective over an axis of size 1 sends nothing)."""

    device_type = "cpu"
    mesh_dim_names = ("users", "items")

    def __init__(self, shards):
        self.shards = shards

    def size(self, dim):
        return self.shards if dim == 1 else 1

    def get_local_rank(self, axis):
        return 0


def test_unported_surfaces_raise(tmp_path):
    """Fold-in is ported (slice 9, held against nmftpu in
    test_torch_foldin.py): its four entry points now serve. mesh= is
    ported too (slice 6a, test_torch_retrieval_sharded.py), and fold-in
    on a mesh (slice 6b, test_torch_foldin_sharded.py): on a Recommender
    built or loaded over a one-shard mesh it equals the unsharded
    fold-in."""
    W, H = _factors(17)
    rec = nt.Recommender(W, H, device="cpu")
    assert rec.fold_in([1, 2]).shape == (8,)
    assert rec.fold_in_batch([[1, 2]]).shape == (1, 8)
    s, i = rec.recommend_from_history([1, 2], k=5)
    assert s.shape == i.shape == (5,) and not {1, 2} & set(i.tolist())
    s, i = rec.recommend_from_history_batch([[1, 2]], k=5)
    assert s.shape == i.shape == (1, 5)
    sharded = nt.Recommender(W, H, mesh=_ItemShards(1), device="cpu")
    np.testing.assert_allclose(sharded.fold_in([1, 2]), rec.fold_in([1, 2]),
                               rtol=1e-6, atol=1e-7)
    rec.save(str(tmp_path / "r"))
    loaded = nt.Recommender.load(str(tmp_path / "r"), mesh=_ItemShards(1),
                                 device="cpu")
    s2, i2 = loaded.recommend_from_history([1, 2], k=5)
    s1, i1 = rec.recommend_from_history([1, 2], k=5)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(s2, s1, rtol=1e-6, atol=1e-6)


def test_bad_settings_raise():
    W, H = _factors(18)
    with pytest.raises(ValueError, match="approx|exact|reservoir"):
        nt.Recommender(W, H, method="bogus", device="cpu")
    with pytest.raises(ValueError, match="table_dtype"):
        nt.Recommender(W, H, table_dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="h_scale"):
        nt.Recommender.from_table(W, np.zeros((8, 5), np.int8),
                                  device="cpu")


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    W, H = _factors(19)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nt.Recommender(W, H)
