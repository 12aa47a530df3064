"""The port's native host IO layer against nmftpu's and against the numpy
builders, array for array: nmftpu_torch.native_loader (parse, COO -> CSR,
the fused CSR build, the bucketed-ELL fill), the native paths of the
host containers' to_csr / to_csc and of sparse_ell.build_ell_rows (with
NATIVE_MIN_NNZ lowered to 1, as tests/test_native_io.py does),
nmftpu_torch.data.movielens (load_movielens with the C++ and the numpy
parser on both fixtures, train_test_split_by_user) and the rule that an
error of a loaded library raises instead of falling back to numpy.

The library is built at first use (make -C native
build/libnmftpu_io.so CXX=g++); the tests skip only where no compiler is
found. Every comparison is exact."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nmftpu import native_loader as JNL  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ell as JE  # noqa: E402
from nmftpu.data import movielens as JML  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import native_loader as NL  # noqa: E402
from nmftpu_torch import sparse as ts  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch.data import movielens as TML  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [os.path.join(REPO, "tests", "fixtures", name)
            for name in ("ml100k_u.data", "ml20m_ratings.csv")]


@pytest.fixture(scope="module", autouse=True)
def library():
    """Build the IO library once if it is not there."""
    if not NL.available():
        if shutil.which("make") is None or shutil.which("g++") is None:
            pytest.skip("no make or C++ compiler to build libnmftpu_io.so")
        assert NL.build(), "libnmftpu_io.so did not build"
    assert NL.has_csr_build() and NL.has_ell_build()


@pytest.fixture
def native_everywhere(monkeypatch):
    """Lower the size gate so that small inputs take the native paths."""
    monkeypatch.setattr(NL, "NATIVE_MIN_NNZ", 1)
    monkeypatch.delenv("NMFTPU_NATIVE_CSR", raising=False)


def _coo(seed, n=300, m=200, nnz=5000, dtype=np.float32):
    """Distinct coordinates (the order of duplicates is unspecified in
    both builders), values in (0.1, 5)."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(n * m, nnz, replace=False)
    return ts.SparseCOO((flat // m).astype(np.int32),
                        (flat % m).astype(np.int32),
                        rng.uniform(0.1, 5.0, nnz).astype(dtype), (n, m))


def _powerlaw_coo(seed, n=400, m=9000):
    """Power-law row lengths with long rows that split into several
    segments; distinct columns within a row."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.3, n), 4000)
    rows = np.repeat(np.arange(n, dtype=np.int32), lens)
    cols = np.concatenate([rng.choice(m, k, replace=False) for k in lens])
    vals = rng.uniform(0.1, 5.0, len(rows)).astype(np.float32)
    return ts.SparseCOO(rows, cols.astype(np.int32), vals, (n, m))


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


def _numpy(fn, monkeypatch):
    monkeypatch.setenv("NMFTPU_NATIVE_CSR", "0")
    try:
        return fn()
    finally:
        monkeypatch.delenv("NMFTPU_NATIVE_CSR")


# ---------------------------------------------------------------------------
# native_loader
# ---------------------------------------------------------------------------


def test_loader_surface_and_constants():
    assert NL.NATIVE_MIN_NNZ == JNL.NATIVE_MIN_NNZ == 1 << 20
    assert NL.available() and JNL.available()
    assert os.path.realpath(NL.library_path()) == os.path.realpath(
        os.path.join(REPO, "native", "build", "libnmftpu_io.so"))


@pytest.mark.parametrize("path", FIXTURES)
@pytest.mark.parametrize("implicit", [False, True])
def test_parse_movielens_matches_nmftpu(path, implicit):
    before = NL.CALLS["parse_movielens"]
    got = NL.parse_movielens(path, implicit=implicit)
    want = JNL.parse_movielens(path, implicit=implicit)
    assert NL.CALLS["parse_movielens"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_coo_to_csr_matches_nmftpu(seed):
    coo = _coo(seed)
    got = NL.coo_to_csr(coo.row, coo.col, coo.shape[0])
    want = JNL.coo_to_csr(coo.row, coo.col, coo.shape[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    indptr, perm = got
    numpy_csr = ts.SparseCOO(coo.row, coo.col, coo.data, coo.shape)
    np.testing.assert_array_equal(indptr, numpy_csr.to_csr().indptr)
    np.testing.assert_array_equal(coo.col[perm], numpy_csr.to_csr().indices)


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_build_matches_nmftpu_and_numpy(seed, monkeypatch):
    coo = _coo(seed)
    got = NL.csr_build(coo.row, coo.col, coo.data, coo.shape[0])
    want = JNL.csr_build(coo.row, coo.col, coo.data, coo.shape[0])
    ref = _numpy(coo.to_csr, monkeypatch)
    for g, w, r in zip(got, want, (ref.indptr, ref.indices, ref.data)):
        assert g.dtype == w.dtype == r.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("seg_max,chunk", [(512, 64), (8, 4)])
def test_ell_build_matches_nmftpu_and_numpy(seg_max, chunk, monkeypatch):
    """Bucket for bucket, the padding rule and the out_row tail included."""
    csr = _powerlaw_coo(2).to_csr()
    buckets = TE.DEFAULT_BUCKETS if seg_max == 512 else (2, 4, 8)

    def pad(ns):
        return TE._pad_segments(ns, chunk)

    got = NL.ell_build(csr.indptr, csr.indices, csr.data, seg_max, buckets,
                       pad_segments=pad)
    want = JNL.ell_build(csr.indptr, csr.indices, csr.data, seg_max,
                         buckets, pad_segments=pad)
    ref = _numpy(lambda: TE.build_ell_rows(
        csr, seg_max=seg_max, buckets=buckets, chunk_segments=chunk,
        device="cpu"), monkeypatch)
    assert len(got) == len(want) == len(ref.buckets)
    for g, w, rb in zip(got, want, ref.buckets):
        assert g[3:] == w[3:] and g[4] == rb.width
        for a, b, r in zip(g[:3], w[:3], (rb.vals, rb.cols, rb.out_row)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, r.numpy())


# ---------------------------------------------------------------------------
# the containers' and the ELL builder's native paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_to_csr_and_to_csc_take_the_native_build(seed, native_everywhere,
                                                 monkeypatch):
    coo = _coo(seed)
    before = NL.CALLS["csr_build"]
    csr, csc = coo.to_csr(), coo.to_csc()
    assert NL.CALLS["csr_build"] == before + 2
    ref_csr = _numpy(coo.to_csr, monkeypatch)
    ref_csc = _numpy(coo.to_csc, monkeypatch)
    assert NL.CALLS["csr_build"] == before + 2
    _same(csr, ref_csr, ("indptr", "indices", "data"))
    _same(csc, ref_csc, ("indptr", "indices", "data"))
    # nmftpu's containers take the same native build
    jcoo = js.SparseCOO(coo.row, coo.col, coo.data, coo.shape)
    monkeypatch.setattr(JNL, "NATIVE_MIN_NNZ", 1)
    _same(csr, jcoo.to_csr(), ("indptr", "indices", "data"))


@pytest.mark.parametrize("case", ["float64", "below threshold", "disabled"])
def test_native_csr_applies_only_where_nmftpus_does(case, monkeypatch):
    """float64 data, fewer than NATIVE_MIN_NNZ nonzeros, or
    NMFTPU_NATIVE_CSR=0: numpy's sort, no native call."""
    coo = _coo(3, dtype=np.float64 if case == "float64" else np.float32)
    monkeypatch.setattr(NL, "NATIVE_MIN_NNZ",
                        coo.nnz + 1 if case == "below threshold" else 1)
    if case == "disabled":
        monkeypatch.setenv("NMFTPU_NATIVE_CSR", "0")
    before = dict(NL.CALLS)
    csr = coo.to_csr()
    pair = TE.build_ell_pair(coo, dtype=torch.float32, device="cpu")
    assert NL.CALLS == before
    assert csr.data.dtype == coo.data.dtype and pair.rows.nnz == coo.nnz


@pytest.mark.parametrize("seg_max,chunk", [(512, 2048), (8, 4)])
def test_build_ell_pair_native_equals_numpy_and_nmftpu(seg_max, chunk,
                                                       native_everywhere,
                                                       monkeypatch):
    coo = _powerlaw_coo(4)
    buckets = TE.DEFAULT_BUCKETS if seg_max == 512 else (2, 4, 8)
    kw = dict(seg_max=seg_max, buckets=buckets, chunk_segments=chunk)
    before = NL.CALLS["ell_build"]
    got = TE.build_ell_pair(coo, dtype=torch.float32, device="cpu", **kw)
    assert NL.CALLS["ell_build"] == before + 2
    ref = _numpy(lambda: TE.build_ell_pair(coo, dtype=torch.float32,
                                           device="cpu", **kw), monkeypatch)
    monkeypatch.setattr(JNL, "NATIVE_MIN_NNZ", 1)
    want = JE.build_ell_pair(js.SparseCOO(coo.row, coo.col, coo.data,
                                          coo.shape), **kw)
    for g, r, w in ((got.rows, ref.rows, want.rows),
                    (got.cols, ref.cols, want.cols)):
        assert g.shape == r.shape and g.nnz == r.nnz == w.nnz
        assert len(g.buckets) == len(r.buckets) == len(w.buckets)
        for gb, rb, wb in zip(g.buckets, r.buckets, w.buckets):
            assert gb.width == rb.width == wb.width
            for f in ("vals", "cols", "out_row"):
                assert torch.equal(getattr(gb, f), getattr(rb, f))
                np.testing.assert_array_equal(getattr(gb, f).numpy(),
                                              np.asarray(getattr(wb, f)))


def test_ell_runs_from_native_and_numpy_builds_agree_bit_for_bit(
        native_everywhere, monkeypatch):
    coo = _coo(5)
    kw = dict(rank=4, num_iterations=6, check_interval=3, seed=0,
              strategy="ell", device="cpu")
    nat = nt.nmf(coo, **kw)
    ref = _numpy(lambda: nt.nmf(coo, **kw), monkeypatch)
    assert torch.equal(nat.W, ref.W) and torch.equal(nat.H, ref.H)


def test_a_failing_native_call_raises(native_everywhere):
    """A row index past the shape: the loaded library refuses it
    (nmio_csr_build rc -2) and the error reaches the caller; nmftpu's
    blanket except would fall back to numpy here."""
    coo = _coo(6)
    coo.row[0] = coo.shape[0]
    with pytest.raises(RuntimeError, match="nmio_csr_build"):
        coo.to_csr()
    with pytest.raises(RuntimeError, match="nmio_parse"):
        NL.parse_movielens(os.path.join(REPO, "tests", "fixtures",
                                        "missing.data"))


def test_an_unbuilt_library_takes_the_numpy_paths(monkeypatch, tmp_path):
    monkeypatch.setenv("NMFTPU_NATIVE_LIB", str(tmp_path / "none.so"))
    monkeypatch.setattr(NL, "_lib_checked", False)
    monkeypatch.setattr(NL, "_lib", None)
    monkeypatch.setattr(NL, "NATIVE_MIN_NNZ", 1)
    assert not NL.available() and not NL.has_ell_build()
    coo = _coo(7)
    assert coo.to_csr().nnz == coo.nnz
    assert TE.build_ell_rows(coo, device="cpu").nnz == coo.nnz
    with pytest.raises(RuntimeError, match="unavailable"):
        NL.csr_build(coo.row, coo.col, coo.data, coo.shape[0])
    with pytest.raises(RuntimeError, match="not built"):
        TML.load_movielens(FIXTURES[0], use_native=True)
    assert TML.load_movielens(FIXTURES[0]).matrix.nnz > 0


# ---------------------------------------------------------------------------
# data/movielens.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", FIXTURES)
@pytest.mark.parametrize("use_native", [None, True, False])
@pytest.mark.parametrize("implicit", [False, True])
def test_load_movielens_matches_nmftpu(path, use_native, implicit):
    got = TML.load_movielens(path, implicit=implicit, use_native=use_native)
    want = JML.load_movielens(path, implicit=implicit, use_native=use_native)
    assert isinstance(got.matrix, ts.SparseCOO)
    assert got.matrix.shape == want.matrix.shape
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    _same(got.matrix, want.matrix, ("row", "col", "data"))
    _same(got, want, ("user_ids", "item_ids", "timestamps"))


@pytest.mark.parametrize("path", FIXTURES)
def test_native_and_numpy_parsers_agree(path):
    nat = TML.load_movielens(path, use_native=True)
    py = TML.load_movielens(path, use_native=False)
    np.testing.assert_array_equal(nat.matrix.todense(), py.matrix.todense())
    _same(nat, py, ("user_ids", "item_ids"))
    np.testing.assert_array_equal(np.sort(nat.timestamps),
                                  np.sort(py.timestamps))


def test_load_movielens_refuses_a_missing_file():
    with pytest.raises(FileNotFoundError):
        TML.load_movielens(os.path.join(REPO, "tests", "fixtures", "none"))


@pytest.mark.parametrize("path", FIXTURES)
@pytest.mark.parametrize("holdout,by_time,seed", [
    (1, True, 0), (2, True, 0), (1, False, 0), (2, False, 3)])
def test_train_test_split_matches_nmftpu(path, holdout, by_time, seed):
    got = TML.train_test_split_by_user(
        TML.load_movielens(path, use_native=False), holdout_per_user=holdout,
        seed=seed, by_time=by_time)
    want = JML.train_test_split_by_user(
        JML.load_movielens(path, use_native=False), holdout_per_user=holdout,
        seed=seed, by_time=by_time)
    _same(got[0], want[0], ("row", "col", "data"))
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[1]) > 0


def test_the_package_exports_the_loader():
    from nmftpu_torch import data

    assert data.load_movielens is TML.load_movielens
    assert data.Interactions is TML.Interactions
    assert data.train_test_split_by_user is TML.train_test_split_by_user
