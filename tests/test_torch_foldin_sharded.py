"""Cold-user fold-in on a sharded Recommender (Recommender(mesh=): its
prepared table from each rank's item shard, the replicated solves, the
per-shard scan of recommend_from_history*) against nmftpu's Recommender
on a mesh, on the CPU.

The port runs in one 4-rank gloo world on a 1 x 4 mesh (250 items a
rank); the ranks run tests/torch_mesh_ranks.py, which imports neither
jax nor nmftpu, and build the same Recommender on one device beside it.
nmftpu runs here on a 1 x 4 mesh of the conftest's virtual CPU devices.

Tolerances: the sharded Gram against the one-device Gram bit for bit
for an int8 table (int64 sums) and 1e-6 relative for a float table;
fold-ins 1e-5 of max|x| against the port's one-device fold-in and 1e-4
against nmftpu's (float32 sums in another order); top-k scores 1e-5
relative (2⁻⁸ for bf16 and int8 tables, whose scans round the queries to
bf16) with ids equal except at near-ties."""

import jax
import numpy as np
import pytest

from nmftpu.parallel import make_grid_mesh
from nmftpu.serving import Recommender as JRec
from nmftpu.sparse import SparseCSR as JCSR
from nmftpu_torch.parallel import launch

import torch_mesh_ranks as M

N, M_, R, K = 40, 1000, 8, 10
SHAPE = (1, 4)
TIMEOUT = 240
FOLD_KW = {"als": {}, "ials": {"alpha_confidence": 40.0},
           "mu": {"algorithm": "mu"},
           "mu-kl": {"algorithm": "mu", "objective": "kl"},
           "hals": {"algorithm": "hals"}}
TABLES = ("float32", "bfloat16", "int8")
METHODS = ("exact", "reservoir")


def _data():
    rng = np.random.default_rng(1)
    W = rng.uniform(0.0, 1.0, (N, R)).astype(np.float32)
    mag = np.logspace(0, -2, R).astype(np.float32)[:, None]
    H = (rng.uniform(0.0, 1.0, (R, M_)) * mag).astype(np.float32)
    seen = (rng.uniform(size=(N, M_)) < 0.02).astype(np.float32)
    csr = _csr(seen)
    hists = [rng.choice(M_, 20, replace=False) for _ in range(5)]
    hists.append((rng.choice(M_, 3, replace=False),
                  np.array([2.0, 4.5, 1.0], np.float32)))
    hists.append(np.array([M_ - 1]))
    return {"W": W, "H": H, "train": csr, "histories": hists, "k": K}


def _csr(dense):
    rows, cols = np.nonzero(dense)
    counts = np.bincount(rows, minlength=len(dense))
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return (indptr.astype(np.int64), cols.astype(np.int32),
            dense[rows, cols].astype(np.float32), dense.shape)


def _name(table, method, fold):
    return f"{table}-{method}-{fold}"


@pytest.fixture(scope="module")
def ranks():
    data = _data()
    cases = [(_name(t, m, f), dict(table_dtype=t, method=m,
                                   reservoir_slots=128, block=64), kw)
             for t in TABLES for m in METHODS for f, kw in FOLD_KW.items()]
    return {"data": data, "out": launch(M.foldin, 4,
                                        args=(SHAPE, cases, data),
                                        timeout=TIMEOUT, threads=1)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def assert_same_rows(s, i, s_ref, i_ref, rtol):
    """Scores within rtol; ids equal wherever no other score of the row
    ties within rtol (the last slot may tie the next item)."""
    np.testing.assert_allclose(s, s_ref, rtol=rtol, atol=0)
    for row in range(len(s)):
        fin = np.isfinite(s_ref[row])
        for p in np.flatnonzero(fin & (i[row] != i_ref[row])):
            close = np.abs(s_ref[row] - s_ref[row, p]) <= \
                rtol * abs(s_ref[row, p])
            assert close.sum() > 1 or p == fin.sum() - 1, (row, p)


_J = {}


def _jrec(data, table, method):
    key = (table, method)
    if key not in _J:
        indptr, indices, values, shape = data["train"]
        _J[key] = JRec(data["W"], data["H"],
                       train=JCSR(indptr, indices, values, shape),
                       mesh=make_grid_mesh(SHAPE, devices=jax.devices()[:4]),
                       method=method, table_dtype=table, reservoir_slots=128,
                       block=64)
    return _J[key]


def test_ranks_import_neither_jax_nor_nmftpu(ranks):
    for r in ranks["out"]:
        assert r["_imported"] == {"jax": False, "nmftpu": False}


@pytest.mark.parametrize("table", TABLES)
def test_sharded_gram_equals_the_unsharded(ranks, table):
    for r in ranks["out"]:
        got = r[_name(table, "exact", "als")]
        if table == "int8":
            np.testing.assert_array_equal(got["mesh"]["G"], got["one"]["G"])
            np.testing.assert_array_equal(got["mesh"]["h_sum"],
                                          got["one"]["h_sum"])
        else:
            assert _rel(got["mesh"]["G"], got["one"]["G"]) <= 1e-6
            assert _rel(got["mesh"]["h_sum"], got["one"]["h_sum"]) <= 1e-6


@pytest.mark.parametrize("fold", list(FOLD_KW))
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("table", TABLES)
def test_sharded_fold_in_matches(ranks, table, method, fold):
    """The replicated solves give every rank the same embeddings, the
    one-device ones and nmftpu's on its mesh; recommend_from_history
    returns no history item."""
    data = ranks["data"]
    out = ranks["out"]
    got = out[0][_name(table, method, fold)]
    for r in out[1:]:
        np.testing.assert_array_equal(r[_name(table, method, fold)]["mesh"]
                                      ["W"], got["mesh"]["W"])
    assert _rel(got["mesh"]["W"], got["one"]["W"]) <= 1e-5
    jr = _jrec(data, table, method)
    kw = FOLD_KW[fold]
    assert _rel(got["mesh"]["W"],
                jr.fold_in_batch(data["histories"], **kw)) <= 1e-4
    s, i = got["mesh"]["top"]
    s_ref, i_ref = jr.recommend_from_history_batch(data["histories"], k=K,
                                                   **kw)
    rtol = 1e-5 if table == "float32" else 2.0 ** -8
    assert_same_rows(s, i, np.asarray(s_ref), np.asarray(i_ref),
                     rtol=max(rtol, 1e-4 if fold != "als" else rtol))
    for u, h in enumerate(data["histories"]):
        ids = h[0] if isinstance(h, tuple) else h
        assert not set(np.asarray(ids).tolist()) & set(i[u].tolist())
