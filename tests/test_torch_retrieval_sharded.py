"""The port's sharded retrieval (nmftpu_torch.parallel.retrieval_sharded,
Recommender(mesh=), recall_at_k(mesh=), sharded exclusion lists) against
nmftpu's on the CPU: one 4-rank gloo world (the port's launcher,
tests/torch_parallel_ranks.py, no jax in the ranks) on a 2x2 mesh, each
rank holding its 'items' slice; nmftpu on a 2x2 mesh of virtual CPU
devices with H sharded on 'items'; the same numpy inputs.

Scores within 1e-5 (float32 products of r <= 8 terms summed in two
orders); ids equal wherever the reference has no near-tie (the rule of
tests/test_torch_retrieval.py's assert_same_topk); certificates equal
but for at most two tie rows (the kth item's own score can round above
the threshold in one package's count and not the other's; ROADMAP queue
3), whichever side certifies such a row holding the exact top-k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmftpu.parallel import certify_topk_sharded as j_certify
from nmftpu.parallel import factor_shardings, make_grid_mesh
from nmftpu.parallel import topk_mips_sharded as j_topk
from nmftpu.retrieval.evaluate import recall_at_k as j_recall
from nmftpu.retrieval.exclusion import build_block_exclusion as j_lists
from nmftpu.serving import Recommender as JRec
from nmftpu.sparse import SparseCSR as JCSR
from nmftpu.sparse import from_dense as j_from_dense
from nmftpu_torch.parallel import launch
from nmftpu_torch.retrieval.exclusion import build_block_exclusion
from nmftpu_torch.sparse import from_dense
from test_torch_retrieval import assert_same_topk

import torch_parallel_ranks as R

B, RK, M, K = 6, 8, 256, 7
TIMEOUT = 240
TOPK = {
    "exact": dict(method="exact", block=16),
    "approx": dict(method="approx", block=32, candidate_k=2),
    "exact-seen": dict(method="exact", block=16, seen=True),
    "approx-seen": dict(method="approx", block=32, candidate_k=3,
                        seen=True),
    "exact-mask": dict(method="exact", block=16, mask=True),
    "exact-lists": dict(method="exact", block=32, lists=True),
    "approx-lists": dict(method="approx", block=32, candidate_k=2,
                         lists=True),
    "reservoir-float32": dict(method="reservoir", block=16, slots=32),
    "reservoir-bfloat16": dict(method="reservoir", block=16, slots=32,
                               table="bfloat16"),
    "reservoir-int8": dict(method="reservoir", block=16, slots=32,
                           table="int8"),
    "reservoir-int8-seen": dict(method="reservoir", block=16, slots=32,
                                table="int8", seen=True),
}
CERTIFY = {
    "float32": dict(block=16),
    "bfloat16": dict(block=16, table="bfloat16"),
    "int8": dict(block=32, table="int8"),
    "int8-seen": dict(block=32, table="int8", seen=True),
    # a row that misses its best item, whose best seen id is listed twice
    "repeated-seen": dict(block=16, seen=True, top="top_miss",
                          seen_key="seen_rep"),
}
# each method once, and each table dtype under the reservoir kernel
RECS = [("exact", "float32"), ("approx", "bfloat16"),
        ("reservoir", "float32"), ("reservoir", "bfloat16"),
        ("reservoir", "int8")]


def _inputs():
    rng = np.random.default_rng(21)
    Wq = rng.uniform(0.0, 1.0, (B, RK)).astype(np.float32)
    mag = np.logspace(0, -2, RK).astype(np.float32)[:, None]
    H = (rng.uniform(0.0, 1.0, (RK, M)) * mag).astype(np.float32)
    seen = np.full((B, 5), -1, np.int32)
    for row in range(B):
        n = rng.integers(1, 6)
        seen[row, :n] = rng.choice(M, n, replace=False)
    mask = np.zeros((B, M), bool)
    for row in range(B):
        mask[row, seen[row][seen[row] >= 0]] = True
    # the certificate's candidates: a coarse scan that misses items
    scores = Wq.astype(np.float64) @ H
    top_s = np.sort(scores[:, ::3], axis=1)[:, ::-1][:, :K].astype(
        np.float32).copy()
    top_s[::2] = np.sort(scores, axis=1)[::2, ::-1][:, :K]
    # each row's best item seen twice, and candidates that miss the best
    # unseen item: kth score = the (k+1)th unseen one
    best = np.argmax(scores, axis=1)
    seen_rep = np.full((B, 3), -1, np.int32)
    seen_rep[:, 0] = seen_rep[:, 1] = best
    unseen = scores.copy()
    unseen[np.arange(B), best] = -np.inf
    top_miss = np.sort(unseen, axis=1)[:, ::-1][:, 1:K + 1].astype(
        np.float32).copy()
    # a Recommender's factors and training interactions
    W = rng.uniform(0.0, 1.0, (30, RK)).astype(np.float32)
    train = (rng.random((30, M)) < 0.02).astype(np.float32)
    csr = from_dense(train).to_csr()
    test_pairs = np.stack([rng.integers(0, 30, 90),
                           rng.integers(0, M, 90)], axis=1)
    return {"main": {
        "Wq": Wq, "H": H, "seen": seen, "mask": mask, "top_s": top_s,
        "seen_rep": seen_rep, "top_miss": top_miss,
        "W": W, "train": (csr.indptr, csr.indices, csr.data, (30, M)),
        "train_dense": train, "users": np.arange(0, 30, 2),
        "score_ids": np.array([0, 5, 130, 255]), "test_pairs": test_pairs,
    }}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    data = _inputs()
    saved = str(tmp_path_factory.mktemp("sharded_rec") / "bundle")
    cases = [(f"topk-{k}", "topk", {**p, "k": K}) for k, p in TOPK.items()]
    cases += [(f"certify-{k}", "certify", {**p, "k": K})
              for k, p in CERTIFY.items()]
    cases += [(f"rec-{m}-{d}", "recommender",
               dict(method=m, table_dtype=d, k=K, slots=32,
                    save=saved if (m, d) == ("reservoir", "int8") else None))
              for m, d in RECS]
    cases += [(f"recall-{m}", "recall",
               dict(k=10, batch_users=32, block=32, method=m))
              for m in ("exact", "approx")]
    out = launch(R.retrieval, 4, args=((2, 2), cases, data),
                 timeout=TIMEOUT, threads=1)
    return {"data": data["main"], "ranks": out}


@pytest.fixture(scope="module")
def jmesh():
    return make_grid_mesh((2, 2), devices=jax.devices()[:4])


def _table(H, kind):
    if kind == "int8":
        sc = np.maximum(np.abs(H).max(axis=1) / 127.0, 1e-30).astype(
            np.float32)
        return np.clip(np.round(H / sc[:, None]), -127, 127).astype(
            np.int8), sc
    if kind == "bfloat16":
        return jnp.asarray(H, jnp.bfloat16), None
    return H, None


def test_ranks_import_neither_jax_nor_nmftpu(ranks):
    for r in ranks["ranks"]:
        assert r["_imported"] == {"jax": False, "nmftpu": False}


@pytest.mark.parametrize("name", list(TOPK))
def test_topk_mips_sharded_matches_nmftpu(ranks, jmesh, name):
    p, d = TOPK[name], ranks["data"]
    Ht, hs = _table(d["H"], p.get("table"))
    Hd = jax.device_put(jnp.asarray(Ht), factor_shardings(jmesh)["H"])
    kw = {}
    if p.get("seen"):
        kw["seen"] = d["seen"]
    if p.get("mask"):
        kw["exclude_mask"] = jax.device_put(
            d["mask"], factor_shardings(jmesh)["H"])
    if p.get("lists"):
        kw["exclude_lists"] = j_lists(np.arange(B), j_from_dense(
            d["mask"].astype(np.float32)).to_csr(), M, p["block"], shards=2)
    s_ref, i_ref = j_topk(d["Wq"], Hd, K, jmesh, block=p["block"],
                          method=p["method"], h_scale=hs,
                          candidate_k=p.get("candidate_k"),
                          reservoir_slots=p.get("slots", 4096), **kw)
    for r in ranks["ranks"]:
        got = r[f"topk-{name}"]
        assert_same_topk(got["s"], got["i"], s_ref, i_ref)
        if p.get("seen") or p.get("mask") or p.get("lists"):
            for row in range(B):
                assert not set(got["i"][row].tolist()) & set(
                    d["seen"][row][d["seen"][row] >= 0].tolist())


def _exact_rows(Wq, H, top_s):
    """Rows whose returned kth score is the exact top-k's (float64)."""
    best = np.sort(Wq.astype(np.float64) @ H, axis=1)[:, ::-1][:, K - 1]
    return np.abs(top_s[:, K - 1] - best) <= 1e-5 * np.abs(best)


@pytest.mark.parametrize("name", list(CERTIFY))
def test_certify_topk_sharded_matches_nmftpu(ranks, jmesh, name):
    p, d = CERTIFY[name], ranks["data"]
    Ht, hs = _table(d["H"], p.get("table"))
    Hd = jax.device_put(jnp.asarray(Ht), factor_shardings(jmesh)["H"])
    top = d[p.get("top", "top_s")]
    seen = d[p.get("seen_key", "seen")] if p.get("seen") else None
    want = np.asarray(j_certify(d["Wq"], Hd, top, K, jmesh,
                                block=p["block"], h_scale=hs, seen=seen))
    if name == "repeated-seen":
        # nmftpu discounts the twice-listed id twice and certifies rows
        # that miss an item (ROADMAP queue 3); the port counts it once
        assert want.all()
        for r in ranks["ranks"]:
            assert not r[f"certify-{name}"].any()
        return
    for r in ranks["ranks"]:
        got = r[f"certify-{name}"]
        differ = np.flatnonzero(got != want)
        assert len(differ) <= 2, differ
        if not p.get("seen"):
            # a row that misses an item never certifies
            assert not (got & ~_exact_rows(d["Wq"], d["H"], top)).any()
    assert not want.all() and want.any()


@pytest.mark.parametrize("method,table_dtype", RECS)
def test_sharded_recommender_matches_nmftpu(ranks, jmesh, method,
                                            table_dtype):
    d = ranks["data"]
    jr = JRec(d["W"], d["H"], train=j_from_dense(d["train_dense"]),
              mesh=jmesh, method=method, table_dtype=table_dtype,
              reservoir_slots=32)
    s_ref, i_ref = jr.recommend(d["users"], k=K)
    sc_ref, ic_ref, c_ref = jr.recommend_certified(d["users"], k=K,
                                                   fallback="exact")
    for r in ranks["ranks"]:
        got = r[f"rec-{method}-{table_dtype}"]
        assert_same_topk(got["s"], got["i"], s_ref, i_ref)
        assert_same_topk(got["sc"], got["ic"], sc_ref, ic_ref)
        assert len(np.flatnonzero(got["cert"] != c_ref)) <= 2
        np.testing.assert_allclose(
            got["score"], jr.score(int(d["users"][0]), d["score_ids"]),
            rtol=1e-5)
        if "loaded" in got:
            assert_same_topk(*got["loaded"], s_ref, i_ref)


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_sharded_recall_matches_nmftpu(ranks, jmesh, method):
    d = ranks["data"]
    Hd = jax.device_put(d["H"], factor_shardings(jmesh)["H"])
    want = j_recall(d["W"], Hd, d["test_pairs"],
                    train=JCSR(*d["train"]), k=10, batch_users=32,
                    block=32, mesh=jmesh, method=method)
    for r in ranks["ranks"]:
        assert r[f"recall-{method}"] == want


@pytest.mark.parametrize("shards,block", [(2, 32), (4, 16), (2, 1000)])
def test_sharded_exclusion_lists_equal_nmftpu(shards, block):
    d = _inputs()["main"]
    csr_p = from_dense(d["train_dense"]).to_csr()
    csr_j = j_from_dense(d["train_dense"]).to_csr()
    users = np.arange(0, 30, 3)
    for got, want in zip(
            build_block_exclusion(users, csr_p, M, block, shards=shards),
            j_lists(users, csr_j, M, block, shards=shards)):
        np.testing.assert_array_equal(got, want)
