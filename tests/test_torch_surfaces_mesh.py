"""The surfaces on a mesh: the sklearn facade (NMF(mesh=),
MiniBatchNMF(mesh=)), checkpoint.resume(mesh=), rank_selection(mesh=),
the conversions of a sharded Recommender, a sharded OnlineNMF and an
estimator with a mesh, and dryrun_multichip, against nmftpu's on a mesh,
on the CPU.

The port runs in one 4-rank gloo world on a 2 x 2 mesh; the ranks run
tests/torch_mesh_ranks.py, which imports neither jax nor nmftpu. nmftpu
runs here on a 2 x 2 mesh of the conftest's virtual CPU devices, from
the same numpy inputs; its objects reach the ranks as stand-ins holding
their attributes as numpy arrays (the convert functions read nothing
else).

Tolerances: float32 fits of a few iterations, errors 1e-4 relative and
factors 1e-3 of max|x|; float64 online steps 1e-10; rank selection (its
random restarts draw from each package's own generator) the same best
rank, its cophenetic correlation within 0.05 and at least 0.95 in both,
and against the port's one-device run (the same draws) 1e-3 relative;
served top-k scores 1e-5 relative with the same ids."""

import jax
import numpy as np
import pytest

from nmftpu import checkpoint as JC
from nmftpu import minibatch as JM
from nmftpu import sklearn_api as JSK
from nmftpu.model_selection import rank_selection as j_rank_selection
from nmftpu.parallel import make_grid_mesh
from nmftpu.serving import Recommender as JRec
from nmftpu.sparse import SparseCSR as JCSR
from nmftpu.sparse import from_dense as j_from_dense
from nmftpu_torch import sklearn_api as SK
from nmftpu_torch.parallel import dryrun_multichip, launch

import torch_mesh_ranks as M

N, M_, R = 48, 40, 4
SHAPE = (2, 2)
TIMEOUT = 300
NMF_PARAMS = dict(n_components=R, init="custom", solver="mu", max_iter=5,
                  tol=0.0)
MB_PARAMS = dict(n_components=R, init="custom", batch_size=16, max_iter=2,
                 tol=0.0, max_no_improvement=None, dtype="float64")
RESUME = dict(rank=R, num_iterations=6, check_interval=2)


def _mesh():
    return make_grid_mesh(SHAPE, devices=jax.devices()[:4])


def _blocks():
    """Three clear column blocks and noise: rank 3 is the best rank."""
    rng = np.random.default_rng(5)
    V = rng.uniform(0.0, 0.05, (60, 48))
    for b in range(3):
        V[b * 20:(b + 1) * 20, b * 16:(b + 1) * 16] += rng.uniform(
            0.8, 1.2, (20, 16))
    return V.astype(np.float32)


def _snapshots(data):
    """nmftpu's sharded Recommender, sharded OnlineNMF and MiniBatchNMF
    with a mesh, and their attributes as numpy for the ranks."""
    csr = data["train"]
    jr = JRec(data["W"], data["H"], train=JCSR(*csr), mesh=_mesh(),
              method="exact", table_dtype="int8", block=64)
    rec = {"W": np.asarray(jr.W), "H": np.asarray(jr.H),
           "_m_items": jr._m_items, "table_dtype": jr.table_dtype,
           "_h_scale": np.asarray(jr._h_scale), "_train_csr": csr,
           "block": jr.block, "method": jr.method,
           "reservoir_slots": jr.reservoir_slots, "mesh": True}
    online = JM.OnlineNMF(R, batch_size=16, dtype=np.float64, mesh=_mesh())
    online.partial_fit(data["V64"][:16], H0=data["H064"])
    est = JSK.MiniBatchNMF(mesh=_mesh(), **MB_PARAMS)
    est.partial_fit(data["V64"][:16], W=data["W064"][:16], H=data["H064"])
    return {"rec": (jr, rec), "online": (online, _online_attrs(online)),
            "est": (est, _estimator_attrs(est))}


def _online_attrs(model):
    from nmftpu_torch.convert import _ONLINE_PARAMS

    attrs = {k: getattr(model, k) for k in _ONLINE_PARAMS}
    attrs.update(rank=model.rank, dtype=np.dtype(model.dtype).type,
                 rho=model.rho, n_steps=model.n_steps, _shardings=True,
                 H=np.asarray(model.H), _A=np.asarray(model._A),
                 _B=np.asarray(model._B))
    return attrs


def _estimator_attrs(est):
    from nmftpu_torch.convert import _FITTED

    attrs = {k: getattr(est, k) for k in SK.MiniBatchNMF._get_param_names()
             if k not in ("device", "mesh")}
    attrs.update({k: np.asarray(getattr(est, k)) if k == "components_"
                  else getattr(est, k) for k in _FITTED if hasattr(est, k)})
    attrs["_online"] = _online_attrs(est._online)
    return attrs


def _data():
    rng = np.random.default_rng(3)
    V = rng.uniform(0.1, 1.0, (N, M_)) * (rng.uniform(size=(N, M_)) < 0.6)
    W0 = rng.uniform(0.1, 1.0, (N, R))
    H0 = rng.uniform(0.1, 1.0, (R, M_))
    seen = rng.uniform(size=(N, 1000)) < 0.02
    rows, cols = np.nonzero(seen)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=N))])
    return {"V": V.astype(np.float32), "W0": W0.astype(np.float32),
            "H0": H0.astype(np.float32), "V64": V + 0.05, "W064": W0,
            "H064": H0, "blocks": _blocks(),
            "W": rng.uniform(0.0, 1.0, (N, 8)).astype(np.float32),
            "H": rng.uniform(0.0, 1.0, (8, 1000)).astype(np.float32),
            "train": (indptr.astype(np.int64), cols.astype(np.int32),
                      np.ones(len(rows), np.float32), (N, 1000))}


def _cases():
    return [
        ("nmf-dense", "nmf", dict(data="V", params=NMF_PARAMS)),
        ("nmf-sparse", "nmf", dict(data="V", sparse=True,
                                   params={**NMF_PARAMS,
                                           "strategy": "scatter"})),
        ("minibatch", "minibatch", dict(data="V64", params=MB_PARAMS)),
        ("resume-sparse", "resume", dict(data="V", sparse=True, knobs=RESUME,
                                         iteration=2,
                                         kwargs={"chunk": 256})),
        ("resume-dense", "resume", dict(data="V", knobs=RESUME,
                                        iteration=2)),
        ("ranks", "rank_selection", dict(data="blocks", ranks=[2, 3],
                                         kwargs=dict(n_runs=4,
                                                     num_iterations=200,
                                                     seed=0))),
        ("convert-recommender", "convert_recommender", dict(snap="rec")),
        ("convert-online", "convert_online", dict(snap="online",
                                                  data="V64")),
        ("convert-estimator", "convert_estimator", dict(snap="est",
                                                        data="V64")),
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    data = _data()
    snaps = _snapshots(data)
    sent = {**data, **{k: v[1] for k, v in snaps.items()}}
    # the minibatch and online cases run in float64, as nmftpu's here
    sent["W0"], sent["H0"] = data["W0"], data["H0"]
    work = str(tmp_path_factory.mktemp("surfaces"))
    out = launch(M.surfaces, 4, args=(SHAPE, _cases(), sent, work),
                 timeout=TIMEOUT, threads=1)
    return {"data": data, "snaps": snaps, "out": out, "work": work}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_ranks_import_neither_jax_nor_nmftpu(ranks):
    for r in ranks["out"]:
        assert r["_imported"] == {"jax": False, "nmftpu": False}


@pytest.mark.parametrize("name", ["nmf-dense", "nmf-sparse"])
def test_nmf_on_a_mesh_matches_nmftpu(ranks, name):
    d = ranks["data"]
    params = dict(NMF_PARAMS)
    X = d["V"]
    if name == "nmf-sparse":
        params["strategy"] = "scatter"
        X = j_from_dense(X)
    est = JSK.NMF(mesh=_mesh(), **params)
    W = est.fit_transform(X, W=d["W0"], H=d["H0"])
    for r in ranks["out"]:
        got = r[name]
        assert got["n_iter"] == est.n_iter_
        assert got["err"] == pytest.approx(est.reconstruction_err_, rel=1e-4)
        assert _rel(got["W"], W) <= 1e-3
        assert _rel(got["H"], est.components_) <= 1e-3


def test_minibatch_nmf_on_a_mesh_matches_nmftpu(ranks):
    d = ranks["data"]
    est = JSK.MiniBatchNMF(mesh=_mesh(), **MB_PARAMS)
    W = est.fit_transform(d["V64"], W=d["W0"].astype(np.float64),
                          H=d["H0"].astype(np.float64))
    part = JSK.MiniBatchNMF(mesh=_mesh(), **MB_PARAMS)
    for lo in range(0, N, 32):
        first = lo == 0
        part.partial_fit(d["V64"][lo:lo + 32],
                         W=d["W0"][:32].astype(np.float64) if first else None,
                         H=d["H0"].astype(np.float64) if first else None)
    for r in ranks["out"]:
        got = r["minibatch"]
        assert _rel(got["W"], W) <= 1e-10
        assert _rel(got["H"], est.components_) <= 1e-10
        assert got["err"] == pytest.approx(est.reconstruction_err_,
                                           rel=1e-10)
        assert _rel(got["partial_H"], part.components_) <= 1e-10


@pytest.mark.parametrize("name", ["resume-sparse", "resume-dense"])
def test_resume_on_a_mesh_matches_nmftpu(ranks, name, tmp_path):
    """nmftpu's resume(mesh=) takes sparse V through compute_sharded; the
    port's does too, and runs dense V on the dense mesh path, held to
    nmftpu's dense mesh driver from the same checkpoint."""
    import nmftpu.driver as j_driver
    from nmftpu import Initialization, NmfConfig

    d = ranks["data"]
    cfg = NmfConfig(**RESUME)
    JC.save(str(tmp_path / "ck"), d["W0"], d["H0"], iteration=2, config=cfg)
    if name == "resume-sparse":
        want = JC.resume(str(tmp_path / "ck"), j_from_dense(d["V"]), cfg,
                         mesh=_mesh(), chunk=256)
    else:
        warm = NmfConfig(rank=R, num_iterations=4, check_interval=2,
                         init_method=Initialization.COPY_EXISTING)
        want = j_driver.compute(d["V"], warm, W0=d["W0"], H0=d["H0"],
                                mesh=_mesh())
    for r in ranks["out"]:
        got = r[name]
        assert got["num_iterations"] == want.num_iterations == 4
        assert got["error"] == pytest.approx(float(want.error), rel=1e-4)
        assert _rel(got["W"], want.W) <= 1e-3
        assert _rel(got["H"], want.H) <= 1e-3


def test_rank_selection_on_a_mesh_matches_nmftpu(ranks):
    d = ranks["data"]
    want = j_rank_selection(d["blocks"], [2, 3], n_runs=4,
                            num_iterations=200, seed=0, mesh=_mesh())
    for r in ranks["out"]:
        got = r["ranks"]
        assert got["best"] == want.best_rank == 3
        # rank 2 splits three clusters two ways: its consensus depends on
        # the draws; the best rank's is sharp in both packages
        assert got["cophenetic"][1] == pytest.approx(want.cophenetic[1],
                                                     abs=0.05)
        assert min(got["cophenetic"][1], want.cophenetic[1]) >= 0.95
    assert ranks["out"][1]["ranks"] == ranks["out"][0]["ranks"]


def test_rank_selection_on_a_mesh_equals_one_device(ranks):
    """The mesh's random restarts are the one-device run's draws, so its
    consensus is the unsharded one's (float32 sums in another order)."""
    import nmftpu_torch as nt

    one = nt.rank_selection(ranks["data"]["blocks"], [2, 3], n_runs=4,
                            num_iterations=200, seed=0, device="cpu")
    got = ranks["out"][0]["ranks"]
    assert got["best"] == one.best_rank
    np.testing.assert_allclose(got["cophenetic"], one.cophenetic, rtol=1e-3)
    np.testing.assert_allclose(got["dispersion"], one.dispersion, rtol=1e-3)
    np.testing.assert_allclose(got["mean_error"], one.mean_error, rtol=1e-4)


def test_convert_a_sharded_recommender(ranks):
    jr, _ = ranks["snaps"]["rec"]
    s_ref, i_ref = jr.recommend(np.arange(6), k=5)
    table = np.asarray(jr.H)
    for j, r in enumerate(ranks["out"]):
        got = r["convert-recommender"]
        s, i = got["top"]
        np.testing.assert_array_equal(i, np.asarray(i_ref))
        np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-5)
        assert got["local"] == (8, 500)   # the items axis has 2 ranks
        col = (j % 2) * 500
        np.testing.assert_array_equal(got["table"],
                                      table[:, col:col + 500])


def test_convert_a_sharded_online_nmf(ranks):
    online, _ = ranks["snaps"]["online"]
    online.partial_fit(ranks["data"]["V64"][:32])
    for r in ranks["out"]:
        got = r["convert-online"]
        assert got["local"] == (R, M_ // 4)
        assert got["n_steps"] == online.n_steps
        assert _rel(got["H"], online.H) <= 1e-10


def test_convert_an_estimator_with_a_mesh(ranks):
    est, _ = ranks["snaps"]["est"]
    est.partial_fit(ranks["data"]["V64"][:32])
    for r in ranks["out"]:
        got = r["convert-estimator"]
        assert got["mesh"] and got["n_steps"] == est.n_steps_
        assert _rel(got["H"], est.components_) <= 1e-10


def test_dryrun_multichip_on_four_ranks(capsys):
    s = dryrun_multichip(4, device_type="cpu")
    assert s["mesh"] == (2, 2)
    for key in ("fro_err", "ring_err", "kmeans_err", "masked_err",
                "masked_als_err", "beta_dense_mesh_err", "resumed_err"):
        assert np.isfinite(s[key]), key
    assert "dryrun_multichip OK" in capsys.readouterr().out
