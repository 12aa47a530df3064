"""The port's 2-D grid engine (nmftpu_torch.parallel, scatter tiles)
against nmftpu.parallel on the CPU.

The port runs in gloo ranks started by its own launcher
(`parallel.launch`: spawn, a FileStore, a deadline per launch): one
4-rank world runs every case on a 2x2 mesh, then a subset on 1x4 and
4x1 meshes; a 1-rank world runs a 1x1 mesh. The ranks run
tests/torch_parallel_ranks.py, which imports neither jax nor nmftpu.
nmftpu.parallel runs here, on meshes of the conftest's virtual CPU
devices, from the same numpy inputs, seeds and W0/H0.

Tolerances: one iteration (each half-step) and the error metrics on the
same blocks, float64 1e-10 and float32 1e-5 of max|x| (sums in another
order); compute_sharded after several iterations, errors 1e-4 relative
and factors 1e-3 of max|x|, HALS after one iteration; partitions equal
array for array; the port's own reruns equal bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import nmftpu_torch as nt
from nmftpu import Algorithm, Initialization, NmfConfig, Objective
from nmftpu import sparse as hs
from nmftpu.parallel import compute_sharded as j_compute_sharded
from nmftpu.parallel import factor_shardings, make_grid_mesh
from nmftpu.parallel import partition_sparse as j_partition
from nmftpu.parallel.driver import _pad_perm_matrix
from nmftpu.parallel.sharded_coo import balance_report as j_balance_report
from nmftpu.parallel.updates import (
    build_sharded_beta_error,
    build_sharded_errors,
    build_sharded_update,
)
from nmftpu_torch.parallel import launch

import torch_parallel_ranks as R

N, M, RANK = 40, 48, 4
TIMEOUT = 240

# name -> knobs; the cases of tests/test_parallel.py:86-120 plus weighted,
# masked, beta, iALS and HALS
BASE = dict(rank=RANK, num_iterations=15, check_interval=5, lambda_w=0.05,
            lambda_h=0.05, lambda_tik=0.05, theta=0.3)
SCATTER = {
    "mu-frobenius": dict(algorithm="mu", objective="frobenius"),
    "mu-kl": dict(algorithm="mu", objective="kullback-leibler"),
    "als": dict(algorithm="als"),
    "acls": dict(algorithm="acls"),
    "ahcls": dict(algorithm="ahcls"),
    "gdcls": dict(algorithm="gdcls"),
    "nsnmf-frobenius": dict(algorithm="nsnmf"),
    "nsnmf-kl": dict(algorithm="nsnmf", objective="kullback-leibler"),
    "weighted": dict(alpha_confidence=4.0),
    "masked-frobenius": dict(mask="observed"),
    "masked-kl": dict(mask="observed", objective="kullback-leibler"),
    "masked-als": dict(mask="observed", algorithm="als"),
    "beta-1.5": dict(objective="beta-divergence", beta=1.5),
    "beta-0.5": dict(objective="beta-divergence", beta=0.5),
    "ials-exact": dict(algorithm="als", alpha_confidence=4.0),
    "ials-cg": dict(algorithm="als", alpha_confidence=4.0,
                    als_solver="cg"),
    "hals": dict(algorithm="hals", num_iterations=1, check_interval=1),
}
STEPS = ("mu-frobenius", "mu-kl", "als", "ahcls", "gdcls", "nsnmf-kl",
         "weighted", "masked-frobenius", "masked-kl", "masked-als",
         "beta-0.5", "ials-exact", "hals")
SUBSET = ("mu-frobenius", "mu-kl", "als", "hals", "ials-exact")
INITS = ("mean_columns", "kmeans_random", "kmeans_nonnegative_wtv",
         "kmeans_absolute_wtv")


def _spmat(rng, n=N, m=M, density=0.3):
    dense = rng.uniform(0.2, 2.0, (n, m))
    mask = rng.uniform(size=(n, m)) < density
    mask[:, 0] = True
    mask[0, :] = True
    return (dense * mask).astype(np.float32)


def _data():
    rng = np.random.default_rng(0)
    dense = _spmat(rng)
    W0 = rng.uniform(0.1, 1.0, (N, RANK)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (RANK, M)).astype(np.float32)
    power = nt.data.synthetic.synthetic_powerlaw_sparse(
        120, 90, 3000, alpha_user=1.3, seed=3).todense()
    return {"main": {"dense": dense, "W0": W0, "H0": H0},
            "f64": {"dense": dense.astype(np.float64),
                    "W0": W0.astype(np.float64),
                    "H0": H0.astype(np.float64)},
            "power": {"dense": power.astype(np.float32)}}


def _cases():
    cases = [(f"partition-{b}", "partition_coo",
              dict(balance=b, chunk=256)) for b in (False, True)]
    cases.append(("partition-power", "partition_coo",
                  dict(balance=True, chunk=256, data="power")))
    for name in SCATTER:
        cases.append((f"compute-{name}", "compute",
                      dict(engine="scatter", knobs={**BASE,
                                                    **SCATTER[name]})))
    for name in STEPS:
        for dt in ("float32", "float64"):
            cases.append((f"step-{name}-{dt}", "step", dict(
                engine="scatter", data="main" if dt == "float32" else "f64",
                knobs={**BASE, **SCATTER[name], "dtype": dt})))
    for init in INITS:
        cases.append((f"init-{init}", "init", dict(
            engine="scatter", data="f64",
            knobs=dict(rank=RANK, init_method=init, dtype="float64",
                       kmeans_max_iter=5, seed=3))))
    cases.append(("init-ell-kmeans", "init", dict(
        engine="ell", data="f64",
        knobs=dict(rank=RANK, init_method="kmeans_nonnegative_wtv",
                   dtype="float64", kmeans_max_iter=5, seed=3))))
    cases.append(("plan", "plan", dict(knobs=dict(rank=3,
                                                   num_iterations=6,
                                                   seed=9))))
    cases.append(("rowshards", "rowshards", dict(
        knobs=dict(rank=RANK, num_iterations=6))))
    for engine in ("scatter", "ell"):
        cases.append((f"determinism-{engine}", "determinism",
                      dict(engine=engine,
                           knobs=dict(rank=3, num_iterations=8, seed=4))))
    return cases


def _subset():
    return [(f"compute-{name}", "compute",
             dict(engine="scatter", knobs={**BASE, **SCATTER[name]}))
            for name in SUBSET]


@pytest.fixture(scope="module")
def ranks():
    """One 4-rank world (2x2, then 1x4 and 4x1) and one 1-rank world."""
    data = _data()
    out = launch(R.training, 4, args=(
        [((2, 2), _cases()), ((1, 4), _subset()), ((4, 1), _subset())],
        data), timeout=TIMEOUT, threads=1)
    one = launch(R.training, 1, args=([((1, 1), _subset())], data),
                 timeout=TIMEOUT, threads=1)
    return {"data": data, "world4": out, "world1": one}


def _mesh(shape):
    return make_grid_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


def _j_config(knobs):
    kw = dict(knobs)
    for key, enum in (("algorithm", Algorithm), ("objective", Objective),
                      ("init_method", Initialization)):
        if key in kw:
            kw[key] = enum(kw[key])
    return NmfConfig(**kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _by_coords(results, shape, name):
    return {tuple(r[shape][name]["coords"]): r[shape][name]
            for r in results}


def test_ranks_import_neither_jax_nor_nmftpu(ranks):
    for r in ranks["world4"] + ranks["world1"]:
        assert r["_imported"] == {"jax": False, "nmftpu": False}


@pytest.mark.parametrize("name,balance,key", [
    ("partition-False", False, "main"), ("partition-True", True, "main"),
    ("partition-power", True, "power")])
def test_partition_equals_nmftpu(ranks, name, balance, key):
    dense = ranks["data"][key]["dense"]
    scoo, rp, cp = j_partition(hs.from_dense(dense), (2, 2), chunk=256,
                               balance=balance)
    got = _by_coords(ranks["world4"], (2, 2), name)
    assert set(got) == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for (i, j), g in got.items():
        np.testing.assert_array_equal(g["values"], np.asarray(scoo.values)[i, j])
        np.testing.assert_array_equal(g["rows"], np.asarray(scoo.rows)[i, j])
        np.testing.assert_array_equal(g["cols"], np.asarray(scoo.cols)[i, j])
        np.testing.assert_array_equal(g["row_perm"], rp)
        np.testing.assert_array_equal(g["col_perm"], cp)
        assert g["chunk"] == scoo.chunk
        assert g["block"] == (scoo.block_rows, scoo.block_cols)
        assert g["report"] == pytest.approx(j_balance_report(scoo))


def _j_step(knobs, data):
    """nmftpu's one iteration and metrics on the padded start."""
    import jax.numpy as jnp

    cfg = dataclasses.replace(_j_config(knobs),
                              init_method=Initialization.COPY_EXISTING)
    mesh = _mesh((2, 2))
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    scoo, rp, cp = j_partition(hs.from_dense(data["dense"]), (2, 2),
                               dtype=dtype, chunk=256, seed=cfg.seed,
                               out_shardings=factor_shardings(mesh)["tile"])
    pn, pm = scoo.padded_shape
    sh = factor_shardings(mesh)
    W = jax.device_put(_pad_perm_matrix(data["W0"], rp, pn, 0), sh["W"])
    H = jax.device_put(_pad_perm_matrix(data["H0"], cp, pm, 1), sh["H"])
    make_aux, update, eff = build_sharded_update(cfg, mesh, scoo)
    aux = make_aux(scoo)
    masked = cfg.mask == "observed"
    fro, kl = build_sharded_errors(mesh, scoo, masked=masked)
    if cfg.objective is Objective.BETA:
        kl = build_sharded_beta_error(mesh, scoo, cfg.beta)
    svsq = (0.0 if masked else jnp.sum(scoo.values * scoo.values))

    @jax.jit
    def step(scoo, aux, W, H, svsq):
        He = eff(aux, H)
        return fro(scoo, W, He, svsq), kl(scoo, W, He), update(scoo, aux,
                                                                W, H)

    f, k, (W1, H1) = step(scoo, aux, W, H, svsq)
    f, k = float(f), float(k)
    return (np.asarray(W1), np.asarray(H1), f, k, scoo.block_rows,
            scoo.block_cols)


# iALS and masked ALS build their Grams and solve in float32 whatever
# the dtype, in both packages, and the beta divergence sums in float32:
# their float64 steps (the divergence: its metric) take float32's limit
F32_SOLVES = ("masked-als", "ials-exact")
F32_METRIC = ("beta-0.5",)


@pytest.mark.parametrize("name", STEPS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
def test_half_steps_match_nmftpu(ranks, name, dtype, tol):
    knobs = {**BASE, **SCATTER[name], "dtype": dtype}
    if name in F32_SOLVES:
        tol = max(tol, 1e-5)
    kl_tol = max(tol, 1e-5) if name in F32_METRIC else tol
    data = ranks["data"]["main" if dtype == "float32" else "f64"]
    W1, H1, f, k, br, bc = _j_step(knobs, data)
    for (i, j), g in _by_coords(ranks["world4"], (2, 2),
                                f"step-{name}-{dtype}").items():
        assert _rel(g["W"], W1[i * br:(i + 1) * br]) <= tol, (i, j)
        assert _rel(g["H"], H1[:, j * bc:(j + 1) * bc]) <= tol, (i, j)
        assert g["fro"] == pytest.approx(f, rel=tol)
        assert g["kl"] == pytest.approx(k, rel=kl_tol)


def _j_compute(knobs, data, shape, engine="scatter"):
    cfg = _j_config({"init_method": "copy_existing", **knobs})
    return j_compute_sharded(hs.from_dense(data["dense"]), cfg,
                             mesh=_mesh(shape), W0=data["W0"],
                             H0=data["H0"], chunk=256, engine=engine)


def _check_compute(got, want):
    assert got["num_iterations"] == want.num_iterations
    assert got["error"] == pytest.approx(float(want.error), rel=1e-4)
    assert got["frobenius_error"] == pytest.approx(
        float(want.frobenius_error), rel=1e-4)
    if want.kl_error is not None:
        assert got["kl_error"] == pytest.approx(float(want.kl_error),
                                                rel=1e-4)
    assert _rel(got["W"], want.W) <= 1e-3
    assert _rel(got["H"], want.H) <= 1e-3


@pytest.mark.parametrize("name", list(SCATTER))
def test_compute_sharded_matches_nmftpu(ranks, name):
    want = _j_compute({**BASE, **SCATTER[name]}, ranks["data"]["main"],
                      (2, 2))
    results = [r[(2, 2)][f"compute-{name}"] for r in ranks["world4"]]
    _check_compute(results[0], want)
    for r in results[1:]:   # every rank returns the same full factors
        np.testing.assert_array_equal(r["W"], results[0]["W"])
        np.testing.assert_array_equal(r["H"], results[0]["H"])


@pytest.mark.parametrize("shape", [(1, 4), (4, 1), (1, 1)])
@pytest.mark.parametrize("name", SUBSET)
def test_other_meshes_match_nmftpu(ranks, shape, name):
    world = ranks["world1" if shape == (1, 1) else "world4"]
    want = _j_compute({**BASE, **SCATTER[name]}, ranks["data"]["main"],
                      shape)
    _check_compute(world[0][shape][f"compute-{name}"], want)


def _draws(knobs, m, col_perm):
    """The sharded init's shared draws (global permuted ids), mapped to
    V's original columns: mean columns' (r, q) samples or k-means' r
    seed columns."""
    from nmftpu_torch.init.strategies import run_seed

    r = knobs["rank"]
    inv = torch.from_numpy(np.argsort(col_perm))
    shared = torch.Generator().manual_seed(run_seed(knobs["seed"], 0))
    if knobs["init_method"] == "mean_columns":
        q = int(min(max(5, m // r), m))
        return inv[torch.randint(0, m, (r, q), generator=shared)].numpy()
    return inv[torch.randperm(m, generator=shared)[:r]].numpy()


def _nmftpu_init(knobs, dense, draws, monkeypatch):
    """nmftpu's single-device init (nmftpu.sparse_ops) from the same
    draws, in V's original coordinates: mean columns through its
    `project_columns`, k-means through `kmeans_columns_sparse`, whose
    `jax.random.choice` hands back the port's seed columns."""
    import jax.numpy as jnp
    from nmftpu import sparse_ops as JS

    coo = JS.device_put_sparse(hs.from_dense(dense), dtype=jnp.float64)
    m, r = dense.shape[1], knobs["rank"]
    if knobs["init_method"] == "mean_columns":
        q = draws.shape[1]
        A = np.zeros((m, r))
        np.add.at(A, (draws.reshape(-1), np.repeat(np.arange(r), q)),
                  1.0 / q)
        return np.asarray(JS.project_columns(coo, jnp.asarray(A))), None
    monkeypatch.setattr(jax.random, "choice",
                        lambda key, a, shape, replace: jnp.asarray(draws))
    cent, _ = JS.kmeans_columns_sparse(coo, r, jax.random.PRNGKey(0),
                                       max_iter=knobs["kmeans_max_iter"])
    W = jnp.maximum(cent, 0.0) + 1e-6
    WtV = JS.wt_v(coo, W)
    H = {"kmeans_random": None,
         "kmeans_nonnegative_wtv": jnp.maximum(WtV, 0.0) + 1e-6,
         "kmeans_absolute_wtv": jnp.abs(WtV) + 1e-6}[knobs["init_method"]]
    return np.asarray(W), None if H is None else np.asarray(H)


def _port_init(knobs, dense, draws):
    """The second witness: the port's single-device sparse Lloyd and
    column projection from the same draws."""
    from nmftpu_torch import sparse_ops as TS
    from nmftpu_torch.sparse import from_dense

    coo = TS.device_put_sparse(from_dense(dense), dtype=torch.float64,
                               device="cpu")
    m, r = dense.shape[1], knobs["rank"]
    draws = torch.from_numpy(draws)
    if knobs["init_method"] == "mean_columns":
        q = draws.shape[1]
        A = torch.zeros((m, r), dtype=torch.float64)
        A.index_put_((draws.reshape(-1),
                      torch.arange(r).repeat_interleave(q)),
                     torch.tensor(1.0 / q, dtype=torch.float64),
                     accumulate=True)
        return TS.project_columns(coo, A).numpy(), None
    cent, _ = TS._lloyd_sparse(coo, TS.extract_columns(coo, draws),
                               knobs["kmeans_max_iter"])
    W = torch.clamp(cent, min=0.0) + 1e-6
    WtV = TS.wt_v(coo, W)
    H = {"kmeans_random": None,
         "kmeans_nonnegative_wtv": torch.clamp(WtV, min=0.0) + 1e-6,
         "kmeans_absolute_wtv": torch.abs(WtV) + 1e-6}[knobs["init_method"]]
    return W.numpy(), None if H is None else H.numpy()


@pytest.mark.parametrize("name", [f"init-{i}" for i in INITS]
                         + ["init-ell-kmeans"])
def test_data_dependent_inits_match_one_device(ranks, name, monkeypatch):
    got = ranks["world4"][0][(2, 2)][name]
    knobs = {c[0]: c[2] for c in _cases()}[name]["knobs"]
    dense = ranks["data"]["f64"]["dense"]
    draws = _draws(knobs, dense.shape[1], got["col_perm"])
    for W, H in (_nmftpu_init(knobs, dense, draws, monkeypatch),
                 _port_init(knobs, dense, draws)):
        assert _rel(got["W"], W) <= 1e-10
        if H is not None:
            assert _rel(got["H"], H) <= 1e-10
        else:
            assert got["H"].shape == (RANK, M) and (got["H"] > 0).all()
    for r in ranks["world4"][1:]:
        np.testing.assert_array_equal(r[(2, 2)][name]["W"], got["W"])


def test_plan_reuse_warm_starts_and_unpermute(ranks):
    got = ranks["world4"][0][(2, 2)]["plan"]
    np.testing.assert_array_equal(got["r1"]["W"], got["r2"]["W"])
    assert got["same_operand"]
    assert got["r3"]["num_iterations"] == 12
    assert got["r3"]["frobenius_error"] <= got["r1"]["frobenius_error"] + 1e-6
    assert "dtype" in got["refusals"][0] and "rank" in got["refusals"][1]
    assert got["refusals"][2:] == [True, True]
    np.testing.assert_array_equal(got["unpermuted"][0], got["r1"]["W"])
    np.testing.assert_array_equal(got["unpermuted"][1], got["r1"]["H"])
    assert got["block_shapes"] == ((24, 3), (3, 24))


def test_rowshard_ingestion_equals_prepare_sharded(ranks):
    for r in ranks["world4"]:
        got = r[(2, 2)]["rowshards"]
        assert got["values"]
        assert got["nnz"][0] == got["nnz"][1]
        # a float64 host sum against summed float32 tile sums
        assert got["mean_v"][0] == pytest.approx(got["mean_v"][1], rel=1e-6)
        np.testing.assert_array_equal(*got["tile_nnz"])
        np.testing.assert_array_equal(got["a"]["W"], got["b"]["W"])
        np.testing.assert_array_equal(got["a"]["H"], got["b"]["H"])


@pytest.mark.parametrize("engine", ["scatter", "ell"])
def test_determinism_on_the_cpu(ranks, engine):
    got = ranks["world4"][0][(2, 2)][f"determinism-{engine}"]
    np.testing.assert_array_equal(got["a"]["W"], got["b"]["W"])
    np.testing.assert_array_equal(got["a"]["H"], got["b"]["H"])
    assert got["a"]["W"].shape == (N, 3)


def test_a_failing_rank_makes_the_launcher_raise():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        launch(R.fail_on_rank_one, 2, timeout=60, threads=1)
    assert "rank one fails on purpose" in str(e.value)


def test_launcher_times_out():
    with pytest.raises(TimeoutError, match="killed"):
        launch(R.sleep_forever, 2, timeout=2, threads=1)


def test_ring_engine_and_dense_mesh_raise_naming_6b():
    """The ring engine and dense V on a mesh are ported (slice 6b,
    test_torch_ring.py, test_torch_dense_mesh.py); what is not a
    DeviceMesh is refused by both."""
    dense = _data()["main"]["dense"]
    sp = nt.sparse.from_dense(dense)
    with pytest.raises(TypeError, match="DeviceMesh"):
        nt.nmf(sp, RANK, mesh=object(), strategy="ring", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        nt.parallel.prepare_sharded(sp, nt.NmfConfig(rank=RANK),
                                    mesh=object(), engine="ring")
    with pytest.raises(TypeError, match="DeviceMesh"):
        nt.nmf(dense, RANK, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="single-device only"):
        nt.nmf(sp, RANK, mesh=object(), strategy="densified", device="cpu")
