"""The port's ring engine (nmftpu_torch.parallel.ring, engine="ring")
against nmftpu.parallel.compute_sharded(engine="ring") on the CPU.

The port runs in gloo ranks started by its own launcher, one world per
ring size p in {1, 2, 3, 4} (p = 3 is the ring where a wrong +2 delivery
of the H-side reduce would show); the ranks run
tests/torch_mesh_ranks.py, which imports neither jax nor nmftpu.
nmftpu runs here on the first p of the conftest's virtual CPU devices,
from the same numpy inputs and W0/H0.

Tolerances: one iteration, 1e-5 of max|x| (float32 sums in another
order; nmftpu's ring accumulates its error terms in float32, so it takes
no float64 run); several iterations, errors 1e-4 relative and factors
1e-3 of max|x|; the data inits against the grid engine's on
the same ranks (the same draws), float64 1e-10; partitions array for
array; the threshold stop at the same check."""

import jax
import numpy as np
import pytest

from nmftpu import Algorithm, Initialization, NmfConfig, Objective
from nmftpu import sparse as hs
from nmftpu.parallel import compute_sharded as j_compute_sharded
from nmftpu.parallel import make_grid_mesh
from nmftpu.parallel import ring as j_ring
from nmftpu_torch.parallel import launch

import torch_mesh_ranks as M

N, M_, RANK = 30, 37, 3
TIMEOUT = 240

# the algorithms and objectives of tests/test_ring.py, plus the beta
# divergence, HALS and iALS, which nmftpu's ring runs too
CASES = {
    "mu-frobenius": dict(),
    "mu-frobenius-hw": dict(update_order="HW"),
    "mu-kl": dict(objective="kullback-leibler"),
    "mu-kl-hw": dict(objective="kullback-leibler", update_order="HW"),
    "beta-1.5": dict(objective="beta-divergence", beta=1.5),
    "beta-0.5": dict(objective="beta-divergence", beta=0.5),
    "weighted": dict(alpha_confidence=4.0),
    "als": dict(algorithm="als"),
    "acls": dict(algorithm="acls", lambda_w=0.1, lambda_h=0.1),
    "ahcls": dict(algorithm="ahcls", lambda_w=0.1, lambda_h=0.1,
                  alpha_w=0.6, alpha_h=0.6),
    "gdcls": dict(algorithm="gdcls", lambda_tik=0.05),
    "nsnmf-frobenius": dict(algorithm="nsnmf", theta=0.3),
    "nsnmf-kl": dict(algorithm="nsnmf", theta=0.3,
                     objective="kullback-leibler"),
    "hals": dict(algorithm="hals"),
    "ials": dict(algorithm="als", alpha_confidence=4.0, lambda_w=0.1,
                 lambda_h=0.1),
}
SUBSET = ("mu-frobenius", "mu-kl", "als", "weighted")
INITS = ("mean_columns", "kmeans_random", "kmeans_nonnegative_wtv",
         "kmeans_absolute_wtv")
F32 = dict(rank=RANK, num_iterations=6, check_interval=2)
ONE = dict(rank=RANK, num_iterations=1, check_interval=1)
THRESHOLD = dict(rank=RANK, num_iterations=400, check_interval=10,
                 threshold_value=1e-3)


def _problem():
    rng = np.random.default_rng(0)
    dense = rng.uniform(0.2, 2.0, (N, M_))
    mask = rng.uniform(size=(N, M_)) < 0.4
    mask[:, 0] = True
    mask[0, :] = True
    dense = (dense * mask).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (N, RANK)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (RANK, M_)).astype(np.float32)
    return {"main": {"dense": dense, "W0": W0, "H0": H0},
            "f64": {"dense": dense.astype(np.float64),
                    "W0": W0.astype(np.float64),
                    "H0": H0.astype(np.float64)}}


def _cases(p):
    names = CASES if p >= 3 else SUBSET
    cases = [(f"f32-{n}", "compute", {**F32, **CASES[n]}) for n in names]
    if p == 3:
        cases += [(f"one-{n}", "compute", {**ONE, **CASES[n]})
                  for n in CASES]
        cases.append(("threshold", "compute", dict(THRESHOLD)))
    if p == 4:
        cases += [(f"init-{i}", "init", dict(
            rank=RANK, init_method=i, dtype="float64", kmeans_max_iter=5,
            seed=3, data="f64")) for i in INITS]
        cases.append(("partition", "partition", dict(seed=0)))
    return cases


@pytest.fixture(scope="module")
def ranks():
    """One world per ring size."""
    data = _problem()
    return {"data": data,
            **{p: launch(M.ring, p, args=(_cases(p), data), timeout=TIMEOUT,
                         threads=1) for p in (1, 2, 3, 4)}}


def _j_config(knobs):
    kw = {k: v for k, v in knobs.items() if k != "data"}
    for key, enum in (("algorithm", Algorithm), ("objective", Objective),
                      ("init_method", Initialization)):
        if key in kw:
            kw[key] = enum(kw[key])
    return NmfConfig(**{"init_method": Initialization.COPY_EXISTING, **kw})


def _j_ring(knobs, d, p):
    return j_compute_sharded(
        hs.from_dense(d["dense"]), _j_config(knobs),
        mesh=make_grid_mesh((1, p), devices=jax.devices()[:p]),
        W0=d["W0"], H0=d["H0"], engine="ring", chunk=64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _check(got, want, tol, err_tol):
    assert got["num_iterations"] == want.num_iterations
    assert got["error"] == pytest.approx(float(want.error), rel=err_tol)
    assert got["frobenius_error"] == pytest.approx(
        float(want.frobenius_error), rel=err_tol)
    if want.kl_error is not None:
        assert got["kl_error"] == pytest.approx(float(want.kl_error),
                                                rel=err_tol)
    assert _rel(got["W"], want.W) <= tol
    assert _rel(got["H"], want.H) <= tol


def test_ranks_import_neither_jax_nor_nmftpu(ranks):
    for p in (1, 2, 3, 4):
        assert [r["rank"] for r in ranks[p]] == list(range(p))
        for r in ranks[p]:
            assert r["_imported"] == {"jax": False, "nmftpu": False}


@pytest.mark.parametrize("p,name", [(p, n) for p in (1, 2, 3, 4)
                                    for n in (CASES if p >= 3 else SUBSET)])
def test_ring_matches_nmftpu_float32(ranks, p, name):
    want = _j_ring({**F32, **CASES[name]}, ranks["data"]["main"], p)
    results = [r[f"f32-{name}"] for r in ranks[p]]
    _check(results[0], want, 1e-3, 1e-4)
    for r in results[1:]:   # every rank returns the same full factors
        np.testing.assert_array_equal(r["W"], results[0]["W"])
        np.testing.assert_array_equal(r["H"], results[0]["H"])


@pytest.mark.parametrize("name", list(CASES))
def test_one_iteration_on_three_ranks(ranks, name):
    """p = 3: the +2 delivery of the H-side reduce is not a no-op."""
    want = _j_ring({**ONE, **CASES[name]}, ranks["data"]["main"], 3)
    _check(ranks[3][0][f"one-{name}"], want, 1e-5, 1e-5)


def test_threshold_stop_matches_nmftpu(ranks):
    want = _j_ring(THRESHOLD, ranks["data"]["main"], 3)
    got = ranks[3][0]["threshold"]
    assert want.converged and got["converged"]
    assert got["num_iterations"] == want.num_iterations < 400
    assert got["error"] == pytest.approx(float(want.error), rel=1e-4)


@pytest.mark.parametrize("init", INITS)
def test_ring_data_inits_equal_the_grid_engines(ranks, init):
    """The ring's inits take the grid's draws: the same factors (which
    tests/test_torch_parallel.py holds against nmftpu's single-device
    init from those draws)."""
    for r in ranks[4]:
        got = r[f"init-{init}"]
        Wr, Hr = got["ring"]
        Ws, Hs = got["scatter"]
        assert Wr.shape == (N, RANK) and Hr.shape == (RANK, M_)
        assert _rel(Wr, Ws) <= 1e-10
        if init == "kmeans_random":
            assert (Hr > 0).all()   # the random block of each ring rank
        else:
            assert _rel(Hr, Hs) <= 1e-10
        np.testing.assert_array_equal(Wr, ranks[4][0][f"init-{init}"]
                                      ["ring"][0])


def test_partition_equals_nmftpu(ranks):
    scoo, rp, cp = j_ring.partition_for_ring(
        hs.from_dense(ranks["data"]["main"]["dense"]), 4, chunk=64, seed=0)
    for my, r in enumerate(ranks[4]):
        got = r["partition"]
        np.testing.assert_array_equal(got["row_perm"], rp)
        np.testing.assert_array_equal(got["col_perm"], cp)
        assert got["block"] == (scoo.block_rows, scoo.block_cols)
        for j, (v, rows, cols) in enumerate(got["tiles"]):
            np.testing.assert_array_equal(v, np.asarray(scoo.values)[my, j])
            np.testing.assert_array_equal(rows, np.asarray(scoo.rows)[my, j])
            np.testing.assert_array_equal(cols, np.asarray(scoo.cols)[my, j])


def test_ppermute_rotates_and_stages_nothing_on_the_cpu():
    """ppermute on one rank is the identity (no group, no send)."""
    import torch

    from nmftpu_torch.parallel.mesh import STAGED_BYTES, ppermute

    class _One:
        mesh_dim_names = ("shards",)

        def size(self, dim):
            return 1

    x = torch.arange(6.0)
    before = dict(STAGED_BYTES)
    assert ppermute(x, _One(), "shards", 1) is x
    assert ppermute(x, _One(), "shards", 2) is x
    assert STAGED_BYTES == before
