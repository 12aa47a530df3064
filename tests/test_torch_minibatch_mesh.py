"""Mini-batch NMF and OnlineNMF with the item axis sharded over a mesh
(nmftpu_torch.minibatch, mesh=) against nmftpu.minibatch on a mesh, on
the CPU.

The port runs in one 4-rank gloo world on a 2 x 2 mesh, flattened to
the 4 item shards of 'mb_items' (12 of the 48 columns a rank); the ranks
run tests/torch_mesh_ranks.py, which imports neither jax nor nmftpu.
nmftpu runs here on a 2 x 2 mesh of the conftest's virtual CPU devices,
from the same float64 inputs and W0/H0.

Tolerances: float64, 1e-10 of max|x| (the same guarded operations, the
column sums in another order); a saved and reloaded stream against the
uninterrupted one, exactly; early stopping at the same step."""

import jax
import numpy as np
import pytest

from nmftpu import minibatch as JM
from nmftpu.parallel import make_grid_mesh
from nmftpu_torch.parallel import launch

import torch_mesh_ranks as M

N, M_, R = 64, 48, 6
SHAPE = (2, 2)
TIMEOUT = 240
TOL = 1e-10
FITS = {
    "fit-frobenius": dict(beta=2.0, max_iter=3, tol=0.0,
                          max_no_improvement=None),
    "fit-kl": dict(beta=1.0, max_iter=3, tol=0.0, max_no_improvement=None),
    "fit-beta-0.5": dict(beta=0.5, max_iter=3, tol=0.0,
                         max_no_improvement=None),
    "fit-monitored": dict(beta=1.0, max_iter=20, tol=1e-3,
                          max_no_improvement=3, batch_size=16),
    "fit-fresh": dict(beta=2.0, max_iter=2, tol=0.0,
                      max_no_improvement=None, fresh_restarts=True,
                      batch_size=16),
}
ONLINE = {"online-frobenius": dict(beta=2.0), "online-kl": dict(beta=1.0)}


def _data():
    rng = np.random.default_rng(4)
    return {"V": rng.uniform(0.05, 1.0, (N, M_)),
            "W0": rng.uniform(0.1, 1.0, (N, R)),
            "H0": rng.uniform(0.1, 1.0, (R, M_))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    data = _data()
    cases = [(n, "fit", {"batch_size": 32, "dtype": "float64", **kw})
             for n, kw in FITS.items()]
    cases += [(n, "online", {"batch_size": 16, "dtype": "float64", **kw})
              for n, kw in ONLINE.items()]
    cases.append(("bad-m", "bad_m", {"dtype": "float64"}))
    save_dir = str(tmp_path_factory.mktemp("online"))
    return {"data": data, "out": launch(M.minibatch, 4,
                                        args=(SHAPE, cases, data, save_dir),
                                        timeout=TIMEOUT, threads=1)}


def _mesh():
    return make_grid_mesh(SHAPE, devices=jax.devices()[:4])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_ranks_import_neither_jax_nor_nmftpu(ranks):
    for r in ranks["out"]:
        assert r["_imported"] == {"jax": False, "nmftpu": False}


@pytest.mark.parametrize("name", list(FITS))
def test_minibatch_fit_matches_nmftpu_on_a_mesh(ranks, name):
    d = ranks["data"]
    kw = {"batch_size": 32, **FITS[name]}
    W, H, n_iter, n_steps = JM.minibatch_fit(
        d["V"], R, W0=d["W0"], H0=d["H0"], dtype=np.float64, mesh=_mesh(),
        **kw)
    for r in ranks["out"]:
        got = r[name]
        assert (got["n_iter"], got["n_steps"]) == (n_iter, n_steps)
        assert got["H"].shape == (R, M_)
        assert _rel(got["W"], W) <= TOL
        assert _rel(got["H"], H) <= TOL


@pytest.mark.parametrize("name", list(ONLINE))
def test_online_nmf_matches_nmftpu_on_a_mesh(ranks, name):
    """partial_fit steps, transform, and a stream saved by the first rank
    and loaded back onto the mesh (re-sharded), which goes on exactly as
    the uninterrupted one."""
    d = ranks["data"]
    model = JM.OnlineNMF(R, batch_size=16, dtype=np.float64, mesh=_mesh(),
                         **ONLINE[name])
    want = []
    for lo in range(0, N, 16):
        model.partial_fit(d["V"][lo:lo + 16], H0=d["H0"] if lo == 0 else None)
        want.append(np.asarray(model.H))
    for r in ranks["out"]:
        got = r[name]
        assert got["local_shape"] == (R, M_ // 4)
        for g, w in zip(got["steps"], want):
            assert _rel(g, w) <= TOL
        assert _rel(got["transform"], model.transform(d["V"][:16])) <= TOL
        np.testing.assert_array_equal(got["resumed"], got["continued"])
    model.partial_fit(d["V"][:16])
    assert _rel(ranks["out"][0][name]["continued"], model.H) <= TOL


def test_item_count_must_divide_over_the_ranks(ranks):
    d = ranks["data"]
    with pytest.raises(ValueError) as err:
        JM.minibatch_fit(d["V"][:, :-1], R, W0=d["W0"], H0=d["H0"][:, :-1],
                         dtype=np.float64, mesh=_mesh())
    assert "divisible" in str(err.value)
    for r in ranks["out"]:
        assert "divisible" in r["bad-m"]
