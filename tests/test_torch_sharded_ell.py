"""The port's grid engine on ELL tiles (nmftpu_torch.parallel.sharded_ell)
against nmftpu.parallel.sharded_ell on the CPU: one 4-rank gloo world
(the port's launcher, tests/torch_parallel_ranks.py, no jax in the
ranks) on a 2x2 mesh, nmftpu on a 2x2 mesh of virtual CPU devices, the
same numpy inputs and W0/H0.

Tolerances as tests/test_torch_parallel.py: one iteration and the
metrics on the same blocks, float64 1e-10 and float32 1e-5 of max|x|
(the beta divergence sums in float32 in both packages, so its float64
metric takes float32's limit); compute_sharded errors 1e-4 relative,
factors 1e-3 of max|x|; the tiles equal array for array."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nmftpu_torch as nt
from nmftpu import Initialization, Objective
from nmftpu import sparse as hs
from nmftpu.parallel import factor_shardings
from nmftpu.parallel import sharded_ell as SEL
from nmftpu.parallel.driver import _pad_perm_matrix
from nmftpu_torch.parallel import launch
from test_torch_parallel import (
    BASE,
    RANK,
    TIMEOUT,
    _by_coords,
    _check_compute,
    _data,
    _j_compute,
    _j_config,
    _mesh,
    _rel,
)

import torch_parallel_ranks as R

ELL = {
    "mu-frobenius": {},
    "mu-kl": dict(objective="kullback-leibler"),
    "weighted": dict(alpha_confidence=4.0),
    "beta-1.5": dict(objective="beta-divergence", beta=1.5),
    "beta-0.5": dict(objective="beta-divergence", beta=0.5),
    "beta-0": dict(objective="itakura-saito"),
}
LAYOUTS = {
    "small-False": dict(seg_max=16, buckets=(8, 16), balance=False),
    "small-True": dict(seg_max=16, buckets=(8, 16), balance=True),
    "default-power": dict(seg_max=512, buckets=(8, 16, 32, 64, 128, 256,
                                                512), balance=True,
                          data="power"),
}


def _cases():
    cases = [(f"partition-{k}", "partition_ell", p)
             for k, p in LAYOUTS.items()]
    for name, knobs in ELL.items():
        cases.append((f"compute-{name}", "compute",
                      dict(engine="ell", knobs={**BASE, **knobs})))
        for dt in ("float32", "float64"):
            cases.append((f"step-{name}-{dt}", "step", dict(
                engine="ell", data="main" if dt == "float32" else "f64",
                knobs={**BASE, **knobs, "dtype": dt})))
    return cases


@pytest.fixture(scope="module")
def ranks():
    data = _data()
    out = launch(R.training, 4, args=([((2, 2), _cases())], data),
                 timeout=TIMEOUT, threads=1)
    return {"data": data, "world4": out}


def test_ranks_import_neither_jax_nor_nmftpu(ranks):
    for r in ranks["world4"]:
        assert r["_imported"] == {"jax": False, "nmftpu": False}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_partition_ell_equals_nmftpu(ranks, name):
    p = LAYOUTS[name]
    dense = ranks["data"][p.get("data", "main")]["dense"]
    sell, rp, cp = SEL.partition_sparse_ell(
        hs.from_dense(dense), (2, 2), seg_max=p["seg_max"],
        buckets=p["buckets"], balance=p["balance"])
    got = _by_coords(ranks["world4"], (2, 2), f"partition-{name}")
    for (i, j), g in got.items():
        np.testing.assert_array_equal(g["row_perm"], rp)
        np.testing.assert_array_equal(g["col_perm"], cp)
        for side, widths, vals, cols, rows in (
                ("rows", sell.r_widths, sell.r_vals, sell.r_cols,
                 sell.r_rows),
                ("cols", sell.c_widths, sell.c_vals, sell.c_cols,
                 sell.c_rows)):
            assert [b[0] for b in g[side]] == list(widths)
            for (w, v, c, r), jv, jc, jr in zip(g[side], vals, cols, rows):
                np.testing.assert_array_equal(v, np.asarray(jv)[i, j])
                np.testing.assert_array_equal(c, np.asarray(jc)[i, j])
                np.testing.assert_array_equal(r, np.asarray(jr)[i, j])


def _j_step(knobs, data):
    cfg = dataclasses.replace(_j_config(knobs),
                              init_method=Initialization.COPY_EXISTING)
    mesh = _mesh((2, 2))
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    sell, rp, cp = SEL.partition_sparse_ell(
        hs.from_dense(data["dense"]), (2, 2), dtype=dtype, seed=cfg.seed,
        mesh=mesh)
    pn, pm = sell.padded_shape
    sh = factor_shardings(mesh)
    W = jax.device_put(_pad_perm_matrix(data["W0"], rp, pn, 0), sh["W"])
    H = jax.device_put(_pad_perm_matrix(data["H0"], cp, pm, 1), sh["H"])
    _, update, _ = SEL.build_sharded_ell_update(cfg, mesh, sell)
    fro, kl = SEL.build_sharded_ell_errors(mesh, sell)
    if cfg.objective is Objective.BETA:
        kl = SEL.build_sharded_ell_beta_error(mesh, sell, cfg.beta)
    svsq = sum(jnp.sum(v * v) for v in sell.r_vals)

    @jax.jit
    def step(sell, W, H, svsq):
        return fro(sell, W, H, svsq), kl(sell, W, H), update(sell, (), W, H)

    f, k, (W1, H1) = step(sell, W, H, svsq)
    return (np.asarray(W1), np.asarray(H1), float(f), float(k),
            sell.block_rows, sell.block_cols)


@pytest.mark.parametrize("name", list(ELL))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
def test_ell_half_steps_match_nmftpu(ranks, name, dtype, tol):
    knobs = {**BASE, **ELL[name], "dtype": dtype}
    data = ranks["data"]["main" if dtype == "float32" else "f64"]
    W1, H1, f, k, br, bc = _j_step(knobs, data)
    kl_tol = max(tol, 1e-5) if name.startswith("beta") else tol
    for (i, j), g in _by_coords(ranks["world4"], (2, 2),
                                f"step-{name}-{dtype}").items():
        assert _rel(g["W"], W1[i * br:(i + 1) * br]) <= tol, (i, j)
        assert _rel(g["H"], H1[:, j * bc:(j + 1) * bc]) <= tol, (i, j)
        assert g["fro"] == pytest.approx(f, rel=tol)
        assert g["kl"] == pytest.approx(k, rel=kl_tol)


@pytest.mark.parametrize("name", list(ELL))
def test_ell_compute_sharded_matches_nmftpu(ranks, name):
    want = _j_compute({**BASE, **ELL[name]}, ranks["data"]["main"], (2, 2),
                      engine="ell")
    _check_compute(ranks["world4"][0][(2, 2)][f"compute-{name}"], want)


@pytest.mark.parametrize("knobs,match", [
    (dict(algorithm="hals"), "MU family"),
    (dict(algorithm="als"), "MU family"),
    (dict(mask="observed"), "'scatter'"),
    (dict(v_storage="int8"), "v_storage"),
])
def test_ell_refuses_what_nmftpu_refuses(knobs, match):
    """Checked before any collective: a 1x1 mesh stand-in suffices."""
    from nmftpu_torch.parallel import sharded_ell as TSEL
    from nmftpu_torch.parallel.driver import _check_sharded, _resolve_engine

    cfg = nt.NmfConfig(rank=RANK, **knobs)
    with pytest.raises(ValueError, match=match):
        engine = _resolve_engine(cfg, "ell")
        _check_sharded(cfg, engine)
        TSEL.build_sharded_ell_update(cfg, None)
