"""The last public names of nmftpu that the port lacked, each held against
its nmftpu twin on the same numpy inputs: the package's lazy
`prepare_sharded` / `ShardedPlan`, the `linalg` and `kernels` package
exports, `synthetic_lowrank_dense` (bit for bit), `map_values` /
`combine_values` on ELL rows, `v_ht_ell(gather_dtype=)`,
`initialize_factors(mean_v=)`, `NmfResult.row_perm` / `col_perm`,
`initialize_distributed(initialization_timeout=)`, and the constants
`AXIS_USERS` (sharded retrieval) and `NEG` (the reservoir scan).

Tolerances: the ELL products with a bf16 table, 1e-6 relative (both
packages round the same table to bf16 and sum float32 products of at
most a row's nonzeros, in another order); the random init's scale, 1e-6
relative (float32 square roots of the same mean)."""

import dataclasses
import datetime
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ell as JE  # noqa: E402
from nmftpu.init import strategies as JI  # noqa: E402
from nmftpu_torch import sparse as ts  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch.init import strategies as TI  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-6


def _ratings(seed=0, n=70, m=55, density=0.2):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < density,
                     rng.integers(1, 6, (n, m)), 0).astype(np.float32)
    dense[rng.integers(n), :] = rng.integers(1, 6, m)   # one long row
    return dense, js.from_dense(dense), ts.from_dense(dense)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_the_package_exports_the_sharded_plan():
    from nmftpu_torch import parallel

    assert nt.prepare_sharded is parallel.prepare_sharded
    assert nt.ShardedPlan is parallel.ShardedPlan
    assert {"prepare_sharded", "ShardedPlan"} <= set(nt.__all__)
    assert set(nmftpu._LAZY) <= set(nt._LAZY) | set(nt.__all__)


def test_linalg_reexports_the_dense_layer():
    from nmftpu_torch import linalg
    from nmftpu_torch.linalg import dense

    assert linalg.__all__ == nmftpu.linalg.__all__
    for name in linalg.__all__:
        assert getattr(linalg, name) is getattr(dense, name), name


def test_kernels_exports_its_modules_lazily_without_a_build():
    import nmftpu.kernels

    import nmftpu_torch.kernels as K

    assert K.__all__ == nmftpu.kernels.__all__
    for name in K.__all__:
        assert getattr(K, name).__name__ == f"nmftpu_torch.kernels.{name}"
    with pytest.raises(AttributeError):
        K.no_such_kernel
    # a fresh interpreter whose build fails: the exports still load
    code = ("import sys\n"
            "import nmftpu_torch.kernels._build as B\n"
            "def _no(*a, **k):\n"
            "    sys.exit(3)\n"
            "B.build = B.load = _no\n"
            "import nmftpu_torch.kernels as K\n"
            "K.quantized, K.sparse_ell_kernel, K.dense_mu\n"
            "print('loaded')\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and "loaded" in done.stdout, done.stderr


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("noise", [0.0, 0.01, 0.5])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_lowrank_dense_is_bit_identical(seed, noise, dtype):
    from nmftpu.data import synthetic_lowrank_dense as ref

    from nmftpu_torch.data import synthetic_lowrank_dense as got

    a = got(40, 33, 5, noise=noise, seed=seed, dtype=dtype)
    b = ref(40, 33, 5, noise=noise, seed=seed, dtype=dtype)
    assert a.dtype == b.dtype == dtype and a.shape == (40, 33)
    np.testing.assert_array_equal(a, b)


def _same_structure(got, want):
    assert got.shape == want.shape and got.nnz == want.nnz
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        assert g.width == w.width
        np.testing.assert_array_equal(g.cols.numpy(), np.asarray(w.cols))
        np.testing.assert_array_equal(g.out_row.numpy(),
                                      np.asarray(w.out_row))


def test_map_and_combine_values_match_nmftpu():
    _, jsp, tsp = _ratings()
    jr = JE.build_ell_pair(jsp).rows
    tr = TE.build_ell_pair(tsp, device="cpu").rows
    _same_structure(tr, jr)

    def fn(v):
        return 2.0 * v + 1.0

    def comb(a, b):
        return a * b + a

    for got, want in ((TE.map_values(tr, fn), JE.map_values(jr, fn)),
                      (TE.combine_values(tr, TE.map_values(tr, fn), comb),
                       JE.combine_values(jr, JE.map_values(jr, fn), comb))):
        _same_structure(got, want)
        _same_structure(got, tr)
        for g, w, orig in zip(got.buckets, want.buckets, tr.buckets):
            np.testing.assert_array_equal(g.vals.numpy(), np.asarray(w.vals))
            assert g.cols is orig.cols and g.out_row is orig.out_row


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
def test_v_ht_ell_gather_dtype_matches_nmftpu(gather_dtype):
    dense, jsp, tsp = _ratings(seed=1)
    H = np.random.default_rng(2).uniform(0.1, 1.0, (6, dense.shape[1])) \
        .astype(np.float32)
    got = TE.v_ht_ell(TE.build_ell_pair(tsp, device="cpu").rows,
                      torch.tensor(H),
                      gather_dtype=getattr(torch, gather_dtype)
                      if gather_dtype else None)
    want = JE.v_ht_ell(JE.build_ell_pair(jsp).rows, jnp.asarray(H),
                       gather_dtype=getattr(jnp, gather_dtype)
                       if gather_dtype else None)
    assert got.dtype == torch.float32 and got.shape == (dense.shape[0], 6)
    assert _rel(got, want) <= RTOL
    # the bf16 table is what the sums see: the float64 sum of V and the
    # rounded table, not of V and H
    Ht = torch.tensor(H.T)
    if gather_dtype:
        Ht = Ht.to(torch.bfloat16)
    exact = dense.astype(np.float64) @ Ht.double().numpy()
    assert _rel(got, exact) <= RTOL
    if gather_dtype:
        assert _rel(got, dense.astype(np.float64) @ H.T.astype(np.float64)) \
            > 1e-4


def test_v_ht_ell_gather_dtype_keeps_float64_sums():
    """A float64 run with a bf16 table sums in float64 (nmftpu would
    truncate to float32)."""
    dense, _, tsp = _ratings(seed=3)
    H = np.random.default_rng(4).uniform(0.1, 1.0, (6, dense.shape[1]))
    rows = TE.build_ell_pair(tsp, dtype=torch.float64, device="cpu").rows
    got = TE.v_ht_ell(rows, torch.tensor(H), gather_dtype=torch.bfloat16)
    assert got.dtype == torch.float64
    Ht = torch.tensor(H.T).to(torch.bfloat16).double().numpy()
    assert _rel(got, dense.astype(np.float64) @ Ht) <= 1e-14


def test_initialize_factors_mean_v_sets_the_random_scale():
    """nmftpu's and the port's random init with mean_v = c: (u + 1e-4)
    times sqrt(c / r), u each package's own uniform draws."""
    n, m, r, c = 30, 20, 4, 2.5
    V = np.random.default_rng(5).uniform(0.0, 9.0, (n, m)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    Wj, Hj = JI.initialize_factors(jnp.asarray(V), r,
                                   nmftpu.Initialization.ALL_RANDOM_VALUES,
                                   key, mean_v=c)
    kw, kh, _ = jax.random.split(key, 3)
    uj = jax.random.uniform(kw, (n, r), dtype=jnp.float32)
    scale_j = np.asarray(Wj) / (np.asarray(uj) + 1e-4)

    gen = TI.run_generator(3, 0, "cpu")
    Wt, Ht = TI.initialize_factors(torch.tensor(V), r,
                                   nt.Initialization.ALL_RANDOM_VALUES, gen,
                                   mean_v=c)
    ut = torch.rand((n, r), generator=TI.run_generator(3, 0, "cpu"))
    scale_t = (Wt / (ut + 1e-4)).numpy()
    want = np.sqrt(c / r)
    assert np.abs(scale_j / want - 1).max() <= RTOL
    assert np.abs(scale_t / want - 1).max() <= RTOL
    # by default the scale is V's mean's: the same as passing it
    Wd, Hd = TI.initialize_factors(torch.tensor(V), r,
                                   nt.Initialization.ALL_RANDOM_VALUES,
                                   TI.run_generator(3, 0, "cpu"))
    Wm, Hm = TI.initialize_factors(torch.tensor(V), r,
                                   nt.Initialization.ALL_RANDOM_VALUES,
                                   TI.run_generator(3, 0, "cpu"),
                                   mean_v=torch.tensor(V).mean())
    assert torch.equal(Wd, Wm) and torch.equal(Hd, Hm)


def test_an_unsharded_result_has_no_permutations():
    V = np.random.default_rng(6).uniform(0.1, 1.0, (20, 15)).astype(
        np.float32)
    want = nmftpu.nmf(V, 3, num_iterations=2)
    got = nt.nmf(V, 3, num_iterations=2, device="cpu")
    for res in (want, got):
        assert res.row_perm is None and res.col_perm is None
    fields = [f.name for f in dataclasses.fields(got)]
    assert fields[-2:] == ["row_perm", "col_perm"]


@pytest.mark.parametrize("given", [None, 7])
def test_initialize_distributed_passes_the_timeout(monkeypatch, given):
    import torch.distributed as dist

    from nmftpu_torch.parallel import multihost

    seen = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: seen.update(k))
    monkeypatch.setattr(multihost, "_set_device", lambda rank: None)
    multihost.initialize_distributed("localhost:29500", 1, 0,
                                     initialization_timeout=given,
                                     backend="gloo")
    assert seen["timeout"] == (None if given is None
                               else datetime.timedelta(seconds=given))
    assert seen["init_method"] == "tcp://localhost:29500"


def test_the_constants_match_nmftpu():
    from nmftpu.kernels import mips_reservoir as JM
    from nmftpu.parallel import retrieval_sharded as JR

    from nmftpu_torch.kernels import mips_reservoir as TM
    from nmftpu_torch.parallel import retrieval_sharded as TR

    assert TR.AXIS_USERS == JR.AXIS_USERS and TR.AXIS_ITEMS == JR.AXIS_ITEMS
    assert TM.NEG == JM.NEG == float("-inf")
