"""The ALS family, GDCLS, nsNMF, HALS, iALS, masked ALS and the sparse
inits on sparse V on the card: nmf on CUDA tensors against the same run
on the CPU, whose plain torch path the CPU tests hold against nmftpu.
Sparse HALS sweeps on #7 (`kernels/hals_sweep.py`, two launches an
iteration, held against its plain twin on the run's own operands); the
int8 densified ALS family, GDCLS and nsNMF-Frobenius take their
right-hand sides from #6's one-sided entries (one launch of each an
iteration). Every test here is marked `cuda` and skips without a CUDA
device; the file imports no jax, so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_slice12_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.kernels import dual_numer as DN  # noqa: E402
from nmftpu_torch.kernels import hals_sweep as HS  # noqa: E402
from nmftpu_torch.sparse import from_dense  # noqa: E402

pytestmark = pytest.mark.cuda

U32 = 2.0 ** -24
# the card against the CPU, float32: the same operations summed in
# another order (cuBLAS, cuSOLVER, atomics). An MU-type half-step ~1e-6,
# 1e-4 leaves 100x; a solve 10 kappa 2^-24; HALS's first iteration 1e-4
# (the hessian division amplifies the reordering); #7 against its twin
# at 3e-5 max|W| (chip_smoke.py's HALS_ATOL)
MU_RTOL = 1e-4
HALS_ATOL = 3e-5
RANK, HALS_RANK = 8, 16
FAMILY = {
    "als": {},
    "acls": {"lambda_w": 0.1, "lambda_h": 0.2},
    "ahcls": {"lambda_w": 0.1, "lambda_h": 0.2, "alpha_w": 0.5,
              "alpha_h": 0.3},
    "gdcls": {"lambda_tik": 0.1},
    "nsnmf": {"theta": 0.5},
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(seed=0, n=400, m=300, r=RANK, density=0.08):
    rng = np.random.default_rng(seed)
    V = np.where(rng.random((n, m)) < density,
                 rng.integers(1, 11, (n, m)) * 0.5, 0.0).astype(np.float32)
    V[7, :] = 0.0
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    return V, W, H


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _pair(V, W, H, dev, iters, **kw):
    """The same sparse run on the card and on the CPU."""
    return [nt.nmf(from_dense(V), W.shape[1], init="copy", W0=W, H0=H,
                   num_iterations=iters, device=d, **kw)
            for d in (dev, "cpu")]


def test_sparse_hals_sweeps_on_the_kernel(dev):
    V, W, H = _data(1, r=HALS_RANK)
    before = HS.LAUNCHES["hals_sweep"]
    got, want = _pair(V, W, H, dev, 1, algorithm="hals", strategy="scatter")
    assert HS.LAUNCHES["hals_sweep"] - before == 2
    assert _rel(got.W, want.W) <= MU_RTOL and _rel(got.H, want.H) <= MU_RTOL
    before = HS.LAUNCHES["hals_sweep"]
    got, want = _pair(V, W, H, dev, 5, algorithm="hals", lambda_w=0.1,
                      l1_h=0.01)
    assert HS.LAUNCHES["hals_sweep"] - before == 10
    np.testing.assert_allclose(got.stats.errors, want.stats.errors,
                               rtol=1e-4)


def test_sparse_hals_kernel_matches_its_twin_on_the_runs_operands(dev):
    V, W, H = _data(2, r=HALS_RANK)
    coo = TS.device_put_sparse(from_dense(V), device=dev)
    Wd, Hd = torch.tensor(W, device=dev), torch.tensor(H, device=dev)
    XHt, G = TS.v_ht(coo, Hd), Hd @ Hd.T
    got = HS.hals_sweep(XHt, G, Wd)
    want = HS.hals_sweep_plain(XHt, G, Wd)
    assert float((got - want).abs().max()) <= HALS_ATOL * float(
        want.abs().max())


@pytest.mark.parametrize("alg", list(FAMILY))
def test_int8_densified_family_on_the_one_sided_entries(dev, alg):
    V, W, H = _data(3)
    kw = dict(algorithm=alg, strategy="densified", v_storage="int8",
              **FAMILY[alg])
    DN.LAUNCHES.update(vht_int8=0, wtv_int8=0)
    got, want = _pair(V, W, H, dev, 3, **kw)
    assert {k: DN.LAUNCHES[k] for k in ("vht_int8", "wtv_int8")} == {
        "vht_int8": 3, "wtv_int8": 3}
    np.testing.assert_allclose(got.stats.errors, want.stats.errors,
                               rtol=1e-3)
    got, want = _pair(V, W, H, dev, 1, **kw)
    limit = (10 * np.linalg.cond(H.astype(np.float64) @ H.T) * U32
             if alg in ("als", "acls", "ahcls") else MU_RTOL)
    assert _rel(got.W, want.W) <= max(limit, MU_RTOL)


@pytest.mark.parametrize("strategy", ["scatter", "ell", "densified"])
@pytest.mark.parametrize("alg,obj", [(a, "frobenius") for a in FAMILY]
                         + [("nsnmf", "kullback-leibler")])
def test_family_on_each_engine_matches_the_cpu(dev, alg, obj, strategy):
    V, W, H = _data(4)
    got, want = _pair(V, W, H, dev, 1, algorithm=alg, objective=obj,
                      strategy=strategy, **FAMILY[alg])
    assert got.W.device.type == "cuda"
    limit = (10 * np.linalg.cond(H.astype(np.float64) @ H.T) * U32
             if alg in ("als", "acls", "ahcls") else MU_RTOL)
    assert _rel(got.W, want.W) <= max(limit, MU_RTOL)
    np.testing.assert_allclose(got.error, want.error, rtol=1e-3)


@pytest.mark.parametrize("strategy", ["scatter", "ell"])
@pytest.mark.parametrize("knobs", [dict(alpha_confidence=5.0),
                                   dict(alpha_confidence=5.0,
                                        als_solver="cg"),
                                   dict(mask="observed", lambda_w=0.05,
                                        lambda_h=0.05)],
                         ids=["ials", "ials-cg", "masked"])
def test_ials_and_masked_als_match_the_cpu(dev, knobs, strategy):
    V, W, H = _data(5, density=0.3)
    got, want = _pair(V, W, H, dev, 3, algorithm="als", strategy=strategy,
                      check_interval=1, **knobs)
    np.testing.assert_allclose(got.stats.errors, want.stats.errors,
                               rtol=1e-4)
    assert (got.W >= 0).all() and (got.H >= 0).all()


def test_dense_ials_matches_the_cpu(dev):
    V, W, H = _data(6, density=1.0)
    got, want = (nt.nmf(V, RANK, algorithm="als", alpha_confidence=5.0,
                        init="copy", W0=W, H0=H, num_iterations=3,
                        check_interval=1, device=d) for d in (dev, "cpu"))
    np.testing.assert_allclose(got.stats.errors, want.stats.errors,
                               rtol=1e-4)


@pytest.mark.parametrize("init", ["kmeans_random", "kmeans_nonnegative_wtv",
                                  "nndsvd", "nndsvdar"])
def test_sparse_inits_on_the_card(dev, init):
    V, _, _ = _data(7)
    res = nt.nmf(from_dense(V), RANK, init=init, num_iterations=5,
                 strategy="scatter", device=dev)
    assert res.W.device.type == "cuda"
    assert (res.W >= 0).all() and (res.H >= 0).all()
    assert np.isfinite(res.stats.errors).all()
