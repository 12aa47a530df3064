"""The beta divergence on every engine and the native host IO layer on
the card: beta MU through nmf on the densified (bf16, int8), ELL and
scatter engines and on dense bf16 / int8 V, each against the same call
on the CPU, whose plain path the CPU tests hold against nmftpu; the
native CSR and ELL builds feeding a CUDA run; a MovieLens fixture parsed
natively and factorized on the card. Every test here is marked `cuda`
and skips without a CUDA device; the file imports no jax, so on a
machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_slice10_cuda.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import native_loader as NL  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch.data import load_movielens  # noqa: E402

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on the card against float32 on the CPU, one step: the same
# operations summed in another order (cuBLAS, atomics), ~1e-6; 1e-4
RTOL = 1e-4
# densified: that reordering can flip the bf16 rounding of one weighted
# entry, (WH)^(β-2)·V or (WH)^(β-1), by an ulp (2^-7 relative at worst),
# and a row with one nonzero averages nothing away
RTOL_BF16 = 2 ** -6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(seed=0, n=300, m=200, density=0.1):
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 11, (n, m)) / 2.0
    V = np.where(rng.random((n, m)) < density, vals, 0.0).astype(np.float32)
    W = rng.uniform(0.1, 1.0, (n, 8)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (8, m)).astype(np.float32)
    return V, W, H


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("engine,storage", [
    ("densified", "float32"), ("densified", "int8"), ("ell", "float32"),
    ("scatter", "float32"), ("dense", "bfloat16"), ("dense", "int8")])
@pytest.mark.parametrize("beta", [0.0, 0.5, 1.5])
def test_beta_on_the_card_matches_the_cpu(dev, engine, storage, beta):
    V, W, H = _data(1)
    if engine == "dense":
        V = V + np.float32(0.1)
    obj = ({"objective": "itakura-saito"} if beta == 0.0 else
           {"objective": "beta-divergence", "beta": beta})
    kw = dict(init="copy", W0=W, H0=H, num_iterations=1, v_storage=storage,
              **obj)
    runs = []
    for d in (dev, "cpu"):
        if engine == "dense":
            runs.append(nt.nmf(V, 8, device=d, **kw))
        else:
            runs.append(nt.nmf(nt.sparse.from_dense(V), 8, strategy=engine,
                               device=d, **kw))
    got, want = runs
    assert got.W.device.type == "cuda"
    tol = RTOL if engine in ("ell", "scatter") else RTOL_BF16
    assert _rel(got.W, want.W) < tol and _rel(got.H, want.H) < tol
    assert abs(got.kl_error / want.kl_error - 1) < tol


def test_native_builds_feed_a_run_on_the_card(dev, monkeypatch):
    """The native CSR and ELL builds (size gate lowered) give the same
    buckets as numpy, and a beta ELL run on the card from either agrees
    with the CPU's."""
    assert NL.available() or NL.build(), "libnmftpu_io.so did not build"
    V, W, H = _data(2)
    sp = nt.sparse.from_dense(V)
    monkeypatch.setattr(NL, "NATIVE_MIN_NNZ", 1)
    monkeypatch.delenv("NMFTPU_NATIVE_CSR", raising=False)
    before = NL.CALLS["ell_build"]
    nat = TE.build_ell_pair(sp, device=dev)
    assert NL.CALLS["ell_build"] == before + 2
    monkeypatch.setenv("NMFTPU_NATIVE_CSR", "0")
    ref = TE.build_ell_pair(sp, device=dev)
    for a, b in zip(nat.rows.buckets + nat.cols.buckets,
                    ref.rows.buckets + ref.cols.buckets):
        assert a.vals.device.type == "cuda"
        for f in ("vals", "cols", "out_row"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    kw = dict(init="copy", W0=W, H0=H, num_iterations=3,
              objective="beta-divergence", beta=1.5, strategy="ell")
    got = nt.nmf(sp, 8, device=dev, **kw)
    want = nt.nmf(sp, 8, device="cpu", **kw)
    assert _rel(got.W, want.W) < 10 * RTOL


@pytest.mark.parametrize("name", ["ml100k_u.data", "ml20m_ratings.csv"])
def test_a_movielens_fixture_factorizes_on_the_card(dev, name):
    assert NL.available() or NL.build(), "libnmftpu_io.so did not build"
    path = os.path.join(REPO, "tests", "fixtures", name)
    inter = load_movielens(path, use_native=True)
    py = load_movielens(path, use_native=False)
    np.testing.assert_array_equal(inter.matrix.todense(), py.matrix.todense())
    rng = np.random.default_rng(3)
    n, m = inter.matrix.shape
    W0 = rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (4, m)).astype(np.float32)
    kw = dict(init="copy", W0=W0, H0=H0, num_iterations=5,
              objective="beta-divergence", beta=0.5, strategy="scatter")
    got = nt.nmf(inter.matrix, 4, device=dev, **kw)
    want = nt.nmf(inter.matrix, 4, device="cpu", **kw)
    assert _rel(got.W, want.W) < 10 * RTOL
