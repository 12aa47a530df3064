"""Cold-user fold-in and dense beta MU on the card: the int8 table's Gram
on the int8 numerator kernel (#6's one-sided entry, per panel), the HALS
fold-in on the sweep kernel (#7) and the reservoir scan (#8) behind
recommend_from_history_batch, each against the same call on the CPU,
whose plain path the CPU tests hold against nmftpu. Every test here is
marked `cuda` and skips without a CUDA device; the file imports no jax,
so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_slice9_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import foldin as PF  # noqa: E402
from nmftpu_torch.kernels import dual_numer as DN  # noqa: E402
from nmftpu_torch.kernels import hals_sweep as HS  # noqa: E402
from nmftpu_torch.kernels import mips_reservoir as MR  # noqa: E402
from nmftpu_torch.retrieval.exclusion import (  # noqa: E402
    build_block_exclusion,
)

pytestmark = pytest.mark.cuda

# float32 on the card against float32 on the CPU: the same operations
# summed in another order (cuBLAS, cuSOLVER, atomics); one HALS sweep is
# held to the kernel's bound against its twin (3e-5 of max|W|)
RTOL = 1e-4
HALS_ATOL = 3e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _table(seed=0, r=64, m=5000):
    rng = np.random.default_rng(seed)
    mag = np.logspace(0, -2, r)[:, None]
    return (rng.uniform(0.0, 1.0, (r, m)) * mag).astype(np.float32)


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def test_int8_gram_on_the_kernel_is_exact(dev):
    """int8_gram on #6 equals the exact integer Gram, one launch per
    panel, a ragged last panel included."""
    rng = np.random.default_rng(1)
    Hq = rng.integers(-127, 128, (96, 3000)).astype(np.int8)
    before = DN.LAUNCHES["vht_int8"]
    G = PF.int8_gram(torch.tensor(Hq, device=dev), panel=1024)
    assert DN.LAUNCHES["vht_int8"] - before == 3
    exact = Hq.astype(np.int64) @ Hq.T.astype(np.int64)
    np.testing.assert_array_equal(G.cpu().numpy(), exact)


def test_int8_gram_panel_does_not_wrap_on_the_kernel(dev):
    """A default panel of ±127 sums to 2,114,060,288 < 2³¹ on the
    kernel; two panels add past it exactly in int64."""
    Hq = torch.full((2, 2 * PF.GRAM_PANEL_INT8), 127, dtype=torch.int8,
                    device=dev)
    G = PF.int8_gram(Hq)
    assert int(G[0, 1]) == 2 * PF.GRAM_PANEL_INT8 * 127 ** 2


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_prepare_table_on_the_card_matches_the_cpu(dev, table_dtype):
    H = _table(2)
    recs = [nt.Recommender(np.ones((2, 64), np.float32), H,
                           table_dtype=table_dtype, device=d)
            for d in (dev, "cpu")]
    pc, pp = (r._prep() for r in recs)
    assert _rel(pc.G, pp.G) <= RTOL and _rel(pc.h_sum, pp.h_sum) <= RTOL
    if table_dtype == "int8":
        # exact integer sums and one scale fold: equal to the CPU's on the
        # card's own table bits and scales (quantize_table may round a
        # scale an ulp apart on the two devices)
        cpu = PF.prepare_table(recs[0].H.cpu(), scale=recs[0]._h_scale.cpu())
        assert torch.equal(pc.G.cpu(), cpu.G)
        assert torch.equal(pc.h_sum.cpu(), cpu.h_sum)


def test_hals_fold_in_runs_the_sweep_kernel(dev):
    """transform(algorithm='hals') launches #7 once per iteration; one
    iteration is within the kernel's bound of the CPU's blocked sweep,
    and twenty reach the CPU run's error."""
    H = _table(3)
    rng = np.random.default_rng(4)
    V = np.where(rng.random((300, 5000)) < 0.02, 1.0, 0.0).astype(
        np.float32)
    sp = nt.sparse.from_dense(V)
    before = HS.LAUNCHES["hals_sweep"]
    one = PF.transform(sp, H, algorithm="hals", num_iterations=1,
                       device=dev)
    assert HS.LAUNCHES["hals_sweep"] - before == 1
    ref = PF.transform(sp, H, algorithm="hals", num_iterations=1,
                       device="cpu")
    top = float(ref.W.abs().max())
    assert float((one.W.cpu() - ref.W).abs().max()) <= HALS_ATOL * top
    before = HS.LAUNCHES["hals_sweep"]
    res = PF.transform(sp, H, algorithm="hals", num_iterations=20,
                       device=dev)
    assert HS.LAUNCHES["hals_sweep"] - before == 20
    ref = PF.transform(sp, H, algorithm="hals", num_iterations=20,
                       device="cpu")
    np.testing.assert_allclose(res.error, ref.error, rtol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"alpha_confidence": 40.0},
                                {"algorithm": "mu"},
                                {"algorithm": "mu", "objective": "kl"}])
def test_fold_in_on_the_card_matches_the_cpu(dev, kw):
    H = _table(5)
    W = np.ones((2, 64), np.float32)
    rng = np.random.default_rng(6)
    hists = [rng.choice(5000, 50, replace=False) for _ in range(40)]
    got, want = (nt.Recommender(W, H, table_dtype="int8", device=d)
                 .fold_in_batch(hists, **kw) for d in (dev, "cpu"))
    assert _rel(torch.tensor(got), torch.tensor(want)) <= RTOL


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
def test_recommend_from_history_runs_the_reservoir_kernel(dev,
                                                          table_dtype):
    """recommend_from_history_batch on method='reservoir' launches #8 and
    returns no history item; its ids match the exact scan of the same
    embeddings except at near-ties."""
    H = _table(7, m=20000)
    W = np.ones((2, 64), np.float32)
    rng = np.random.default_rng(8)
    hists = [rng.choice(20000, 100, replace=False) for _ in range(64)]
    rec = nt.Recommender(W, H, method="reservoir", table_dtype=table_dtype,
                         reservoir_slots=1024, device=dev)
    before = MR.LAUNCHES["reservoir_scan"]
    s, i = rec.recommend_from_history_batch(hists, k=20)
    assert MR.LAUNCHES["reservoir_scan"] - before >= 1
    for u, h in enumerate(hists):
        assert not set(h.tolist()) & set(i[u].tolist())
    exact = nt.Recommender.from_table(W, rec.H, h_scale=rec._h_scale,
                                      method="exact", device=dev)
    csr = rec._histories_csr(hists)
    Wq = rec._fold_in_csr(csr, algorithm="als", objective="frobenius",
                          num_iterations=50, alpha_confidence=0.0,
                          lambda_w=1e-6, seed=0)
    lists = build_block_exclusion(np.arange(64), csr, rec.n_items,
                                  exact.block)
    s_ex, i_ex = exact._topk(Wq, 21, lists, None)
    s_ex, i_ex = s_ex.cpu().numpy(), i_ex.cpu().numpy()
    recall = np.mean([len(set(i[u].tolist()) & set(i_ex[u, :20].tolist()))
                      / 20 for u in range(64)])
    assert recall >= 0.999


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.5])
def test_beta_mu_on_the_card_matches_the_cpu(dev, beta):
    rng = np.random.default_rng(9)
    V = (np.abs(rng.normal(size=(300, 200))) + 0.1).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (300, 8)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (8, 200)).astype(np.float32)
    kw = dict(objective="beta-divergence", beta=beta, init="copy", W0=W0,
              H0=H0, num_iterations=10, check_interval=5)
    got, want = (nt.nmf(V, 8, device=d, **kw) for d in (dev, "cpu"))
    assert _rel(got.W, want.W) <= 1e-3 and _rel(got.H, want.H) <= 1e-3
    np.testing.assert_allclose(got.kl_error, want.kl_error, rtol=1e-4)
