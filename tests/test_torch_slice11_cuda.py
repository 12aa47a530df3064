"""The dense ALS family, GDCLS and nsNMF and the k-means and NNDSVD inits
on the card: each algorithm on float32, bf16 and int8 V through nmf,
one iteration against the same call on the CPU (whose plain path the CPU
tests hold against nmftpu); the int8 family's right-hand sides on #6's
one-sided entries (launched once per half-step, equal to the entries'
plain twins and to the exact product); the inits on CUDA tensors. Every
test here is marked `cuda` and skips without a CUDA device; the file
imports no jax, so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_slice11_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch.init import kmeans as KM  # noqa: E402
from nmftpu_torch.kernels import dual_numer as DN  # noqa: E402
from nmftpu_torch.linalg import dense as D  # noqa: E402

pytestmark = pytest.mark.cuda

KNOBS = {
    "als": {},
    "acls": {"lambda_w": 0.1, "lambda_h": 0.2},
    "ahcls": {"lambda_w": 0.1, "lambda_h": 0.2, "alpha_w": 0.5,
              "alpha_h": 0.3},
    "gdcls": {"lambda_tik": 0.1},
    "nsnmf": {"theta": 0.5},
}
ALGORITHMS = [(a, "frobenius") for a in KNOBS] + [("nsnmf",
                                                   "kullback-leibler")]
SOLVES = ("als", "acls", "ahcls")
U32 = 2.0 ** -24
# the card against the CPU, the first half-step of one iteration: the same
# float32 operations summed in another order (cuBLAS, cuSOLVER). An MU-type
# half-step: ~1e-6, 1e-4 leaves 100x; a solve: 10 kappa 2^-24, kappa the
# solved Gram's condition number
MU_RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(seed=0, n=300, m=200, r=16):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.0, 5.0, (n, m)).astype(np.float32)
    W = rng.uniform(0.05, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.05, 1.0, (r, m)).astype(np.float32)
    return V, W, H


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("algorithm,objective", ALGORITHMS)
def test_each_algorithm_on_the_card_matches_the_cpu(dev, algorithm,
                                                     objective, storage):
    V, W, H = _data(1)
    kw = dict(init="copy", W0=W, H0=H, num_iterations=1, v_storage=storage,
              algorithm=algorithm, objective=objective, **KNOBS[algorithm])
    got, want = (nt.nmf(V, 16, device=d, **kw) for d in (dev, "cpu"))
    assert got.W.device.type == "cuda"
    # W is the first half-step (order WH), from the same (W0, H0)
    limit = (10 * np.linalg.cond(H.astype(np.float64) @ H.T) * U32
             if algorithm in SOLVES else MU_RTOL)
    assert _rel(got.W, want.W) <= limit
    np.testing.assert_allclose(got.error, want.error, rtol=1e-3)
    assert np.isfinite(got.stats.errors).all()


@pytest.mark.parametrize("algorithm", ["als", "ahcls", "gdcls", "nsnmf"])
def test_int8_family_launches_the_one_sided_entries(dev, algorithm):
    """One vht_int8 and one wtv_int8 launch per iteration, none on
    torch._int_mm or a twin."""
    V, W, H = _data(2)
    DN.LAUNCHES.update(vht_int8=0, wtv_int8=0)
    res = nt.nmf(V, 16, init="copy", W0=W, H0=H, num_iterations=4,
                 v_storage="int8", algorithm=algorithm, device=dev,
                 **KNOBS[algorithm])
    assert DN.LAUNCHES["vht_int8"] == DN.LAUNCHES["wtv_int8"] == 4
    assert np.isfinite(res.stats.errors).all()


@pytest.mark.parametrize("side", ["w", "h"])
def test_ls_terms_int8_match_their_twins(dev, side):
    """The right-hand sides from the kernels equal the twins' and the
    exact product; the Grams agree to float32 reordering."""
    V, W, H = _data(3)
    from nmftpu_torch.kernels import quantized as Q

    Vq, s = Q.quantize_v(torch.tensor(V, device=dev))
    X = torch.tensor(H if side == "w" else W, device=dev)
    fn = getattr(D, f"_ls_terms_{side}_int8")
    g_dev, r_dev = fn(Vq, s, X)
    g_cpu, r_cpu = fn(Vq.cpu(), s.cpu(), X.cpu())
    assert torch.equal(r_dev.cpu(), r_cpu)
    torch.testing.assert_close(g_dev.cpu(), g_cpu, rtol=1e-6, atol=0)
    if side == "w":
        exact = DN.vht_exact(Vq, D.quantize_sym(X)[1]).T
    else:
        exact = DN.wtv_exact(Vq, D.quantize_sym_t(X)[1])
    scale = float(s) * float(D.quantize_sym(X)[0])
    torch.testing.assert_close(r_dev.double(), exact * scale, rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("init", ["kmeans_random", "kmeans_nonnegative_wtv",
                                  "kmeans_absolute_wtv", "nndsvd", "nndsvda",
                                  "nndsvdar"])
def test_inits_on_the_card(dev, init):
    V, _, _ = _data(4)
    res = nt.nmf(V, 16, init=init, num_iterations=0, device=dev)
    assert res.W.device.type == "cuda"
    assert (res.W >= 0).all() and (res.H >= 0).all()
    assert np.isfinite(res.error)


def test_lloyd_on_the_card_matches_the_cpu(dev):
    """Well-separated clusters: the same assignments; the centroids to
    float32 reordering."""
    rng = np.random.default_rng(5)
    centres = rng.uniform(0.0, 10.0, (40, 6))
    V = np.abs(centres[:, rng.integers(0, 6, 300)]
               + 0.05 * rng.standard_normal((40, 300))).astype(np.float32)
    near = np.abs(V[:, :, None] - centres[:, None, :]).max(axis=0) < 1.0
    start = np.array([np.flatnonzero(near[:, k])[0] for k in range(6)])
    Vt = torch.tensor(V)
    c_dev, a_dev = KM._lloyd(Vt.to(dev), Vt[:, start].to(dev), 10)
    c_cpu, a_cpu = KM._lloyd(Vt, Vt[:, start], 10)
    assert torch.equal(a_dev.cpu(), a_cpu)
    assert _rel(c_dev, c_cpu) <= 1e-5
