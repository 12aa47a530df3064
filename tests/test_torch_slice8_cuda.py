"""Confidence weighting, int8 densified storage and masked completion on
the card: nmf on CUDA tensors against the same run on the CPU, whose
plain torch path the CPU tests hold against nmftpu. Every test here is
marked `cuda` and skips without a CUDA device; the file imports no jax,
so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_slice8_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch.kernels import dual_numer as DN  # noqa: E402
from nmftpu_torch.sparse import from_dense  # noqa: E402

pytestmark = pytest.mark.cuda

# float32 on the card against float32 on the CPU: the same operations,
# summed in another order (cuBLAS, atomics), ~sqrt(K) 2^-24 per step
RTOL_STEP = 1e-5
RTOL_ERR = 1e-4
# bf16 densified: a reordering can flip one bf16 rounding by an ulp
RTOL_BF16_STEP = 1e-4
RANK = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(seed=0, n=300, m=200, density=0.05, ones=False):
    rng = np.random.default_rng(seed)
    vals = 1.0 if ones else rng.integers(1, 11, (n, m)) * 0.5
    V = np.where(rng.random((n, m)) < density, vals, 0.0).astype(np.float32)
    V[7, :] = 0.0
    W = rng.uniform(0.1, 1.0, (n, RANK)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (RANK, m)).astype(np.float32)
    return V, W, H


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _pair(V, W, H, dev, iters, sparse, **kw):
    """The same run on the card and on the CPU."""
    out = []
    for device in (dev, "cpu"):
        X = from_dense(V) if sparse else V
        out.append(nt.nmf(X, RANK, init="copy", W0=W, H0=H,
                          num_iterations=iters, device=device, **kw))
    return out


@pytest.mark.parametrize("engine,storage,step_tol", [
    ("dense", "float32", RTOL_STEP),
    ("dense", "bfloat16", RTOL_BF16_STEP),
    ("dense", "int8", RTOL_BF16_STEP),
    ("densified", "float32", RTOL_BF16_STEP),
    ("densified", "int8", RTOL_BF16_STEP),
    ("ell", "float32", RTOL_STEP),
    ("scatter", "float32", RTOL_STEP),
])
def test_weighted_nmf_on_the_card_matches_the_cpu(dev, engine, storage,
                                                  step_tol):
    V, W, H = _data(ones=True)
    kw = dict(alpha_confidence=40.0, v_storage=storage)
    if engine != "dense":
        kw["strategy"] = engine
    gpu, cpu = _pair(V, W, H, dev, 1, engine != "dense", **kw)
    assert gpu.W.device.type == "cuda"
    assert _rel(gpu.W, cpu.W) < step_tol and _rel(gpu.H, cpu.H) < step_tol
    gpu, cpu = _pair(V, W, H, dev, 10, engine != "dense", **kw)
    assert abs(gpu.frobenius_error / cpu.frobenius_error - 1) < RTOL_ERR


@pytest.mark.parametrize("objective,sparse", [
    ("frobenius", True), ("kullback-leibler", True),
    ("kullback-leibler", False)])
def test_int8_densified_on_the_card_matches_the_cpu(dev, objective, sparse):
    """Sparse V on the densified int8 engine, and dense int8 KL (the same
    row-panel KL with the scale). Frobenius runs #6's one-sided entries:
    two launches an iteration, the same integers as the CPU twins."""
    V, W, H = _data()
    before = dict(DN.LAUNCHES)
    kw = {"strategy": "densified"} if sparse else {}
    gpu, cpu = _pair(V, W, H, dev, 3, sparse, v_storage="int8",
                     objective=objective, **kw)
    launched = {k: DN.LAUNCHES[k] - before[k] for k in DN.LAUNCHES}
    want = {"dual_numerators_int8": 0, "vht_int8": 0, "wtv_int8": 0}
    if objective == "frobenius":
        want.update(vht_int8=3, wtv_int8=3)
    assert launched == want
    assert abs(gpu.frobenius_error / cpu.frobenius_error - 1) < RTOL_ERR
    if objective != "frobenius":
        assert abs(gpu.kl_error / cpu.kl_error - 1) < RTOL_ERR


@pytest.mark.parametrize("strategy", ["ell", "scatter"])
@pytest.mark.parametrize("objective", ["frobenius", "kullback-leibler"])
def test_masked_nmf_on_the_card_matches_the_cpu(dev, strategy, objective):
    V, W, H = _data(seed=1)
    kw = dict(mask="observed", objective=objective, strategy=strategy)
    gpu, cpu = _pair(V, W, H, dev, 1, True, **kw)
    assert _rel(gpu.W, cpu.W) < RTOL_STEP and _rel(gpu.H, cpu.H) < RTOL_STEP
    gpu, cpu = _pair(V, W, H, dev, 10, True, **kw)
    assert abs(gpu.frobenius_error / cpu.frobenius_error - 1) < RTOL_ERR
    assert gpu.rmsd == pytest.approx(
        gpu.frobenius_error / np.sqrt(np.count_nonzero(V)), rel=1e-6)
