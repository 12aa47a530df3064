"""Slice 5's surfaces on the card: compute_batched and vectorized
restarts on the hand-written kernels (#1/#2 with use_pallas=True, #3/#4
with int8 V, #7 under HALS), one launch per problem (or restart) and
half-step, against the same runs on the CPU, whose plain torch path the
CPU tests hold against nmftpu; the sklearn facade's HALS fit and
transform on #7; MiniBatchNMF and compat on the card. Every test here is
marked `cuda` and skips without a CUDA device; the file imports no jax,
so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_slice13_cuda.py

Tolerances: the card against the CPU after a few float32 iterations
1e-4 of max|W| (sums in another order; tensor-core split products),
int8 and HALS errors 1e-3 and 2e-3 (chip_smoke.py's limits);
the card's lockstep runner against its own solo or sequential runs
1e-6 (the same launches on the same operands)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import sklearn_api as SK  # noqa: E402
from nmftpu_torch.batched import compute_batched  # noqa: E402
from nmftpu_torch.kernels import dense_mu as K  # noqa: E402
from nmftpu_torch.kernels import hals_sweep as HS  # noqa: E402
from nmftpu_torch.kernels import quantized as Q  # noqa: E402

pytestmark = pytest.mark.cuda

RTOL, SELF = 1e-4, 1e-6
B, N, R, ITERS = 3, 512, 32, 5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _stack(seed=0):
    rng = np.random.default_rng(seed)
    Vs = rng.uniform(0.05, 1.0, (B, N, N)).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (B, N, R)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (B, R, N)).astype(np.float32)
    return Vs, W0, H0


ROUTES = {
    "f32": ({"use_pallas": True}, K.LAUNCHES,
            ("w_update_fused", "h_update_fused")),
    "int8": ({"v_storage": "int8", "use_pallas": True}, Q.LAUNCHES,
             ("w_update_fused_q", "h_update_fused_q")),
    "hals": ({"algorithm": "hals"}, HS.LAUNCHES, ("hals_sweep",)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_batched_launches_per_problem_and_matches_cpu(route):
    knobs, counts, names = ROUTES[route]
    Vs, W0, H0 = _stack()
    cfg = nt.NmfConfig(rank=R, init_method="copy_existing",
                       num_iterations=ITERS, check_interval=ITERS, **knobs)
    before = {k: counts[k] for k in names}
    gpu = compute_batched(Vs, cfg, W0=W0, H0=H0, device="cuda")
    torch.cuda.synchronize()
    # one launch per problem and half-step: each MU kernel runs one
    # half-step, #7 both
    per = 2 if route == "hals" else 1
    assert {k: counts[k] - before[k] for k in names} == \
        dict.fromkeys(names, per * ITERS * B)
    cpu = compute_batched(Vs, cfg, W0=W0, H0=H0, device="cpu")
    if route == "int8":   # requantization: errors, not factors
        np.testing.assert_allclose(gpu.error, cpu.error, rtol=1e-3)
    elif route == "hals":  # a flipped clamp moves factors, not the error
        np.testing.assert_allclose(gpu.error, cpu.error, rtol=2e-3)
    else:
        assert _rel(gpu.W, cpu.W) <= RTOL and _rel(gpu.H, cpu.H) <= RTOL
    for i in range(B):
        solo = nt.compute(Vs[i], cfg, W0=W0[i], H0=H0[i], device="cuda")
        assert _rel(gpu.W[i], solo.W) <= SELF


def test_batched_plain_runs_batched_gemms_on_the_card():
    Vs, W0, H0 = _stack(seed=1)
    cfg = nt.NmfConfig(rank=R, init_method="copy_existing",
                       num_iterations=ITERS, check_interval=ITERS)
    before = dict(K.LAUNCHES)
    gpu = compute_batched(Vs, cfg, W0=W0, H0=H0, device="cuda")
    assert dict(K.LAUNCHES) == before
    cpu = compute_batched(Vs, cfg, W0=W0, H0=H0, device="cpu")
    assert _rel(gpu.W, cpu.W) <= RTOL


@pytest.mark.parametrize("route", ["f32", "hals"])
def test_vectorized_restarts_on_the_kernels(route):
    knobs, counts, names = ROUTES[route]
    V = np.random.default_rng(2).uniform(0.05, 1.0,
                                         (N, N)).astype(np.float32)
    kw = dict(num_runs=3, num_iterations=ITERS, check_interval=ITERS,
              device="cuda", seed=4, **knobs)
    before = {k: counts[k] for k in names}
    vec = nt.nmf(V, R, vectorize_runs=True, **kw)
    per = 2 if route == "hals" else 1
    assert {k: counts[k] - before[k] for k in names} == \
        dict.fromkeys(names, per * ITERS * 3)
    seq = nt.nmf(V, R, **kw)
    np.testing.assert_allclose(vec.run_errors, seq.run_errors, rtol=SELF)
    assert vec.best_run == seq.best_run
    assert _rel(vec.W, seq.W) <= SELF


def test_sklearn_cd_fit_and_transform_on_hals_kernel():
    rng = np.random.default_rng(3)
    V = rng.uniform(0.1, 2.0, (N, 384)).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (N, R)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (R, 384)).astype(np.float32)
    kw = dict(n_components=R, init="custom", max_iter=1, tol=0.0)
    before = HS.LAUNCHES["hals_sweep"]
    gpu = SK.NMF(device="cuda", **kw)
    Wg = gpu.fit_transform(V, W=W0, H=H0)
    assert HS.LAUNCHES["hals_sweep"] - before == 2
    Wc = SK.NMF(device="cpu", **kw).fit_transform(V, W=W0, H=H0)
    assert _rel(Wg, Wc) <= RTOL
    before = HS.LAUNCHES["hals_sweep"]
    gpu.set_params(max_iter=3)
    Wt = gpu.transform(V[:40])
    assert HS.LAUNCHES["hals_sweep"] - before == 3
    assert Wt.shape == (40, R) and (Wt >= 0).all()


def test_minibatch_and_compat_on_the_card():
    from nmftpu_torch import compat

    rng = np.random.default_rng(5)
    V = rng.uniform(0.1, 1.0, (N, 256)).astype(np.float32)
    kw = dict(n_components=8, batch_size=64, init="random", random_state=1,
              max_iter=2, tol=0.0, max_no_improvement=None,
              beta_loss="kullback-leibler")
    Wg = SK.MiniBatchNMF(device="cuda", **kw).fit_transform(V)
    Wc = SK.MiniBatchNMF(device="cpu", **kw).fit_transform(V)
    assert _rel(Wg, Wc) <= RTOL
    assert compat.initialize() == compat.ResultType.SUCCESS
    assert compat.device_count() == torch.cuda.device_count()
    assert compat.device_info(0)["kind"] == torch.cuda.get_device_name(0)
    assert compat.choose_device(0) == compat.ResultType.SUCCESS
    res = compat.compute(compat.NmfDescription(input_matrix=V, rank=4,
                                               num_iterations=10))
    assert res.W.device.type == "cuda"
    compat.finalize()
