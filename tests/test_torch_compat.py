"""The port's nmfgpu-style API (nmftpu_torch.compat) against
nmftpu.compat, on the CPU: NMFTPU_PLATFORM=cpu makes the CPU the one
device, as the CLI and the C ABI read it. Results from the same warm
start agree to rtol 1e-4 (float32 after 20 iterations); sparse V runs
on auto's engine, densified bf16 at this size in both packages, whose
factors are rounded to bf16 at every step, so a rounding that falls the
other way moves the error by about 2^-9: there the error is held to
5 * 2^-9 (chip_smoke.py's bf16 limit) against nmftpu's, and exactly
against the port's own compute_sparse."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmftpu.compat as jcompat  # noqa: E402
from nmftpu.sparse import from_dense as j_from_dense  # noqa: E402
import nmftpu_torch  # noqa: E402
import nmftpu_torch.compat as nmfgpu  # noqa: E402
from nmftpu_torch.sparse import from_dense  # noqa: E402

RTOL = 1e-4


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("NMFTPU_PLATFORM", "cpu")
    monkeypatch.setattr(nmfgpu, "_chosen_device", None)
    yield
    nmfgpu.finalize()


def _V(seed=0, n=30, m=24):
    return np.random.default_rng(seed).uniform(0.1, 2.0,
                                               (n, m)).astype(np.float32)


def test_full_reference_call_sequence(cpu):
    assert nmfgpu.initialize() == nmfgpu.ResultType.SUCCESS
    assert nmfgpu.device_count() == 1
    info = nmfgpu.device_info(0)
    assert info["platform"] == "cpu" and info["index"] == 0
    assert nmfgpu.choose_device(0) == nmfgpu.ResultType.SUCCESS
    assert nmfgpu.choose_device(None) == nmfgpu.ResultType.SUCCESS
    assert nmfgpu.version() == nmftpu_torch.__version__

    V = _V()
    res = nmfgpu.compute(nmfgpu.NmfDescription(
        input_matrix=V, rank=4, algorithm="acls", num_iterations=20,
        threshold_value=1e-3, seed=42,
        parameters={"lambda_w": 0.05, "lambda_h": 0.05},
    ))
    assert res.W.shape == (30, 4) and res.W.device.type == "cpu"
    assert np.isfinite(res.frobenius_error)
    res2 = nmfgpu.compute(nmfgpu.NmfDescription(
        input_matrix=from_dense(V), rank=4, num_iterations=10))
    assert res2.H.shape == (4, 24)
    res3 = nmfgpu.compute(nmfgpu.NmfDescription(
        input_matrix=V, rank=4, init_method="copy_existing",
        initial_w=res.W.numpy(), initial_h=res.H.numpy(),
        num_iterations=10))
    assert res3.frobenius_error <= res.frobenius_error * 1.001


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("algorithm,params", [
    ("mu", {}), ("hals", {}), ("gdcls", {"lambda_tik": 0.1}),
])
def test_compute_matches_nmftpu(cpu, algorithm, params, sparse):
    V = _V(seed=1)
    if sparse:
        V[V < 1.0] = 0.0
    rng = np.random.default_rng(2)
    W0 = rng.uniform(0.1, 1.0, (30, 4)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (4, 24)).astype(np.float32)
    kw = dict(rank=4, algorithm=algorithm, init_method="copy_existing",
              initial_w=W0, initial_h=H0, num_iterations=20,
              check_interval=5, parameters=params)
    jcompat.initialize()
    nmfgpu.initialize()
    want = jcompat.compute(jcompat.NmfDescription(
        input_matrix=j_from_dense(V) if sparse else V, **kw))
    got = nmfgpu.compute(nmfgpu.NmfDescription(
        input_matrix=from_dense(V) if sparse else V, **kw))
    jcompat.finalize()
    if sparse:
        np.testing.assert_allclose(got.frobenius_error,
                                   want.frobenius_error, rtol=5 * 2**-9)
        cfg = nmftpu_torch.NmfConfig(
            rank=4, algorithm=algorithm, init_method="copy_existing",
            num_iterations=20, check_interval=5, **params)
        own = nmftpu_torch.compute_sparse(from_dense(V), cfg, W0=W0, H0=H0,
                                          device="cpu")
        assert torch.equal(got.W, own.W)
        return
    np.testing.assert_allclose(got.frobenius_error, want.frobenius_error,
                               rtol=RTOL)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W),
                               rtol=RTOL, atol=1e-5)


def test_compute_requires_initialize(cpu):
    nmfgpu.finalize()
    with pytest.raises(RuntimeError, match="initialize"):
        nmfgpu.compute(nmfgpu.NmfDescription(input_matrix=_V(), rank=2))


def test_invalid_device_index(cpu):
    nmfgpu.initialize()
    assert nmfgpu.choose_device(10**6) == \
        nmfgpu.ResultType.ERROR_INVALID_ARGUMENT
    with pytest.raises(IndexError):
        nmfgpu.device_info(3)


def test_no_device_without_cuda_or_cpu_platform(monkeypatch):
    """Without the CPU platform and without CUDA there is no device:
    initialize reports ERROR_NO_DEVICE, as the reference does."""
    monkeypatch.delenv("NMFTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert nmfgpu.initialize() == nmfgpu.ResultType.ERROR_NO_DEVICE
    assert nmfgpu.device_count() == 0
    assert nmfgpu.choose_device(0) == nmfgpu.ResultType.ERROR_NO_DEVICE


def test_compat_interrupt(cpu):
    """The interrupt flag polled at every convergence check cancels the
    run (the reference's C17)."""
    nmfgpu.initialize()
    calls = []

    def interrupt():
        calls.append(1)
        return len(calls) >= 2

    res = nmfgpu.compute(nmfgpu.NmfDescription(
        input_matrix=_V(seed=3, n=24, m=18), rank=3, num_iterations=400,
        check_interval=10, interrupt=interrupt))
    assert res.num_iterations == 20 and len(calls) == 2
