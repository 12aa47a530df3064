"""Checkpoint / resume in the port (nmftpu_torch.checkpoint) against
nmftpu.checkpoint: the same fingerprint, each package reading the
other's factors.npz layout, resume against an uninterrupted run and
against nmftpu's resume, on the CPU.

Tolerances: a resumed run against the uninterrupted one rtol 1e-6 (the
same operations; the factors go through float32 numpy exactly); the
port's resume against nmftpu's rtol 1e-4 (float32 after 20
iterations)."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmftpu  # noqa: E402
from nmftpu import checkpoint as JC  # noqa: E402
from nmftpu.sparse import from_dense as j_from_dense  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import checkpoint as TC  # noqa: E402
from nmftpu_torch.convert import config_from_nmftpu  # noqa: E402
from nmftpu_torch.sparse import from_dense  # noqa: E402

RTOL = 1e-4
RESUME_RTOL = 1e-6


def _problem(seed=0, n=64, m=48, r=6):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 2.0, (n, m)).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    return V, W0, H0


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("knobs", [
    {}, {"algorithm": "hals", "dtype": "float64"},
    {"objective": "beta-divergence", "beta": 0.5, "seed": 3},
    {"use_pallas": True, "v_storage": "int8", "num_runs": 2},
])
def test_fingerprint_equals_nmftpu(knobs):
    jc = nmftpu.NmfConfig(rank=4, **knobs)
    assert TC._config_fingerprint(nt.NmfConfig(rank=4, **knobs)) == \
        JC._config_fingerprint(jc)
    assert TC._config_fingerprint(config_from_nmftpu(jc)) == \
        JC._config_fingerprint(jc)


def test_save_load_roundtrip_tensors(tmp_path):
    _, W0, H0 = _problem()
    cfg = nt.NmfConfig(rank=6, num_iterations=10)
    TC.save(str(tmp_path / "ck"), torch.tensor(W0), torch.tensor(H0),
            iteration=7, config=cfg)
    assert sorted(os.listdir(tmp_path / "ck")) == ["factors.npz",
                                                   "meta.json"]
    ck = TC.load(str(tmp_path / "ck"))
    np.testing.assert_array_equal(ck.W, W0)
    np.testing.assert_array_equal(ck.H, H0)
    assert ck.iteration == 7
    assert ck.config_fingerprint == TC._config_fingerprint(cfg)


def test_nmftpu_reads_a_port_checkpoint(tmp_path):
    """nmftpu.checkpoint.load takes the port's directory through its npz
    branch (there is no orbax factors/ tree), and nmftpu resumes from
    it."""
    V, W0, H0 = _problem(seed=1)
    TC.save(str(tmp_path / "ck"), torch.tensor(W0), torch.tensor(H0),
            iteration=5, config=nt.NmfConfig(rank=6, num_iterations=10))
    ck = JC.load(str(tmp_path / "ck"))
    np.testing.assert_array_equal(np.asarray(ck.W), W0)
    assert ck.iteration == 5
    res = JC.resume(str(tmp_path / "ck"), V,
                    nmftpu.NmfConfig(rank=6, num_iterations=10))
    assert res.num_iterations == 5


def test_port_reads_an_nmftpu_npz_checkpoint(tmp_path, monkeypatch):
    """A checkpoint nmftpu writes without orbax (its fallback layout,
    _HAS_ORBAX patched to False) loads and resumes in the port."""
    monkeypatch.setattr(JC, "_HAS_ORBAX", False)
    V, W0, H0 = _problem(seed=2)
    jcfg = nmftpu.NmfConfig(rank=6, num_iterations=20)
    JC.save(str(tmp_path / "ck"), W0, H0, iteration=12, config=jcfg)
    ck = TC.load(str(tmp_path / "ck"))
    np.testing.assert_array_equal(ck.W, W0)
    assert ck.iteration == 12
    res = TC.resume(str(tmp_path / "ck"), V, config_from_nmftpu(jcfg),
                    device="cpu")
    assert res.num_iterations == 8


def test_orbax_checkpoint_is_refused_by_name(tmp_path):
    """nmftpu with orbax writes a factors/ tree the port cannot read:
    load raises an error naming that directory (no silent skip)."""
    if not JC._HAS_ORBAX:
        pytest.skip("orbax is not installed, nmftpu writes npz")
    _, W0, H0 = _problem(seed=3)
    JC.save(str(tmp_path / "ck"), W0, H0, iteration=1,
            config=nmftpu.NmfConfig(rank=6))
    with pytest.raises(ValueError, match="orbax") as err:
        TC.load(str(tmp_path / "ck"))
    assert os.path.join(str(tmp_path / "ck"), "factors") in str(err.value)


@pytest.mark.parametrize("knobs", [{}, {"use_pallas": True},
                                   {"algorithm": "hals"}])
def test_resume_equals_uninterrupted(tmp_path, knobs):
    """10 iterations, save, resume to 20 against 20 straight (rtol
    1e-6), and against nmftpu's resume of the same checkpoint (rtol
    1e-4)."""
    V, W0, H0 = _problem(seed=4)
    base = nt.NmfConfig(rank=6, num_iterations=20, check_interval=5,
                        init_method="copy_existing", **knobs)
    full = nt.compute(V, base, W0=W0, H0=H0, device="cpu")
    first = nt.compute(V, dataclasses.replace(base, num_iterations=10),
                       W0=W0, H0=H0, device="cpu")
    TC.save(str(tmp_path / "ck"), first.W, first.H, iteration=10,
            config=base)
    resumed = TC.resume(str(tmp_path / "ck"), V, base, device="cpu")
    assert resumed.num_iterations == 10
    assert _rel(resumed.W, full.W) <= RESUME_RTOL
    assert _rel(resumed.H, full.H) <= RESUME_RTOL
    np.testing.assert_allclose(resumed.frobenius_error,
                               full.frobenius_error, rtol=RESUME_RTOL)
    jres = JC.resume(str(tmp_path / "ck"), V, nmftpu.NmfConfig(
        rank=6, num_iterations=20, check_interval=5,
        init_method="copy_existing", **knobs))
    assert _rel(resumed.W, jres.W) <= RTOL
    np.testing.assert_allclose(resumed.frobenius_error,
                               jres.frobenius_error, rtol=RTOL)


def test_resume_sparse_routes_to_compute_sparse(tmp_path):
    V, W0, H0 = _problem(seed=5)
    V[V < 1.0] = 0.0
    base = nt.NmfConfig(rank=6, num_iterations=8, check_interval=4,
                        init_method="copy_existing")
    full = nt.compute_sparse(from_dense(V), base, W0=W0, H0=H0,
                             device="cpu", strategy="scatter")
    first = nt.compute_sparse(from_dense(V), dataclasses.replace(
        base, num_iterations=4), W0=W0, H0=H0, device="cpu",
        strategy="scatter")
    TC.save(str(tmp_path / "ck"), first.W, first.H, iteration=4,
            config=base)
    resumed = TC.resume(str(tmp_path / "ck"), from_dense(V), base,
                        device="cpu", strategy="scatter")
    assert _rel(resumed.W, full.W) <= RTOL
    jres = JC.resume(str(tmp_path / "ck"), j_from_dense(V),
                     nmftpu.NmfConfig(rank=6, num_iterations=8,
                                      check_interval=4,
                                      init_method="copy_existing"),
                     strategy="scatter")
    np.testing.assert_allclose(resumed.frobenius_error,
                               jres.frobenius_error, rtol=RTOL)


def test_resume_at_budget_returns_factors_unchanged(tmp_path):
    """An exhausted budget runs zero update steps: the stored factors
    come back with their real error and converged=False, as nmftpu's."""
    V, W0, H0 = _problem(seed=6)
    cfg = nt.NmfConfig(rank=6, num_iterations=10)
    TC.save(str(tmp_path / "ck"), W0, H0, iteration=12, config=cfg)
    res = TC.resume(str(tmp_path / "ck"), V, cfg, device="cpu")
    assert res.num_iterations == 0 and not res.converged
    np.testing.assert_array_equal(res.W.numpy(), W0)
    jres = JC.resume(str(tmp_path / "ck"), V,
                     nmftpu.NmfConfig(rank=6, num_iterations=10))
    np.testing.assert_allclose(res.frobenius_error, jres.frobenius_error,
                               rtol=RTOL)


def test_resume_refusals(tmp_path):
    V, W0, H0 = _problem(seed=7)
    TC.save(str(tmp_path / "ck"), W0, H0, iteration=3,
            config=nt.NmfConfig(rank=6, num_iterations=10))
    with pytest.raises(ValueError, match="different NmfConfig"):
        TC.resume(str(tmp_path / "ck"), V,
                  nt.NmfConfig(rank=6, num_iterations=11), device="cpu")
    res = TC.resume(str(tmp_path / "ck"), V,
                    nt.NmfConfig(rank=6, num_iterations=11), strict=False,
                    device="cpu")
    assert res.num_iterations == 8
    # mesh= is ported (test_torch_surfaces_mesh.py); what is not a
    # DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        TC.resume(str(tmp_path / "ck"), V,
                  nt.NmfConfig(rank=6, num_iterations=10), mesh=object())
