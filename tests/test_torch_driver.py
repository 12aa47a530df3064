"""The port end to end: nmftpu_torch.nmf against nmftpu.nmf on the ML-100K
fixture with the same W0/H0 (the whole slice: api -> driver -> registry ->
update rules or fused-kernel twins -> loop -> result), plus the loop's
contract, the registry's routes and what still raises."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import driver as tdriver  # noqa: E402
from nmftpu_torch.algorithms import build_dense_update  # noqa: E402
from nmftpu_torch.convert import (  # noqa: E402
    factors_from_numpy,
    result_to_numpy,
)
from nmftpu_torch.init import run_generator  # noqa: E402
from nmftpu_torch.loop import execute  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK = 8


def _fixture_matrix():
    """tests/fixtures/ml100k_u.data (user, item, rating, time) as a dense
    users x items float32 matrix."""
    rows = np.loadtxt(os.path.join(REPO, "tests", "fixtures",
                                   "ml100k_u.data")).astype(np.int64)
    V = np.zeros((rows[:, 0].max(), rows[:, 1].max()), np.float32)
    V[rows[:, 0] - 1, rows[:, 1] - 1] = rows[:, 2]
    return V


V_FIX = _fixture_matrix()
_rng = np.random.default_rng(7)
W0 = _rng.uniform(0.1, 1.0, (V_FIX.shape[0], RANK)).astype(np.float32)
H0 = _rng.uniform(0.1, 1.0, (RANK, V_FIX.shape[1])).astype(np.float32)


def _both(**kw):
    kw = {"init": "copy", "W0": W0, "H0": H0, **kw}
    return nmftpu.nmf(V_FIX, RANK, **kw), nt.nmf(V_FIX, RANK, device="cpu",
                                                  **kw)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _assert_off_knife_edge(deltas, threshold, stop_at, margin=1.15):
    """The run stops at check `stop_at`: every earlier delta sits clearly
    above the threshold and the stopping one clearly below, so float32
    rounding cannot move the stop."""
    assert np.all(deltas[:stop_at] > threshold * margin)
    assert deltas[stop_at] < threshold / margin


# ---------------------------------------------------------------------------
# the whole slice against nmftpu
# ---------------------------------------------------------------------------


def test_slice_matches_nmftpu_fused_kernels():
    """use_pallas=True on both sides: nmftpu's Pallas kernels (interpret
    mode) against the port's fused-kernel twins, two restarts, stopping
    on the threshold. After 90 float32 MU steps the factors agree to
    1e-5 (measured 2.5e-6); errors to 1e-5 relative; deltas, which are
    differences of errors ~33, to 1e-5 * max error absolute."""
    thr = 6e-3
    j, t = _both(use_pallas=True, num_runs=2, num_iterations=200,
                 check_interval=5, threshold=thr)
    tr = result_to_numpy(t)
    stop = len(j.stats.deltas) - 1
    _assert_off_knife_edge(np.asarray(j.stats.deltas), thr, stop)
    assert j.converged and tr["converged"]
    assert tr["num_iterations"] == j.num_iterations == 90
    assert tr["best_run"] == j.best_run == 0
    assert len(tr["run_errors"]) == 2
    np.testing.assert_array_equal(tr["stats"][:, 0], j.stats.iterations)
    np.testing.assert_allclose(tr["stats"][:, 1], j.stats.errors, rtol=1e-5)
    np.testing.assert_allclose(tr["stats"][:, 2], j.stats.deltas, rtol=0,
                               atol=1e-5 * j.stats.errors.max())
    assert _max_rel(tr["W"], j.W) < 1e-5
    assert _max_rel(tr["H"], j.H) < 1e-5
    np.testing.assert_allclose(tr["error"], j.error, rtol=1e-5)
    np.testing.assert_allclose(tr["frobenius_error"], j.frobenius_error,
                               rtol=1e-5)
    np.testing.assert_allclose(tr["rmsd"], j.rmsd, rtol=1e-5)
    assert t.kl_error is None and j.kl_error is None


@pytest.mark.parametrize("order", ["WH", "HW"])
def test_slice_matches_nmftpu_float64(order):
    """The plain path in float64, stopping on an RMSD threshold: the two
    packages agree to roundoff, check for check."""
    thr = 1.2e-3
    j, t = _both(dtype="float64", num_iterations=150, check_interval=7,
                 threshold=thr, threshold_type="rmsd", update_order=order)
    stop = len(j.stats.deltas) - 1
    _assert_off_knife_edge(np.asarray(j.stats.deltas), thr, stop)
    assert t.W.dtype == torch.float64
    assert (t.num_iterations, t.converged) == (j.num_iterations, j.converged)
    np.testing.assert_array_equal(t.stats.iterations, j.stats.iterations)
    np.testing.assert_allclose(t.stats.errors, j.stats.errors, rtol=1e-6)
    np.testing.assert_allclose(t.W.numpy(), np.asarray(j.W), rtol=1e-9)
    np.testing.assert_allclose(t.H.numpy(), np.asarray(j.H), rtol=1e-9)


@pytest.mark.parametrize("v_storage,w_tol,err_tol", [
    # nmftpu's int8 kernel rounds W, H, G to bf16 each step (<= 5.9e-3
    # per step, see test_torch_kernels.py); measured 1.1e-2 after 10
    ("int8", 3e-2, 1e-3),
    # bf16-stored V: the same numerators; float32 differences in W flip
    # bf16 roundings of later steps; measured 1.3e-3 after 10
    ("bfloat16", 1e-2, 1e-4),
])
def test_slice_matches_nmftpu_low_precision_v(v_storage, w_tol, err_tol):
    j, t = _both(use_pallas=True, v_storage=v_storage, num_iterations=10,
                 check_interval=5)
    assert t.num_iterations == j.num_iterations == 10
    np.testing.assert_allclose(t.stats.errors, j.stats.errors, rtol=err_tol)
    assert _max_rel(t.W.numpy(), j.W) < w_tol
    assert _max_rel(t.H.numpy(), j.H) < w_tol


@pytest.mark.parametrize("iters,interval", [(0, 10), (1, 10), (23, 5),
                                            (20, 20)])
def test_check_schedule_matches_nmftpu(iters, interval):
    """Checks every `interval` iterations and at the last one."""
    j, t = _both(num_iterations=iters, check_interval=interval)
    assert t.num_iterations == j.num_iterations == iters
    assert not t.converged and not j.converged
    np.testing.assert_array_equal(t.stats.iterations, j.stats.iterations)
    np.testing.assert_allclose(t.stats.errors, j.stats.errors, rtol=1e-5)
    np.testing.assert_allclose(t.error, j.error, rtol=1e-5)


def test_best_of_n_picks_the_lowest_objective():
    res = nt.nmf(V_FIX, RANK, seed=3, num_runs=3, num_iterations=15,
                 device="cpu")
    assert len(res.run_errors) == 3
    assert res.best_run == int(np.argmin(res.run_errors))
    assert res.error == min(res.run_errors)


def test_execute_keeps_the_first_run_on_a_tie():
    cfg = nt.NmfConfig(rank=2, num_runs=3)
    compares = [2.0, 1.0, 1.0]

    def runner(V, W, H, run_idx):
        c = torch.tensor(compares[run_idx])
        return (W, H, c, c, None, c, 4, False, torch.zeros(2, 3), 1)

    res = execute(torch.zeros(3, 3), cfg, runner,
                  lambda i: (torch.full((3, 2), float(i)), torch.ones(2, 3)),
                  numel=9)
    assert res.best_run == 1 and float(res.W[0, 0]) == 1.0
    assert res.run_errors == compares


# ---------------------------------------------------------------------------
# loop contract: callback, interrupt, verbosity
# ---------------------------------------------------------------------------


def test_callback_once_per_check_with_host_numbers():
    seen = []
    res = nt.nmf(V_FIX, RANK, init="copy", W0=W0, H0=H0, num_iterations=12,
                 check_interval=5, device="cpu",
                 callback=lambda *a: seen.append(a))
    assert [(r, it) for r, it, _, _ in seen] == [(0, 5), (0, 10), (0, 12)]
    assert all(isinstance(e, float) and isinstance(d, float)
               for _, _, e, d in seen)
    np.testing.assert_allclose([e for *_, e, _ in seen], res.stats.errors)


def test_interrupt_stops_at_a_check():
    polls = []

    def interrupt():
        polls.append(1)
        return len(polls) == 2

    res = nt.nmf(V_FIX, RANK, init="copy", W0=W0, H0=H0, num_iterations=50,
                 check_interval=4, device="cpu", interrupt=interrupt)
    assert res.num_iterations == 8 and not res.converged
    assert len(polls) == 2


@pytest.mark.parametrize("verbosity,lines", [(0, 0), (1, 1), (2, 4), (3, 4)])
def test_verbosity_lines(capsys, verbosity, lines):
    nt.nmf(V_FIX, RANK, num_iterations=9, check_interval=3, device="cpu",
           verbosity=verbosity)
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("[nmftpu_torch]")]
    assert len(out) == lines
    if verbosity == 3:
        assert all("elapsed" in ln for ln in out[:3])


# ---------------------------------------------------------------------------
# init, devices, inputs
# ---------------------------------------------------------------------------


def test_random_init_is_seeded_per_run():
    a = nt.nmf(V_FIX, RANK, seed=11, num_iterations=0, device="cpu")
    b = nt.nmf(V_FIX, RANK, seed=11, num_iterations=0, device="cpu")
    c = nt.nmf(V_FIX, RANK, seed=12, num_iterations=0, device="cpu")
    assert torch.equal(a.W, b.W) and not torch.equal(a.W, c.W)
    g0, g1 = run_generator(11, 0, "cpu"), run_generator(11, 1, "cpu")
    assert not torch.equal(torch.rand(4, generator=g0),
                           torch.rand(4, generator=g1))
    # the sklearn 'random' scale: (u + 1e-4) * sqrt(mean(V) / rank)
    scale = np.sqrt(V_FIX.mean() / RANK)
    assert 1e-4 * scale <= float(a.W.min())
    assert float(a.W.max()) <= (1 + 1e-4) * scale * (1 + 1e-6)


def test_mean_columns_init_averages_columns_of_v():
    res = nt.nmf(V_FIX, RANK, init="mean_columns", num_iterations=0,
                 device="cpu")
    assert res.W.shape == (V_FIX.shape[0], RANK)
    assert float(res.W.min()) >= 0.0
    assert float(res.W.max()) <= V_FIX.max()


def test_copy_init_leaves_the_warm_start_untouched():
    W0t, H0t = factors_from_numpy(W0, H0, device="cpu")
    before = W0t.clone()
    nt.nmf(torch.tensor(V_FIX), RANK, init="copy", W0=W0t, H0=H0t,
           num_iterations=5)
    assert torch.equal(W0t, before)


def test_tensor_input_runs_on_its_device():
    res = nt.nmf(torch.tensor(V_FIX), RANK, num_iterations=3)
    assert res.W.device.type == "cpu"


def test_numpy_input_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.nmf(V_FIX, RANK, num_iterations=1)


@pytest.mark.parametrize("bad,error", [
    ({"rank": 100}, ValueError),
    ({"data": np.ones(5, np.float32)}, ValueError),
    # dense V on a mesh is ported (slice 6b, test_torch_dense_mesh.py):
    # these ids now hold the refusal of a mesh that is not a DeviceMesh;
    # the k-means and NNDSVD inits are ported in slice 4b-i
    # (test_torch_init.py), vectorize_runs in slice 5
    # (test_torch_batched.py)
    pytest.param({"mesh": object()}, TypeError,
                 id="bad2-NotImplementedError"),
    pytest.param({"init": "kmeans", "vectorize_runs": True, "num_runs": 2,
                  "mesh": object()},
                 TypeError, id="bad3-NotImplementedError"),
    pytest.param({"init": "copy"}, ValueError, id="bad5-ValueError"),
])
def test_driver_rejects(bad, error):
    kw = {"data": V_FIX, "rank": RANK, "num_iterations": 1, "device": "cpu",
          **bad}
    with pytest.raises(error):
        nt.nmf(kw.pop("data"), kw.pop("rank"), **kw)


def test_sparse_inputs_raise():
    """Sparse types other than the port's containers point to
    sparse.from_scipy."""
    sp = pytest.importorskip("scipy.sparse")
    with pytest.raises(TypeError, match="from_scipy"):
        nt.nmf(sp.csr_matrix(V_FIX), RANK, device="cpu")
    with pytest.raises(TypeError, match="from_scipy"):
        nt.nmf(torch.tensor(V_FIX).to_sparse(), RANK, device="cpu")


# ---------------------------------------------------------------------------
# registry routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs,route", [
    ({}, "mu_update_frobenius"),
    ({"use_pallas": True}, "mu_update_frobenius_fused"),
    ({"use_pallas": True, "v_storage": "int8"}, "mu_update_frobenius_q"),
    ({"v_storage": "bfloat16"}, "mu_update_frobenius_bf16v"),
    ({"v_storage": "bfloat16", "use_pallas": True},
     "mu_update_frobenius_bf16v"),
])
def test_registry_routes(monkeypatch, knobs, route):
    from nmftpu_torch.kernels import dense_mu, quantized
    from nmftpu_torch.linalg import dense

    called = []
    for mod in (dense, dense_mu, quantized):
        if hasattr(mod, route):
            real = getattr(mod, route)
            monkeypatch.setattr(
                mod, route,
                lambda *a, _real=real, **k: called.append(1) or _real(*a, **k))
    make_aux, update, effective_h = build_dense_update(
        nt.NmfConfig(rank=2, **knobs))
    V = torch.rand(6, 5) + 0.1
    aux = make_aux(V)
    W, H = update(V, aux, torch.rand(6, 2) + 0.1, torch.rand(2, 5) + 0.1)
    assert called == [1]
    assert W.shape == (6, 2) and H.shape == (2, 5)
    assert effective_h(aux, H) is H


@pytest.mark.parametrize("knobs,where", [
    # HALS, dense KL, jacobi and int8 without use_pallas are ported (slice
    # 4a), dense int8 KL and confidence weighting (slice 8, held against
    # nmftpu in test_torch_int8_densified.py and test_torch_weighted.py),
    # dense float32 beta MU (slice 9, test_torch_beta.py), bf16 and int8
    # beta MU (slice 10, test_torch_beta_engines.py), the dense ALS
    # family, GDCLS, nsNMF and the k-means and NNDSVD inits (slice 4b-i,
    # test_torch_als_family.py, test_torch_init.py; iALS's refusal is
    # test_torch_als_family.py::test_ials_still_raises) and vectorize_runs
    # (slice 5, test_torch_batched.py) and mesh= (slice 6b,
    # test_torch_dense_mesh.py); these cases keep their ids and now hold
    # the refusal of a mesh that is not a DeviceMesh
    pytest.param({"objective": "beta", "beta": 0.5, "mesh": object()},
                 "DeviceMesh", id="knobs3-slice 4"),
    pytest.param({"algorithm": "gdcls", "v_storage": "int8",
                  "vectorize_runs": True, "num_runs": 2, "mesh": object()},
                 "DeviceMesh", id="knobs4-slice 4"),
    pytest.param({"algorithm": "nsnmf", "mesh": object()}, "DeviceMesh",
                 id="knobs5-slice 3"),
    pytest.param({"vectorize_runs": True, "num_runs": 2, "mesh": object()},
                 "DeviceMesh", id="knobs7-slice 5"),
])
def test_unported_configurations_raise(knobs, where):
    with pytest.raises(TypeError, match=where):
        nt.nmf(V_FIX, RANK, num_iterations=1, device="cpu", **knobs)


def test_dense_ops_use_the_original_v_for_errors():
    cfg = nt.NmfConfig(rank=RANK, v_storage="int8", use_pallas=True)
    ops = tdriver._dense_ops(cfg)
    V = torch.tensor(V_FIX)
    W, H = factors_from_numpy(W0, H0, device="cpu")
    want = float(torch.linalg.norm(V - W @ H))
    got = float(ops.frobenius(V, ops.make_aux(V), W, H, ops.sum_v_sq(V)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the port never imports jax
# ---------------------------------------------------------------------------


def test_import_leaves_jax_out():
    code = (
        "import sys, importlib, pkgutil, nmftpu_torch\n"
        "for m in pkgutil.walk_packages(nmftpu_torch.__path__, "
        "'nmftpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'nmftpu.')) or m == 'nmftpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
