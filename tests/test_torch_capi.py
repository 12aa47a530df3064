"""The port's C ABI on the CPU (NMFTPU_PLATFORM=cpu): the library built
by nmftpu_torch.capi.build() from its own copy of the source, with
native/test_capi.c compiled unchanged against its header and driving
it from pure C (the checks of tests/test_capi.py), and the Python half
(nmftpu_torch.capi_bridge.compute_from_buffers) against nmftpu's on the
same buffers: the same C-side results, W/H within 1e-4 of max|W|,
max|H| from a given warm start (float32 after 20 iterations; clamped
solves leave entries near zero, where an element-wise ratio means
nothing)."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmftpu import capi_bridge as JB  # noqa: E402
from nmftpu_torch import capi  # noqa: E402
from nmftpu_torch import capi_bridge as TB  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")


@pytest.fixture(autouse=True)
def _compilers():
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("the C ABI needs g++ and gcc")


def test_c_host_drives_the_port(tmp_path):
    lib = capi.build()
    assert lib.exists() and lib.parent.name == "capi"
    assert capi.build() == lib          # up to date: no rebuild
    exe = str(tmp_path / "test_capi")
    subprocess.run(
        ["gcc", os.path.join(NATIVE, "test_capi.c"), "-I",
         str(capi.HERE), "-L", str(lib.parent), "-lnmftpu_torch", "-lm",
         "-o", exe], check=True, capture_output=True)
    env = capi.embed_env()
    env["NMFTPU_PLATFORM"] = "cpu"
    r = subprocess.run([exe, REPO], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, (
        f"rc={r.returncode}\nstdout={r.stdout}\nstderr={r.stderr[-2000:]}")
    assert "C ABI OK" in r.stdout
    m = re.search(r"callback records=(\d+).*iters=(\d+)", r.stdout)
    assert m and int(m.group(1)) >= 3 and int(m.group(2)) < 400, r.stdout
    assert "version: 0.1.0, devices: 1" in r.stdout


def _ptr(a):
    return 0 if a is None else a.ctypes.data


def _call(bridge, V=None, csr=None, W0=None, H0=None, cb=0, **kw):
    n, m = (V.shape if V is not None else csr[3])
    r = kw.pop("rank")
    out_w = np.zeros((n, r), np.float32)
    out_h = np.zeros((r, m), np.float32)
    args = dict(algorithm="mu", objective="frobenius",
                init_method="copy_existing", seed=0, num_iterations=20,
                num_runs=1, check_interval=5, threshold_type="frobenius",
                threshold_value=0.0, lambda_w=0.0, lambda_h=0.0,
                alpha_w=0.0, alpha_h=0.0, lambda_tik=0.0, theta=0.0,
                alpha_confidence=0.0, beta=0.0)
    args.update(kw)
    indptr, indices, values = (csr[:3] if csr is not None
                               else (None, None, None))
    stats = bridge.compute_from_buffers(
        n, m, r, args["algorithm"], args["objective"], args["init_method"],
        args["seed"], args["num_iterations"], args["num_runs"],
        args["check_interval"], args["threshold_type"],
        args["threshold_value"], args["lambda_w"], args["lambda_h"],
        args["alpha_w"], args["alpha_h"], args["lambda_tik"],
        args["theta"], args["alpha_confidence"], args["beta"],
        _ptr(V), _ptr(indptr), _ptr(indices), _ptr(values),
        0 if values is None else len(values), _ptr(W0), _ptr(H0),
        _ptr(out_w), _ptr(out_h), cb, 0)
    return stats, out_w, out_h


@pytest.mark.parametrize("kw", [
    dict(), dict(algorithm="hals"), dict(objective="beta-divergence",
                                         beta=1.5),
    dict(algorithm="acls", lambda_w=0.1, lambda_h=0.1),
])
def test_bridge_matches_nmftpu(monkeypatch, kw):
    monkeypatch.setenv("NMFTPU_PLATFORM", "cpu")
    rng = np.random.default_rng(3)
    V = np.ascontiguousarray(rng.uniform(0.1, 2.0, (40, 30)),
                             dtype=np.float32)
    W0 = rng.uniform(0.1, 1.0, (40, 4)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (4, 30)).astype(np.float32)
    assert TB.initialize() == 0
    sj, Wj, Hj = _call(JB, V=V, W0=W0, H0=H0, rank=4, **kw)
    st, Wt, Ht = _call(TB, V=V, W0=W0, H0=H0, rank=4, **kw)
    assert st[2:] == sj[2:]                       # iterations, converged
    np.testing.assert_allclose(st[:2], sj[:2], rtol=1e-4)
    for got, want in ((Wt, Wj), (Ht, Hj)):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert TB.version() == "0.1.0" and TB.device_count() == 1
    assert TB.choose_device(-1) == 0 and TB.choose_device(0) == 0


def test_bridge_csr_and_cancelling_callback(monkeypatch):
    """CSR buffers route to the sparse engines; the C stats callback
    sees each check and a nonzero return cancels the run."""
    monkeypatch.setenv("NMFTPU_PLATFORM", "cpu")
    import scipy.sparse as sp

    rng = np.random.default_rng(4)
    V = rng.uniform(0.1, 2.0, (40, 30)).astype(np.float32)
    V[V < 1.0] = 0.0
    c = sp.csr_matrix(V)
    csr = (c.indptr.astype(np.int64), c.indices.astype(np.int32),
           c.data.astype(np.float32), V.shape)
    seen = []
    cb_type = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                               ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_double, ctypes.c_double,
                               ctypes.c_double)

    @cb_type
    def cb(user, run, it, err, delta, ms):
        seen.append(it)
        return 1 if it >= 10 else 0

    fp = ctypes.cast(cb, ctypes.c_void_p).value
    TB.initialize()
    stats, W, H = _call(TB, csr=csr, rank=3, init_method="all_random_values",
                        num_iterations=400, check_interval=5, cb=fp)
    assert seen == [5, 10] and stats[2] == 10
    assert np.isfinite(W).all() and (W >= 0).all()
