"""The port's scikit-learn facade (nmftpu_torch.sklearn_api) against
nmftpu.sklearn_api on the same numpy inputs, on the CPU, and its
estimator protocol without and with scikit-learn.

The packages draw different random streams, so the engine-side random
init is compared from explicit W/H (init="custom"); the numpy-side
inits (MiniBatchNMF's init="random") and the host NNDSVD (NMF's
default init=None -> nndsvda) are compared over the whole path.
Tolerances: float32 after 20 iterations rtol 1e-4 (HALS: 1e-4 after
20, its clamps see the same inputs to float32 roundoff), float64 1e-10;
reconstruction_err_ 1e-4."""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmftpu import sklearn_api as J  # noqa: E402
from nmftpu_torch import sklearn_api as T  # noqa: E402
from nmftpu_torch.convert import estimator_from_nmftpu  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, F64 = 1e-4, 1e-10


def _problem(seed=0, n=64, m=48, r=6, dtype=np.float32):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 2.0, (n, m)).astype(dtype)
    W0 = rng.uniform(0.1, 1.0, (n, r)).astype(dtype)
    H0 = rng.uniform(0.1, 1.0, (r, m)).astype(dtype)
    return V, W0, H0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


FITS = {
    "cd": dict(solver="cd"),
    "cd_reg": dict(solver="cd", alpha_W=0.01, alpha_H=0.02, l1_ratio=0.5),
    "mu": dict(solver="mu"),
    "mu_kl": dict(solver="mu", beta_loss="kullback-leibler"),
    "mu_beta": dict(solver="mu", beta_loss=1.5),
    "mu_is": dict(solver="mu", beta_loss="itakura-saito"),
    "als": dict(algorithm="als"),
    "acls": dict(algorithm="acls", lambda_w=0.1, lambda_h=0.1),
    "weighted": dict(solver="mu", alpha_confidence=2.0),
    "ials": dict(algorithm="als", alpha_confidence=2.0, lambda_w=0.1,
                 lambda_h=0.1),
}


@pytest.mark.parametrize("case", list(FITS))
def test_nmf_fit_transform_matches_nmftpu(case):
    """W, components_, n_iter_ and reconstruction_err_ from the same
    custom start, then transform of new rows (the fold-in the model's
    solver implies) and inverse_transform."""
    V, W0, H0 = _problem()
    kw = dict(n_components=6, init="custom", max_iter=20, tol=0.0,
              **FITS[case])
    j, t = J.NMF(**kw), T.NMF(device="cpu", **kw)
    Wj, Wt = j.fit_transform(V, W=W0, H=H0), t.fit_transform(V, W=W0, H=H0)
    assert isinstance(Wt, np.ndarray) and Wt.shape == (64, 6)
    assert _rel(Wt, Wj) <= RTOL
    assert _rel(t.components_, j.components_) <= RTOL
    assert (t.n_iter_, t.n_components_, t.n_features_in_) == (
        j.n_iter_, j.n_components_, j.n_features_in_)
    np.testing.assert_allclose(t.reconstruction_err_, j.reconstruction_err_,
                               rtol=RTOL)
    Vn = _problem(seed=1, n=12)[0]
    assert _rel(t.transform(Vn), j.transform(Vn)) <= RTOL
    assert t.inverse_transform(Wt).shape == V.shape
    np.testing.assert_allclose(t.inverse_transform(Xt=Wt),
                               Wt @ t.components_)


def test_nmf_default_init_whole_path():
    """init=None -> nndsvda (the host SVD, the same in both packages),
    solver 'cd': the whole path without a given start, on dense and on
    scipy-sparse input (HALS on scatter), float64 1e-10 on dense."""
    sp = pytest.importorskip("scipy.sparse")
    V, _, _ = _problem(seed=2, dtype=np.float64)
    kw = dict(n_components=5, max_iter=15, tol=0.0, dtype="float64")
    Wj = J.NMF(**kw).fit_transform(V)
    Wt = T.NMF(device="cpu", **kw).fit_transform(V)
    assert _rel(Wt, Wj) <= F64
    Vs = V.copy()
    Vs[Vs < 1.0] = 0.0
    kw32 = dict(n_components=5, max_iter=10, tol=0.0)
    j, t = J.NMF(**kw32), T.NMF(device="cpu", **kw32)
    Wj = j.fit_transform(sp.csr_matrix(Vs.astype(np.float32)))
    Wt = t.fit_transform(sp.csr_matrix(Vs.astype(np.float32)))
    assert _rel(Wt, Wj) <= RTOL
    np.testing.assert_allclose(t.reconstruction_err_, j.reconstruction_err_,
                               rtol=RTOL)


def test_nmf_port_sparse_container_and_tensor_inputs():
    from nmftpu_torch.sparse import from_dense

    V, W0, H0 = _problem(seed=3)
    kw = dict(n_components=6, init="custom", max_iter=5, tol=0.0,
              solver="mu", device="cpu")
    a = T.NMF(**kw).fit_transform(V, W=W0, H=H0)
    b = T.NMF(**kw).fit_transform(torch.tensor(V), W=W0, H=H0)
    c = T.NMF(strategy="scatter", **kw).fit_transform(from_dense(V), W=W0,
                                                      H=H0)
    np.testing.assert_allclose(b, a, rtol=1e-6)
    assert _rel(c, a) <= RTOL


@pytest.mark.parametrize("solver,beta", [("mu", "frobenius"),
                                         ("mu", "kullback-leibler"),
                                         ("mu", 0.5), ("cd", "frobenius")])
def test_non_negative_factorization_matches_nmftpu(solver, beta):
    V, W0, H0 = _problem(seed=4)
    kw = dict(n_components=6, solver=solver, beta_loss=beta, max_iter=20)
    Wj, Hj, nj = J.non_negative_factorization(V, H=H0, update_H=False, **kw)
    Wt, Ht, nt_ = T.non_negative_factorization(V, H=H0, update_H=False,
                                               device="cpu", **kw)
    assert _rel(Wt, Wj) <= RTOL and nt_ == nj == 20
    np.testing.assert_array_equal(Ht, H0)
    Wj, Hj, _ = J.non_negative_factorization(V, W0, H0, init="custom",
                                             tol=0.0, **kw)
    Wt, Ht, _ = T.non_negative_factorization(V, W0, H0, init="custom",
                                             tol=0.0, device="cpu", **kw)
    assert _rel(Wt, Wj) <= RTOL and _rel(Ht, Hj) <= RTOL


def test_non_negative_factorization_guards_match_nmftpu():
    V, W0, H0 = _problem(seed=5)
    for kw, match in ((dict(update_H=False), "requires H"),
                      (dict(update_H=False, H=H0, n_components=3),
                       "n_components"),
                      (dict(update_H=False, H=H0, solver="cd",
                            beta_loss="kullback-leibler"), "frobenius")):
        with pytest.raises(ValueError, match=match) as jerr:
            J.non_negative_factorization(V, **kw)
        with pytest.raises(ValueError, match=match) as terr:
            T.non_negative_factorization(V, device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.warns(RuntimeWarning, match="not used"):
        T.non_negative_factorization(V, W=W0, H=H0, update_H=False,
                                     max_iter=1, device="cpu")


def test_estimator_errors_match_nmftpu():
    V, _, _ = _problem(seed=6)
    cases = [
        (dict(n_components=3, solver="pg"), NotImplementedError, "solver"),
        (dict(n_components=3, solver="mu", beta_loss="not-a-loss"),
         ValueError, "beta_loss"),
        (dict(n_components=3, solver="mu", alpha_W=0.1),
         NotImplementedError, "acls"),
        (dict(n_components=3, init="custom"), ValueError, "custom"),
        (dict(n_components=3, solver="cd", beta_loss="kullback-leibler"),
         ValueError, "frobenius"),
        (dict(n_components=3, shuffle=True), NotImplementedError,
         "shuffle"),
        (dict(n_components=3, random_state=np.random.default_rng(0)),
         ValueError, "random_state"),
    ]
    for kw, err, match in cases:
        with pytest.raises(err, match=match) as jerr:
            J.NMF(**kw).fit(V)
        with pytest.raises(err, match=match) as terr:
            T.NMF(device="cpu", **kw).fit(V)
        assert str(terr.value).replace("nmftpu_torch", "nmftpu") == \
            str(jerr.value)
    Vz = V.copy()
    Vz[0, 0] = 0.0
    with pytest.raises(ValueError, match="beta_loss <= 0"):
        T.NMF(3, solver="mu", beta_loss=0.0, device="cpu").fit(Vz)
    with pytest.raises(AttributeError, match="not fitted"):
        T.NMF(n_components=3, device="cpu").transform(V)
    # mesh= is ported (test_torch_surfaces_mesh.py); what is not a
    # DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        T.NMF(n_components=3, mesh=object(), device="cpu").fit(V)
    with pytest.warns(RuntimeWarning, match="ignored"):
        T.NMF(3, max_iter=1, device="cpu").fit(V, W=np.ones((64, 3)))


def test_params_repr_clone_and_pipeline():
    """get_params / set_params from the __init__ signature, __repr__,
    sklearn.base.clone and a Pipeline, with the port's own base."""
    from sklearn.base import clone
    from sklearn.pipeline import Pipeline

    est = T.NMF(n_components=3, max_iter=10, tol=0.0, random_state=5,
                device="cpu")
    params = est.get_params()
    assert set(params) == set(J.NMF().get_params()) | {"device"}
    assert params["n_components"] == 3 and params["max_iter"] == 10
    assert repr(est) == ("NMF(device='cpu', max_iter=10, n_components=3, "
                         "random_state=5, tol=0.0)")
    est2 = clone(est).set_params(max_iter=20)
    assert est2 is not est and est.max_iter == 10
    V, _, _ = _problem(seed=7)
    W = est2.fit_transform(V)
    assert est2.n_iter_ == 20 and W.shape == (64, 3)
    with pytest.raises(ValueError, match="Invalid parameter"):
        est.set_params(bogus=1)
    mb = clone(T.MiniBatchNMF(n_components=3, batch_size=8, device="cpu"))
    assert mb.get_params()["batch_size"] == 8
    pipe = Pipeline([("nmf", T.NMF(n_components=4, max_iter=10,
                                   device="cpu"))])
    Wp = pipe.fit_transform(V)
    assert Wp.shape == (64, 4)
    pipe.set_params(nmf__max_iter=5)
    assert pipe.named_steps["nmf"].max_iter == 5
    assert pipe.transform(V[:3]).shape == (3, 4)


@pytest.mark.parametrize("beta", ["frobenius", "kullback-leibler", 0.5])
def test_minibatch_nmf_matches_nmftpu(beta):
    """MiniBatchNMF with init='random' (numpy's stream, the same in
    both) over the whole path, float64 1e-10; transform; the facade over
    scipy-sparse input."""
    sp = pytest.importorskip("scipy.sparse")
    V, _, _ = _problem(seed=8, dtype=np.float64)
    kw = dict(n_components=5, init="random", batch_size=16, beta_loss=beta,
              tol=0.0, max_no_improvement=None, max_iter=3, random_state=3,
              dtype="float64")
    j, t = J.MiniBatchNMF(**kw), T.MiniBatchNMF(device="cpu", **kw)
    Wj, Wt = j.fit_transform(V), t.fit_transform(V)
    assert _rel(Wt, Wj) <= F64
    assert _rel(t.components_, j.components_) <= F64
    assert (t.n_iter_, t.n_steps_) == (j.n_iter_, j.n_steps_)
    np.testing.assert_allclose(t.reconstruction_err_, j.reconstruction_err_,
                               rtol=F64)
    assert _rel(t.transform(V[:7]), j.transform(V[:7])) <= 1e-8
    Vs = V.copy()
    Vs[Vs < 1.0] = 0.0
    if beta != 0.5:
        Wj = J.MiniBatchNMF(**kw).fit_transform(sp.csr_matrix(Vs))
        Wt = T.MiniBatchNMF(device="cpu", **kw).fit_transform(
            sp.csr_matrix(Vs))
        assert _rel(Wt, Wj) <= F64


def test_minibatch_nmf_default_init_and_partial_fit():
    """init=None (nndsvda on the whole X), and a partial_fit stream
    whose first batch seeds H, as nmftpu's (float64)."""
    V, _, _ = _problem(seed=9, dtype=np.float64)
    kw = dict(n_components=4, batch_size=16, tol=0.0,
              max_no_improvement=None, max_iter=2, dtype="float64")
    assert _rel(T.MiniBatchNMF(device="cpu", **kw).fit_transform(V),
                J.MiniBatchNMF(**kw).fit_transform(V)) <= F64
    j, t = J.MiniBatchNMF(**kw), T.MiniBatchNMF(device="cpu", **kw)
    for lo in range(0, 64, 16):
        j.partial_fit(V[lo:lo + 16])
        t.partial_fit(V[lo:lo + 16])
    assert t.n_steps_ == j.n_steps_ == 4
    assert _rel(t.components_, j.components_) <= F64
    # a components_ replaced by the user goes back into the stream
    t.components_ = t.components_ * 1.0
    j.components_ = np.asarray(j.components_) * 1.0
    j.partial_fit(V[:16])
    t.partial_fit(V[:16])
    assert _rel(t.components_, j.components_) <= F64


def test_estimator_from_nmftpu():
    V, W0, H0 = _problem(seed=10)
    j = J.NMF(n_components=6, init="custom", solver="cd", max_iter=10,
              tol=0.0)
    j.fit(V, W=W0, H=H0)
    t = estimator_from_nmftpu(j, device="cpu")
    assert isinstance(t, T.NMF) and t.device == "cpu"
    assert t.get_params(deep=False)["solver"] == "cd"
    np.testing.assert_array_equal(t.components_, j.components_)
    assert t.reconstruction_err_ == j.reconstruction_err_
    Vn = _problem(seed=11, n=9)[0]
    assert _rel(t.transform(Vn), j.transform(Vn)) <= RTOL
    jm = J.MiniBatchNMF(n_components=4, batch_size=16)
    jm.partial_fit(V[:16])
    tm = estimator_from_nmftpu(jm, device="cpu")
    assert tm.n_steps_ == 1 and tm._online.n_steps == 1
    jm.partial_fit(V[16:32])
    tm.partial_fit(V[16:32])
    assert _rel(tm.components_, jm.components_) <= 1e-5
    unfitted = estimator_from_nmftpu(J.NMF(n_components=2), device="cpu")
    assert not hasattr(unfitted, "components_")
    with pytest.raises(TypeError, match="NMF or MiniBatchNMF"):
        estimator_from_nmftpu(object(), device="cpu")


def _run(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env})


def test_facade_imports_and_fits_without_sklearn():
    """With sklearn made unimportable (sys.modules['sklearn'] = None), the
    port's facade imports, fits, transforms and clones its parameters."""
    out = _run(
        "import sys; sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "from nmftpu_torch.sklearn_api import NMF, MiniBatchNMF\n"
        "V = np.random.default_rng(0).uniform(0.1, 1, (30, 20))\n"
        "est = NMF(n_components=3, max_iter=10, device='cpu')\n"
        "W = est.fit_transform(V)\n"
        "assert W.shape == (30, 3) and est.transform(V[:2]).shape == (2, 3)\n"
        "mb = MiniBatchNMF(3, batch_size=8, max_iter=2, device='cpu')\n"
        "assert mb.fit_transform(V).shape == (30, 3)\n"
        "again = type(est)(**est.get_params())\n"
        "assert repr(again) == repr(est)\n"
        "assert 'sklearn' not in {m.split('.')[0] for m in sys.modules\n"
        "                         if sys.modules[m] is not None}\n"
        "print('OK')\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_submodule_reachable_after_package_import():
    """`import nmftpu_torch` alone, then nmftpu_torch.sklearn_api.NMF and
    the lazy re-exports resolve (the package's __getattr__ falls through
    to real submodules)."""
    out = _run(
        "import nmftpu_torch\n"
        "assert nmftpu_torch.sklearn_api.NMF is nmftpu_torch.NMF\n"
        "for name in ('MiniBatchNMF', 'non_negative_factorization',\n"
        "             'compute_batched', 'BatchedNmfResult', 'OnlineNMF',\n"
        "             'minibatch_fit', 'rank_selection'):\n"
        "    getattr(nmftpu_torch, name)\n"
        "assert nmftpu_torch.checkpoint.save\n"
        "try:\n"
        "    nmftpu_torch.no_such_thing\n"
        "except AttributeError:\n"
        "    print('OK')\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "OK"


def test_minibatch_guards_match_nmftpu():
    V, _, _ = _problem(seed=12)
    V[0, 0] = 0.0
    for kw, match in ((dict(n_components=3, beta_loss="itakura-saito"),
                       "beta_loss <= 0"),
                      (dict(n_components=3, init="custom"), "custom")):
        with pytest.raises(ValueError, match=match):
            J.MiniBatchNMF(**kw).fit(V)
        with pytest.raises(ValueError, match=match):
            T.MiniBatchNMF(device="cpu", **kw).fit(V)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.MiniBatchNMF(3, max_iter=1, device="cpu").fit(np.abs(V) + 0.1)
