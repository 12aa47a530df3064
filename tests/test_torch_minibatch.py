"""Online / mini-batch NMF in the port (nmftpu_torch.minibatch) against
nmftpu.minibatch on the same numpy inputs, on the CPU.

Tolerances: float64 rtol 1e-10 (the same guarded operations; sums in
another order); float32 one step 1e-5, a fit of several epochs 1e-4;
the port against itself (epoch_fused against the per-batch loop, a saved
and resumed stream against the uninterrupted one) exactly."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmftpu import checkpoint as JC  # noqa: E402
from nmftpu import minibatch as JM  # noqa: E402
from nmftpu_torch import minibatch as TM  # noqa: E402
from nmftpu_torch.convert import online_state_from_nmftpu  # noqa: E402

F64, F32_STEP, F32_FIT = 1e-10, 1e-5, 1e-4
BETAS = [2.0, 1.0, 0.5, 1.5, 0.0, 3.0]


def _problem(seed=0, n=64, m=48, r=6, dtype=np.float64):
    rng = np.random.default_rng(seed)
    V = (rng.uniform(0.05, 1.0, (n, m))).astype(dtype)
    W0 = rng.uniform(0.1, 1.0, (n, r)).astype(dtype)
    H0 = rng.uniform(0.1, 1.0, (r, m)).astype(dtype)
    return V, W0, H0


def _rel(a, b):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64),
                                       (np.float32, F32_STEP)])
@pytest.mark.parametrize("beta", BETAS)
def test_step_functions_match_nmftpu(beta, dtype, tol):
    """w_mu_step, h_online_step and minibatch_step (warm, with its
    cost) from the same inputs."""
    V, W0, H0 = _problem(dtype=dtype)
    Xb, Wb = V[:16], W0[:16]
    gamma = TM.beta_gamma(beta)
    A = H0 * 1.5
    B = np.ones_like(H0) * 2.0
    regs = dict(l1_w=0.01, l2_w=0.02)
    assert _rel(TM.w_mu_step(_t(Xb), _t(Wb), _t(H0), beta, gamma=gamma,
                             **regs),
                JM.w_mu_step(Xb, Wb, H0, beta, gamma=gamma, **regs)) <= tol
    got = TM.h_online_step(_t(Xb), _t(Wb), _t(H0), _t(A), _t(B), 0.7,
                           beta, 0.01, 0.03, gamma)
    want = JM.h_online_step(Xb, Wb, H0, A, B, 0.7, beta, 0.01, 0.03, gamma)
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol
    got = TM.minibatch_step(_t(Xb), _t(Wb), _t(H0), _t(A), _t(B), 0.7,
                            beta=beta, gamma=gamma, with_cost=True, **regs)
    want = JM.minibatch_step(Xb, Wb, H0, A, B, 0.7, beta=beta, gamma=gamma,
                             with_cost=True, **regs)
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("beta", [2.0, 1.0, 0.5])
@pytest.mark.parametrize("tol_", [0.0, 1e-3])
def test_solve_w_matches_nmftpu(beta, tol_):
    """The fresh solve from the flat start, to max_iter (tol 0) or to a
    relative change <= tol; with the global mean given too."""
    V, _, H0 = _problem(seed=1)
    gamma = TM.beta_gamma(beta)
    for mean_v in (None, 0.3):
        got = TM.solve_w(_t(V[:20]), _t(H0), beta, 0.0, 0.01, gamma,
                         max_iter=40, tol=tol_, mean_v=mean_v)
        want = JM.solve_w(V[:20], H0, beta, 0.0, 0.01, gamma, max_iter=40,
                          tol=tol_, mean_v=mean_v)
        assert _rel(got, want) <= F64


@pytest.mark.parametrize("beta", [2.0, 1.0, 1.5])
@pytest.mark.parametrize("n,fresh", [(64, False), (70, False),
                                     (64, True)])
def test_minibatch_fit_matches_nmftpu(n, fresh, beta):
    """The whole fit (host loop, a tail batch, fresh restarts) in float64
    against nmftpu's, and the port's epoch_fused path bit-equal to its
    per-batch loop."""
    V, W0, H0 = _problem(seed=2, n=n)
    kw = dict(batch_size=16, max_iter=3, beta=beta, alpha_w=0.002,
              alpha_h=0.004, l1_ratio=0.3, tol=0.0,
              max_no_improvement=None, fresh_restarts=fresh,
              fresh_restarts_max_iter=10, W0=W0, H0=H0, dtype="float64")
    Wj, Hj, nij, nsj = JM.minibatch_fit(V, 6, fused=False,
                                        **{**kw, "dtype": np.float64})
    Wh, Hh, nih, nsh = TM.minibatch_fit(V, 6, fused=False, device="cpu",
                                        **kw)
    Wf, Hf, nif, nsf = TM.minibatch_fit(V, 6, fused=True, device="cpu",
                                        **kw)
    assert _rel(Wh, Wj) <= F64 and _rel(Hh, Hj) <= F64
    assert (nih, nsh) == (nij, nsj) == (nif, nsf)
    assert torch.equal(Wf, Wh) and torch.equal(Hf, Hh)


def test_minibatch_fit_float32_and_early_stop():
    """float32 (rtol 1e-4 after 4 epochs), and the monitored loop
    (tol and the no-improvement patience) stopping where nmftpu's
    does."""
    V, W0, H0 = _problem(seed=3, dtype=np.float32)
    kw = dict(batch_size=16, max_iter=4, beta=1.0, W0=W0, H0=H0,
              tol=0.0, max_no_improvement=None)
    Wj, Hj, _, _ = JM.minibatch_fit(V, 6, **kw)
    Wt, Ht, _, _ = TM.minibatch_fit(V, 6, device="cpu", **kw)
    assert _rel(Wt, Wj) <= F32_FIT and _rel(Ht, Hj) <= F32_FIT
    V64, W64, H64 = _problem(seed=3)
    kw = dict(batch_size=8, max_iter=50, beta=2.0, W0=W64, H0=H64,
              tol=1e-3, max_no_improvement=3)
    _, Hj, nij, nsj = JM.minibatch_fit(V64, 6, dtype=np.float64, **kw)
    _, Ht, nit, nst = TM.minibatch_fit(V64, 6, dtype="float64",
                                       device="cpu", **kw)
    assert (nit, nst) == (nij, nsj) and nst < 50 * 8
    assert _rel(Ht, Hj) <= F64


def test_minibatch_fit_streams_memmap_and_sparse(tmp_path):
    """A memmap and a scipy CSR (through the facade's _RowSource) never
    fuse: panels stream, fresh restarts solve per panel
    (_solve_w_streamed), and the results match nmftpu's."""
    sp = pytest.importorskip("scipy.sparse")
    from nmftpu.sklearn_api import _RowSource as JRow
    from nmftpu_torch.sklearn_api import _RowSource

    V, W0, H0 = _problem(seed=4)
    V[V < 0.4] = 0.0
    mm = np.lib.format.open_memmap(str(tmp_path / "v.npy"), mode="w+",
                                   dtype=np.float64, shape=V.shape)
    mm[:] = V
    csr = sp.csr_matrix(V)
    assert not TM._can_fuse(mm, False, "float64")
    assert not TM._can_fuse(_RowSource(csr), False, "float64")
    assert TM._can_fuse(V, False, "float64")
    assert TM._can_fuse(torch.tensor(V), False, "float64")
    assert not TM._can_fuse(V, True, "float64")
    kw = dict(batch_size=16, max_iter=2, tol=0.0, max_no_improvement=None,
              fresh_restarts=True, fresh_restarts_max_iter=5, W0=W0, H0=H0)
    Wj, Hj, _, _ = JM.minibatch_fit(JRow(csr), 6, dtype=np.float64, **kw)
    for src in (mm, _RowSource(csr)):
        Wt, Ht, _, _ = TM.minibatch_fit(src, 6, dtype="float64",
                                        device="cpu", **kw)
        assert _rel(Wt, Wj) <= F64 and _rel(Ht, Hj) <= F64


@pytest.mark.parametrize("beta", [2.0, 1.0, 0.5])
def test_divergence_blocked_matches_nmftpu(beta):
    V, W0, H0 = _problem(seed=5)
    got = TM.divergence_blocked(V, W0, H0, beta, batch=10,
                                dtype="float64", device="cpu")
    want = JM.divergence_blocked(V, W0, H0, beta, batch=10,
                                 dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=F64)


def test_online_nmf_stream_matches_nmftpu():
    """partial_fit batch by batch from the first batch's NNDSVDA (the
    host SVD, equal in both packages) and from a given H0, then
    transform (float64)."""
    V, _, H0 = _problem(seed=6)
    for h0 in (None, H0):
        j = JM.OnlineNMF(6, batch_size=16, seed=1, dtype=np.float64,
                         alpha_w=0.001, l1_ratio=0.5)
        t = TM.OnlineNMF(6, batch_size=16, seed=1, dtype="float64",
                         alpha_w=0.001, l1_ratio=0.5, device="cpu")
        for lo in range(0, 64, 16):
            j.partial_fit(V[lo:lo + 16], H0=h0)
            t.partial_fit(V[lo:lo + 16], H0=h0)
        assert t.n_steps == j.n_steps == 4
        assert _rel(t.H, j.H) <= F64
        assert _rel(t.transform(V[:5]), j.transform(V[:5])) <= F64


def test_online_nmf_save_resume(tmp_path):
    """A saved stream resumes exactly (atol 0), in the npz layout
    nmftpu writes without orbax, and either package reads the other's."""
    V, _, _ = _problem(seed=7, dtype=np.float32)
    batches = [V[lo:lo + 16] for lo in range(0, 64, 16)]
    full = TM.OnlineNMF(6, batch_size=16, seed=2, device="cpu")
    for b in batches:
        full.partial_fit(b)
    part = TM.OnlineNMF(6, batch_size=16, seed=2, device="cpu")
    for b in batches[:2]:
        part.partial_fit(b)
    part.save(str(tmp_path / "s"))
    meta = json.loads((tmp_path / "s" / "online_meta.json").read_text())
    assert meta["dtype"] == "float32" and meta["n_steps"] == 2
    resumed = TM.OnlineNMF.load(str(tmp_path / "s"), device="cpu")
    assert resumed.n_steps == 2 and resumed.rho == part.rho
    for b in batches[2:]:
        resumed.partial_fit(b)
    assert torch.equal(resumed.H, full.H)
    assert torch.equal(resumed._A, full._A)

    # nmftpu's load reads the port's directory
    jm = JM.OnlineNMF.load(str(tmp_path / "s"))
    np.testing.assert_array_equal(np.asarray(jm.H), part.H.numpy())
    with pytest.raises(ValueError, match="nothing to save"):
        TM.OnlineNMF(4, device="cpu").save(str(tmp_path / "empty"))


def test_online_nmf_reads_nmftpu_npz_state(tmp_path, monkeypatch):
    monkeypatch.setattr(JC, "_HAS_ORBAX", False)
    V, _, _ = _problem(seed=8, dtype=np.float32)
    j = JM.OnlineNMF(6, batch_size=16, seed=3)
    j.partial_fit(V[:16])
    j.save(str(tmp_path / "j"))
    t = TM.OnlineNMF.load(str(tmp_path / "j"), device="cpu")
    assert t.n_steps == 1 and t.rho == j.rho
    np.testing.assert_array_equal(t.H.numpy(), np.asarray(j.H))
    j.partial_fit(V[16:32])
    t.partial_fit(V[16:32])
    assert _rel(t.H, j.H) <= F32_STEP


def test_online_state_from_nmftpu():
    V, _, _ = _problem(seed=9, dtype=np.float32)
    j = JM.OnlineNMF(6, batch_size=16, seed=4, beta=1.5, alpha_w=0.01,
                     forget_factor=0.5, n_rows_hint=64)
    j.partial_fit(V[:16])
    t = online_state_from_nmftpu(j, device="cpu")
    assert (t.rank, t.beta, t.batch_size, t.rho, t.n_steps, t.seed) == (
        j.rank, j.beta, j.batch_size, j.rho, j.n_steps, j.seed)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t._B.numpy(), np.asarray(j._B))
    j.partial_fit(V[16:32])
    t.partial_fit(V[16:32])
    assert _rel(t.H, j.H) <= F32_STEP
    empty = online_state_from_nmftpu(JM.OnlineNMF(3), device="cpu")
    assert empty.H is None


def test_guards():
    V, W0, H0 = _problem(seed=10)
    with pytest.raises(ValueError, match="explicit W0/H0"):
        TM.minibatch_fit(V, 6, device="cpu")
    with pytest.raises(ValueError, match="early stopping"):
        TM.minibatch_fit(V, 6, W0=W0, H0=H0, fused=True, device="cpu")
    # mesh= is ported (test_torch_minibatch_mesh.py); what is not a
    # DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        TM.minibatch_fit(V, 6, W0=W0, H0=H0, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        TM.OnlineNMF(6, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="not seen any data"):
        TM.OnlineNMF(6, device="cpu").transform(V)
