"""The `train_ials_cg` kind's pieces on tiny inputs: its reference
(`reference/train_ials_cg.py`) against iALS by Jacobi-preconditioned CG
written out in float64 on the dense matrix, row by row; its work count;
and the readers of its spans and of #11's CG launches on synthetic
records."""

import numpy as np
import pytest
import torch
from conftest import ROOT

from benchmark import harness, yardstick
from benchmark.kinds.train_ials_cg import ials_cg_work
from benchmark.reference import train_ials_cg as RC

ALPHA, LAM_W, LAM_H, EPS = 40.0, 0.1, 0.3, 1e-9


def _problem(seed=0, n=11, m=9, r=4, density=0.35):
    """Clicks of value 1 and 2 (an empty row and column among them) and a
    warm start."""
    rng = np.random.default_rng(seed)
    V = np.where(rng.random((n, m)) < density,
                 rng.integers(1, 3, (n, m)), 0).astype(np.float64)
    V[2, :] = 0.0
    V[:, 5] = 0.0
    return V, rng.random((n, r)) + 0.1, rng.random((r, m)) + 0.1


def _dense_cg(V, T, X, lam, steps):
    """Each row u: A = TᵀC_uT with C_u = 1 + alpha v_u, plus the ridge of
    the program's float32 model; b = Tᵀ(c_u ⊙ v_u); `steps` Jacobi
    preconditioned CG steps from X[u], then clamped."""
    r = T.shape[1]
    out = np.zeros_like(X)
    for u in range(V.shape[0]):
        c = 1.0 + ALPHA * V[u]
        A = (T * c[:, None]).T @ T
        A += (lam + EPS + 100 * 2.0**-23 * np.trace(A) / r) * np.eye(r)
        b = T.T @ (c * V[u])
        d = 1.0 / np.diag(A)
        x = X[u].copy()
        res = b - A @ x
        z = d * res
        p, rz = z, res @ z
        for _ in range(steps):
            Ap = A @ p
            a = rz / (p @ Ap) if p @ Ap > 0 else 0.0
            x, res = x + a * p, res - a * Ap
            z = d * res
            rz2 = res @ z
            p = z + (rz2 / rz if rz > 0 else 0.0) * p
            rz = rz2
        out[u] = np.maximum(x, 0.0)
    return out


@pytest.mark.parametrize("steps", [1, 3])
def test_reference_matches_dense_cg(steps):
    V, W0, H0 = _problem()
    i, j = np.nonzero(V)
    W, H, err = RC.fit(torch.as_tensor(i), torch.as_tensor(j),
                       torch.as_tensor(V[i, j], dtype=torch.float32),
                       *V.shape, torch.as_tensor(W0), torch.as_tensor(H0),
                       ALPHA, LAM_W, LAM_H, 4, EPS, steps, chunk=7)
    Wn, Hn = W0.copy(), H0.copy()
    for _ in range(4):
        Wn = _dense_cg(V, Hn.T, Wn, LAM_W, steps)
        Hn = _dense_cg(V.T, Wn, Hn.T, LAM_H, steps).T
    np.testing.assert_allclose(W.numpy(), Wn, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(H.numpy(), Hn, rtol=1e-10, atol=1e-12)
    assert err == pytest.approx(np.sqrt(((V - Wn @ Hn) ** 2).sum()),
                                rel=1e-10)


def test_reference_blocks_change_nothing(monkeypatch):
    """Blocks of one or two rows (lanes taken a few at a time) give the
    same fit as one block."""
    import benchmark.reference.train_ials as RI

    V, W0, H0 = _problem(seed=1)
    i, j = np.nonzero(V)
    args = (torch.as_tensor(i), torch.as_tensor(j),
            torch.as_tensor(V[i, j], dtype=torch.float32), *V.shape,
            torch.as_tensor(W0), torch.as_tensor(H0), ALPHA, LAM_W, LAM_H,
            3, EPS, 3)
    whole = RC.fit(*args)
    monkeypatch.setattr(RI, "BLOCK_BYTES", 4 * 8 * 3)
    parts = RC.fit(*args)
    for a, b in zip(whole[:2], parts[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_the_tf32_control_moves_the_fit():
    V, W0, H0 = _problem(seed=2, n=40, m=30, r=8)
    i, j = np.nonzero(V)
    args = (torch.as_tensor(i), torch.as_tensor(j),
            torch.as_tensor(V[i, j], dtype=torch.float32), *V.shape,
            torch.as_tensor(W0, dtype=torch.float32),
            torch.as_tensor(H0, dtype=torch.float32), ALPHA, LAM_W, LAM_H,
            3, EPS, 3)
    W, _, _ = RC.fit(*args)
    Wc, _, _ = RC.fit(*args, precision="tf32")
    assert Wc.dtype == torch.float32
    assert 1e-6 < float((Wc.double() - W).abs().max() / W.abs().max()) < 0.5


def test_work_count_at_msd():
    """One iteration at MSD clicks and r = 256, 3 steps: 0.28 TFLOP in
    the 8 sparse products, 0.32 in the 8 products by G, 0.08 in the base
    Grams, 0.07 in the right-hand sides and diagonals."""
    n, m, nnz, r = 571_355, 41_140, 33_633_450, 256
    flops, nbytes = ials_cg_work(n, m, r, nnz, 3)
    sparse = 8 * 4.0 * nnz * r
    by_g = 4 * 2.0 * (n + m) * r * r
    grams = 2.0 * (n + m) * r * r
    rhs = 2 * 4.0 * nnz * r
    assert flops == pytest.approx(sparse + by_g + grams + rhs)
    assert (sparse, by_g, grams, rhs) == (
        pytest.approx(0.2755e12, rel=1e-3), pytest.approx(0.3211e12,
                                                          rel=1e-3),
        pytest.approx(0.0803e12, rel=1e-3), pytest.approx(0.0689e12,
                                                          rel=1e-3))
    assert nbytes == pytest.approx(2 * 6 * 8.0 * nnz
                                   + 2 * 6 * (n + m) * r * 4.0)


def _reader(metric):
    return harness.load_module(ROOT / "benchmark" / "metrics"
                               / f"{metric}.py")


def test_span_readers_per_update():
    spans = {"nmftpu.loop.update": {"count": 4, "device_s": 0.0},
             "nmftpu.ials.cg": {"count": 8, "device_s": 0.4},
             "nmftpu.ials.rhs": {"count": 8, "device_s": 0.02}}
    rec = {"slice": {"trace": {"spans": spans}}}
    assert _reader("cg_ms.ials").read(rec) == pytest.approx(100.0)
    assert _reader("rhs_ms.ials").read(rec) == pytest.approx(5.0)
    del spans["nmftpu.ials.cg"], spans["nmftpu.ials.rhs"]
    assert _reader("cg_ms.ials").read(rec) is None
    assert _reader("rhs_ms.ials").read(rec) is None


def test_ell_cg_roofline_on_a_synthetic_record():
    """The CG launches, half W half-steps and half H half-steps, each at
    #11's bound (4·nnz·r over the float32 peak at MSD's shape), over the
    class `ell_kl`'s device time; none without CG launches."""
    n, m, r, nnz = 571_355, 41_140, 256, 33_633_450
    least = sum(yardstick.bound_s(*yardstick.ell_kl_work(o, t, r, nnz),
                                  yardstick.F32_PEAK)[0]
                for o, t in ((n, m), (m, n))) / 2
    assert least == pytest.approx(4.0 * nnz * r / 67e12)
    rec = {"n": n, "m": m, "r": r, "nnz": nnz,
           "slice": {"launches": {"ell_cg": 16, "ell_kl": 0},
                     "trace": {"classes": {"ell_kl": {"seconds": 16 * 8e-3,
                                                      "events": 16}}}}}
    got = _reader("ell_cg_roofline").read(rec)
    assert got == pytest.approx(100 * least / 8e-3)
    rec["slice"]["launches"] = {"ell_kl": 16}
    assert _reader("ell_cg_roofline").read(rec) is None


def test_the_check_adds_a_first_iteration_fit(tiny_root):
    """The window keeps its fits and adds one fit of the first iteration,
    off its clock; the comparison reads both against the reference's 15
    and 1 iterations, and the cell's limits name all six numbers."""
    from conftest import SEED

    cell = harness.find_cell(tiny_root, "msd-clicks.train-ials-cg")
    kind = cell.kind
    state = kind.setup(harness.Ctx(cell, SEED, torch.device("cpu")))
    rec = kind.window(state, 0.0, None)
    kind.release(state)
    assert rec["first"].num_iterations == 1
    assert all(f.num_iterations == cell.traffic["iterations"]
               for f in rec["fits"])
    got = kind.compare(state, kind.answers(state, rec), cell.reference)
    assert set(got) == set(cell.limits) == {
        f"{k}{s}" for k in ("w_gap", "h_gap", "err_gap")
        for s in ("", "_first")}
    W1, H1, _ = kind.reference_fit(state, cell.reference, iterations=1)
    assert torch.equal(state["reference_first"][0], W1)
    assert got["w_gap_first"] == pytest.approx(float(
        (rec["first"].W.double() - W1).abs().max() / W1.abs().max()))
