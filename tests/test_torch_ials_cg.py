"""The port's matrix-free iALS cg on ELL against nmftpu, which builds every
row's Gram and runs the same Jacobi-preconditioned CG on it: one
half-step of each side from the same warm start for several step
counts, whole fits through `nmf` in both update orders, and the engine
check at the Million Song Dataset's shape (Liang et al.'s 571,355 users
x 41,140 songs) and r = 256, where the per-row Grams would need 149.5
GiB: `prepare_sparse` takes cg on `ell` and still refuses the exact
solver, and cg on `scatter`, with nmftpu's message.

Tolerances, as tests/test_torch_ials.py holds two float32 CG runs: a
half-step's error against the same steps of CG in float64 (on the rows'
own systems, built from the dense matrix) at most twice nmftpu's, or
within 10 kappa u (u = 2^-24, kappa the largest condition number of the
rows' systems): finite-precision CG leaves its exact-arithmetic iterates
by more than kappa u as the steps add up, in both packages; a fit's
error after each iteration at RTOL_ERR = 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ell as JE  # noqa: E402
from nmftpu import sparse_ops as JS  # noqa: E402
from nmftpu_torch import sparse as S  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch.config import NmfConfig  # noqa: E402
from nmftpu_torch.convert import sparse_from_nmftpu  # noqa: E402

RTOL_ERR = 1e-4
U32 = 2.0 ** -24
RANK, ALPHA, LAM = 8, 5.0, 0.05
MSD = (571_355, 41_140)


def _matrix(seed, n=200, m=150, density=0.1):
    """Ratings 1..5, an empty row (5) and column (7), two long rows."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < density,
                     rng.integers(1, 6, (n, m)), 0).astype(np.float32)
    for row, k in ((3, 2 * m // 5), (3 * n // 4, 3 * m // 5)):
        dense[row, rng.choice(m, k, replace=False)] = rng.integers(1, 6, k)
    dense[5, :] = 0.0
    dense[:, 7] = 0.0
    jsp = js.from_dense(dense)
    return dense, jsp, sparse_from_nmftpu(jsp)


def _factors(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (n, RANK)).astype(np.float32),
            rng.uniform(0.1, 1.0, (RANK, m)).astype(np.float32))


def _cg64(dense, P, x0, lam, steps):
    """`steps` warm-started Jacobi-preconditioned CG steps on the rows'
    ridged iALS systems against the partner P (r, m) in float64, clamped,
    and the systems' largest condition number."""
    V, P = dense.astype(np.float64), P.astype(np.float64)
    A = np.einsum("rm,um,sm->urs", P, ALPHA * V, P) + (P @ P.T)[None]
    rhs = (V * (1.0 + ALPHA * V)) @ P.T
    diag = np.trace(A, axis1=1, axis2=2)[:, None, None] / RANK
    A += (lam + 1e-9 + 100 * np.finfo(np.float32).eps * diag) * np.eye(RANK)
    dinv = 1.0 / np.diagonal(A, axis1=1, axis2=2)
    x = x0.astype(np.float64)
    res = rhs - np.einsum("nij,nj->ni", A, x)
    z = dinv * res
    p, rz = z, np.sum(res * z, axis=1, keepdims=True)
    for _ in range(steps):
        Ap = np.einsum("nij,nj->ni", A, p)
        denom = np.sum(p * Ap, axis=1, keepdims=True)
        a = np.where(denom > 0, rz / np.where(denom > 0, denom, 1), 0)
        x, res = x + a * p, res - a * Ap
        z = dinv * res
        rz2 = np.sum(res * z, axis=1, keepdims=True)
        p = z + np.where(rz > 0, rz2 / np.where(rz > 0, rz, 1), 0) * p
        rz = rz2
    return np.maximum(x, 0.0), float(np.linalg.cond(A).max())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("steps", [1, 3, 6])
@pytest.mark.parametrize("order", ["WH", "HW"])
def test_one_half_step_matches_nmftpu(order, steps):
    """The first half of an iteration in each order (W from (W0, H0), or
    H from (W0, H0)), cg from the factors themselves."""
    dense, jsp, tsp = _matrix(seed=31)
    W, H = _factors(*dense.shape, seed=32)
    kw = dict(lambda_w=LAM, lambda_h=2 * LAM, solver="cg", cg_steps=steps,
              order=order)
    got = TE.als_update_weighted_ell_exact(
        TE.build_ell_pair(tsp, device="cpu"), torch.tensor(W),
        torch.tensor(H), ALPHA, **kw)
    want = JE.als_update_weighted_ell_exact(
        JE.build_ell_pair(jsp), jnp.asarray(W), jnp.asarray(H), ALPHA, **kw)
    if order == "WH":
        got, want = got[0], want[0]
        exact, kappa = _cg64(dense, H, W, LAM, steps)
    else:
        got, want = got[1].T, np.asarray(want[1]).T
        exact, kappa = _cg64(dense.T, W.T, H.T, 2 * LAM, steps)
    err, ref_err = _rel(got, exact), _rel(want, exact)
    assert err <= max(2 * ref_err, 10 * kappa * U32), (err, ref_err, kappa)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("order", ["WH", "HW"])
def test_nmf_matches_nmftpu(order, steps):
    dense, jsp, tsp = _matrix(seed=33)
    W0, H0 = _factors(*dense.shape, seed=34)
    kw = dict(algorithm="als", alpha_confidence=ALPHA, als_solver="cg",
              cg_steps=steps, update_order=order, lambda_w=LAM,
              lambda_h=LAM, init="copy", W0=W0, H0=H0, num_iterations=5,
              check_interval=1, strategy="ell")
    jr = nmftpu.nmf(jsp, RANK, **kw)
    tr = nt.nmf(tsp, RANK, device="cpu", **kw)
    np.testing.assert_allclose(tr.stats.errors, np.asarray(jr.stats.errors),
                               rtol=RTOL_ERR)
    assert (tr.W >= 0).all() and (tr.H >= 0).all()


def _msd_csr():
    """MSD's shape with a few thousand clicks: the engine check reads the
    shape and the rank, not the clicks."""
    rng = np.random.default_rng(35)
    rows = rng.choice(MSD[0], 3000, replace=False)
    cols = rng.integers(0, MSD[1], 3000)
    return S.SparseCOO(row=rows, col=cols,
                       data=np.ones(3000, np.float32), shape=MSD).to_csr()


def _msd_config(solver):
    return NmfConfig(rank=256, algorithm="als", alpha_confidence=40.0,
                     lambda_w=0.1, lambda_h=0.1, als_solver=solver)


def test_msd_shape_runs_cg_on_ell_and_refuses_the_grams(monkeypatch):
    """(571,355 + 41,140) x 256^2 x 4 bytes = 149.5 GiB of Grams: cg on
    `ell` (and `auto`, which picks it) is accepted, since it builds none;
    the exact solver, and cg on `scatter`, are refused with nmftpu's
    message, at prepare time and when a cg plan is asked to run them."""
    monkeypatch.delenv("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", raising=False)
    csr = _msd_csr()
    with pytest.raises(ValueError) as want:
        JS._check_weighted_gram_budget(*MSD, 256)
    assert "149.5 GiB" in str(want.value)
    plan = nt.prepare_sparse(csr, _msd_config("cg"), strategy="ell",
                             device="cpu")
    assert plan.strategy == "ell"
    assert nt.prepare_sparse(csr, _msd_config("cg"),
                             device="cpu").strategy == "ell"
    for solver, strategy in (("exact", "ell"), ("exact", "auto"),
                             ("cg", "scatter")):
        with pytest.raises(ValueError) as got:
            nt.prepare_sparse(csr, _msd_config(solver), strategy=strategy,
                              device="cpu")
        assert str(got.value) == str(want.value), (solver, strategy)
    with pytest.raises(ValueError) as got:
        plan.run(_msd_config("exact"))
    assert str(got.value) == str(want.value)
