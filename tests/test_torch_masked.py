"""Masked completion (mask="observed") in the port against nmftpu on the
same numpy inputs: the observation mask, the masked Frobenius and KL
updates and metrics on the scatter and ELL engines, an independent
float64 numpy oracle for one step, nmf end to end with its metrics over
the observed set, strategy resolution, and the refusals. The inputs hold
an explicitly stored zero, which counts as unobserved."""

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
from nmftpu.config import NmfConfig as JConfig  # noqa: E402
from nmftpu_torch import sparse as ts  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.convert import config_from_nmftpu  # noqa: E402

# float32, one step or metric: sums of at most a few hundred nonnegative
# terms in another order, ~sqrt(K) 2^-24 ~ 1e-6; KL adds a log and a
# ratio
RTOL_STEP = 1e-5
RTOL_KL = 1e-4
# the error after ten steps: the per-step reordering compounds
RTOL_ERR = 1e-4
RTOL_F64 = 1e-10
N, M, RANK = 60, 45, 5
OBJECTIVES = ["frobenius", "kullback-leibler"]
DTYPES = [np.float32, np.float64]


def _data(seed=0, n=N, m=M, density=0.25, dtype=np.float32):
    """Ratings (1..5) at `density` as COO triplets with one explicitly
    stored zero at (0, 0), an empty row (3) and column (4); nmftpu's
    container and the port's from the same arrays; nonnegative factors."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < density,
                     rng.integers(1, 6, (n, m)), 0).astype(dtype)
    dense[3, :] = 0.0
    dense[:, 4] = 0.0
    dense[0, 0] = 0.0
    rows, cols = np.nonzero(dense)
    rows = np.concatenate([[0], rows]).astype(np.int32)
    cols = np.concatenate([[0], cols]).astype(np.int32)
    vals = np.concatenate([[0.0], dense[rows[1:], cols[1:]]]).astype(dtype)
    jsp = js.SparseCOO(row=rows, col=cols, data=vals, shape=(n, m))
    tsp = ts.SparseCOO(rows, cols, vals, (n, m))
    W = rng.uniform(0.1, 1.0, (n, RANK)).astype(dtype)
    H = rng.uniform(0.1, 1.0, (RANK, m)).astype(dtype)
    return dense, jsp, tsp, W, H


def _rel(a, b):
    a = np.asarray(a.double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _tdt(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def _coos(dtype=np.float32):
    dense, jsp, tsp, W, H = _data(dtype=dtype)
    jc = JS.device_put_sparse(jsp, dtype=jnp.dtype(dtype), chunk=256)
    tc = TS.device_put_sparse(tsp, dtype=_tdt(dtype), chunk=256,
                              device="cpu")
    return dense, jc, tc, W, H


def _pairs(dtype=np.float32):
    dense, jsp, tsp, W, H = _data(dtype=dtype)
    kw = dict(seg_max=8, buckets=(2, 4, 8))
    jp = JE.build_ell_pair(jsp, dtype=jnp.dtype(dtype), **kw)
    tp = TE.build_ell_pair(tsp, dtype=_tdt(dtype), device="cpu", **kw)
    return dense, jp, tp, W, H


def _oracle_step(dense, W, H, objective, order="WH", eps=1e-9):
    """One masked MU step in float64 numpy from the completion objective
    over M = (V != 0): Frobenius W <- W (M V) Hᵀ / ((M WH) Hᵀ + eps); KL
    W <- W (M V / (WH + eps)) Hᵀ / (M Hᵀ + eps)."""
    V, W, H = (np.asarray(x, np.float64) for x in (dense, W, H))
    mask = (V != 0).astype(np.float64)

    def upd_w(W, H):
        if objective == "frobenius":
            return W * (V @ H.T) / ((mask * (W @ H)) @ H.T + eps)
        return W * ((V / (W @ H + eps)) @ H.T) / (mask @ H.T + eps)

    def upd_h(W, H):
        if objective == "frobenius":
            return H * (W.T @ V) / (W.T @ (mask * (W @ H)) + eps)
        return H * (W.T @ (V / (W @ H + eps))) / (W.T @ mask + eps)

    if order == "WH":
        W = upd_w(W, H)
        return W, upd_h(W, H)
    H = upd_h(W, H)
    return upd_w(W, H), H


def _masked_errors(dense, W, H, eps=1e-12):
    V, W, H = (np.asarray(x, np.float64) for x in (dense, W, H))
    obs = V != 0
    WH = W @ H
    fro = np.sqrt(np.sum(np.where(obs, V - WH, 0.0) ** 2))
    whc = np.maximum(WH, eps)
    kl = np.sum(np.where(obs, V * np.log(np.maximum(V, eps) / whc) - V + whc,
                         0.0))
    return fro, kl


# ---------------------------------------------------------------------------
# module 8: the scatter engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_obs_mask_matches_nmftpu(dtype):
    _, jc, tc, _, _ = _coos(dtype)
    got = TS._obs_mask(tc).values
    assert got.dtype == _tdt(dtype)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JS._obs_mask(jc).values))
    # the stored zero and the padding count as unobserved
    assert got[0] == 0 and got.sum() == tc.nnz - 1


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_scatter_update_matches_nmftpu(objective, order, dtype):
    dense, jc, tc, W, H = _coos(dtype)
    jf, tf = ((JS.mu_update_frobenius_masked, TS.mu_update_frobenius_masked)
              if objective == "frobenius" else
              (JS.mu_update_kl_masked, TS.mu_update_kl_masked))
    want = jf(jc, jnp.asarray(W), jnp.asarray(H), order=order)
    got = tf(tc, torch.tensor(W), torch.tensor(H), order=order)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_STEP
    for g, w, o in zip(got, want, _oracle_step(dense, W, H, objective,
                                               order)):
        assert g.dtype == _tdt(dtype)
        assert _rel(g, w) < tol and _rel(g, o) < tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_scatter_metrics_match_nmftpu(dtype):
    dense, jc, tc, W, H = _coos(dtype)
    Wt, Ht = torch.tensor(W), torch.tensor(H)
    fro, kl = _masked_errors(dense, W, H)
    got = TS.frobenius_error_masked(tc, Wt, Ht)
    assert _rel(got, JS.frobenius_error_masked(jc, jnp.asarray(W),
                                               jnp.asarray(H))) < RTOL_STEP
    assert _rel(got, fro) < RTOL_STEP
    got = TS.kl_error_masked(tc, Wt, Ht)
    assert _rel(got, JS.kl_error_masked(jc, jnp.asarray(W),
                                        jnp.asarray(H))) < RTOL_KL
    assert _rel(got, kl) < RTOL_KL


# ---------------------------------------------------------------------------
# module 9: the ELL engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_ell_update_matches_nmftpu(objective, order, dtype):
    dense, jp, tp, W, H = _pairs(dtype)
    jf, tf = ((JE.mu_update_frobenius_masked_ell,
               TE.mu_update_frobenius_masked_ell)
              if objective == "frobenius" else
              (JE.mu_update_kl_masked_ell, TE.mu_update_kl_masked_ell))
    want = jf(jp, jnp.asarray(W), jnp.asarray(H), order=order)
    got = tf(tp, torch.tensor(W), torch.tensor(H), order=order)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_STEP
    for g, w, o in zip(got, want, _oracle_step(dense, W, H, objective,
                                               order)):
        assert g.dtype == _tdt(dtype)
        assert _rel(g, w) < tol and _rel(g, o) < tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_ell_metrics_match_nmftpu(dtype):
    dense, jp, tp, W, H = _pairs(dtype)
    Wt, Ht = torch.tensor(W), torch.tensor(H)
    fro, kl = _masked_errors(dense, W, H)
    got = TE.frobenius_error_masked_ell(tp, Wt, Ht)
    assert _rel(got, JE.frobenius_error_masked_ell(
        jp, jnp.asarray(W), jnp.asarray(H))) < RTOL_STEP
    assert _rel(got, fro) < RTOL_STEP
    got = TE.kl_error_masked_ell(tp, Wt, Ht)
    assert _rel(got, JE.kl_error_masked_ell(
        jp, jnp.asarray(W), jnp.asarray(H))) < RTOL_KL
    assert _rel(got, kl) < RTOL_KL


def test_masked_ell_and_scatter_agree():
    """The two engines run the same masked step (one gather per
    half-step against three scatters)."""
    _, _, tsp, W, H = _data()
    tc = TS.device_put_sparse(tsp, device="cpu")
    tp = TE.build_ell_pair(tsp, device="cpu")
    for tf, ef in ((TS.mu_update_frobenius_masked,
                    TE.mu_update_frobenius_masked_ell),
                   (TS.mu_update_kl_masked, TE.mu_update_kl_masked_ell)):
        a = tf(tc, torch.tensor(W), torch.tensor(H))
        b = ef(tp, torch.tensor(W), torch.tensor(H))
        for x, y in zip(a, b):
            assert _rel(x, y.numpy()) < RTOL_STEP


# ---------------------------------------------------------------------------
# nmf end to end: metrics over the observed set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["ell", "scatter", "auto"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_masked_nmf_matches_nmftpu(strategy, objective):
    """Factors after one step, the errors after ten; the RMSD divides by
    the stored count (the explicit zero included, as nmftpu counts)."""
    dense, jsp, tsp, W, H = _data()
    for iters in (1, 10):
        kw = dict(init="copy", W0=W, H0=H, num_iterations=iters,
                  mask="observed", objective=objective, strategy=strategy)
        want = nmftpu.nmf(jsp, RANK, **kw)
        got = nt.nmf(tsp, RANK, device="cpu", **kw)
        if iters == 1:
            assert _rel(got.W, want.W) < RTOL_STEP
            assert _rel(got.H, want.H) < RTOL_STEP
            continue
        fro, kl = _masked_errors(dense, got.W, got.H)
        assert abs(got.frobenius_error / want.frobenius_error - 1) < RTOL_ERR
        assert abs(got.frobenius_error / fro - 1) < RTOL_STEP
        assert got.rmsd == pytest.approx(got.frobenius_error
                                         / np.sqrt(tsp.nnz), rel=1e-6)
        assert abs(got.rmsd / want.rmsd - 1) < RTOL_ERR
        if objective == "kullback-leibler":
            assert abs(got.kl_error / want.kl_error - 1) < RTOL_ERR
            assert abs(got.kl_error / kl - 1) < RTOL_KL


@pytest.mark.parametrize("strategy", ["ell", "scatter"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_masked_objective_falls(strategy, objective):
    """The completion objective over the observed set, recomputed in
    float64 after each of 8 steps, falls at every step."""
    dense, _, tsp, W, H = _data(seed=3)
    k = 0 if objective == "frobenius" else 1
    objs = [_masked_errors(dense, W, H)[k]]
    Wc, Hc = W, H
    for _ in range(8):
        res = nt.nmf(tsp, RANK, init="copy", W0=Wc, H0=Hc, num_iterations=1,
                     mask="observed", objective=objective, strategy=strategy,
                     device="cpu")
        Wc, Hc = res.W.numpy(), res.H.numpy()
        objs.append(_masked_errors(dense, Wc, Hc)[k])
    assert all(b < a for a, b in zip(objs[:-1], objs[1:])), objs


def test_masked_run_ignores_the_unobserved_entries():
    """Raising an unobserved cell's reconstruction changes nothing in
    the masked metric; the same run unmasked treats it as a zero."""
    _, _, tsp, W, H = _data()
    plan = nt.prepare_sparse(tsp, nt.NmfConfig(rank=RANK, mask="observed"),
                             strategy="ell", device="cpu")
    ops = plan._bundle(plan.config)
    Wt, Ht = torch.tensor(W), torch.tensor(H)
    base = float(ops.frobenius(plan.operand, (), Wt, Ht, None))
    Wt2 = Wt.clone()
    Wt2[3] += 10.0                      # row 3 holds no observation
    assert float(ops.frobenius(plan.operand, (), Wt2, Ht, None)) == base
    assert ops.numel(plan.operand) == tsp.nnz


# ---------------------------------------------------------------------------
# strategy resolution and refusals, as nmftpu's
# ---------------------------------------------------------------------------


def test_resolve_strategy_matches_nmftpu_on_slice8_configs():
    """Masked, weighted and int8 configurations, below and above the
    densify budget, for a host container and a DeviceCOO, auto and each
    explicit engine nmftpu accepts."""
    host = ts.SparseCOO([0], [0], [1.0], (1, 1))
    checked = 0
    for n, m in ((1000, 1000), (100_000, 60_000), (300_000, 60_000)):
        coo = TS.DeviceCOO(values=torch.zeros(256), rows=torch.zeros(256),
                           cols=torch.zeros(256), shape=(n, m), nnz=1,
                           chunk=256)
        jcoo = JS.DeviceCOO(values=None, rows=None, cols=None, shape=(n, m),
                            nnz=1, chunk=256)
        for kw in (dict(mask="observed"),
                   dict(mask="observed", objective="kullback-leibler"),
                   dict(mask="observed", dtype="float64"),
                   dict(alpha_confidence=40.0),
                   dict(alpha_confidence=40.0, v_storage="int8"),
                   dict(alpha_confidence=40.0, v_storage="bfloat16"),
                   dict(v_storage="int8"),
                   dict(v_storage="int8", objective="kullback-leibler")):
            jcfg = JConfig(rank=4, **kw)
            tcfg = config_from_nmftpu(jcfg)
            for strategy in ("auto", "ell", "scatter"):
                for tv, jv in ((host, host), (coo, jcoo)):
                    want = JS._resolve_strategy(jv, jcfg, strategy, n, m)
                    got = TS._resolve_strategy(tv, tcfg, strategy, n, m)
                    assert got == want, (kw, strategy, n, m)
                    checked += 1
    assert checked == 144


def test_masked_densified_is_refused_like_nmftpu():
    _, jsp, tsp, _, _ = _data()
    kw = dict(num_iterations=1, mask="observed", strategy="densified")
    with pytest.raises(ValueError, match="cannot run the densified"):
        nmftpu.nmf(jsp, RANK, **kw)
    with pytest.raises(ValueError, match="cannot run the densified"):
        nt.nmf(tsp, RANK, device="cpu", **kw)


def test_a_densified_plan_refuses_a_masked_run():
    """A plan densified for an unmasked config cannot run a masked one:
    the port raises where nmftpu runs the unmasked update and reports
    its RMSD over the observed count."""
    _, jsp, tsp, W, H = _data()
    jplan = JS.prepare_sparse(jsp, JConfig(rank=RANK), strategy="densified")
    masked = dict(rank=RANK, mask="observed", num_iterations=1)
    ran = jplan.run(JConfig(**masked), W0=W, H0=H)
    assert ran.rmsd == pytest.approx(ran.frobenius_error / np.sqrt(tsp.nnz),
                                     rel=1e-6)
    tplan = TS.prepare_sparse(tsp, nt.NmfConfig(rank=RANK),
                              strategy="densified", device="cpu")
    with pytest.raises(ValueError, match="cannot run on a densified plan"):
        tplan.run(nt.NmfConfig(**masked), W0=W, H0=H)


def test_masked_dense_v_is_refused_like_nmftpu():
    dense, _, _, _, _ = _data()
    with pytest.raises(ValueError, match="sparse container"):
        nmftpu.nmf(dense, RANK, mask="observed")
    with pytest.raises(ValueError, match="sparse container"):
        nt.nmf(dense, RANK, mask="observed", device="cpu")
