"""The references against float64 NumPy written out loop by loop on tiny
inputs: KL and Frobenius MU over COO, the fit's error, and exact top-k
with seen exclusion on a float32 table and on the int8 table quantized
again; and the controls' roundings."""

import numpy as np
import pytest
import torch

from benchmark.reference import serve_closed as RS
from benchmark.reference import train_fits as RT

EPS = 1e-9


def _problem(seed=0, n=9, m=7, r=3, density=0.4):
    rng = np.random.default_rng(seed)
    V = np.where(rng.random((n, m)) < density,
                 rng.integers(1, 11, (n, m)) * 0.5, 0.0)
    W0 = rng.random((n, r)) + 0.1
    H0 = rng.random((r, m)) + 0.1
    return V, W0, H0


def _numpy_mu(V, W, H, objective, iters):
    W, H = W.copy(), H.copy()
    nz = V != 0
    for _ in range(iters):
        if objective == "kl":
            R = np.where(nz, V / (W @ H + EPS), 0.0)
            W = W * (R @ H.T) / np.maximum(H.sum(axis=1), EPS)[None, :]
            R = np.where(nz, V / (W @ H + EPS), 0.0)
            H = H * (W.T @ R) / np.maximum(W.sum(axis=0), EPS)[:, None]
        else:
            W = W * (V @ H.T) / (W @ (H @ H.T) + EPS)
            H = H * (W.T @ V) / ((W.T @ W) @ H + EPS)
    WH = W @ H
    if objective == "kl":
        err = sum(V[i, j] * np.log(V[i, j] / WH[i, j]) for i, j in
                  zip(*np.nonzero(V))) - V.sum() + WH.sum()
    else:
        err = np.sqrt(((V - WH) ** 2).sum())
    return W, H, err


def _coo(V):
    i, j = np.nonzero(V)
    return (torch.as_tensor(i), torch.as_tensor(j),
            torch.as_tensor(V[i, j], dtype=torch.float32))


@pytest.mark.parametrize("objective", ["kl", "frobenius"])
def test_mu_over_coo_matches_numpy(objective):
    V, W0, H0 = _problem()
    rows, cols, vals = _coo(V)
    W, H, err = RT.fit(rows, cols, vals, *V.shape,
                       torch.as_tensor(W0, dtype=torch.float32),
                       torch.as_tensor(H0, dtype=torch.float32),
                       objective, 7, EPS, chunk=5)
    Wn, Hn, en = _numpy_mu(V, W0.astype(np.float32).astype(np.float64),
                           H0.astype(np.float32).astype(np.float64),
                           objective, 7)
    np.testing.assert_allclose(W.numpy(), Wn, rtol=1e-12)
    np.testing.assert_allclose(H.numpy(), Hn, rtol=1e-12)
    assert err == pytest.approx(en, rel=1e-10)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 3.0e-3,
                      -7.25], dtype=torch.float32)
    y = RT.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-10
    assert y[2] == 1.0 + 2**-10                 # above the half: up
    m, _ = np.frexp(y.numpy())
    assert np.all((m * 2**11) == np.round(m * 2**11))
    assert (y - x).abs().max() <= x.abs().max() * 2**-11


def test_control_precision_moves_the_fit():
    V, W0, H0 = _problem(seed=3)
    rows, cols, vals = _coo(V)
    args = (rows, cols, vals, *V.shape,
            torch.as_tensor(W0, dtype=torch.float32),
            torch.as_tensor(H0, dtype=torch.float32), "kl", 5, EPS)
    W, _, _ = RT.fit(*args)
    Wc, _, _ = RT.fit(*args, precision="tf32")
    gap = float((Wc.double() - W).abs().max() / W.abs().max())
    assert 1e-6 < gap < 1e-2


def _numpy_topk(scores, seen, k):
    out_s, out_i = [], []
    for row, s in enumerate(scores):
        s = s.copy()
        s[list(seen[row])] = -np.inf
        order = sorted(range(len(s)), key=lambda j: -s[j])[:k]
        out_i.append(order)
        out_s.append(s[order])
    return np.array(out_s), np.array(out_i)


def _tables(seed=1, b=5, r=6, m=50):
    rng = np.random.default_rng(seed)
    W = rng.random((b, r)).astype(np.float32)
    H = (rng.random((r, m)) * np.logspace(0, -2, r)[:, None]) \
        .astype(np.float32)
    seen = [rng.choice(m, size=rng.integers(0, 8), replace=False)
            for _ in range(b)]
    return W, H, seen


def _seen_t(seen):
    return [torch.as_tensor(np.asarray(s, np.int64)) for s in seen]


def test_topk_float32_table_matches_numpy():
    W, H, seen = _tables()
    table = RS.Table(torch.as_tensor(H), "float32")
    s, i = RS.topk(table, torch.as_tensor(W), _seen_t(seen), 10, block=7,
                   rows=2)
    sn, inn = _numpy_topk(W.astype(np.float64) @ H.astype(np.float64),
                          seen, 10)
    np.testing.assert_array_equal(i.numpy(), inn)
    np.testing.assert_allclose(s.numpy(), sn, rtol=1e-12)
    got = RS.score_ids(table, torch.as_tensor(W), i)
    np.testing.assert_allclose(got.numpy(), sn, rtol=1e-12)


def test_topk_int8_table_requantized_matches_numpy():
    W, H, seen = _tables(seed=2)
    scale = np.maximum(np.abs(H).max(axis=1) / np.float32(127.0),
                       np.float32(1e-30)).astype(np.float32)
    Hq = np.clip(np.round(H / scale[:, None]), -127, 127)
    Hq_t, scale_t = RS.int8_table(torch.as_tensor(H), chunk=16)
    np.testing.assert_array_equal(Hq_t.numpy(), Hq.astype(np.int8))
    np.testing.assert_allclose(scale_t.numpy(), scale, rtol=2**-23)
    q = torch.as_tensor(W * scale_t.numpy()).to(torch.bfloat16).double()
    sn, inn = _numpy_topk(q.numpy() @ Hq, seen, 10)
    table = RS.Table(torch.as_tensor(H), "int8")
    s, i = RS.topk(table, torch.as_tensor(W), _seen_t(seen), 10, block=9)
    np.testing.assert_array_equal(i.numpy(), inn)
    np.testing.assert_allclose(s.numpy(), sn, rtol=1e-12)


def test_fp8_control_rounds_the_queries():
    W, H, _ = _tables(seed=4)
    ref = RS.Table(torch.as_tensor(H), "int8")
    ctl = RS.Table(torch.as_tensor(H), "int8", precision="fp8")
    q, qc = ref.queries(torch.as_tensor(W)), ctl.queries(torch.as_tensor(W))
    rel = float(((qc - q).abs() / q.abs().amax(dim=1, keepdim=True)).max())
    assert 2**-9 < rel <= 2**-4
