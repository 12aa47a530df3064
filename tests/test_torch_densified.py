"""The port's densified (bf16 V) engine against nmftpu on the same numpy
inputs: densify, the row-panel KL numerators, the KL update and
divergence, the Gram-trick Frobenius error, and the bf16 contraction
that the densified Frobenius update runs on. Panels of fewer rows than
V, not dividing it, make the tail panel run."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nmftpu import densified as JD  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ops as JS  # noqa: E402
from nmftpu.linalg import dense as JLD  # noqa: E402
from nmftpu_torch import densified as TD  # noqa: E402
from nmftpu_torch import sparse as ts  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.convert import sparse_from_nmftpu  # noqa: E402
from nmftpu_torch.linalg import dense as TLD  # noqa: E402

# Both packages round V and the factors to bf16 the same way (round to
# nearest even) and every product of two bf16 values is exact in float32:
# only the float32 summation order differs, ~sqrt(K) * 2^-24 ~ 1e-6
RTOL_STEP = 1e-5
# KL: a log and a ratio on top of those sums
RTOL_KL = 1e-4
RANK = 6
# 257 rows: 100-row panels leave a 57-row tail; 4096 is one short panel
BLOCKS = [4096, 100]


def _data(seed=0, n=257, m=311):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < 0.06,
                     rng.uniform(0.5, 5.0, (n, m)), 0.0).astype(np.float32)
    dense[5, :] = 0.0
    jsp = js.from_dense(dense)
    W = rng.uniform(0.1, 1.0, (n, RANK)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (RANK, m)).astype(np.float32)
    return dense, jsp, W, H


def _dense_pair(row_multiple=1):
    dense, jsp, W, H = _data()
    jV = JD.densify(JS.device_put_sparse(jsp), row_multiple=row_multiple)
    tV = TD.densify(TS.device_put_sparse(sparse_from_nmftpu(jsp),
                                         device="cpu"),
                    row_multiple=row_multiple)
    return dense, jV, tV, W, H


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("row_multiple", [1, 64, 4096])
def test_densify_matches_nmftpu(row_multiple):
    dense, jV, tV, _, _ = _dense_pair(row_multiple)
    n_pad = -(-dense.shape[0] // row_multiple) * row_multiple
    assert tuple(tV.shape) == tuple(jV.shape) == (n_pad, dense.shape[1])
    assert tV.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tV), _np(jV))
    np.testing.assert_array_equal(
        _np(tV)[:dense.shape[0]],
        torch.tensor(dense).to(torch.bfloat16).float().numpy())
    assert not _np(tV)[dense.shape[0]:].any()


def test_densify_sums_duplicates_like_nmftpu():
    rows, cols = [0, 0, 2, 1, 2], [1, 1, 0, 3, 0]
    vals = np.array([1.25, 2.5, 0.3, 4.0, 0.7], np.float32)
    jV = JD.densify(JS.device_put_sparse(
        js.SparseCOO(np.array(rows), np.array(cols), vals, (3, 4))))
    tV = TD.densify(TS.device_put_sparse(
        ts.SparseCOO(rows, cols, vals, (3, 4)), device="cpu"))
    np.testing.assert_array_equal(_np(tV), _np(jV))
    assert _np(tV)[0, 1] == 3.75


@pytest.mark.parametrize("block_rows", BLOCKS)
def test_kl_numerators_match_nmftpu(block_rows):
    _, jV, tV, W, H = _dense_pair()
    got = TD._kl_numer_w_blocked(tV, torch.tensor(W), torch.tensor(H), 1e-9,
                                 block_rows)
    want = JD._kl_numer_w_blocked(jV, jnp.asarray(W), jnp.asarray(H), 1e-9,
                                  block_rows)
    assert got.shape == (W.shape[0], RANK) and got.dtype == torch.float32
    assert _rel(got, want) < RTOL_STEP
    got = TD._kl_numer_h_blocked(tV, torch.tensor(W), torch.tensor(H), 1e-9,
                                 block_rows)
    want = JD._kl_numer_h_blocked(jV, jnp.asarray(W), jnp.asarray(H), 1e-9,
                                  block_rows)
    assert got.shape == H.shape
    assert _rel(got, want) < RTOL_STEP


@pytest.mark.parametrize("block_rows", BLOCKS)
@pytest.mark.parametrize("order", ["WH", "HW"])
def test_kl_update_matches_nmftpu(block_rows, order):
    _, jV, tV, W, H = _dense_pair()
    tW, tH = TD.mu_update_kl_densified(tV, torch.tensor(W), torch.tensor(H),
                                       order=order, block_rows=block_rows)
    jW, jH = JD.mu_update_kl_densified(jV, jnp.asarray(W), jnp.asarray(H),
                                       order=order, block_rows=block_rows)
    assert _rel(tW, jW) < RTOL_STEP and _rel(tH, jH) < RTOL_STEP


def test_kl_update_jacobi_raises():
    _, _, tV, W, H = _dense_pair()
    with pytest.raises(NotImplementedError, match="jacobi"):
        TD.mu_update_kl_densified(tV, torch.tensor(W), torch.tensor(H),
                                  order="jacobi")


@pytest.mark.parametrize("block_rows", BLOCKS)
def test_kl_error_matches_nmftpu(block_rows):
    dense, jV, tV, W, H = _dense_pair()
    got = float(TD.kl_error_densified(tV, torch.tensor(W), torch.tensor(H),
                                      block_rows=block_rows))
    want = float(JD.kl_error_densified(jV, jnp.asarray(W), jnp.asarray(H),
                                       block_rows=block_rows))
    np.testing.assert_allclose(got, want, rtol=RTOL_KL)


@pytest.mark.parametrize("block_rows", BLOCKS)
def test_frobenius_error_and_sum_v_sq_match_nmftpu(block_rows):
    dense, jV, tV, W, H = _dense_pair()
    svsq_t = TD.sum_v_sq_densified(tV, block_rows=block_rows)
    svsq_j = JD.sum_v_sq_densified(jV, block_rows=block_rows)
    np.testing.assert_allclose(float(svsq_t), float(svsq_j), rtol=RTOL_STEP)
    got = TD.frobenius_error_densified(tV, torch.tensor(W), torch.tensor(H),
                                       svsq_t, block_rows=block_rows)
    want = JD.frobenius_error_densified(jV, jnp.asarray(W), jnp.asarray(H),
                                        svsq_j)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL_STEP)


@pytest.mark.parametrize("order", ["WH", "HW"])
def test_frobenius_bf16v_update_matches_nmftpu(order):
    """The densified Frobenius route (linalg.dense.mu_update_frobenius_bf16v,
    as nmftpu's sparse_ops routes it), over the row-padded V."""
    _, jV, tV, W, H = _dense_pair(row_multiple=64)
    Wp = np.pad(W, ((0, tV.shape[0] - W.shape[0]), (0, 0)))
    tW, tH = TLD.mu_update_frobenius_bf16v(tV, torch.tensor(Wp),
                                           torch.tensor(H), order=order)
    jW, jH = JLD.mu_update_frobenius_bf16v(jV, jnp.asarray(Wp),
                                           jnp.asarray(H), order=order)
    assert _rel(tW, jW) < RTOL_STEP and _rel(tH, jH) < RTOL_STEP
    assert not tW[W.shape[0]:].any()     # pad rows stay zero


@pytest.mark.parametrize("block_rows", [4096, 100, 7])
def test_bf16_dot_panels_match_one_contraction(block_rows):
    """Row panels of the larger operand (rows of a, or the contraction
    rows of b) change only the float32 summation order."""
    _, _, tV, W, H = _dense_pair()
    Wt, Hb = torch.tensor(W), torch.tensor(H).T.contiguous()
    whole = (tV.float() @ Hb.to(torch.bfloat16).float(),
             Wt.T.to(torch.bfloat16).float() @ tV.float())
    got = (TLD._bf16_dot(tV, Hb, block_rows),
           TLD._bf16_dot(Wt.T, tV, block_rows))
    for g, w in zip(got, whole):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) < RTOL_STEP
