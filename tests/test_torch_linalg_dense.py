"""nmftpu_torch.linalg.dense against nmftpu.linalg.dense on the same numpy
inputs: rtol 1e-10 in float64, 1e-5 in float32 (float32 sums of at most
256 terms in two orders differ by far less)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nmftpu.linalg import dense as JD  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402

RTOL = {np.float64: 1e-10, np.float32: 1e-5}
SHAPES = [(40, 56, 4), (130, 96, 16), (256, 200, 12)]


def _inputs(shape, dtype, seed=0):
    n, m, r = shape
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.0, 5.0, (n, m)).astype(dtype)
    W = rng.uniform(0.05, 1.0, (n, r)).astype(dtype)
    H = rng.uniform(0.05, 1.0, (r, m)).astype(dtype)
    return V, W, H


def _close(got, want, dtype):
    np.testing.assert_allclose(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=RTOL[dtype], atol=0,
    )


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("half", ["w", "h"])
def test_half_steps_match(half, shape, dtype):
    V, W, H = _inputs(shape, dtype)
    jf = getattr(JD, f"mu_update_{half}_frobenius")
    tf = getattr(TD, f"mu_update_{half}_frobenius")
    want = jf(jnp.asarray(V), jnp.asarray(W), jnp.asarray(H), 1e-9)
    got = tf(torch.tensor(V), torch.tensor(W), torch.tensor(H), 1e-9)
    assert got.dtype == torch.tensor(V).dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("order", ["WH", "HW"])
def test_full_iteration_matches(order, dtype):
    V, W, H = _inputs((120, 88, 8), dtype, seed=1)
    Wj, Hj = jnp.asarray(W), jnp.asarray(H)
    Wt, Ht = torch.tensor(W), torch.tensor(H)
    for _ in range(3):
        Wj, Hj = JD.mu_update_frobenius(jnp.asarray(V), Wj, Hj, 1e-9, order)
        Wt, Ht = TD.mu_update_frobenius(torch.tensor(V), Wt, Ht, 1e-9, order)
    _close(Wt, Wj, dtype)
    _close(Ht, Hj, dtype)


def test_unported_order_raises():
    V, W, H = (torch.tensor(a) for a in _inputs((8, 9, 2), np.float32))
    with pytest.raises(NotImplementedError):
        TD.mu_update_frobenius(V, W, H, order="jacobi")


@pytest.mark.parametrize("order", ["WH", "HW"])
def test_bf16v_matches(order):
    """bf16 operands, float32 products and sums on both sides: the
    rounding is the same, so float32's 1e-5 holds."""
    V, W, H = _inputs((96, 120, 8), np.float32, seed=2)
    Wj, Hj = JD.mu_update_frobenius_bf16v(
        jnp.asarray(V).astype(jnp.bfloat16), jnp.asarray(W), jnp.asarray(H),
        1e-9, order)
    Wt, Ht = TD.mu_update_frobenius_bf16v(
        torch.tensor(V).to(torch.bfloat16), torch.tensor(W),
        torch.tensor(H), 1e-9, order)
    assert Wt.dtype == torch.float32
    _close(Wt, Wj, np.float32)
    _close(Ht, Hj, np.float32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fn", ["frobenius_error_sq", "frobenius_error",
                                "rmsd"])
@pytest.mark.parametrize("given_svsq", [False, True])
def test_error_metrics_match(fn, dtype, given_svsq):
    V, W, H = _inputs((70, 90, 6), dtype, seed=3)
    # a good fit, so the Gram-trace identity cancels noticeably
    H = np.linalg.lstsq(W, V, rcond=None)[0].clip(0.01).astype(dtype)
    svsq_j = jnp.sum(jnp.asarray(V) ** 2) if given_svsq else None
    svsq_t = torch.sum(torch.tensor(V) ** 2) if given_svsq else None
    want = getattr(JD, fn)(jnp.asarray(V), jnp.asarray(W), jnp.asarray(H),
                           svsq_j)
    got = getattr(TD, fn)(torch.tensor(V), torch.tensor(W), torch.tensor(H),
                          svsq_t)
    assert got.ndim == 0
    # the identity subtracts numbers ~||V||^2, so compare relative to it
    scale = float(np.sum(V.astype(np.float64) ** 2))
    if fn != "frobenius_error_sq":
        scale = np.sqrt(scale)
    np.testing.assert_allclose(float(got), float(want),
                               rtol=0, atol=RTOL[dtype] * scale)


def test_frobenius_error_is_the_plain_norm():
    V, W, H = _inputs((50, 60, 5), np.float64, seed=4)
    got = TD.frobenius_error(torch.tensor(V), torch.tensor(W),
                             torch.tensor(H))
    np.testing.assert_allclose(float(got), np.linalg.norm(V - W @ H),
                               rtol=1e-10)


def test_frobenius_error_sq_clamps_at_zero():
    W = torch.rand(20, 3, dtype=torch.float64) + 0.1
    H = torch.rand(3, 30, dtype=torch.float64) + 0.1
    V = W @ H
    assert float(TD.frobenius_error_sq(V, W, H, torch.sum(V * V) - 1e-6)) \
        == 0.0
