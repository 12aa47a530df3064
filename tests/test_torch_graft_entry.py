"""`nmftpu_torch.graft_entry.entry`, the twin of `__graft_entry__.entry`:
the same example arguments bit for bit, and one step (an MU-Frobenius
iteration and the error) against the JAX step on the CPU.

Tolerance: 1e-5 relative on W, H and the error (float32 sums of 256
terms in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import __graft_entry__  # noqa: E402
from nmftpu_torch import graft_entry  # noqa: E402

RTOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_the_arguments_are_the_references_bit_for_bit():
    _, want = __graft_entry__.entry()
    _, got = graft_entry.entry(device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_one_step_matches_the_jax_step():
    jstep, jargs = __graft_entry__.entry()
    step, args = graft_entry.entry(device="cpu")
    Wj, Hj, ej = jstep(*jargs)
    W, H, e = step(*args)
    assert W.shape == (256, 32) and H.shape == (32, 256) and e.ndim == 0
    assert _rel(W, Wj) <= RTOL and _rel(H, Hj) <= RTOL
    assert float(e) == pytest.approx(float(ej), rel=RTOL)
    # the step descends from the arguments' own error
    V, W0, H0 = args
    assert float(e) < float(torch.linalg.norm(V - W0 @ H0))


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
