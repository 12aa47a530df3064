"""Slice 6a on the card: the port's grid engine and sharded serving in
ranks of its launcher, the kernels on each rank's shard. A world-1 NCCL
mesh and two ranks sharing the card (gloo, 1 x 2) run sharded HALS (#7,
two launches an iteration), the reservoir shard scan (#8) and the
sharded certificate (#9), each against the same sharded call on CPU
tensors (the kernels' plain twins). Every test here is marked `cuda` and
skips without a CUDA device; the file imports no jax, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_slice14_cuda.py

Tolerances: HALS after one iteration, the card against the CPU, 1e-4 of
max|W| (float32 sums in another order, the sweep on #7); #7 against its
twin on a rank's operands 3e-5 of max|W| (chip_smoke.py's HALS_ATOL);
scores 1e-5 and ids equal but at near-ties (phase 7's rule);
certificates equal but in at most two tie rows (the count kernel counts
against the exact chain, the twin's blocked product may round a tie
either way)."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402

from nmftpu_torch.parallel import launch  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    from nmftpu_torch.kernels import _build

    _build.build()  # once here: the ranks load the built library


def _problem(seed=3, n=300, m=240, r=32):
    rng = np.random.default_rng(seed)
    dense = rng.uniform(0.2, 2.0, (n, m))
    dense = (dense * (rng.uniform(size=(n, m)) < 0.2)).astype(np.float32)
    return {"dense": dense,
            "W0": rng.uniform(0.1, 1.0, (n, r)).astype(np.float32),
            "H0": rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)}


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_hals_launches_7_on_every_rank(world, backend):
    outs = launch(R.card_hals, world, args=(_problem(), 1), backend=backend,
                  timeout=300)
    for out in outs:
        assert out["backend"] == backend
        assert out["imported"] == {"jax": False, "nmftpu": False}
        assert out["launches"] == 2
        assert _rel(out["card"]["W"], out["cpu"]["W"]) <= 1e-4
        assert _rel(out["card"]["H"], out["cpu"]["H"]) <= 1e-4
        diff, scale = out["twin"]
        assert diff <= 3e-5 * scale


def test_reservoir_and_certificate_on_each_shard():
    rng = np.random.default_rng(5)
    b, r, m, k = 64, 32, 1 << 16, 20
    mag = np.logspace(0, -2, r).astype(np.float32)[:, None]
    seen = np.full((b, 8), -1, np.int64)
    for row in range(b):
        seen[row] = rng.choice(m, 8, replace=False)
    data = {"Wq": rng.uniform(0, 1, (b, r)).astype(np.float32),
            "H": (rng.uniform(0, 1, (r, m)) * mag).astype(np.float32),
            "seen": seen, "k": k}
    outs = launch(R.card_serving, 2, args=(data, 1024), backend="gloo",
                  timeout=300)
    for out in outs:
        card, cpu = out["cuda"], out["cpu"]
        assert min(card["launches"]) >= 1 and cpu["launches"] == (0, 0)
        np.testing.assert_allclose(card["s"], cpu["s"], rtol=1e-5)
        for row in range(b):
            for p in np.flatnonzero(card["i"][row] != cpu["i"][row]):
                close = np.abs(cpu["s"][row] - cpu["s"][row, p]) <= \
                    1e-5 * abs(cpu["s"][row, p])
                assert close.sum() > 1 or p == k - 1, (row, p)
            assert not set(card["i"][row]) & set(seen[row])
        assert (card["cert"] != cpu["cert"]).sum() <= 2
        assert card["cert"].mean() > 0.5
