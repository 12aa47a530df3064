"""Slice 6b on the card: the ring engine, dense V on a mesh and the
fold-in on a sharded Recommender in ranks of the port's launcher, the
kernels on each rank's operands. A world-1 NCCL mesh and two ranks
sharing the card (gloo) run the ring against the same ring on CPU
tensors; two gloo ranks run dense V on 2 x 1 and 1 x 2 meshes with the
fused kernels (#1-#4 where a half is local, #5 where its sum spans the
ranks, #6's dual entry under int8 Jacobi) against the unsharded run on
the card; two gloo ranks fold cold users into an int8 table sharded 1 x
2 (#6's Gram, #7, #8 on every rank) against the unsharded Recommender.
Every test here is marked `cuda` and skips without a CUDA device; the
file imports no jax, so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_slice15_cuda.py

Tolerances: the ring on the card against the CPU after 2 iterations,
1e-4 of max|x| (float32 sums in another order); dense V on the mesh
against the unsharded run after one iteration, 1e-4 (int8 Jacobi: the
int32 sums are exact, 1e-5); the sharded int8 Gram equal to the
unsharded one, the fold-ins 1e-4 of max|x| (the history rows are summed
by `index_add_`, whose atomics add in another order on every call), the
top-10 ids 0.99 the same."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_ranks as M  # noqa: E402

from nmftpu_torch.parallel import launch  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    from nmftpu_torch.kernels import _build

    _build.build()  # once here: the ranks load the built library


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _sparse(seed=3, n=300, m=240, r=16):
    rng = np.random.default_rng(seed)
    dense = rng.uniform(0.2, 2.0, (n, m))
    dense = (dense * (rng.uniform(size=(n, m)) < 0.2)).astype(np.float32)
    return {"dense": dense,
            "W0": rng.uniform(0.1, 1.0, (n, r)).astype(np.float32),
            "H0": rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)}


RING_KINDS = [("mu-frobenius", {}),
              ("mu-kl", {"objective": "kullback-leibler"}),
              ("als", {"algorithm": "als"}),
              ("weighted", {"alpha_confidence": 4.0})]


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_ring_on_the_card_matches_the_cpu(world, backend):
    outs = launch(M.card_ring, world, args=(_sparse(), RING_KINDS),
                  backend=backend, timeout=300)
    for out in outs:
        assert out["backend"] == backend
        assert out["imported"] == {"jax": False, "nmftpu": False}
        for kind, _ in RING_KINDS:
            got = out[kind]
            assert _rel(got["cuda"]["W"], got["cpu"]["W"]) <= 1e-4, kind
            assert _rel(got["cuda"]["H"], got["cpu"]["H"]) <= 1e-4, kind


DENSE_RUNS = [((2, 1), "f32", {"use_pallas": True}),
              ((1, 2), "f32", {"use_pallas": True}),
              ((2, 1), "int8", {"v_storage": "int8", "use_pallas": True}),
              ((1, 2), "int8", {"v_storage": "int8", "use_pallas": True}),
              ((2, 1), "int8-jacobi", {"v_storage": "int8",
                                       "use_pallas": True,
                                       "mu_style": "jacobi"})]
# the kernel of the local half, and #5 on the half whose sum spans
WHOLE = {((2, 1), "f32"): "w_update_fused", ((1, 2), "f32"): "h_update_fused",
         ((2, 1), "int8"): "w_update_fused_q",
         ((1, 2), "int8"): "h_update_fused_q",
         ((2, 1), "int8-jacobi"): "dual_numerators_int8"}


def test_dense_mesh_runs_the_kernels_and_matches_unsharded():
    rng = np.random.default_rng(7)
    n, m, r = 515, 389, 32
    data = {"V": rng.uniform(0.0, 2.0, (n, m)).astype(np.float32),
            "W0": rng.uniform(0.1, 1.0, (n, r)).astype(np.float32),
            "H0": rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)}
    outs = launch(M.card_dense, 2, args=(data, DENSE_RUNS), backend="gloo",
                  timeout=300)
    for out in outs:
        assert out["imported"] == {"jax": False, "nmftpu": False}
        for shape, name, _ in DENSE_RUNS:
            got = out[shape, name]
            assert got["launches"][WHOLE[shape, name]] >= 1, (shape, name)
            if name != "int8-jacobi":
                assert got["launches"]["fused_multiply_divide"] == 1
            tol = 1e-5 if name == "int8-jacobi" else 1e-4
            assert _rel(got["mesh"]["W"], got["one"]["W"]) <= tol
            assert _rel(got["mesh"]["H"], got["one"]["H"]) <= tol


def test_sharded_fold_in_on_the_card():
    rng = np.random.default_rng(9)
    r, m = 64, 1 << 16
    mag = np.logspace(0, -2, r).astype(np.float32)[:, None]
    data = {"W": rng.uniform(0.0, 1.0, (100, r)).astype(np.float32),
            "H": (rng.uniform(0.0, 1.0, (r, m)) * mag).astype(np.float32),
            "histories": [rng.choice(m, 30, replace=False)
                          for _ in range(64)]}
    outs = launch(M.card_foldin, 2, args=(data,), backend="gloo",
                  timeout=300)
    for out in outs:
        assert out["imported"] == {"jax": False, "nmftpu": False}
        g, one = out["mesh"], out["one"]
        assert min(g["launches"]) >= 1
        np.testing.assert_array_equal(g["G"], one["G"])
        assert _rel(g["als"], one["als"]) <= 1e-4
        assert _rel(g["hals"], one["hals"]) <= 1e-4
        # two reservoir scans (per shard and merged, or whole) of
        # embeddings 1e-6 apart: the same items but for a near-tie or a
        # reservoir miss
        hits = [len(set(a.tolist()) & set(b.tolist())) / len(a)
                for a, b in zip(g["top"][1], one["top"][1])]
        assert np.mean(hits) >= 0.99
