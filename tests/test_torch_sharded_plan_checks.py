"""`ShardedPlan.run` runs the prepare-time config checks: a ring or ELL
plan prepared for an unmasked config refuses a masked run and a
quantized V storage, as `SparsePlan.run` refuses them on one device; a
scatter plan's masked run is unchanged. nmftpu's `ShardedPlan.run` on a
ring plan runs the masked config unmasked instead (a fault of the
reference, pinned here).

The port runs on a one-rank gloo world in this process
(`make_grid_mesh((1, 1), "cpu")`), nmftpu on one virtual CPU device.
Inputs: 60 x 50 V with 600 nonzeros in 1..5, r = 4, 5 iterations, seed
0. Tolerances: the scatter plan's masked run against compute_sharded's
from the same (W0, H0), 1e-6 relative (the same float32 operations on
the same partition); nmftpu's errors against each other at 1e-6."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402

import nmftpu_torch as nt  # noqa: E402
from nmftpu import NmfConfig as JConfig  # noqa: E402
from nmftpu import Initialization as JInit  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu.parallel import compute_sharded as j_compute_sharded  # noqa: E402
from nmftpu.parallel import make_grid_mesh as j_make_grid_mesh  # noqa: E402
from nmftpu.parallel import prepare_sharded as j_prepare_sharded  # noqa: E402
from nmftpu_torch import sparse as ts  # noqa: E402
from nmftpu_torch.parallel import compute_sharded, make_grid_mesh  # noqa: E402
from nmftpu_torch.parallel import prepare_sharded  # noqa: E402

N, M, NNZ, RANK, ITERS = 60, 50, 600, 4, 5
RTOL = 1e-6


def _problem():
    rng = np.random.default_rng(0)
    flat = np.sort(rng.choice(N * M, NNZ, replace=False))
    rows, cols = (flat // M).astype(np.int32), (flat % M).astype(np.int32)
    vals = rng.integers(1, 6, NNZ).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (N, RANK)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (RANK, M)).astype(np.float32)
    return (js.SparseCOO(row=rows, col=cols, data=vals, shape=(N, M)),
            ts.SparseCOO(rows, cols, vals, (N, M)), W0, H0)


@pytest.fixture(scope="module")
def mesh():
    """A world-1 gloo group in this process, torn down after the file
    (if this file started it)."""
    started = not dist.is_initialized()
    yield make_grid_mesh((1, 1), "cpu")
    if started:
        dist.destroy_process_group()


def _config(**knobs):
    return nt.NmfConfig(rank=RANK, num_iterations=ITERS, check_interval=1,
                        init_method="copy_existing", **knobs)


@pytest.mark.parametrize("engine", ["ring", "ell"])
def test_a_ring_or_ell_plan_refuses_a_masked_or_quantized_run(mesh, engine):
    _, sp, W0, H0 = _problem()
    plan = prepare_sharded(sp, _config(), mesh=mesh, engine=engine, chunk=64)
    assert plan.engine == engine
    with pytest.raises(ValueError, match="mask='observed'"):
        plan.run(_config(mask="observed"), W0=W0, H0=H0)
    with pytest.raises(ValueError, match="v_storage='int8'"):
        plan.run(_config(v_storage="int8"), W0=W0, H0=H0)
    # the plan still runs its own config, as compute_sharded does
    got = plan.run(_config(), W0=W0, H0=H0)
    want = compute_sharded(sp, _config(), mesh=mesh, W0=W0, H0=H0,
                           engine=engine, chunk=64)
    assert got.frobenius_error == pytest.approx(want.frobenius_error,
                                                rel=RTOL)
    assert got.row_perm is not None and want.row_perm is not None


def test_a_scatter_plans_masked_run_is_unchanged(mesh):
    _, sp, W0, H0 = _problem()
    plan = prepare_sharded(sp, _config(), mesh=mesh, engine="scatter",
                           chunk=64)
    got = plan.run(_config(mask="observed"), W0=W0, H0=H0)
    want = compute_sharded(sp, _config(mask="observed"), mesh=mesh, W0=W0,
                           H0=H0, engine="scatter", chunk=64)
    for attr in ("frobenius_error", "rmsd", "error"):
        assert getattr(got, attr) == pytest.approx(getattr(want, attr),
                                                   rel=RTOL), attr
    for a, b in ((got.W, want.W), (got.H, want.H)):
        assert float((a - b).abs().max() / b.abs().max()) <= RTOL
    # the masked metrics: the RMSD over the stored entries
    assert got.rmsd == pytest.approx(got.frobenius_error / np.sqrt(NNZ),
                                     rel=RTOL)


def test_nmftpus_ring_plan_runs_a_masked_config_unmasked():
    """The reference's fault: its ring plan runs mask="observed" with the
    unmasked update, reports the unmasked error, and takes the RMSD over
    the stored count."""
    sp, _, W0, H0 = _problem()
    jmesh = j_make_grid_mesh((1, 1), devices=jax.devices()[:1])
    base = JConfig(rank=RANK, num_iterations=ITERS, check_interval=1,
                   init_method=JInit.COPY_EXISTING)
    plan = j_prepare_sharded(sp, base, mesh=jmesh, engine="ring", chunk=64)
    masked = plan.run(dataclasses.replace(base, mask="observed"), W0=W0,
                      H0=H0)
    unmasked = j_compute_sharded(sp, base, mesh=jmesh, W0=W0, H0=H0,
                                 engine="ring", chunk=64)
    assert float(masked.frobenius_error) == pytest.approx(
        float(unmasked.frobenius_error), rel=RTOL)
    assert float(masked.rmsd) == pytest.approx(
        float(masked.frobenius_error) / np.sqrt(NNZ), rel=RTOL)
    assert float(unmasked.rmsd) == pytest.approx(
        float(unmasked.frobenius_error) / np.sqrt(N * M), rel=RTOL)
