"""The multi-rank dry run (port of ``__graft_entry__.dryrun_multichip``):
a full sharded training and serving pass at a small size on an n-rank
('users', 'items') mesh, every rank a gloo process started by
`parallel.launch`.

Steps, at the reference's sizes (96 x 80, 1,500 nonzeros, rank 8, 2
iterations): sparse training on the grid; sharded top-5 with
block-bucketed seen exclusion; a reservoir Recommender on the mesh with
its certified pass and exact fallback; the ring engine; iALS and HALS on
the grid; the mesh-native k-means init; the random init's blocks (each
rank holds only its (pn / pu, r) and (r, pm / pi) blocks); mini-batch
NMF and OnlineNMF with the item axis sharded; masked completion (MU and
ALS); the beta divergence on dense V on the mesh and on the scatter and
ELL engines; a batched stack; a checkpoint written by one rank and
resumed on the mesh. The reference's weak-scaling timing, which measures
host contention on a CPU mesh, is not part of it.

    python -c "from nmftpu_torch.parallel.dryrun import dryrun_multichip;
               dryrun_multichip(4)"                    # on the card
    python -c "...; dryrun_multichip(4, device_type='cpu')"  # on the host
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch


def _rank(n_ranks: int, device_type: str, ckpt_dir: str) -> dict:
    """One rank of the dry run; returns its summary numbers."""
    import torch.distributed as dist

    from nmftpu_torch import checkpoint as ckpt
    from nmftpu_torch.batched import compute_batched
    from nmftpu_torch.config import Algorithm, Initialization, NmfConfig
    from nmftpu_torch.data.synthetic import synthetic_powerlaw_sparse
    from nmftpu_torch.driver import compute as compute_dense
    from nmftpu_torch.minibatch import OnlineNMF, minibatch_fit
    from nmftpu_torch.parallel import (
        compute_sharded,
        make_grid_mesh,
        prepare_sharded,
        topk_mips_sharded,
    )
    from nmftpu_torch.parallel.mesh import AXIS_ITEMS, mesh_device
    from nmftpu_torch.retrieval.exclusion import build_block_exclusion
    from nmftpu_torch.serving import Recommender

    mesh = make_grid_mesh(None, device_type)
    dev = mesh_device(mesh)
    pu, pi = mesh.size(0), mesh.size(1)
    sp = synthetic_powerlaw_sparse(96, 80, nnz=1500, seed=0)
    cfg = NmfConfig(rank=8, num_iterations=2, check_interval=1, seed=0)
    res = compute_sharded(sp, cfg, mesh=mesh, chunk=256)
    assert tuple(res.W.shape) == (96, 8) and tuple(res.H.shape) == (8, 80)
    assert np.isfinite(res.frobenius_error)

    # sharded retrieval over the learned table, block-bucketed exclusion
    m_loc = 80 // pi
    j = mesh.get_local_rank(AXIS_ITEMS)
    H_loc = res.H[:, j * m_loc:(j + 1) * m_loc].contiguous()
    Wq = res.W[:4]
    if 80 % pi == 0:
        lists = build_block_exclusion(np.arange(4), sp.to_csr(), 80, 16,
                                      shards=pi)
        scores, _ = topk_mips_sharded(Wq, H_loc, 5, mesh, block=16,
                                      exclude_lists=lists)
        assert tuple(scores.shape) == (4, 5)

        # the sharded reservoir scan, its certificate and the exact
        # fallback
        rec_m = Recommender(res.W, res.H, train=sp, mesh=mesh,
                            method="reservoir", reservoir_slots=16)
        s_r, i_r = rec_m.recommend([0, 1, 2], k=5)
        assert s_r.shape == (3, 5) and (i_r < 80).all()
        s_mc, i_mc, cert_mc = rec_m.recommend_certified(
            [0, 1, 2], k=5, fallback="exact")
        assert cert_mc.shape == (3,) and (i_mc < 80).all()
    rec_1 = Recommender(res.W, res.H, train=sp, method="reservoir",
                        reservoir_slots=32, device=dev)
    s_c, _, cert = rec_1.recommend_certified([0, 1, 2], k=5,
                                             fallback="exact")
    assert cert.shape == (3,) and s_c.shape == (3, 5)

    # the ring engine over the same ranks
    res_ring = compute_sharded(sp, cfg, mesh=mesh, engine="ring", chunk=256)
    assert np.isfinite(res_ring.frobenius_error)

    # iALS and HALS on the grid
    cfg_ials = dataclasses.replace(cfg, algorithm=Algorithm.ALS,
                                   alpha_confidence=8.0, lambda_w=0.1,
                                   lambda_h=0.1)
    assert np.isfinite(compute_sharded(sp, cfg_ials, mesh=mesh,
                                       chunk=256).frobenius_error)
    cfg_hals = dataclasses.replace(cfg, algorithm=Algorithm.HALS)
    assert np.isfinite(compute_sharded(sp, cfg_hals, mesh=mesh,
                                       chunk=256).frobenius_error)

    # the mesh-native k-means init
    cfg_km = dataclasses.replace(
        cfg, init_method=Initialization.K_MEANS_AND_NON_NEGATIVE_WTV,
        kmeans_max_iter=2)
    res_km = compute_sharded(sp, cfg_km, mesh=mesh, chunk=256)
    assert np.isfinite(res_km.frobenius_error)

    # the random init holds only this rank's blocks, never a full factor
    plan = prepare_sharded(sp, cfg, mesh=mesh, chunk=256)
    W0, H0 = plan._init_fn(cfg, None, None)(0)
    assert tuple(W0.shape) == (plan.block_rows, 8)
    assert tuple(H0.shape) == (8, plan.block_cols)
    assert plan.block_rows * pu >= 96 and plan.block_cols * pi >= 80

    # mini-batch NMF with the item axis sharded over every rank
    rng_mb = np.random.default_rng(2)
    Vmb = (np.abs(rng_mb.normal(size=(64, 8 * n_ranks)))
           + 0.05).astype(np.float32)
    Wmb = (np.abs(rng_mb.normal(size=(64, 4))) + 0.05).astype(np.float32)
    Hmb = (np.abs(rng_mb.normal(size=(4, Vmb.shape[1])))
           + 0.05).astype(np.float32)
    _, H_mb, _, _ = minibatch_fit(Vmb, 4, batch_size=32, max_iter=2, tol=0.0,
                                  max_no_improvement=None, W0=Wmb, H0=Hmb,
                                  mesh=mesh)
    assert torch.isfinite(H_mb).all()
    online = OnlineNMF(4, batch_size=32, mesh=mesh, seed=0)
    online.partial_fit(Vmb[:32])
    assert tuple(online.H.shape) == (4, 8)

    # masked completion, MU and exact ALS
    res_mask = compute_sharded(sp, dataclasses.replace(cfg, mask="observed"),
                               mesh=mesh, chunk=256)
    assert np.isfinite(res_mask.frobenius_error)
    res_mals = compute_sharded(
        sp, dataclasses.replace(cfg, mask="observed", algorithm=Algorithm.ALS,
                                lambda_w=0.01, lambda_h=0.01),
        mesh=mesh, chunk=256)
    assert np.isfinite(res_mals.frobenius_error)

    # the beta divergence on dense V on the mesh and on the sparse engines
    rng_b = np.random.default_rng(3)
    Vb = (np.abs(rng_b.normal(size=(64, 8 * n_ranks)))
          + 0.05).astype(np.float32)
    cfg_beta = NmfConfig(rank=4, num_iterations=2, check_interval=2,
                         objective="beta-divergence", beta=1.5, seed=0)
    res_beta = compute_dense(Vb, cfg_beta, mesh=mesh)
    assert np.isfinite(res_beta.error)
    for engine in ("scatter", "ell"):
        assert np.isfinite(compute_sharded(
            sp, cfg_beta, mesh=mesh, chunk=256, engine=engine).kl_error)

    # a batched stack on this rank's device
    Vs = (np.abs(np.random.default_rng(4).normal(size=(6, 32, 24)))
          + 0.05).astype(np.float32)
    res_b = compute_batched(Vs, NmfConfig(rank=4, num_iterations=2,
                                          check_interval=2, seed=0),
                            device=dev)
    assert tuple(res_b.W.shape) == (6, 32, 4)

    # a checkpoint written by the first rank, resumed on the mesh
    cfg_more = dataclasses.replace(cfg, num_iterations=4)
    if dist.get_rank() == 0:
        ckpt.save(ckpt_dir, res.W, res.H, iteration=2, config=cfg_more)
    dist.barrier()
    res_resumed = ckpt.resume(ckpt_dir, sp, cfg_more, mesh=mesh, chunk=256)
    assert np.isfinite(res_resumed.frobenius_error)
    return {"mesh": (pu, pi), "fro_err": res.frobenius_error,
            "ring_err": res_ring.frobenius_error,
            "kmeans_err": res_km.frobenius_error,
            "masked_err": res_mask.frobenius_error,
            "masked_als_err": res_mals.frobenius_error,
            "beta_dense_mesh_err": res_beta.error,
            "resumed_err": res_resumed.frobenius_error}


def dryrun_multichip(n_ranks: int, device_type: str = "cuda",
                     timeout: float = 600.0) -> dict:
    """Run the dry run on `n_ranks` gloo ranks, their tensors on the
    cards (ranks sharing a card as gloo allows), or on the CPU with
    device_type="cpu"; every rank must agree. Returns the first rank's
    summary and prints it."""
    from nmftpu_torch.parallel.multihost import launch

    with tempfile.TemporaryDirectory(prefix="nmftpu_dryrun_") as tmp:
        out = launch(_rank, n_ranks,
                     args=(n_ranks, device_type, os.path.join(tmp, "ck")),
                     backend="gloo", timeout=timeout, threads=1)
    for r in out[1:]:
        assert r == out[0], (r, out[0])
    s = out[0]
    print(f"dryrun_multichip OK: mesh={s['mesh']}, fro_err="
          f"{s['fro_err']:.4f}, ring_err={s['ring_err']:.4f}, kmeans_err="
          f"{s['kmeans_err']:.4f}, masked_err={s['masked_err']:.4f}, "
          f"masked_als_err={s['masked_als_err']:.4f}, beta_dense_mesh_err="
          f"{s['beta_dense_mesh_err']:.4f}, resumed_err="
          f"{s['resumed_err']:.4f}")
    return s
