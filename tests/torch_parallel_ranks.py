"""Rank programs for the port's multi-rank CPU tests
(tests/test_torch_parallel.py, test_torch_sharded_ell.py,
test_torch_retrieval_sharded.py) and its card tests
(test_torch_slice14_cuda.py).

`nmftpu_torch.parallel.launch` starts each function here on every rank
of a fresh world. This module imports numpy, torch and nmftpu_torch
only, never jax or nmftpu: the ranks run the port alone, and each
result reports what the rank had imported. Cases arrive as plain data
(names, knobs, numpy arrays) and results go back as numpy arrays and
floats.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch


def _nt():
    import nmftpu_torch as nt

    return nt


def config(knobs: dict):
    """An NmfConfig from plain knobs (enum fields by value)."""
    nt = _nt()
    kw = dict(knobs)
    for key, enum in (("algorithm", nt.Algorithm),
                      ("objective", nt.Objective),
                      ("init_method", nt.Initialization)):
        if key in kw:
            kw[key] = enum(kw[key])
    return nt.NmfConfig(**kw)


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def imported() -> dict:
    return {"jax": "jax" in sys.modules, "nmftpu": "nmftpu" in sys.modules}


def _mesh(shape, device_type="cpu"):
    from nmftpu_torch.parallel import make_grid_mesh

    return make_grid_mesh(tuple(shape), device_type)


def _result(res) -> dict:
    return {"W": _np(res.W), "H": _np(res.H), "error": res.error,
            "frobenius_error": res.frobenius_error, "kl_error": res.kl_error,
            "num_iterations": res.num_iterations,
            "errors": res.stats.errors}


def _full(plan, W, H):
    """A rank's blocks gathered and un-permuted to the full factors."""
    from nmftpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS, all_gather

    Wf = all_gather(W, plan.mesh, AXIS_USERS)
    Hf = all_gather(H, plan.mesh, AXIS_ITEMS)
    Wf = Wf.reshape(-1, Wf.shape[-1])
    Hf = Hf.permute(1, 0, 2).reshape(Hf.shape[1], -1)
    return (_np(Wf)[plan.row_perm], _np(Hf)[:, plan.col_perm])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _partition_coo(mesh, sp, p):
    from nmftpu_torch.parallel import partition_sparse
    from nmftpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS

    coords = (mesh.get_local_rank(AXIS_USERS), mesh.get_local_rank(AXIS_ITEMS))
    scoo, rp, cp = partition_sparse(sp, (mesh.size(0), mesh.size(1)), coords,
                                    chunk=p["chunk"], balance=p["balance"],
                                    seed=p.get("seed", 0))
    from nmftpu_torch.parallel import balance_report

    return {"coords": coords, "values": _np(scoo.values),
            "rows": _np(scoo.rows), "cols": _np(scoo.cols),
            "chunk": scoo.chunk, "block": (scoo.block_rows, scoo.block_cols),
            "row_perm": rp, "col_perm": cp, "report": balance_report(scoo)}


def _partition_ell(mesh, sp, p):
    from nmftpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS
    from nmftpu_torch.parallel.sharded_ell import partition_sparse_ell

    coords = (mesh.get_local_rank(AXIS_USERS), mesh.get_local_rank(AXIS_ITEMS))
    sell, rp, cp = partition_sparse_ell(
        sp, (mesh.size(0), mesh.size(1)), coords, seg_max=p["seg_max"],
        buckets=tuple(p["buckets"]), balance=p["balance"],
        seed=p.get("seed", 0))

    def side(ell):
        return [(b.width, _np(b.vals), _np(b.cols), _np(b.out_row))
                for b in ell.buckets]

    return {"coords": coords, "rows": side(sell.pair.rows),
            "cols": side(sell.pair.cols), "row_perm": rp, "col_perm": cp}


def _step(mesh, sp, p, data):
    """One iteration (both half-steps) and the error metrics on this
    rank's blocks of the given start."""
    from nmftpu_torch.parallel.driver import _sharded_ops, prepare_sharded

    cfg = config({**p["knobs"], "init_method": "copy_existing"})
    plan = prepare_sharded(sp, cfg, mesh=mesh, engine=p["engine"],
                           chunk=p.get("chunk", 256))
    W, H = plan._init_fn(cfg, data["W0"], data["H0"])(0)
    n, m = plan.shape
    ops = _sharded_ops(cfg, mesh, plan.engine, n, m, plan.nnz)
    aux = ops.make_aux(plan.operand)
    svsq = ops.sum_v_sq(plan.operand)
    He = ops.effective_h(aux, H)
    out = {"coords": plan.coords,
           "fro": float(ops.frobenius(plan.operand, aux, W, He, svsq)),
           "kl": float(ops.kl(plan.operand, aux, W, He))}
    W1, H1 = ops.update(plan.operand, aux, W, H)
    out.update(W=_np(W1), H=_np(H1))
    return out


def _compute(mesh, sp, p, data):
    from nmftpu_torch.parallel import compute_sharded

    cfg = config({"init_method": "copy_existing", **p["knobs"]})
    res = compute_sharded(sp, cfg, mesh=mesh, W0=data["W0"], H0=data["H0"],
                          engine=p["engine"], chunk=p.get("chunk", 256))
    return _result(res)


def _init(mesh, sp, p):
    """The init's full factors (gathered, un-permuted), and the draws."""
    from nmftpu_torch.parallel import prepare_sharded

    cfg = config(p["knobs"])
    plan = prepare_sharded(sp, cfg, mesh=mesh, engine=p["engine"],
                           chunk=p.get("chunk", 256))
    W, H = plan._init_fn(cfg, None, None)(0)
    Wf, Hf = _full(plan, W, H)
    return {"W": Wf, "H": Hf, "row_perm": plan.row_perm,
            "col_perm": plan.col_perm}


def _plan(mesh, sp, p, data):
    """Plan reuse, warm starts and unpermute=False."""
    from nmftpu_torch.parallel import compute_sharded, prepare_sharded

    cfg = config(p["knobs"])
    plan = prepare_sharded(sp, cfg, mesh=mesh, chunk=256)
    r1 = plan.run()
    r2 = compute_sharded(sp, cfg, mesh=mesh, chunk=256)
    operand = plan.operand
    r3 = plan.run(dataclasses.replace(cfg, num_iterations=2 *
                                      cfg.num_iterations))
    refusals = []
    for bad in (dict(dtype="float64"), dict(rank=64)):
        try:
            plan.run(dataclasses.replace(cfg, **bad))
        except ValueError as e:
            refusals.append(str(e))
    rp = plan.run(unpermute=False)
    Wu, Hu = _full(plan, rp.W, rp.H)
    warm = config({**p["knobs"], "init_method": "copy_existing"})
    for engine in ("scatter", "ell"):
        wplan = prepare_sharded(sp, warm, mesh=mesh, chunk=256,
                                engine=engine)
        a = wplan.run(W0=data["W0"], H0=data["H0"])
        b = compute_sharded(sp, warm, mesh=mesh, chunk=256, engine=engine,
                            W0=data["W0"], H0=data["H0"])
        refusals.append(bool(np.array_equal(_np(a.W), _np(b.W))))
    return {"r1": _result(r1), "r2": _result(r2), "r3": _result(r3),
            "same_operand": plan.operand is operand, "refusals": refusals,
            "unpermuted": (Wu, Hu), "block_shapes": (tuple(rp.W.shape),
                                                     tuple(rp.H.shape))}


def _rowshards(mesh, sp, p, data):
    """Each rank passes only its users block's rows; the plan equals the
    whole-matrix partition."""
    from nmftpu_torch.parallel import prepare_sharded, prepare_sharded_rowshards
    from nmftpu_torch.parallel.mesh import AXIS_USERS
    from nmftpu_torch.parallel.sharded_coo import block_sizes
    from nmftpu_torch.sparse import SparseCOO

    cfg = config({**p["knobs"], "init_method": "copy_existing"})
    coo = sp.to_coo()
    n, m = coo.shape
    br, _ = block_sizes((n, m), (mesh.size(0), mesh.size(1)))
    iu = mesh.get_local_rank(AXIS_USERS)
    lo, hi = iu * br, min((iu + 1) * br, n)
    sel = (coo.row >= lo) & (coo.row < hi)
    local = SparseCOO(row=(coo.row[sel] - lo).astype(np.int32),
                      col=coo.col[sel], data=coo.data[sel],
                      shape=(hi - lo, m))
    rs = prepare_sharded_rowshards(local, lo, (n, m), cfg, mesh=mesh,
                                   balance=False, chunk=256)
    whole = prepare_sharded(sp, cfg, mesh=mesh, balance=False, chunk=256,
                            engine="scatter")
    a = rs.run(W0=data["W0"], H0=data["H0"])
    b = whole.run(W0=data["W0"], H0=data["H0"])
    return {"a": _result(a), "b": _result(b),
            "values": bool(torch.equal(rs.operand.values,
                                       whole.operand.values)),
            "nnz": (rs.nnz, whole.nnz), "mean_v": (rs.mean_v, whole.mean_v),
            "tile_nnz": (rs.operand.tile_nnz, whole.operand.tile_nnz)}


def _determinism(mesh, sp, p):
    from nmftpu_torch.parallel import compute_sharded

    cfg = config(p["knobs"])
    a = compute_sharded(sp, cfg, mesh=mesh, chunk=256, engine=p["engine"])
    b = compute_sharded(sp, cfg, mesh=mesh, chunk=256, engine=p["engine"])
    return {"a": _result(a), "b": _result(b)}


_TRAINING = {"partition_coo": _partition_coo, "partition_ell": _partition_ell,
             "init": _init, "determinism": _determinism}
_TRAINING_DATA = {"step": _step, "compute": _compute, "plan": _plan,
                  "rowshards": _rowshards}


def training(runs, data):
    """Run each (mesh shape, cases) of `runs` on a mesh of this world;
    returns {shape: {name: result}} plus the rank's imports. cases:
    (name, kind, params); data: {key: {"dense": (n, m) array, "W0",
    "H0"}}, params["data"] naming the key (default "main")."""
    from nmftpu_torch.sparse import from_dense

    out = {"_imported": None}
    for shape, cases in runs:
        mesh = _mesh(shape)
        got = out[tuple(shape)] = {}
        for name, kind, p in cases:
            d = data[p.get("data", "main")]
            sp = from_dense(d["dense"])
            if kind in _TRAINING:
                got[name] = _TRAINING[kind](mesh, sp, p)
            else:
                got[name] = _TRAINING_DATA[kind](mesh, sp, p, d)
    out["_imported"] = imported()
    return out


def fail_on_rank_one():
    """Rank 1 raises while rank 0 waits in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()


# ---------------------------------------------------------------------------
# Retrieval
# ---------------------------------------------------------------------------


def _shard(H, mesh):
    from nmftpu_torch.parallel.mesh import AXIS_ITEMS

    pi, j = mesh.size(1), mesh.get_local_rank(AXIS_ITEMS)
    m_loc = H.shape[1] // pi
    return H[:, j * m_loc:(j + 1) * m_loc].contiguous()


def retrieval(shape, cases, data):
    """Sharded top-k, certificates and the Recommender on a `shape`
    mesh; cases: (name, kind, params)."""
    from nmftpu_torch import Recommender, recall_at_k
    from nmftpu_torch.parallel import (
        certify_topk_sharded,
        topk_mips_sharded,
    )
    from nmftpu_torch.retrieval.exclusion import build_block_exclusion
    from nmftpu_torch.serving import quantize_table
    from nmftpu_torch.sparse import SparseCSR, from_dense

    mesh = _mesh(shape)
    out = {}
    for name, kind, p in cases:
        d = data[p.get("data", "main")]
        Wq = torch.as_tensor(d["Wq"])
        H = torch.as_tensor(d["H"])
        if kind == "topk":
            Hs, hs = H, None
            if p.get("table") == "int8":
                Hs, hs = quantize_table(H)
            elif p.get("table") == "bfloat16":
                Hs = H.to(torch.bfloat16)
            kw = {}
            if p.get("seen"):
                kw["seen"] = d["seen"]
            if p.get("mask"):
                kw["exclude_mask"] = d["mask"]
            if p.get("lists"):
                csr = from_dense(d["mask"].astype(np.float32)).to_csr()
                kw["exclude_lists"] = build_block_exclusion(
                    np.arange(Wq.shape[0]), csr, H.shape[1], p["block"],
                    shards=mesh.size(1))
            s, i = topk_mips_sharded(
                Wq, _shard(Hs, mesh), p["k"], mesh, block=p["block"],
                method=p["method"], h_scale=hs,
                candidate_k=p.get("candidate_k"),
                reservoir_slots=p.get("slots", 4096), **kw)
            out[name] = {"s": _np(s), "i": _np(i)}
        elif kind == "certify":
            Hs, hs = H, None
            if p.get("table") == "int8":
                Hs, hs = quantize_table(H)
            elif p.get("table") == "bfloat16":
                Hs = H.to(torch.bfloat16)
            cert = certify_topk_sharded(
                Wq, _shard(Hs, mesh), torch.as_tensor(d[p.get("top", "top_s")]),
                p["k"], mesh, block=p["block"], h_scale=hs,
                seen=d[p.get("seen_key", "seen")] if p.get("seen") else None)
            out[name] = _np(cert)
        elif kind == "recommender":
            train = SparseCSR(*d["train"])
            rec = Recommender(d["W"], d["H"], train=train, mesh=mesh,
                              method=p["method"],
                              table_dtype=p["table_dtype"],
                              reservoir_slots=p.get("slots", 4096),
                              device="cpu")
            users = d["users"]
            s, i = rec.recommend(users, k=p["k"])
            sc, ic, cert = rec.recommend_certified(users, k=p["k"],
                                                   fallback="exact")
            out[name] = {"s": s, "i": i, "sc": sc, "ic": ic, "cert": cert,
                         "score": rec.score(int(users[0]), d["score_ids"])}
            if p.get("save"):
                rec.save(p["save"])
                back = Recommender.load(p["save"], mesh=mesh, device="cpu")
                out[name]["loaded"] = back.recommend(users, k=p["k"])
        elif kind == "recall":
            out[name] = recall_at_k(
                d["W"], d["H"], d["test_pairs"], train=SparseCSR(*d["train"]),
                k=p["k"], batch_users=p["batch_users"], block=p["block"],
                mesh=mesh, method=p["method"])
        else:
            raise ValueError(kind)
    out["_imported"] = imported()
    return out


def sleep_forever():
    import time

    time.sleep(3600)


# ---------------------------------------------------------------------------
# On the card (tests/test_torch_slice14_cuda.py)
# ---------------------------------------------------------------------------


def card_hals(data, iters):
    """Sharded HALS on this world's mesh on the card: #7's launches, the
    run against the same sharded run on the CPU (the plain sweep), and #7
    against its twin on this rank's operands."""
    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.parallel import compute_sharded, prepare_sharded, psum
    from nmftpu_torch.sparse import from_dense
    from nmftpu_torch.sparse_ops import v_ht
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (1, dist.get_world_size())
    sp = from_dense(data["dense"])
    cfg = config(dict(rank=data["W0"].shape[1], algorithm="hals",
                      init_method="copy_existing", num_iterations=iters,
                      check_interval=1))
    mesh = _mesh(shape, "cuda")
    before = HS.LAUNCHES["hals_sweep"]
    card = compute_sharded(sp, cfg, mesh=mesh, W0=data["W0"], H0=data["H0"],
                           engine="scatter")
    launches = HS.LAUNCHES["hals_sweep"] - before
    cpu_mesh = _mesh(shape, "cpu")
    cpu = compute_sharded(sp, cfg, mesh=cpu_mesh, W0=data["W0"],
                          H0=data["H0"], engine="scatter")
    plan = prepare_sharded(sp, cfg, mesh=mesh, engine="scatter")
    res = plan.run(W0=data["W0"], H0=data["H0"], unpermute=False)
    local = plan.operand.local()
    XHt = psum(v_ht(local, res.H), mesh, "items")
    G = psum(res.H @ res.H.T, mesh, "items")
    got = HS.hals_sweep(XHt, G, res.W)
    want = HS.hals_sweep_plain(XHt, G, res.W)
    return {"launches": launches, "card": _result(card), "cpu": _result(cpu),
            "twin": (float((got - want).abs().max()),
                     float(want.abs().max())),
            "backend": dist.get_backend(), "imported": imported()}


def card_serving(data, slots):
    """The reservoir shard scan (#8) and the sharded certificate (#9) on
    an int8 table sharded over this world's ranks, against the same calls
    on CPU tensors (the twins)."""
    import torch.distributed as dist

    from nmftpu_torch.kernels import count_above as CA
    from nmftpu_torch.kernels import mips_reservoir as MR
    from nmftpu_torch.parallel import certify_topk_sharded, topk_mips_sharded
    from nmftpu_torch.parallel.retrieval_sharded import (
        rescore_and_sort_sharded,
    )
    from nmftpu_torch.serving import quantize_table

    shape = (1, dist.get_world_size())
    out = {"backend": dist.get_backend(), "imported": imported()}
    for dev, mesh in (("cuda", _mesh(shape, "cuda")),
                      ("cpu", _mesh(shape, "cpu"))):
        Hq, hs = quantize_table(torch.as_tensor(data["H"]))
        Hq, hs = _shard(Hq, mesh).to(dev), hs.to(dev)
        Wq = torch.as_tensor(data["Wq"]).to(dev)
        before = (MR.LAUNCHES["reservoir_scan"], CA.LAUNCHES["count_above"])
        s, i = topk_mips_sharded(Wq, Hq, data["k"], mesh, method="reservoir",
                                 h_scale=hs, reservoir_slots=slots,
                                 seen=data["seen"])
        # the certificate counts against the exact chain scores: the
        # candidates are re-scored at its rules first, as a Recommender
        # does (the kernel's tensor-core scores may round the kth item
        # above its own threshold)
        s2, _ = rescore_and_sort_sharded(Wq, Hq, i, mesh, h_scale=hs,
                                         invalid=s == float("-inf"),
                                         seen=data["seen"])
        cert = certify_topk_sharded(Wq, Hq, s2, data["k"], mesh, h_scale=hs,
                                    seen=data["seen"])
        out[dev] = {"s": _np(s), "i": _np(i), "cert": _np(cert),
                    "launches": (MR.LAUNCHES["reservoir_scan"] - before[0],
                                 CA.LAUNCHES["count_above"] - before[1])}
    return out
