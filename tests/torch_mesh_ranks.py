"""Rank programs for the port's slice-6b CPU tests (tests/test_torch_ring.py,
test_torch_dense_mesh.py, test_torch_foldin_sharded.py,
test_torch_minibatch_mesh.py, test_torch_surfaces_mesh.py) and its card
tests (test_torch_slice15_cuda.py).

`nmftpu_torch.parallel.launch` starts each function here on every rank
of a fresh world. Like tests/torch_parallel_ranks.py this module imports
numpy, torch and nmftpu_torch only, never jax or nmftpu: cases arrive
as plain data and results go back as numpy arrays and numbers, with the
rank's imports.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch_parallel_ranks import _mesh, _np, _result, config, imported


# ---------------------------------------------------------------------------
# The ring engine
# ---------------------------------------------------------------------------


def ring(cases, data):
    """cases: (name, kind, knobs); kinds "compute" (init copy from
    data's W0/H0), "init" (the ring's data init against the grid's, the
    full factors gathered) and "partition" (this rank's tiles). Every
    rank's mesh is (1, world): the ring flattens it."""
    import torch.distributed as dist

    from nmftpu_torch.parallel import compute_sharded, prepare_sharded
    from nmftpu_torch.parallel.ring import partition_for_ring
    from nmftpu_torch.sparse import from_dense

    p = dist.get_world_size()
    mesh = _mesh((1, p))
    out = {"_imported": None, "rank": dist.get_rank()}
    for name, kind, knobs in cases:
        d = data[knobs.pop("data", "main")]
        sp = from_dense(d["dense"])
        if kind == "compute":
            cfg = config({"init_method": "copy_existing", **knobs})
            res = compute_sharded(sp, cfg, mesh=mesh, W0=d["W0"], H0=d["H0"],
                                  engine="ring", chunk=64)
            out[name] = _result(res)
            out[name]["converged"] = res.converged
        elif kind == "init":
            cfg = config(knobs)
            got = {}
            for engine in ("ring", "scatter"):
                plan = prepare_sharded(sp, cfg, mesh=mesh, engine=engine,
                                       chunk=64)
                res = plan.run(dataclasses.replace(cfg, num_iterations=0))
                got[engine] = (_np(res.W), _np(res.H))
            out[name] = got
        elif kind == "partition":
            op, rp, cp = partition_for_ring(sp, p, dist.get_rank(),
                                            chunk=64, seed=knobs["seed"])
            out[name] = {"tiles": [(_np(t.values), _np(t.rows),
                                    _np(t.cols)) for t in op.tiles],
                         "row_perm": rp, "col_perm": cp,
                         "block": (op.block_rows, op.block_cols)}
        else:
            raise ValueError(kind)
    out["_imported"] = imported()
    return out


# ---------------------------------------------------------------------------
# Dense V on the mesh
# ---------------------------------------------------------------------------


def dense(runs, data, inits=()):
    """runs: [(mesh shape, [(name, knobs)])]: `driver.compute(mesh=)`
    from data's W0/H0 and, once per name, the one-device run; plus the
    int8 scale check on the 2 x 2 mesh. inits: [(mesh shape, [(name,
    knobs)])], each an init on the mesh (no W0/H0), under "init"."""
    import nmftpu_torch as nt
    from nmftpu_torch.algorithms.registry import _quantize_v
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.parallel.dense_mesh import (
        DenseTile,
        MeshSums,
        _tile_of,
        block_shape,
    )
    from nmftpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS

    V, W0, H0 = data["V"], data["W0"], data["H0"]
    out = {"_imported": None, "one": {}}
    for shape, cases in runs:
        mesh = _mesh(shape)
        got = out[tuple(shape)] = {}
        for name, knobs in cases:
            cfg = config({"init_method": "copy_existing", **knobs})
            got[name] = _result(nt.driver.compute(V, cfg, W0=W0, H0=H0,
                                                  mesh=mesh))
            if name not in out["one"]:
                out["one"][name] = _result(nt.driver.compute(
                    V, cfg, W0=W0, H0=H0, device="cpu"))
        if tuple(shape) == (2, 2):
            # the int8 tile takes the whole V's scale: its integers are
            # the whole V's, which the tile's own scale would not give
            n, m = V.shape
            br, bc = block_shape((n, m), shape)
            i, j = (mesh.get_local_rank(AXIS_USERS),
                    mesh.get_local_rank(AXIS_ITEMS))
            tile = DenseTile(V=_tile_of(V, slice(i * br, (i + 1) * br),
                                        slice(j * bc, (j + 1) * bc),
                                        (br, bc), torch.float32, "cpu"),
                             shape=(n, m), coords=(i, j))
            mesh_q, mesh_s = _quantize_v(MeshSums(mesh))(tile.V)
            own_q, own_s = Q.quantize_v(tile.V)
            whole_q, whole_s = Q.quantize_v(torch.as_tensor(V))
            vr, vc = tile.valid
            out["scale"] = {
                "coords": (i, j), "mesh_scale": float(mesh_s),
                "whole_scale": float(whole_s), "own_scale": float(own_s),
                "mesh_q_equal": bool(torch.equal(
                    mesh_q[:vr, :vc],
                    whole_q[i * br:i * br + vr, j * bc:j * bc + vc])),
                "own_q_equal": bool(torch.equal(
                    own_q[:vr, :vc],
                    whole_q[i * br:i * br + vr, j * bc:j * bc + vc]))}
    out["init"] = {}
    for shape, cases in inits:
        mesh = _mesh(shape)
        out["init"][tuple(shape)] = {
            name: _result(nt.driver.compute(V, config(knobs), mesh=mesh))
            for name, knobs in cases}
    out["_imported"] = imported()
    return out


# ---------------------------------------------------------------------------
# Fold-in on a sharded Recommender
# ---------------------------------------------------------------------------


def foldin(shape, cases, data):
    """cases: (name, recommender knobs, fold-in knobs): the sharded
    Recommender's prepared table, fold_in_batch and
    recommend_from_history_batch, beside the same on one device."""
    from nmftpu_torch import Recommender
    from nmftpu_torch.sparse import SparseCSR

    mesh = _mesh(shape)
    train = SparseCSR(*data["train"])
    out = {"_imported": None}
    for name, rk, fk in cases:
        got = {}
        for where, m in (("mesh", mesh), ("one", None)):
            rec = Recommender(data["W"], data["H"], train=train, mesh=m,
                              device="cpu", **rk)
            prep = rec._prep()
            got[where] = {
                "G": _np(prep.G), "h_sum": _np(prep.h_sum),
                "W": rec.fold_in_batch(data["histories"], **fk),
                "top": rec.recommend_from_history_batch(
                    data["histories"], k=data["k"], **fk)}
        out[name] = got
    out["_imported"] = imported()
    return out


# ---------------------------------------------------------------------------
# Mini-batch NMF and OnlineNMF on the mesh
# ---------------------------------------------------------------------------


def minibatch(shape, cases, data, save_dir):
    """cases: (name, kind, knobs). "fit": minibatch_fit(mesh=); "online":
    partial_fit steps, transform, save, load(mesh=) and one more step;
    "bad_m": m not divisible by the rank count."""
    from nmftpu_torch.minibatch import OnlineNMF, minibatch_fit

    mesh = _mesh(shape)
    out = {"_imported": None}
    for name, kind, kw in cases:
        V = data[kw.pop("data", "V")]
        if kind == "fit":
            W, H, n_iter, n_steps = minibatch_fit(
                V, data["W0"].shape[1], W0=data["W0"], H0=data["H0"],
                mesh=mesh, **kw)
            out[name] = {"W": _np(W), "H": _np(H), "n_iter": n_iter,
                         "n_steps": n_steps}
        elif kind == "online":
            model = OnlineNMF(data["W0"].shape[1], mesh=mesh, **kw)
            steps = []
            for lo in range(0, V.shape[0], kw["batch_size"]):
                model.partial_fit(V[lo:lo + kw["batch_size"]],
                                  H0=data["H0"] if lo == 0 else None)
                steps.append(_np(model.components()))
            Wt = model.transform(V[:16])
            path = f"{save_dir}/{name}"
            model.save(path)
            back = OnlineNMF.load(path, mesh=mesh)
            back.partial_fit(V[:kw["batch_size"]])
            model.partial_fit(V[:kw["batch_size"]])
            out[name] = {"steps": steps, "transform": _np(Wt),
                         "local_shape": tuple(model.H.shape),
                         "resumed": _np(back.components()),
                         "continued": _np(model.components())}
        elif kind == "bad_m":
            try:
                minibatch_fit(V[:, :-1], data["W0"].shape[1], W0=data["W0"],
                              H0=data["H0"][:, :-1], mesh=mesh, **kw)
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
        else:
            raise ValueError(kind)
    out["_imported"] = imported()
    return out


# ---------------------------------------------------------------------------
# The surfaces on a mesh
# ---------------------------------------------------------------------------


def _snapshot(kind, attrs):
    """A stand-in with the attributes of an nmftpu object (arrays as
    numpy) under its class name, for the convert functions."""
    return type(kind, (), dict(attrs))()


def surfaces(shape, cases, data, work_dir):
    """cases: (name, kind, params): "nmf" (sklearn NMF(mesh=)),
    "minibatch" (MiniBatchNMF(mesh=) fit_transform and partial_fit),
    "resume" (checkpoint.resume(mesh=) of a checkpoint the first rank
    writes), "rank_selection", "convert_recommender", "convert_online",
    "convert_estimator"."""
    import torch.distributed as dist

    import nmftpu_torch as nt
    from nmftpu_torch import checkpoint, convert
    from nmftpu_torch import sklearn_api as SK
    from nmftpu_torch.sparse import SparseCSR, from_dense

    mesh = _mesh(shape)
    out = {"_imported": None}
    for name, kind, p in cases:
        if kind == "nmf":
            X = data[p["data"]]
            if p.get("sparse"):
                X = from_dense(X)
            est = SK.NMF(mesh=mesh, **p["params"])
            W = est.fit_transform(X, W=data.get("W0"), H=data.get("H0"))
            out[name] = {"W": W, "H": est.components_,
                         "err": est.reconstruction_err_,
                         "n_iter": est.n_iter_}
        elif kind == "minibatch":
            X = data[p["data"]]
            est = SK.MiniBatchNMF(mesh=mesh, **p["params"])
            W = est.fit_transform(X, W=data["W0"], H=data["H0"])
            part = SK.MiniBatchNMF(mesh=mesh, **p["params"])
            for lo in range(0, X.shape[0], 32):
                first = lo == 0
                part.partial_fit(X[lo:lo + 32],
                                 W=data["W0"][:32] if first else None,
                                 H=data["H0"] if first else None)
            out[name] = {"W": W, "H": est.components_,
                         "err": est.reconstruction_err_,
                         "partial_H": part.components_}
        elif kind == "resume":
            X = data[p["data"]]
            if p.get("sparse"):
                X = from_dense(X)
            cfg = config(p["knobs"])
            path = f"{work_dir}/{name}"
            if dist.get_rank() == 0:
                checkpoint.save(path, data["W0"], data["H0"],
                                iteration=p["iteration"], config=cfg)
            dist.barrier()
            res = checkpoint.resume(path, X, cfg, mesh=mesh,
                                    **p.get("kwargs", {}))
            out[name] = _result(res)
        elif kind == "rank_selection":
            X = data[p["data"]]
            sel = nt.rank_selection(X, p["ranks"], mesh=mesh, **p["kwargs"])
            out[name] = {"best": sel.best_rank,
                         "cophenetic": list(sel.cophenetic),
                         "dispersion": list(sel.dispersion),
                         "mean_error": list(sel.mean_error)}
        elif kind == "convert_recommender":
            snap = dict(data[p["snap"]])
            snap["_train_csr"] = SparseCSR(*snap["_train_csr"])
            rec = convert.recommender_from_nmftpu(
                _snapshot("Recommender", snap), device="cpu", mesh=mesh)
            users = np.arange(6)
            out[name] = {"top": rec.recommend(users, k=5),
                         "local": tuple(rec.H.shape),
                         "table": _np(rec.H)}
        elif kind == "convert_online":
            model = convert.online_state_from_nmftpu(
                _snapshot("OnlineNMF", data[p["snap"]]), device="cpu",
                mesh=mesh)
            model.partial_fit(data[p["data"]][:32])
            out[name] = {"H": _np(model.components()),
                         "local": tuple(model.H.shape),
                         "n_steps": model.n_steps}
        elif kind == "convert_estimator":
            snap = dict(data[p["snap"]])
            snap["_online"] = _snapshot("OnlineNMF", snap["_online"])
            est = convert.estimator_from_nmftpu(
                _snapshot("MiniBatchNMF", snap), device="cpu", mesh=mesh)
            est.partial_fit(data[p["data"]][:32])
            out[name] = {"H": est.components_, "mesh": est.mesh is mesh,
                         "n_steps": est.n_steps_}
        else:
            raise ValueError(kind)
    out["_imported"] = imported()
    return out


# ---------------------------------------------------------------------------
# On the card (tests/test_torch_slice15_cuda.py)
# ---------------------------------------------------------------------------


def card_ring(data, kinds):
    """The ring on this world's ranks, on the card and on the CPU (the
    same engine on CPU tensors), one iteration of each kind."""
    import torch.distributed as dist

    from nmftpu_torch.parallel import compute_sharded
    from nmftpu_torch.sparse import from_dense

    torch.backends.cuda.matmul.allow_tf32 = False
    sp = from_dense(data["dense"])
    world = dist.get_world_size()
    out = {"backend": dist.get_backend(), "imported": None}
    for kind, knobs in kinds:
        cfg = config({"rank": data["W0"].shape[1],
                      "init_method": "copy_existing", "num_iterations": 2,
                      "check_interval": 1, **knobs})
        got = {}
        for dev in ("cuda", "cpu"):
            res = compute_sharded(sp, cfg, mesh=_mesh((1, world), dev),
                                  W0=data["W0"], H0=data["H0"],
                                  engine="ring", chunk=256)
            got[dev] = _result(res)
        out[kind] = got
    out["imported"] = imported()
    return out


def card_dense(data, runs):
    """Dense V on meshes of this world on the card: each run's launches
    by kernel, its factors, and the unsharded run on the card."""
    import torch.distributed as dist

    import nmftpu_torch as nt
    from nmftpu_torch.kernels import dense_mu as K
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.kernels import quantized as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    V = torch.as_tensor(data["V"], device="cuda")
    out = {"backend": dist.get_backend(), "imported": None}
    for shape, name, knobs in runs:
        cfg = config({"rank": data["W0"].shape[1],
                      "init_method": "copy_existing", "num_iterations": 1,
                      "check_interval": 1, **knobs})
        before = {**K.LAUNCHES, **Q.LAUNCHES, **DN.LAUNCHES}
        res = nt.driver.compute(V, cfg, W0=data["W0"], H0=data["H0"],
                                mesh=_mesh(shape, "cuda"))
        torch.cuda.synchronize()
        now = {**K.LAUNCHES, **Q.LAUNCHES, **DN.LAUNCHES}
        one = nt.driver.compute(V, cfg, W0=data["W0"], H0=data["H0"])
        out[tuple(shape), name] = {
            "launches": {k: now[k] - before[k] for k in now},
            "mesh": _result(res), "one": _result(one)}
    out["imported"] = imported()
    return out


def card_foldin(data):
    """Fold-in on an int8 table sharded over this world's ranks (1 x p)
    against the unsharded Recommender on the card: #6's Gram, #7's HALS
    fold-in and #8's scan launched on every rank."""
    import torch.distributed as dist

    from nmftpu_torch import Recommender
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.kernels import mips_reservoir as MR

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = _mesh((1, dist.get_world_size()), "cuda")
    out = {"backend": dist.get_backend(), "imported": None}
    for where, m in (("mesh", mesh), ("one", None)):
        before = (DN.LAUNCHES["vht_int8"], HS.LAUNCHES["hals_sweep"],
                  MR.LAUNCHES["reservoir_scan"])
        rec = Recommender(data["W"], data["H"], mesh=m, method="reservoir",
                          table_dtype="int8", reservoir_slots=1024,
                          device="cuda")
        got = {"G": _np(rec._prep().G),
               "als": rec.fold_in_batch(data["histories"]),
               "hals": rec.fold_in_batch(data["histories"],
                                         algorithm="hals",
                                         num_iterations=10),
               "top": rec.recommend_from_history_batch(data["histories"],
                                                       k=10)}
        torch.cuda.synchronize()
        got["launches"] = (DN.LAUNCHES["vht_int8"] - before[0],
                           HS.LAUNCHES["hals_sweep"] - before[1],
                           MR.LAUNCHES["reservoir_scan"] - before[2])
        out[where] = got
    out["imported"] = imported()
    return out
