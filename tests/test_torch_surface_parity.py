"""The port's public surface against nmftpu's, module by module.

For every module of nmftpu (`pkgutil.walk_packages`), its twin of the
same dotted name under nmftpu_torch must import and hold:
* every name in the module's `__all__` or `_LAZY`, every public function
  and class it defines, and every public upper-case constant it has;
* every public method (and property) of each such class, and every field
  of each such dataclass;
* every named parameter of each such function (a `*args` or `**kwargs`
  of the reference is not a name a caller passes).
And the twin must not bring jax or nmftpu into an interpreter that
imports nmftpu_torch and each of its modules (checked once, in a fresh
interpreter, module by module).

Two tables hold the exceptions, each entry with its reason. TPU_ONLY:
names and parameters that have no meaning off JAX or the TPU. RENAMED:
a reference name whose twin lives under another dotted path, which must
resolve. When nmftpu gains a public name, port it, or add it to one of
the tables with its reason.

Parameters, methods and fields are keyed by the reference object's own
module and qualified name, so a re-export (``nmftpu.init`` re-exports
``nmftpu.init.strategies.initialize_factors``) needs one entry."""

import dataclasses
import importlib
import inspect
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import nmftpu

REPO = Path(__file__).resolve().parents[1]

_GATE = "a TPU backend gate; the port picks the CUDA kernel by the tensor's device"
_PSPEC = "jax's PartitionSpec alias; the port's mesh has no sharding specs"
_INTERPRET = "Pallas interpret mode; the port's CPU path is the plain twin"
_KEY = "a jax PRNG key; the port takes a torch.Generator (`gen`)"
_SHARD_META = ("static shard metadata that shard_map needs; a torch rank "
               "reads it off its own operand")
_TILES = "a Mosaic tile or block size; the CUDA kernel picks its own tiling"

TPU_ONLY = {
    # names: (module, name)
    **{(f"nmftpu.kernels.{k}", "available"): _GATE
       for k in ("count_above", "dense_mu", "dual_numer", "hals_sweep",
                 "mips_reservoir", "sparse_ell_kernel")},
    ("nmftpu.kernels.sparse_ell_kernel", "spmm_supported"): _GATE,
    ("nmftpu.kernels.sparse_ell_kernel", "table_fits"):
        "the VMEM table gate of the Pallas ELL kernel",
    ("nmftpu.kernels.sparse_ell_kernel", "VMEM_TABLE_BUDGET"):
        "the VMEM table budget of the Pallas ELL kernel",
    **{(f"nmftpu.parallel.{k}", "P"): _PSPEC
       for k in ("init_sharded", "mesh", "retrieval_sharded", "ring",
                 "sharded_ell", "updates")},
    ("nmftpu.parallel.ring", "ring_shardings"):
        "a map of jax NamedShardings for the ring's operands",
    ("nmftpu.parallel.ring", "build_ring_mu_update"):
        "a back-compat wrapper of build_ring_update from before the ring "
        "took every algorithm",
    # methods and fields: (defining module, class qualname, attribute)
    ("nmftpu.parallel.sharded_coo", "ShardedCOO", "local_coo_template"):
        "a shape template for shard_map's per-device view; a rank holds "
        "its tile itself",
    **{("nmftpu.parallel.sharded_ell", "ShardedEll", f): (
        "the stacked per-device bucket arrays of shard_map's layout; a "
        "rank holds its own EllPair")
       for f in ("r_vals", "r_cols", "r_rows", "c_vals", "c_cols", "c_rows",
                 "r_widths", "c_widths")},
    # parameters: (defining module, function qualname, parameter)
    ("nmftpu.init.strategies", "initialize_factors", "key"): _KEY,
    ("nmftpu.sparse_ops", "kmeans_columns_sparse", "key"): _KEY,
    ("nmftpu.sparse_ops", "sparse_initialize_factors", "key"): _KEY,
    ("nmftpu.kernels.count_above", "count_above_fused", "tile"): _TILES,
    ("nmftpu.kernels.count_above", "count_above_fused", "q_block"): _TILES,
    ("nmftpu.kernels.count_above", "count_above_fused", "interpret"):
        _INTERPRET,
    ("nmftpu.kernels.dense_mu", "fused_multiply_divide", "interpret"):
        _INTERPRET,
    ("nmftpu.kernels.dense_mu", "mu_update_frobenius_fused", "interpret"):
        _INTERPRET,
    ("nmftpu.kernels.dual_numer", "dual_numerators_int8", "bn"): _TILES,
    ("nmftpu.kernels.dual_numer", "dual_numerators_int8", "bm"): _TILES,
    ("nmftpu.kernels.dual_numer", "dual_numerators_int8", "interpret"):
        _INTERPRET,
    ("nmftpu.kernels.quantized", "mu_update_frobenius_q", "interpret"):
        _INTERPRET,
    ("nmftpu.kernels.sparse_ell_kernel", "bucket_accumulate_pallas",
     "chunk"): _TILES,
    ("nmftpu.kernels.sparse_ell_kernel", "bucket_accumulate_pallas",
     "interpret"): _INTERPRET,
    ("nmftpu.kernels.sparse_ell_kernel", "mu_update_frobenius_ell_pallas",
     "interpret"): _INTERPRET,
    ("nmftpu.kernels.sparse_ell_kernel", "v_ht_ell_pallas", "chunk"): _TILES,
    ("nmftpu.kernels.sparse_ell_kernel", "v_ht_ell_pallas", "interpret"):
        _INTERPRET,
    ("nmftpu.kernels.sparse_ell_kernel", "wt_v_ell_pallas", "chunk"): _TILES,
    ("nmftpu.kernels.sparse_ell_kernel", "wt_v_ell_pallas", "interpret"):
        _INTERPRET,
    ("nmftpu.loop", "build_runner", "jit_wrap"):
        "wraps the runner in jax.jit; the port's loop runs eagerly",
    ("nmftpu.loop", "execute", "V_dev"):
        "V already placed by jax.device_put; the port's operand is the "
        "tensor on its device",
    ("nmftpu.parallel.mesh", "make_grid_mesh", "devices"):
        "a list of jax devices; a torch mesh spans the process group's "
        "ranks, one device each",
    ("nmftpu.parallel.sharded_coo", "partition_sparse", "out_shardings"):
        "jax shardings for device_put; a rank keeps its own tile",
    ("nmftpu.parallel.sharded_ell", "partition_sparse_ell", "mesh"):
        "a jax Mesh for device_put; the port takes the rank's grid "
        "coordinates",
    ("nmftpu.parallel.retrieval_sharded", "topk_mips_sharded",
     "interpret"): _INTERPRET,
    **{("nmftpu.parallel.ring", f, "scoo_meta"): _SHARD_META
       for f in ("build_ring_beta_error", "build_ring_errors",
                 "build_ring_update")},
    **{("nmftpu.parallel.updates", f, "scoo_meta"): _SHARD_META
       for f in ("build_sharded_beta_error", "build_sharded_errors",
                 "build_sharded_update")},
    **{("nmftpu.parallel.sharded_ell", f, "sell"): _SHARD_META
       for f in ("build_sharded_ell_beta_error", "build_sharded_ell_errors",
                 "build_sharded_ell_update")},
    ("nmftpu.parallel.updates", "sum_wh_beta_tile", "br"): _SHARD_META,
    ("nmftpu.parallel.updates", "sum_wh_beta_tile", "bc"): _SHARD_META,
}

RENAMED = {
    ("nmftpu.parallel.init_sharded", "build_sharded_data_init"): (
        "nmftpu_torch.parallel.init_sharded.sharded_data_init",
        "builds and runs the init on the rank at once: nothing to compile"),
    ("nmftpu.parallel.ring", "build_ring_data_init"): (
        "nmftpu_torch.parallel.ring.ring_data_init",
        "builds and runs the init on the rank at once: nothing to compile"),
    ("nmftpu.parallel.ring", "make_ring_mesh"): (
        "nmftpu_torch.parallel.mesh.make_ring_mesh",
        "the ring mesh is a DeviceMesh, built beside the grid's"),
}

MODULES = ["nmftpu"] + sorted(
    m.name for m in pkgutil.walk_packages(nmftpu.__path__, "nmftpu."))


def _twin_name(name: str) -> str:
    return "nmftpu_torch" + name[len("nmftpu"):]


def _public_names(mod) -> set:
    names = set(getattr(mod, "__all__", ())) | set(getattr(mod, "_LAZY", {}))
    for k, v in vars(mod).items():
        if k.startswith("_") or inspect.ismodule(v):
            continue
        if (inspect.isfunction(v) or inspect.isclass(v)) \
                and v.__module__ == mod.__name__:
            names.add(k)
        elif k.isupper() and not callable(v):
            names.add(k)
    return names


def _resolve(path: str):
    mod, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(mod), attr)


def _class_gaps(ref, twin) -> list:
    key = (ref.__module__, ref.__qualname__)
    gaps = []
    for attr, v in vars(ref).items():
        if attr.startswith("_") or (*key, attr) in TPU_ONLY:
            continue
        if (callable(v) or isinstance(v, (property, staticmethod,
                                          classmethod))) \
                and not hasattr(twin, attr):
            gaps.append(f"method {ref.__qualname__}.{attr}")
    if dataclasses.is_dataclass(ref):
        have = ({f.name for f in dataclasses.fields(twin)}
                if dataclasses.is_dataclass(twin) else set())
        for f in dataclasses.fields(ref):
            if not f.name.startswith("_") and f.name not in have \
                    and (*key, f.name) not in TPU_ONLY:
                gaps.append(f"field {ref.__qualname__}.{f.name}")
    return gaps


def _parameter_gaps(ref, twin) -> list:
    key = (ref.__module__, ref.__qualname__)
    have = inspect.signature(twin).parameters
    named = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    return [f"parameter {ref.__qualname__}({p})"
            for p, par in inspect.signature(ref).parameters.items()
            if par.kind not in named and p not in have
            and (*key, p) not in TPU_ONLY]


@pytest.fixture(scope="module")
def forbidden_imports():
    """A fresh interpreter imports nmftpu_torch, then each of its modules
    in turn, and records the jax or nmftpu modules that each import
    brought in."""
    code = r"""
import importlib, json, pkgutil, sys
def bad():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "nmftpu"))
import nmftpu_torch
out = {"nmftpu_torch": bad()}
for m in pkgutil.walk_packages(nmftpu_torch.__path__, "nmftpu_torch."):
    if m.name.endswith("__main__"):
        continue
    importlib.import_module(m.name)
    out[m.name] = bad()
print(json.dumps(out))
"""
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_the_tables_hold_reasons_and_renamed_targets_resolve():
    for key, why in TPU_ONLY.items():
        assert key[0] in MODULES and isinstance(why, str) and why, key
    for (mod, name), (path, why) in RENAMED.items():
        assert mod in MODULES and why, (mod, name)
        assert callable(_resolve(path)), path


@pytest.mark.parametrize("name", MODULES)
def test_the_twin_holds_the_modules_public_surface(name, forbidden_imports):
    ref = importlib.import_module(name)
    twin = importlib.import_module(_twin_name(name))
    gaps = []
    for attr in sorted(_public_names(ref)):
        if (name, attr) in TPU_ONLY:
            continue
        if (name, attr) in RENAMED:
            _resolve(RENAMED[name, attr][0])
            continue
        r = getattr(ref, attr)
        if not hasattr(twin, attr):
            gaps.append(f"name {attr}")
            continue
        t = getattr(twin, attr)
        if inspect.isclass(r):
            if not inspect.isclass(t):
                gaps.append(f"{attr} is not a class")
                continue
            gaps += _class_gaps(r, t)
        elif inspect.isfunction(r):
            gaps += _parameter_gaps(r, t)
    assert not gaps, f"{_twin_name(name)} lacks: {gaps}"
    # the twin (and the package, imported first) brings in no jax/nmftpu
    twin_name = _twin_name(name)
    if not twin_name.endswith("__main__"):
        assert forbidden_imports["nmftpu_torch"] == []
        assert forbidden_imports[twin_name] == [], forbidden_imports[twin_name]
