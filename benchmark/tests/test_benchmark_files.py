"""BENCHMARK.json and the files it names: every cell resolves to its
configuration, traffic, kind, reference, limits and metric readers by
name; names and units keep to their characters; nothing under the
benchmark imports JAX or the JAX package, and the references import
nothing of the program; a new cell is files and entries alone; the tiny
copy is cut by each file's own `tiny` sizes."""

import ast
import json
import re
import shutil
import time

import pytest
from conftest import ROOT, check_resolves, copy_bench, make_tiny, shrink

from benchmark import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    check_resolves(ROOT, cell)


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted((ROOT / "benchmark").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_and_a_plain_reference(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops
    if path.parent.name == "reference":
        assert "nmftpu_torch" not in tops, tops


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nmftpu_torch_lookalike",
                        types.ModuleType("x"))
    assert "nmftpu_torch_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nmftpu.sub", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["nmftpu.sub"]


DUMMY_METRIC = '''
def read(rec):
    return float(rec["requests"])
'''


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as
    files and entries alone, run as a cell of their own."""
    root = make_tiny(tmp_path)
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "text2image10m.json").read_text())
    cfg.update(name="catalog_small")
    cfg["data"].update(n_items=3000, rank=16)
    (b / "configs" / "catalog_small.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "serve-b512.json").read_text())
    tr.update(batch=16, k=5)
    (b / "traffic" / "serve-b16.json").write_text(json.dumps(tr))
    (b / "metrics" / "requests.serve.py").write_text(DUMMY_METRIC)
    shutil.copy(b / "limits" / "text2image10m.serve-b512.json",
                b / "limits" / "catalog_small.serve-b16.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "catalog_small", "source": "a test",
                             "file": "benchmark/configs/catalog_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "catalog_small.serve-b16",
                               "config": "catalog_small",
                               "traffic": "serve-b16", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("catalog_small.serve-b16")
    bench["per_layer"].append({"name": "requests.serve", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving", "moves": "serve_qps",
                               "workloads": ["catalog_small.serve-b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run_cell(root, "catalog_small.serve-b16", 7, 0.3, True,
                           time.perf_counter(), device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests.serve"]["value"] >= 1
    out = harness.run_cell(root, "catalog_small.serve-b16", 7, 0.3, False,
                           time.perf_counter(), device="cpu")
    assert set(out["metrics"]) == {"serve_qps", "serve_p95_ms", "setup_s"}


def test_the_tiny_copy_takes_each_files_own_sizes(tiny_root):
    """`make_tiny` merges each configuration's and traffic mix's `tiny`
    object over it."""
    for sub in ("configs", "traffic"):
        for path in sorted((ROOT / "benchmark" / sub).glob("*.json")):
            full = json.loads(path.read_text())
            got = json.loads((tiny_root / "benchmark" / sub
                              / path.name).read_text())
            for key, value in full["tiny"].items():
                if isinstance(value, dict):
                    assert got[key] == {**full[key], **value}, key
                else:
                    assert got[key] == value, key
    assert json.loads((tiny_root / "benchmark" / "configs"
                       / "ml20m.json").read_text())["data"]["n_users"] < 1000


def test_a_file_without_tiny_sizes_is_refused(tmp_path):
    root = copy_bench(tmp_path)
    path = root / "benchmark" / "traffic" / "train-kl.json"
    d = json.loads(path.read_text())
    del d["tiny"]
    path.write_text(json.dumps(d))
    with pytest.raises(KeyError, match="tiny"):
        shrink(root)


def test_run_refuses_without_a_card():
    import torch

    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2


@pytest.mark.parametrize("loads_jax", [False, True],
                         ids=["clean", "a-reader-loads-jax"])
def test_run_prints_no_result_once_jax_is_loaded(tmp_path, monkeypatch,
                                                 capsys, loads_jax):
    """`run.main` looks at sys.modules after every per-layer reader has
    run: a reader that loads a module named `jax` (a stub here) leaves
    the run with exit code 3 and no result line."""
    import os
    import sys

    import torch

    from benchmark import run

    root = make_tiny(tmp_path / "root")
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    monkeypatch.setattr(sys, "path", list(sys.path))
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    if loads_jax:
        reader = root / "benchmark" / "metrics" / "fallback_rows.serve.py"
        reader.write_text("import jax  # noqa: F401\n"
                          + reader.read_text())
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(harness, "device_for",
                        lambda cell, device=None: torch.device("cpu"))
    cell = next(w["name"] for w in BENCH["workloads"]
                if harness.find_cell(ROOT, w["name"]).traffic["kind"]
                == "serve_closed")
    try:
        rc = run.main(["--workload", cell, "--seed", str(2**31 + 5),
                       "--seconds", "0.3", "--trace", "1"])
        imported = "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    if loads_jax:
        assert imported
        assert rc == 3 and out == "", out
        assert "imported jax" in err
    else:
        assert rc == 0
        line = json.loads(out.strip().splitlines()[-1])
        assert line["correct"] and list(line)[-1] == "checks"
