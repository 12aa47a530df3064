"""A new configuration, traffic mix, kind of training rule, reference,
limits and per-layer metric join the benchmark as new files and entries
alone, and the benchmark's own checks run on the new cell.

In a copy of the benchmark, the files under `new_kind/` are added: a
configuration (`weighted_ratings`), a traffic mix of a new kind
(`train_weighted`: confidence-weighted MU, `alpha_confidence` 40, a rule
no cell runs) built on `train_fits`'s class, that kind's plain
reference, the cell's limits, and a per-layer metric that reads a
program span and a counter. BENCHMARK.json gains entries and list items
only. No file the copy had changes; then the cell is cut to its tiny
sizes and held to what every cell is held to."""

import json
from pathlib import Path

import pytest
from conftest import (check_control, check_fault, check_resolves,
                      check_sound, check_span_metrics, check_stages,
                      copy_bench, shrink)

from benchmark import harness

FIXTURE = Path(__file__).resolve().parent / "new_kind"
CELL = "weighted_ratings.train-weighted"
METRIC = "check_launches.weighted"
# the training metrics that already exist and now list the new cell too
TRAINING = ("iter_ms", "idle_share.train", "device_ms.train", "mfu.train",
            "check_ms.train", "fit_idle_ms.train", "update_idle_ms.train")


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _appended_only(old, new, where="BENCHMARK.json") -> list[str]:
    """Where `new` differs from `old` by more than items appended to
    lists: each such place, by its path."""
    if isinstance(old, dict):
        if not isinstance(new, dict) or set(old) != set(new):
            return [where]
        return [w for k in old for w in _appended_only(old[k], new[k],
                                                        f"{where}.{k}")]
    if isinstance(old, list):
        if not isinstance(new, list) or len(new) < len(old):
            return [where]
        return [w for i, o in enumerate(old)
                for w in _appended_only(o, new[i], f"{where}[{i}]")]
    return [] if old == new else [where]


def _add_cell(root: Path) -> None:
    """The new cell's files and entries, as a later change would add
    them."""
    for src in sorted(FIXTURE.rglob("*")):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = root / "benchmark" / src.relative_to(FIXTURE)
            if dst.exists():
                raise FileExistsError(dst)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(src.read_bytes())
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["configs"].append({
        "name": "weighted_ratings", "source": "a test of the harness",
        "file": "benchmark/configs/weighted_ratings.json", "reduced": [],
        "why": "ML-20M's shape under confidence weighting"})
    bench["workloads"].append({
        "name": CELL, "config": "weighted_ratings",
        "traffic": "train-weighted", "chips": 1,
        "why": "back-to-back confidence-weighted MU fits on the ELL plan"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in TRAINING:
            m["workloads"].append(CELL)
    bench["per_layer"].append({
        "name": METRIC, "unit": "launches", "better": "lower",
        "source": "program_counter", "layer": "kernels",
        "moves": "iter_ms", "workloads": [CELL]})
    path.write_text(json.dumps(bench))


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """(the root with the new cell at its tiny sizes, the files of the
    copy that changed, the places BENCHMARK.json changed other than by
    appending)."""
    root = copy_bench(tmp_path_factory.mktemp("new_kind"))
    before = _files(root)
    _add_cell(root)
    after = _files(root)
    bench = Path("BENCHMARK.json")
    changed = sorted(str(p) for p in before
                     if p != bench and after.get(p) != before[p])
    edits = _appended_only(json.loads(before[bench]),
                           json.loads(after[bench]))
    return shrink(root), changed, edits


def test_the_cell_is_new_files_and_appended_entries(added):
    root, changed, edits = added
    assert changed == [], changed
    assert edits == [], edits
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert CELL in [w["name"] for w in bench["workloads"]]


def test_the_new_cell_resolves(added):
    check_resolves(added[0], CELL)
    assert harness.find_cell(added[0], CELL).config["rank"] == 16


def test_a_sound_run_is_correct_and_runs_the_weighted_rule(added,
                                                           monkeypatch):
    from nmftpu_torch import sparse_ell as SE

    calls = []
    real = SE.mu_update_frobenius_weighted_ell

    def counted(pair, W, H, alpha, **kw):
        calls.append(alpha)
        return real(pair, W, H, alpha, **kw)

    monkeypatch.setattr(SE, "mu_update_frobenius_weighted_ell", counted)
    check_sound(added[0], CELL)
    assert calls and set(calls) == {40.0}


def test_the_control_is_not_correct(added):
    check_control(added[0], CELL)


FAULTS = list(harness.load_module(FIXTURE / "kinds"
                                  / "train_weighted.py").KIND.FAULTS)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_declared_fault_is_not_correct(added, fault):
    check_fault(added[0], CELL, fault)


def test_a_traced_run_reduces_by_stage(added):
    out = check_stages(added[0], CELL)
    assert out["metrics"][METRIC] == 0.0        # no launch on the CPU


def test_the_metric_is_on_the_result_line(added):
    out = check_span_metrics(added[0], CELL)
    assert out["metrics"][METRIC] == {"value": 0.0, "unit": "launches"}
    assert "check_ms.train" in out["metrics"]
