"""`correct` at a size the CPU runs: a sound run of every cell comes out
correct; the control (the reference in the precision below the
configuration's, in the program's place) and every fault planted under
the timed path come out not correct against the cell's own limits. The
look for a card is skipped (device="cpu"); the rest of a run is driven
as `run.py` drives it."""

import json
import time

import pytest
from conftest import ROOT

from benchmark import faults, harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 77


def _kind(cell):
    return harness.find_cell(ROOT, cell).traffic["kind"]


def _run(root, cell, trace=False):
    return harness.run_cell(root, cell, SEED, 0.3, trace,
                            time.perf_counter(), device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell):
    c = harness.find_cell(tiny_root, cell)
    ctx = harness.Ctx(c, SEED, harness.device_for(c, "cpu"))
    state = c.kind.setup(ctx)
    rec = c.kind.window(state, 0.2, None)
    c.kind.release(state)
    numbers = c.kind.compare(state, c.kind.control(state, rec, c.reference),
                             c.reference)
    checks = harness.judged(numbers, c.limits)
    assert not harness.is_correct(checks), checks


FAULTS = [(cell, f) for cell in CELLS
          for f in (faults.TRAINING if _kind(cell) == "train_fits"
                    else faults.SERVING)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    with faults.planted(_kind(cell), fault):
        out = _run(tiny_root, cell)
    assert not out["correct"], out["checks"]
