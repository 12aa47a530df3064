"""`correct` at a size the CPU runs: a sound run of every cell comes out
correct; the control (the reference in the precision below the
configuration's, in the program's place) and every fault that the cell's
kind declares, planted under the timed path, come out not correct
against the cell's own limits. The look for a card is skipped
(device="cpu"); the rest of a run is driven as `run.py` drives it."""

import json

import pytest
from conftest import (ROOT, check_control, check_fault, check_sound,
                      kind_faults)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    check_sound(tiny_root, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell):
    check_control(tiny_root, cell)


FAULTS = [(cell, f) for cell in CELLS for f in kind_faults(ROOT, cell)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    check_fault(tiny_root, cell, fault)
