"""On the card at each one-card cell's own size: a run is correct and the
control is not (python -m pytest portbench/tests -m card, on the chip;
the limits were set from portbench/readings.py over many seeds)."""
import json
import time
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("name", ["plummer8m.query", "coldcollapse8m.step"])
def test_the_control_fails_at_the_cells_size(card, name):
    cell = harness.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                        name)
    sound, _ = harness.run_cell(cell, 2**31 + 101, 1.0, False,
                                time.perf_counter())
    control, _ = harness.run_cell(cell, 2**31 + 101, 1.0, False,
                                  time.perf_counter(),
                                  control=cell.limits["control"])
    assert sound["correct"] and not control["correct"]
