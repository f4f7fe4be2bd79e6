"""On the card at each one-card cell's own size: the program's spans hold
the device time of a warm traced call, no span there is a capture, and
the span metrics read numbers (python -m pytest portbench/tests -m card,
on the chip)."""
import json
import time
from pathlib import Path

import pytest

from portbench import harness, spans

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("name", ["plummer8m.query", "coldcollapse8m.step"])
def test_spans_hold_a_traced_call(card, name):
    cell = harness.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                        name)
    result, run = harness.run_cell(cell, 2**31 + 103, 1.0, True,
                                   time.perf_counter())
    st = spans.of(run)
    assert st.coverage() >= 0.99
    assert not st.span_intervals("graph.capture")
    assert spans.PREFIX + "graph.capture" not in run.trace.host_names
    mine = [m["name"] for m in cell.per_layer
            if m["source"] == "program_span"]
    assert mine and all(m in result["metrics"] for m in mine)
    assert result["correct"]
