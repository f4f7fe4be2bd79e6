"""Cells of the benchmark at a size the CPU holds: the harness's whole run
but its look for a card, with the cells' own limits and smaller samples,
warmed by the traffic's calls alone."""
import json
import time
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
# particles a cell: enough on the cube for a chunk of tiles a shard
N = {"cube_weak4.sharded": 65536}


def limits(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "limits"
                       / f"{name}.json").read_text())


def run(name: str, seed: int = 2**31 + 5, control: str = None) -> dict:
    cell = harness.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                        name)
    cell.limits = dict(cell.limits, targets=64, step_targets=16)
    # the card's start-up floor on warm-up seconds is no part of a CPU run
    cell.traffic = dict(cell.traffic, warm_s=0)
    result, _ = harness.run_cell(cell, seed, 0.0, False, time.perf_counter(),
                                 device="cpu", n=N.get(name, 8192),
                                 control=control)
    return result
