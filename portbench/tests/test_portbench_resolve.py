"""BENCHMARK.json resolves: every cell's configuration, traffic, limits
and metrics are files found by name, and the file keeps the contract's
shape."""
import json
import re
from pathlib import Path

import pytest

from portbench import entries, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_resolves(name):
    cell = harness.Cell(BENCH, name)
    assert issubclass(entries.load("drivers", cell.traffic["driver"],
                                   "Driver"), entries.Entry)
    assert cell.limits["checks"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_each_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric))


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(NAME.match(x.replace(" ", "_")) for x in layers)
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and c["source"] == conf["source"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_file_of_every_kind_is_found_by_name():
    used = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(used) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
