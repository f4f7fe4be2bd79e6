"""`correct` on the CPU at a tiny size, with each cell's own limits: true
on a sound run, false under the control (the program's bf16 tensor-core
form of K1 in K1a's place) and under each fault a cell can have, planted
in the timed path."""
import pytest

from portbench import faults
from portbench.tests import tiny

CELLS = ("plummer8m.query", "coldcollapse8m.step", "cube_weak4.sharded")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = tiny.run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert {"setup_s", "force_err_rms"} <= set(r["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    r = tiny.run(name, control=tiny.limits(name)["control"])
    assert not r["correct"], r["checks"]


FAULTS = [("plummer8m.query", "half_left_out"),
          ("plummer8m.query", "answer_altered"),
          ("coldcollapse8m.step", "state_unchanged"),
          ("coldcollapse8m.step", "half_left_out"),
          ("coldcollapse8m.step", "answer_altered"),
          ("coldcollapse8m.step", "second_query_left_out"),
          ("cube_weak4.sharded", "exchange_left_out"),
          ("cube_weak4.sharded", "answer_altered")]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f}" for n, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = tiny.run(name)
    assert not r["correct"], r["checks"]
