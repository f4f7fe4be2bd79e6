"""The benchmark's rebuild traffic on the CPU at small sizes: the driver of
`Tree.update_positions_o` + `Tree.accs_pots_o` (portbench/drivers/
tree.update_accs_pots_o.py) on the Plummer and the disk configurations,
its calls alternating between the drifted and the drawn set, judged
`correct` with no order error, and not correct under its control or a
fault planted in the update path; the disk's frozen law drawing what the
program's does; K1b's frozen count equal to chip_smoke.py's `bound`; the
port's Tree on a 16,384-particle disk, updated and queried, within the
disk's error envelope; the theta-0 precision probe reading a smaller
potential error compensated than in fp32."""
import json
import time
from pathlib import Path

import pytest
import torch

import chip_smoke
from portbench import entries, harness, inputs_disk, roofline_k1b
from portbench.reference.direct import direct_sum
from rakau_tpu_torch import engine, octree, particles
from rakau_tpu_torch import tree as tree_mod
from rakau_tpu_torch.config import TreeConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = ("plummer8m.rebuild", "disk64m.rebuild")
N = 4096
SEED = 2**31 + 5
DRIVER = "tree.update_accs_pots_o"
probe = entries.load("drivers", DRIVER, "probe")


def _cell(name: str, targets: int = 64):
    cell = harness.Cell(BENCH, name)
    cell.limits = dict(cell.limits, targets=targets)
    # no warm-up: the card's start-up floor is no part of a CPU run, and
    # a window call on the drifted set is the judged one
    cell.traffic = dict(cell.traffic, warm_calls=0, warm_s=0)
    return cell


def _run(name: str, control: str = None, targets: int = 64) -> dict:
    result, _ = harness.run_cell(_cell(name, targets), SEED, 0.0, False,
                                 time.perf_counter(), device="cpu", n=N,
                                 control=control)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_three_calls_alternate_and_are_judged(name):
    cell = _cell(name)
    entry = entries.make(cell.config, cell.traffic, cell.limits, SEED,
                         "cpu", N)
    entry.setup()
    for _ in range(3):
        entry.call()
    assert [r[0] for r in entry.records] == [True, False, True]
    want = entry.positions(True)
    assert torch.equal(entry.tree.positions_o, want)
    assert not torch.equal(want, entry.positions(False))
    checks, diag = entry.judge()
    assert diag["calls_judged"] == 3 and diag["sets_judged"] == 2
    assert checks["order_bad"] == 0
    assert set(checks) == set(cell.limits["checks"])
    assert all(v <= cell.limits["checks"][k] for k, v in checks.items())
    assert {**checks, **diag}["answer_max"] > 0


@pytest.mark.parametrize("warm_calls", [1, 2])
def test_the_warm_up_takes_an_even_number_of_calls(warm_calls):
    """However many calls the clock lets the warm-up make, the window
    opens on P + D after a call on P, none of the warm calls judged."""
    cell = _cell("plummer8m.rebuild")
    cell.traffic["warm_calls"] = warm_calls
    entry = entries.make(cell.config, cell.traffic, cell.limits, SEED,
                         "cpu", N)
    entry.setup()
    assert entry.turn == 2 and entry.calls == 0 and not entry.records
    assert len(entry.info["warm_call_s"]) == 2
    entry.call()
    assert [r[0] for r in entry.records] == [True]


def test_the_probe_runs_the_windows_config(monkeypatch):
    """comp_pot_max is read with the TreeConfig the window's tree ran,
    grown caps included, not the configuration's as written."""
    cell = _cell("disk64m.rebuild")
    entry = entries.make(cell.config, cell.traffic, cell.limits, SEED,
                         "cpu", N)
    entry.setup()
    entry.call()
    grown = entry.tree.config.with_(
        p2p_leaf_cap=2 * entry.tree.config.p2p_leaf_cap)
    entry.tree._cfg = grown
    seen = []
    monkeypatch.setitem(type(entry).judge.__globals__, "probe",
                        lambda *a: seen.append(a[2]) or 0.0)
    entry.judge()
    assert seen == [grown] and grown != entry.cfg0


def test_the_control_sum_is_finite_where_positions_coincide():
    """lower_sum in bfloat16 leaves out a pair that coincides once
    rounded, where direct_sum's is NaN; in float64 on distinct positions
    it is direct_sum."""
    lower_sum = entries.load("drivers", DRIVER, "lower_sum")
    g = torch.Generator().manual_seed(7)
    pos = torch.rand(512, 3, generator=g, dtype=torch.float64) + 1.0
    pos[1] = pos[0] + 1e-4
    mass = torch.full((512,), 1 / 512, dtype=torch.float64)
    samp = torch.arange(0, 512, 8)
    tgt = (pos, mass, pos[samp], samp, 0.0, 1.0)
    bad = direct_sum(*tgt, dtype=torch.bfloat16)
    assert not torch.isfinite(bad[1]).all()
    for got in lower_sum(*tgt, dtype=torch.bfloat16):
        assert torch.isfinite(got).all()
    for got, want in zip(lower_sum(*tgt, dtype=torch.float64),
                         direct_sum(*tgt)):
        assert torch.allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert {"setup_s", "evals_per_s", "force_err_rms"} <= set(r["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """Every target judged. The disk's control, the reference in
    bfloat16 in the program's place, is not correct by its precision
    probe, as at 64M."""
    r = _run(name, control=harness.Cell(BENCH, name).limits["control"],
             targets=N)
    assert not r["correct"], r["checks"]


def _inverse_is_the_permutation(perm):
    return perm.clone()


def _update_skipped(self, new_positions):
    pass


FAULTS = {"order_lost": ("_inverse", _inverse_is_the_permutation),
          "update_skipped": ("update_positions_o", _update_skipped)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_update_path_is_not_correct(fault, monkeypatch):
    name, fn = FAULTS[fault]
    monkeypatch.setattr(tree_mod if name == "_inverse" else tree_mod.Tree,
                        name, fn)
    r = _run("plummer8m.rebuild")
    assert not r["correct"] and r["checks"]["order_bad"]["value"] > 0


def test_the_disk_law_draws_what_the_program_draws():
    a = torch.Generator().manual_seed(SEED)
    b = torch.Generator().manual_seed(SEED)
    pos, mass = inputs_disk.disk_galaxy(N, a, rscale=1.0, zscale=0.05)
    want_pos, want_mass = particles.disk_galaxy(N, generator=b)
    assert torch.equal(pos, want_pos) and torch.equal(mass, want_mass)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


def test_k1b_count_is_chip_smokes_bound():
    cell = harness.Cell(BENCH, "disk64m.rebuild")
    pos, mass = inputs_disk.disk_galaxy(
        8192, torch.Generator().manual_seed(3))
    cfg = TreeConfig(**cell.config["tree"])
    td = engine.build_tree(pos, mass, cfg)
    chunks = engine.live_chunks(td, cfg)
    for c in sorted({0, chunks // 2, chunks - 1}):
        inp = engine.kernel_inputs(td, cfg, 0.75, 0.0, c)[:6]
        # a ragged row: S not a whole number of granules
        ragged = inp[:2] + tuple(t[:-37] for t in inp[2:5]) \
            + (inp[5][:, :-37].contiguous(),)
        for args in (inp, ragged):
            s, by = roofline_k1b.k1b_bound(args, 8192)
            ms, by_smoke = chip_smoke.bound(args, 8192, comp=True)
            assert s * 1e3 == pytest.approx(ms, rel=1e-9)
            assert by == by_smoke


def test_an_updated_disk_tree_stays_in_the_disks_envelope():
    """16,384 disk particles through the cell's TreeConfig, updated to
    P + D and queried: the RMS errors at 1,024 targets stay under those
    the disk reads at 65,536 (tests/test_torch_configs.py's DISK_ERRORS:
    force 1.911e-2, potential 6.027e-3; 1.303e-2 / 3.199e-3 at 8,192), as
    the disk's error grows with N."""
    n = 16384
    cell = harness.Cell(BENCH, "disk64m.rebuild")
    entry = entries.make(cell.config, cell.traffic, cell.limits, SEED,
                         "cpu", n)
    pos, mass = entry.particles()
    x = pos + entry.drift()
    t = octree(coords=pos, masses=mass, device="cpu",
               config=TreeConfig(**cell.config["tree"]))
    t.update_positions_o(x)
    acc, pot = t.accs_pots_o(0.75)
    samp = torch.randperm(n, generator=torch.Generator().manual_seed(1))[
        :1024].sort().values
    ref_acc, ref_pot = direct_sum(x, mass, x[samp], samp)
    f = (torch.linalg.norm(acc[samp].double() - ref_acc, dim=1)
         / torch.linalg.norm(ref_acc, dim=1))
    p = (pot[samp].double() - ref_pot).abs() / ref_pot.abs()
    assert float(f.square().mean().sqrt()) < 1.911e-2
    assert float(p.square().mean().sqrt()) < 6.027e-3


def test_the_probe_reads_compensated_below_fp32():
    cell = harness.Cell(BENCH, "disk64m.rebuild")
    entry = entries.make(cell.config, cell.traffic, cell.limits, SEED,
                         "cpu", N)
    pos, mass = entry.particles()
    cfg = TreeConfig(**cell.config["tree"])
    comp = probe(pos, mass, cfg, SEED, 0.0, 1.0)
    fp32 = probe(pos, mass, cfg.with_(accum="fp32"), SEED, 0.0, 1.0)
    assert 0 < comp < fp32
