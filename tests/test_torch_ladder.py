"""The accuracy ladder's rungs of orders 4 and 6 (a: o4/s2 monopole; b:
o6/s3 quadrupole at theta 0.75; c: rung b through the shared traversal)
through rakau_tpu and the port on one tree (tests/ladder_cases.py), and
the ladder's bounds on their errors in both packages. Then the integer
choices of `chip_smoke.py`'s group accuracy at the reference's sizes,
held to the reference's with no tree built: the leaf-grid level of
lmac8m (8,388,608 particles, level 6 by the occupancy rule), of
lmac8m_l7 and of every rung at 1,048,576, the tile capacity, and the
slicing of the live chunks (engine._slices against the reference's
acc_pot_u_host loop, tests/test_torch_scale.py's stand-in tree). The
order-8 rungs are in tests/test_torch_ladder_o8.py (d) and
tests/test_torch_ladder_o8s4.py (e)."""
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from rakau_tpu import grid2 as r_grid2
from rakau_tpu.config import TreeConfig as RConfig
from rakau_tpu_torch import engine, grid2
from rakau_tpu_torch.config import TreeConfig
from tests import ladder_cases
from tests.test_torch_scale import reference_slices

torch.set_num_threads(1)


@pytest.mark.parametrize("rung", ("a", "b", "c"))
def test_rung_matches_the_reference(rung):
    ladder_cases.check_rung(rung)


def test_ladder_bounds_hold_in_both_packages():
    """chip_smoke.ladder_bounds on rungs a, b, c (a under the Plummer
    bound, b under the reference's gate and at most 1.1 x the shared
    traversal's c) hold for both packages' errors here as on the card."""
    for side in ("ref", "port"):
        f = {r: ladder_cases.both_rung(r)[side]["force_rms"]
             for r in "abc"}
        held = chip_smoke.ladder_bounds(f)
        assert len(held) == 3 and all(held.values()), (side, f, held)


# the group's configurations and sizes: lmac8m, its shared engine beside
# it, lmac8m_l7, and the ladder's rungs
GROUP = {
    "lmac8m": (dict(chip_smoke.LMAC_KW), chip_smoke.ACC8M_N),
    "lmac8m shared": (dict(chip_smoke.LMAC_KW, traversal_mode="shared",
                           frontier_cap=chip_smoke.TREE_KW["frontier_cap"]),
                      chip_smoke.ACC8M_N),
    "lmac8m_l7": (dict(chip_smoke.LMAC_KW, grid_level=chip_smoke.ACC8M_L7),
                  chip_smoke.ACC8M_N),
    **{f"rung {r}": (chip_smoke.rung_kw(r), chip_smoke.ACC_N)
       for r in chip_smoke.ACC_RUNGS},
}


@pytest.mark.parametrize("name", list(GROUP))
def test_grid_level_and_tile_capacity_are_the_reference_s(name):
    kw, n = GROUP[name]
    cfg, rcfg = TreeConfig(**kw), RConfig(**kw)
    assert (grid2.effective_grid_level(cfg, n)
            == r_grid2.effective_grid_level(rcfg, n))
    assert cfg.tile_capacity(n) == rcfg.tile_capacity(n)


def test_the_group_s_grid_levels():
    """lmac8m's leaf grid is level 6 (round(log8(2^23 / 32))), one deeper
    than the 1M ladder's 5; lmac8m_l7 sets 7, grid2's 3-D cap."""
    levels = {name: grid2.effective_grid_level(TreeConfig(**kw), n)
              for name, (kw, n) in GROUP.items()}
    assert levels["lmac8m"] == levels["lmac8m shared"] == 6
    assert levels["lmac8m_l7"] == chip_smoke.ACC8M_L7 == 7
    assert {levels[f"rung {r}"] for r in chip_smoke.ACC_RUNGS} == {5}


@pytest.mark.parametrize("fill", ("least", "typical", "full"))
@pytest.mark.parametrize("name", ("lmac8m", "rung a"))
def test_slices_are_the_reference_s(name, fill, monkeypatch):
    """The port's slices of lmac8m's live chunks and of a rung's (every
    rung has the same tile table) start where the reference's do and hold
    as many chunks, at the fewest tiles, the typical ~1.3 n / ncrit and a
    full table: at 8,388,608 about 21 slices of 32 chunks."""
    kw, n = GROUP[name]
    cfg = TreeConfig(**kw)
    capacity = cfg.tile_capacity(n)
    n_tiles = {"least": -(-n // cfg.ncrit),
               "typical": int(1.3 * n / cfg.ncrit),
               "full": capacity}[fill]
    td = SimpleNamespace(tile_begin=torch.empty(capacity),
                         n_tiles=torch.tensor(n_tiles))
    live = engine.live_chunks(td, cfg)
    ours = engine._slices(live, cfg.tile_chunk)
    want = reference_slices(kw, n_tiles, capacity, monkeypatch)
    assert [(start, K) for _, start, K in ours] == want
    assert engine.evaluated_chunks(live, cfg.tile_chunk) == sum(
        K for _, K in want)
    if name == "lmac8m" and fill == "typical":
        assert len(ours) == 21 and ours[0][2] == 32
