"""The integer choices of the port's runs at the reference's own sizes,
held to the reference's with no tree built: bench.py's headline of
8,000,000 Plummer particles (bench.py:38-39) and BASELINE config #2's
1 << 23 (benchmarks/configs.py:90), in the configurations that
`chip_smoke.py`'s phase group `scale` runs there (shared+grid, gwalk+grid,
config #2's step and energy query), and the grid2 ones beside them.

Each is exact: the tile capacity, the leaf-grid levels of `grid` and
`grid2`, and the slicing of a query's live chunks into sliced graphs
(`engine._slices` against the loop of the reference's
`rakau_tpu.engine.acc_pot_u_host`, run on a stand-in tree whose slices
only record where they start).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rakau_tpu import engine as r_engine
from rakau_tpu import grid as r_grid
from rakau_tpu import grid2 as r_grid2
from rakau_tpu.config import TreeConfig as RConfig
from rakau_tpu_torch import engine, grid, grid2
from rakau_tpu_torch.config import TreeConfig

torch.set_num_threads(1)

SIZES = (chip_smoke.SCALE_N, chip_smoke.SCALE_LF_N)


def configs(n: int) -> dict:
    """The configurations run at the reference's sizes, as keyword
    arguments both packages' TreeConfig take."""
    lf = dict(chip_smoke.LF_KW)
    return {
        "shared+grid": dict(chip_smoke.TREE_KW),
        "gwalk+grid": dict(chip_smoke.gwalk_kw(n), farfield="grid"),
        "config2 step": lf,
        "config2 energy": dict(lf, multipole_order=2, accum="compensated",
                               farfield="m2p"),
        "shared+grid2": dict(chip_smoke.TREE_KW, **chip_smoke.GRID2_KW),
        "gwalk+grid2": dict(chip_smoke.gwalk_kw(n), **chip_smoke.GRID2_KW),
        "lmac+grid2": dict(chip_smoke.LMAC_KW),
    }


NAMES = tuple(configs(SIZES[0]))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_tile_capacity_is_the_reference_s(name, n):
    kw = configs(n)[name]
    assert (TreeConfig(**kw).tile_capacity(n)
            == RConfig(**kw).tile_capacity(n))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_grid_levels_are_the_reference_s(name, n):
    kw = configs(n)[name]
    cfg, rcfg = TreeConfig(**kw), RConfig(**kw)
    assert (grid.effective_grid_level(cfg, n)
            == r_grid.effective_grid_level(rcfg, n))
    assert (grid2.effective_grid_level(cfg, n)
            == r_grid2.effective_grid_level(rcfg, n))


def test_the_headline_grid_level_is_deeper_than_at_1m():
    """At 8,000,000 / ncrit 512 the dense far field runs at level 4, one
    deeper than the 1M runs' 3 (effective_grid_level's floor of
    log8(n / ncrit))."""
    cfg = TreeConfig(**chip_smoke.TREE_KW)
    assert grid.effective_grid_level(cfg, chip_smoke.SCALE_N) == 4
    assert grid.effective_grid_level(cfg, 1 << 20) == 3


def reference_slices(kw: dict, n_tiles: int, capacity: int,
                     monkeypatch) -> list:
    """(first chunk, chunks) of each slice that the reference's
    acc_pot_u_host dispatches for a tree of `n_tiles` tiles in a table of
    `capacity`: its per-tree state, slice executable and assembly replaced
    by stand-ins (the slice records its arguments and returns empty
    rows), its loop unchanged."""
    cfg = RConfig(**kw)
    CH = min(cfg.tile_chunk, capacity)
    chunks = -(-capacity // CH)
    seen = []

    def query_state(td, cfg, eps):
        return (np.zeros((chunks, CH)),), None, None

    def slice_query(td, cfg, theta, eps, G, tiles, tables, Lgrid, start, K,
                    mode="both"):
        seen.append((int(start), int(K)))
        rows = jnp.zeros((K, 0), jnp.float32)
        return rows, rows, jnp.zeros(4, bool), jnp.zeros(4, jnp.int32)

    monkeypatch.setattr(r_engine, "_query_state", query_state)
    monkeypatch.setattr(r_engine, "_slice_query_jit", slice_query)
    monkeypatch.setattr(r_engine, "_assemble_jit",
                        lambda td, cfg, a, p: (a, p))
    monkeypatch.setattr(r_engine, "_far_jit", lambda td, cfg, eps, G: (0, 0))
    td = SimpleNamespace(pos=jnp.zeros((1, 3), jnp.float32),
                         n_tiles=n_tiles)
    r_engine.acc_pot_u_host(td, cfg, 0.75, 0.0)
    return seen


# the sliced configurations and their sizes (gwalk runs one executable)
SLICED = (("shared+grid", chip_smoke.SCALE_N),
          ("config2 step", chip_smoke.SCALE_LF_N),
          ("config2 energy", chip_smoke.SCALE_LF_N),
          ("lmac+grid2", chip_smoke.SCALE_N))


@pytest.mark.parametrize("fill", ("least", "typical", "full"))
@pytest.mark.parametrize("name,n", SLICED)
def test_slices_are_the_reference_s(name, n, fill, monkeypatch):
    """The port's slices of the live chunks (engine.live_chunks, then
    engine._slices) start where the reference's do and hold as many
    chunks, for a tree of the fewest tiles the build can make (n / ncrit),
    of the ~1.3 n / ncrit the build typically makes, and of a full tile
    table."""
    kw = configs(n)[name]
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
    # every live chunk is in exactly one slice's new chunks
    assert [s for s, _, _ in ours] == list(range(0, live, ours[0][2]))


@pytest.mark.parametrize("eps", (0.0, 0.02))
def test_the_card_oracle_is_the_numpy_direct_sum(eps):
    """chip_smoke.card_oracle, the float64 direct sum that phase scale runs
    on the card at sampled targets (in passes of ORACLE_CHUNK), against
    direct_acc_pot_np on the same targets: within ORACLE_RTOL, the bound
    chip_smoke holds it to on the card."""
    from rakau_tpu_torch import direct_acc_pot_np, particles
    n = 3000
    pos, mass = particles.plummer(
        n, generator=torch.Generator().manual_seed(5))
    samp = np.sort(np.random.default_rng(6).choice(n, 37, replace=False))
    acc_o, pot_o = chip_smoke.card_oracle(pos, mass, samp, eps)
    check = chip_smoke.oracle_check(pos, mass, samp, acc_o, pot_o, eps)
    acc_n, pot_n = direct_acc_pot_np(pos.double().numpy(),
                                     mass.double().numpy(), eps=eps,
                                     targets=samp)
    rel = np.linalg.norm(acc_o - acc_n, axis=1) / np.linalg.norm(acc_n,
                                                                 axis=1)
    assert rel.max() <= chip_smoke.ORACLE_RTOL
    assert (np.abs(pot_o - pot_n) / np.abs(pot_n)).max() \
        <= chip_smoke.ORACLE_RTOL
    assert check["targets"] == chip_smoke.ORACLE_CHECK
