"""rakau_tpu_torch.traversal2 against rakau_tpu.traversal2 on one
JAX-built tree handed over through rakau_tpu_torch.convert: per chunk,
the shared source row (positions, masses, indices), the per-tile masks,
the counts, overflow flags and maxima must be exactly equal, for the bh
and bh_geom MACs with the local and grid far fields, and with grid2 (the
drop test against the tile's cell range, the emitted source cells and the
quadrupole rows beside them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu import traversal2 as jt2
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import traversal2
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 2048
THETA = 0.6
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))


def plummer_np(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


@pytest.mark.parametrize("mac", ["bh", "bh_geom"])
@pytest.mark.parametrize("farfield", ["local", "grid"])
def test_shared_sources_match_jax(mac, farfield):
    kw = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=8,
              m2p_cap=1024, p2p_leaf_cap=256, p2p_src_cap=4096,
              frontier_cap=512, mac=mac, farfield=farfield)
    if farfield == "grid":
        kw["grid_level"] = 3
    jc = JaxConfig(**kw)
    cfg = config_from_jax(jc)
    pos, mass = plummer_np(N, 21)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    jtiles = jengine._gather_tiles(jtd, jc)
    jtables = jt2.make_tables(jtd, jc)
    tables = traversal2.make_tables(td, cfg)
    jwalk = jax.jit(
        lambda blo, bhi, tcell, tvalid: jt2.build_shared_sources(
            jtd, jc, jnp.float32(THETA), blo, bhi, tables=jtables,
            tile_cell=tcell, tile_valid=tvalid))
    n_live = -(-int(jtd.n_tiles) // jc.tile_chunk)
    for ch in range(0, n_live, max(1, n_live // 5)):
        tpos, tidx, blo, bhi, tcell = (np.asarray(a[ch]) for a in jtiles)
        tvalid = tidx[:, 0] < N
        want = jwalk(jnp.asarray(blo), jnp.asarray(bhi),
                     jnp.asarray(tcell), jnp.asarray(tvalid))
        got = traversal2.build_shared_sources(
            td, cfg, THETA, torch.as_tensor(blo), torch.as_tensor(bhi),
            tables=tables, tile_cell=torch.as_tensor(tcell).long(),
            tile_valid=torch.as_tensor(tvalid))
        wmask = np.asarray(want.mask)
        gmask = got.mask.numpy()
        bad = np.argwhere(gmask != wmask)
        assert not len(bad), (
            f"chunk {ch}: masks differ at (tile, row) {bad[:10].tolist()}; "
            "sources there: " + str(
                [(got.pos[r].tolist(), float(got.mass[r]), int(got.idx[r]))
                 for _, r in bad[:5]]))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
        np.testing.assert_array_equal(got.mass.numpy(),
                                      np.asarray(want.mass))
        assert int(got.count) == int(want.count)
        np.testing.assert_array_equal(got.overflow.numpy(),
                                      np.asarray(want.overflow))
        np.testing.assert_array_equal(got.maxima.numpy(),
                                      np.asarray(want.maxima))
        assert gmask.any()


def test_small_caps_set_the_overflow_flags_like_jax():
    kw = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=8,
              m2p_cap=64, p2p_leaf_cap=16, p2p_src_cap=64,
              frontier_cap=8)
    jc = JaxConfig(**kw)
    cfg = config_from_jax(jc)
    pos, mass = plummer_np(N, 22)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    tpos, tidx, blo, bhi, tcell = (np.asarray(a[1])
                                   for a in jengine._gather_tiles(jtd, jc))
    want = jt2.build_shared_sources(jtd, jc, jnp.float32(0.3),
                                    jnp.asarray(blo), jnp.asarray(bhi))
    got = traversal2.build_shared_sources(td, cfg, 0.3,
                                          torch.as_tensor(blo),
                                          torch.as_tensor(bhi))
    assert np.asarray(want.overflow).sum() >= 3
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    np.testing.assert_array_equal(got.maxima.numpy(),
                                  np.asarray(want.maxima))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("mac", ["bh", "bh_geom"])
def test_quad_rows_match_jax(mac):
    """multipole_order=2 with farfield='m2p': the M2P node rows carry
    their second moments (SharedSources.quad) in the same stable order as
    pos and mass, zero on invalid rows; masks, indices and counts stay
    exactly equal to the reference's."""
    kw = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=8,
              m2p_cap=1024, p2p_leaf_cap=256, p2p_src_cap=4096,
              frontier_cap=512, mac=mac, farfield="m2p", multipole_order=2)
    jc = JaxConfig(**kw)
    cfg = config_from_jax(jc)
    pos, mass = plummer_np(N, 23)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    jtiles = jengine._gather_tiles(jtd, jc)
    jtables = jt2.make_tables(jtd, jc)
    tables = traversal2.make_tables(td, cfg)
    jwalk = jax.jit(
        lambda blo, bhi, tvalid: jt2.build_shared_sources(
            jtd, jc, jnp.float32(THETA), blo, bhi, tables=jtables,
            tile_valid=tvalid))
    n_live = -(-int(jtd.n_tiles) // jc.tile_chunk)
    for ch in range(0, n_live, max(1, n_live // 4)):
        tpos, tidx, blo, bhi, _ = (np.asarray(a[ch]) for a in jtiles)
        tvalid = tidx[:, 0] < N
        want = jwalk(jnp.asarray(blo), jnp.asarray(bhi), jnp.asarray(tvalid))
        got = traversal2.build_shared_sources(
            td, cfg, THETA, torch.as_tensor(blo), torch.as_tensor(bhi),
            tables=tables, tile_valid=torch.as_tensor(tvalid))
        assert got.quad.shape == (cfg.m2p_cap, 6)
        np.testing.assert_array_equal(got.quad.numpy(), np.asarray(want.quad))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
        assert int(got.count) == int(want.count)
        ucnt = int(want.maxima[0])
        assert np.asarray(want.quad)[:ucnt].any()
        assert not got.quad[ucnt:].any()


@pytest.mark.parametrize("sep", [2, 3])
@pytest.mark.parametrize("order", [0, 2])
def test_grid2_sources_and_cells_match_jax(sep, order):
    """farfield='grid2': tiles span several leaf-grid cells, so the walk
    drops a node only when the tile's whole cell range is covered, and
    every source row carries its leaf cell. mask, idx, cell, quad, counts,
    flags and maxima exactly equal. cell on every row, padding included:
    node padding reads node 0 (cell 0), particle padding sits at the
    4 * box sentinel, which the cell map clamps to the last cell."""
    kw = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=8,
              m2p_cap=1024, p2p_leaf_cap=512, p2p_src_cap=4096,
              frontier_cap=512, farfield="grid2", grid_level=3,
              grid_sep=sep, local_order=3, multipole_order=order)
    jc = JaxConfig(**kw)
    cfg = config_from_jax(jc)
    pos, mass = plummer_np(N, 24)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    jtiles = jengine._gather_tiles(jtd, jc)
    assert len(jtiles) == 8
    from rakau_tpu_torch import engine
    tiles = engine._gather_tiles(td, cfg)
    assert len(tiles) == 8
    for got, want in zip(tiles, jtiles):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jtables = jt2.make_tables(jtd, jc)
    tables = traversal2.make_tables(td, cfg)
    jwalk = jax.jit(
        lambda blo, bhi, tvalid, clo, chi: jt2.build_shared_sources(
            jtd, jc, jnp.float32(THETA), blo, bhi, tables=jtables,
            tile_valid=tvalid, tcell_lo=clo, tcell_hi=chi))
    n_live = -(-int(jtd.n_tiles) // jc.tile_chunk)
    spans = 0
    for ch in range(0, n_live, max(1, n_live // 4)):
        _, tidx, blo, bhi, _, _, clo, chi = (np.asarray(a[ch])
                                             for a in jtiles)
        tvalid = tidx[:, 0] < N
        spans += int(((chi > clo).any(1) & tvalid).sum())
        want = jwalk(jnp.asarray(blo), jnp.asarray(bhi), jnp.asarray(tvalid),
                     jnp.asarray(clo), jnp.asarray(chi))
        got = traversal2.build_shared_sources(
            td, cfg, THETA, torch.as_tensor(blo), torch.as_tensor(bhi),
            tables=tables, tile_valid=torch.as_tensor(tvalid),
            tcell_lo=torch.as_tensor(clo).long(),
            tcell_hi=torch.as_tensor(chi).long())
        assert got.cell.shape == (cfg.m2p_cap + cfg.p2p_src_cap, 3)
        np.testing.assert_array_equal(got.cell.numpy(), np.asarray(want.cell))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
        np.testing.assert_array_equal(got.mass.numpy(),
                                      np.asarray(want.mass))
        assert int(got.count) == int(want.count)
        np.testing.assert_array_equal(got.overflow.numpy(),
                                      np.asarray(want.overflow))
        np.testing.assert_array_equal(got.maxima.numpy(),
                                      np.asarray(want.maxima))
        if order:
            np.testing.assert_array_equal(got.quad.numpy(),
                                          np.asarray(want.quad))
            assert got.quad[:int(want.maxima[0])].any()
        else:
            assert got.quad is None
        assert got.mask.any()
        # particle padding rows: the clamped cell of the sentinel
        pad = ~got.mask.any(0)[cfg.m2p_cap:] & (got.idx[cfg.m2p_cap:] < 0)
        assert (got.cell[cfg.m2p_cap:][pad] == 7).all() and pad.any()
    assert spans > 0, "no tile spanned several cells"
