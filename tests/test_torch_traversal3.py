"""rakau_tpu_torch.traversal3 (the walk-free local MAC, lmac) against
rakau_tpu.traversal3 on one JAX-built tree handed over through
rakau_tpu_torch.convert: the tables, the slice's candidate table and, per
chunk, the shared source row with and without it. Integers, masks, flags
and maxima must be exactly equal; the floats are gathered table entries
and are held to rtol 1e-6. Then the partition argument on the port alone:
every tile's masked source masses sum to the total mass, also above the
bh_geom monotonicity bound, where theta is clamped."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu import traversal3 as jt3
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import engine, traversal3
from rakau_tpu_torch.convert import (config_from_jax, group_cand_from_numpy,
                                     lmac_tables_from_numpy,
                                     treedata_from_numpy)

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 2048
THETA = 0.6
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
BASE = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=16,
            m2p_cap=2048, p2p_leaf_cap=1024, p2p_src_cap=4096,
            frontier_cap=4096, traversal_mode="lmac")
GRID2 = dict(farfield="grid2", grid_level=3, grid_sep=2, local_order=3)
CASES = {
    "m2p-bh": dict(farfield="m2p"),
    "m2p-bh_geom": dict(farfield="m2p", mac="bh_geom"),
    "grid-bh": dict(farfield="grid", grid_level=3),
    "grid-bh_geom": dict(farfield="grid", grid_level=3, mac="bh_geom"),
    "grid2-bh": GRID2,
    "grid2-bh_geom": dict(GRID2, mac="bh_geom"),
    "m2p-quad": dict(farfield="m2p", multipole_order=2),
    "grid2-quad-sep3": dict(GRID2, grid_sep=3, multipole_order=2),
    "2d-m2p": dict(ndim=2, farfield="m2p"),
    "2d-grid2-bh_geom": dict(GRID2, ndim=2, mac="bh_geom"),
}
FIELDS = ("pos", "mass", "idx", "mask", "count", "overflow", "maxima",
          "quad", "cell")


def particles_np(n, ndim, seed):
    """A Plummer-like ball: dense core, a few far particles."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, ndim))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


def both_trees(kw, seed):
    jc = JaxConfig(**{**BASE, **kw})
    cfg = config_from_jax(jc)
    pos, mass = particles_np(N, jc.ndim, seed)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    return jc, cfg, jtd, td


def cell_ranges(tiles):
    """(lo, hi) of the tiles' cell ranges: grid2's own, else the clipped
    tile's one cell for both."""
    return (tiles[6], tiles[7]) if len(tiles) > 5 else (tiles[4], tiles[4])


def flat(a):
    return a.reshape((-1,) + a.shape[2:])


def assert_same(got, want, what):
    """Port tensor against JAX array: integers and bools exactly, floats
    to rtol 1e-6."""
    if want is None:
        assert got is None, what
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape, what
    if g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_tables_candidates_and_sources_match_jax(case):
    jc, cfg, jtd, td = both_trees(CASES[case], 31)
    D = jc.ndim
    jtab = jt3.make_tables(jtd, jc)
    tab = traversal3.make_tables(td, cfg)
    want = lmac_tables_from_numpy(np.asarray(jtab.lm), np.asarray(jtab.pm),
                                  D, jtab.L0, "cpu")
    assert tab.L0 == want.L0
    assert torch.equal(tab.fi, want.fi)
    np.testing.assert_allclose(tab.ff.numpy(), want.ff.numpy(), rtol=1e-6,
                               atol=0)
    assert torch.equal(tab.pm, want.pm)

    jtiles = jengine._gather_tiles(jtd, jc)
    tiles = engine._gather_tiles(td, cfg)
    jclo, jchi = cell_ranges(jtiles)
    clo, chi = cell_ranges(tiles)
    th = jnp.float32(THETA)
    jcand = jax.jit(lambda: jt3.build_group_candidates(
        jtd, jc, th, flat(jtiles[2]), flat(jtiles[3]), jtab,
        tile_valid=flat(jtiles[1])[:, 0] < N, tcell_lo=flat(jclo),
        tcell_hi=flat(jchi)))()
    cand = traversal3.build_group_candidates(
        td, cfg, THETA, flat(tiles[2]), flat(tiles[3]), tab,
        tile_valid=flat(tiles[1])[:, 0] < N, tcell_lo=flat(clo),
        tcell_hi=flat(chi))
    wcand = group_cand_from_numpy(
        *(np.asarray(x) for x in (jcand.lm, jcand.begin, jcand.end,
                                  jcand.overflow, jcand.count)), D, "cpu")
    for f in ("fi", "begin", "end", "overflow", "count"):
        assert torch.equal(getattr(cand, f), getattr(wcand, f)), f
    np.testing.assert_allclose(cand.ff.numpy(), wcand.ff.numpy(), rtol=1e-6,
                               atol=0)
    assert 0 < int(cand.count) < cfg.frontier_cap and not bool(cand.overflow)

    jsrc = jax.jit(lambda blo, bhi, tv, lo, hi, c: jt3.build_shared_sources(
        jtd, jc, th, blo, bhi, tables=jtab, tile_valid=tv, tcell_lo=lo,
        tcell_hi=hi, cand=c))
    n_live = engine.live_chunks(td, cfg)
    for ch in sorted({0, n_live // 2, n_live - 1}):
        tv = tiles[1][ch][:, 0] < N
        kw = dict(tables=tab, tile_valid=tv, tcell_lo=clo[ch],
                  tcell_hi=chi[ch])
        full = traversal3.build_shared_sources(td, cfg, THETA, tiles[2][ch],
                                               tiles[3][ch], **kw)
        pre = traversal3.build_shared_sources(td, cfg, THETA, tiles[2][ch],
                                              tiles[3][ch], cand=cand, **kw)
        want = jsrc(jtiles[2][ch], jtiles[3][ch], jnp.asarray(tv.numpy()),
                    jclo[ch], jchi[ch], jcand)
        for f in FIELDS:
            a, b = getattr(full, f), getattr(pre, f)
            # with and without the candidate table: bit-identical
            assert (a is None and b is None) or torch.equal(a, b), (ch, f)
            assert_same(b, getattr(want, f), (ch, f))
        assert pre.mask.any()
        if cfg.farfield == "grid2":
            # padding node rows carry -1, valid rows a cell
            U = cfg.m2p_cap
            ucnt = int(pre.maxima[0])
            assert (pre.cell[ucnt:U] == -1).all()
            assert (pre.cell[:ucnt] >= 0).all()


def test_small_caps_set_the_overflow_flags_like_jax():
    kw = dict(farfield="m2p", m2p_cap=64, p2p_leaf_cap=16, p2p_src_cap=16,
              frontier_cap=32)
    jc, cfg, jtd, td = both_trees(kw, 32)
    jtab = jt3.make_tables(jtd, jc)
    tab = traversal3.make_tables(td, cfg)
    jtiles = jengine._gather_tiles(jtd, jc)
    tiles = engine._gather_tiles(td, cfg)
    th = jnp.float32(0.3)
    jcand = jt3.build_group_candidates(
        jtd, jc, th, flat(jtiles[2]), flat(jtiles[3]), jtab,
        tile_valid=flat(jtiles[1])[:, 0] < N)
    cand = traversal3.build_group_candidates(
        td, cfg, 0.3, flat(tiles[2]), flat(tiles[3]), tab,
        tile_valid=flat(tiles[1])[:, 0] < N)
    assert bool(cand.overflow) and bool(jcand.overflow)
    assert int(cand.count) == int(jcand.count) > cfg.frontier_cap
    tv = tiles[1][1][:, 0] < N
    want = jt3.build_shared_sources(
        jtd, jc, th, jtiles[2][1], jtiles[3][1], tables=jtab,
        tile_valid=jnp.asarray(tv.numpy()), cand=jcand)
    got = traversal3.build_shared_sources(
        td, cfg, 0.3, tiles[2][1], tiles[3][1], tables=tab, tile_valid=tv,
        cand=cand)
    assert bool(got.overflow[3])          # the candidate table's flag
    for f in ("mask", "idx", "overflow", "maxima", "count"):
        assert_same(getattr(got, f), getattr(want, f), f)
    # the whole node table against the same small caps: the other three
    want = jt3.build_shared_sources(
        jtd, jc, th, jtiles[2][1], jtiles[3][1], tables=jtab,
        tile_valid=jnp.asarray(tv.numpy()))
    got = traversal3.build_shared_sources(
        td, cfg, 0.3, tiles[2][1], tiles[3][1], tables=tab, tile_valid=tv)
    assert got.overflow.tolist() == [True, True, True, False]
    for f in ("mask", "idx", "overflow", "maxima", "count"):
        assert_same(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("kw", [dict(farfield="m2p"),
                                dict(farfield="m2p", mac="bh_geom"),
                                dict(ndim=2, farfield="m2p")],
                         ids=["bh", "bh_geom", "2d"])
def test_mass_partition_is_exact(kw):
    """For every valid tile the masked source masses (nodes and expanded
    particles) sum to the total mass: each particle enters through exactly
    one transition node or P2P row."""
    cfg = config_from_jax(JaxConfig(**{**BASE, **kw, "m2p_cap": 4096,
                                       "p2p_src_cap": 8192}))
    pos, mass = particles_np(N, cfg.ndim, 33)
    from rakau_tpu_torch import build
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    tiles = engine._gather_tiles(td, cfg)
    tab = traversal3.make_tables(td, cfg)
    for theta in (0.4, 0.75, 1.0):
        for ch in range(engine.live_chunks(td, cfg)):
            tv = tiles[1][ch][:, 0] < N
            src = traversal3.build_shared_sources(
                td, cfg, theta, tiles[2][ch], tiles[3][ch], tables=tab,
                tile_cell=tiles[4][ch], tile_valid=tv)
            assert not src.overflow.any()
            ms = torch.where(src.mask, src.mass[None, :], 0.0).double().sum(1)
            np.testing.assert_allclose(ms[tv].numpy(), float(mass.sum()),
                                       rtol=2e-5)
            assert not ms[~tv].any()


def test_bh_geom_clamp_cannot_be_bypassed():
    """bh_geom + lmac above theta = 2/sqrt(D): traversal3 clamps theta
    itself, so a direct engine call at any theta equals the call at the
    bound bit for bit and keeps the exact mass partition."""
    cfg = config_from_jax(JaxConfig(**{**BASE, "farfield": "m2p",
                                       "mac": "bh_geom", "m2p_cap": 4096,
                                       "p2p_src_cap": 8192}))
    pos, mass = particles_np(N, 3, 34)
    from rakau_tpu_torch import build
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    bound = 2.0 / np.sqrt(3.0)
    big = engine.acc_pot_u_host(td, cfg, 5.0, 0.0)
    bnd = engine.acc_pot_u_host(td, cfg, bound, 0.0)
    assert not big[2].any() and not bnd[2].any()
    assert torch.equal(big[0], bnd[0]) and torch.equal(big[1], bnd[1])
    tiles = engine._gather_tiles(td, cfg)
    tv = tiles[1][0][:, 0] < N
    src = traversal3.build_shared_sources(td, cfg, 5.0, tiles[2][0],
                                          tiles[3][0], tile_valid=tv)
    ms = torch.where(src.mask, src.mass[None, :], 0.0).double().sum(1)
    np.testing.assert_allclose(ms[tv].numpy(), float(mass.sum()), rtol=2e-5)
