"""rakau_tpu_torch.traversal4 (the gwalk walk and pool) against
rakau_tpu.traversal4 on one JAX-built tree handed over through
rakau_tpu_torch.convert: the incidence lists, counts, overflow flags,
maxima and round counts of the dynamic and the unrolled walk, and every
plane and segment field of the pool built from the same lists, must be
exactly equal, for the "m2p" and "grid" far fields."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu import grid2 as jgrid2
from rakau_tpu import traversal4 as jt4
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu.config import fit_round_caps as jfit_round_caps
from rakau_tpu_torch import grid2, traversal4
from rakau_tpu_torch.config import fit_round_caps
from rakau_tpu_torch.convert import (config_from_jax, global_lists_from_numpy,
                                     treedata_from_numpy)

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 2048
THETA = 0.7
BLOCK = 128
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
jax_walk = jax.jit(jt4.build_global_incidences, static_argnames=("cfg",))
jax_pool = jax.jit(jt4.build_pool, static_argnames=(
    "G", "block", "pool_cap", "window_blocks", "sep", "quad_dim",
    "cell_bits", "group", "row_chunk"))
_CASES = {}


def plummer_np(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


def _case(farfield):
    """JAX config and tree (with second moments for "m2p"), the port's
    copy of the tree, the flat tile operands, and the reference's dynamic
    walk on them; built once per far field."""
    if farfield not in _CASES:
        kw = dict(max_depth=9, max_leaf_n=16, ncrit=64, tile_chunk=8,
                  m2p_cap=16384, p2p_leaf_cap=12288, p2p_src_cap=131072,
                  frontier_cap=2048, traversal_mode="gwalk",
                  farfield=farfield)
        if farfield == "grid":
            kw["grid_level"] = 3
        else:
            kw["multipole_order"] = 2
        jc = JaxConfig(**kw)
        pos, mass = plummer_np(N, 31)
        jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
        td = treedata_from_numpy(
            {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
        tiles = jengine._gather_tiles(jtd, jc)
        _, tidx, blo, bhi, tcell = (np.array(t) for t in tiles)
        G = tidx.shape[0] * tidx.shape[1]
        ops = dict(lo=blo.reshape(G, 3), hi=bhi.reshape(G, 3),
                   cell=tcell.reshape(G, 3),
                   valid=(tidx[..., 0] < N).reshape(G))
        _CASES[farfield] = (jc, jtd, td, ops, _jax_walk(jc, jtd, ops))
    return _CASES[farfield]


def _jax_walk(jc, jtd, ops):
    return jax_walk(jtd, jc, jnp.float32(THETA), jnp.asarray(ops["lo"]),
                    jnp.asarray(ops["hi"]),
                    tile_valid=jnp.asarray(ops["valid"]),
                    tcell_lo=jnp.asarray(ops["cell"]),
                    tcell_hi=jnp.asarray(ops["cell"]))


def _walk(cfg, td, ops):
    cell = torch.as_tensor(ops["cell"]).long()
    return traversal4.build_global_incidences(
        td, cfg, THETA, torch.as_tensor(ops["lo"]),
        torch.as_tensor(ops["hi"]), tile_valid=torch.as_tensor(ops["valid"]),
        tcell_lo=cell, tcell_hi=cell)


def _assert_lists_equal(got, want):
    for name in traversal4.GlobalLists._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)


@pytest.mark.parametrize("walk", ["dynamic", "unrolled"])
@pytest.mark.parametrize("farfield", ["m2p", "grid"])
def test_global_incidences_match_jax(farfield, walk):
    jc, jtd, td, ops, want = _case(farfield)
    assert not np.asarray(want.overflow).any()
    if walk == "unrolled":
        # the per-round caps a tuning query fits from the dynamic walk
        caps = fit_round_caps(np.asarray(want.round_counts))
        assert caps == jfit_round_caps(np.asarray(want.round_counts))
        assert len(caps) >= 3
        jc = jc.with_(gwalk_round_caps=caps)
        want = _jax_walk(jc, jtd, ops)
        assert not np.asarray(want.overflow).any()
    got = _walk(config_from_jax(jc), td, ops)
    _assert_lists_equal(got, want)
    assert int(got.m2p_cnt) > 0 and int(got.leaf_cnt) > 0
    # tile-major segments
    assert (np.diff(got.m2p_tile.numpy()) >= 0).all()
    assert (np.diff(got.leaf_tile.numpy()) >= 0).all()


@pytest.mark.parametrize("small", ["caps", "round_caps"])
def test_undersized_caps_flag_like_jax(small):
    """Undersized m2p, leaf and frontier caps (dynamic walk), or round
    caps (unrolled walk), flag the same slots and keep the same
    truncated lists as the reference."""
    jc, jtd, td, ops, want = _case("m2p")
    if small == "caps":
        jc = jc.with_(m2p_cap=1024, p2p_leaf_cap=512, frontier_cap=256)
        flagged = [True, True, False, True]
    else:
        caps = fit_round_caps(np.asarray(want.round_counts))
        jc = jc.with_(gwalk_round_caps=(256,) * len(caps))
        flagged = [False, False, False, True]
    want = _jax_walk(jc, jtd, ops)
    assert np.asarray(want.overflow).tolist() == flagged
    _assert_lists_equal(_walk(config_from_jax(jc), td, ops), want)


POOLS = {
    # no window packing, one tile per group
    "plain": dict(farfield="m2p", window_blocks=0, group=1),
    # window packing by groups of 2, node rows with second moments
    "packed-group2-quad": dict(farfield="m2p", window_blocks=256, group=2,
                               quad_dim=6),
    # window packing, the grid far field's per-particle coverage drop
    "packed-grid": dict(farfield="grid", window_blocks=256, group=1),
    # the leaf expansion in chunks of 1000 rows, against the reference's
    # one-shot expansion (its chunked loop does not trace with jax's x64
    # on, which tests/conftest.py sets)
    "row-chunk": dict(farfield="m2p", window_blocks=256, group=2,
                      row_chunk=1000),
}


@pytest.mark.parametrize("setting", list(POOLS))
def test_pool_matches_jax(setting):
    kw = dict(POOLS[setting])
    jc, jtd, td, ops, jgl = _case(kw.pop("farfield"))
    G = ops["lo"].shape[0]
    pool_cap = 4 * 256 * BLOCK
    jkw, tkw = dict(kw), dict(kw)
    jkw.pop("row_chunk", None)
    if jc.farfield == "grid":
        L0 = jc.grid_level
        pc = jgrid2.particle_cells(jtd.pos, jtd.box_size, jc.max_depth, L0)
        cell = jnp.asarray(ops["cell"])
        jkw.update(pcell=pc, tcell_lo=cell, tcell_hi=cell, sep=3,
                   cell_bits=L0)
        tcell = torch.as_tensor(ops["cell"]).long()
        tkw.update(pcell=grid2.particle_cells(td.pos, td.box_size,
                                              jc.max_depth, L0),
                   tcell_lo=tcell, tcell_hi=tcell, sep=3)
    want = jax_pool(jtd, jgl, G, BLOCK, pool_cap, **jkw)
    gl = global_lists_from_numpy(
        {k: np.asarray(v) for k, v in jgl._asdict().items()}, "cpu")
    got = traversal4.build_pool(td, gl, G, BLOCK, pool_cap, **tkw)
    assert not bool(want.overflow)
    for name in traversal4.GlobalPool._fields:
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(w), err_msg=name)
    assert int(got.p2p_cnt) > 0 and bool((got.idx >= 0).any())
    if "row_chunk" in kw:
        tkw.pop("row_chunk")
        whole = traversal4.build_pool(td, gl, G, BLOCK, pool_cap, **tkw)
        for name in ("pos", "mass", "idx"):
            assert torch.equal(getattr(whole, name), getattr(got, name))
    if kw.get("quad_dim"):
        assert bool(got.quad.any())


def test_particle_cells_match_jax():
    jc, jtd, td, _, _ = _case("grid")
    want = jgrid2.particle_cells(jtd.pos, jtd.box_size, jc.max_depth, 3)
    got = grid2.particle_cells(td.pos, td.box_size, jc.max_depth, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fit_round_caps_matches_jax():
    for counts in ([40, 700, 1300, 900, 0, 0], [0, 0], [5000], []):
        assert fit_round_caps(counts) == jfit_round_caps(counts)
    assert fit_round_caps([300, 10, 0]) == (512, 256)
