"""rakau_tpu_torch.build against rakau_tpu.build on the same float32
inputs: every integer field of the tree (codes, permutations, node
topology, cells, tile table, counts, overflow) exactly equal, the
gwalk+grid2 tile table clipped at grid2's cells included; node mass/COM
and the geometric fields to fp32 rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import build
from rakau_tpu_torch.convert import config_from_jax

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 2048
# one XLA compile per config instead of hundreds of eager op compiles
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
INT_FIELDS = ("perm", "inv_perm", "node_begin", "node_end",
              "node_child_begin", "node_child_count", "node_is_leaf",
              "node_level", "node_parent", "node_cell", "tile_begin",
              "tile_cnt", "tile_cell", "n_nodes", "n_tiles", "overflow")


def plummer_np(n, seed, ndim=3):
    """Plummer sample with numpy (the same inputs feed both packages)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, ndim))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


def _both(pos, mass, **kw):
    jc = JaxConfig(**kw)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    ttd = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass),
                           config_from_jax(jc))
    return jtd, ttd


@pytest.mark.parametrize("kw", [
    dict(max_depth=10, max_leaf_n=16, ncrit=64, farfield="grid",
         grid_level=3),
    dict(max_depth=10, max_leaf_n=16, ncrit=64, farfield="local"),
    dict(ndim=2, max_depth=10, max_leaf_n=8, ncrit=64, farfield="m2p"),
    dict(max_depth=10, max_leaf_n=16, ncrit=64, farfield="m2p",
         multipole_order=2),
    # gwalk clips its tiles at grid2's cells (set level, and the auto
    # level that tracks n/ncrit); the shared traversal does not
    dict(max_depth=10, max_leaf_n=16, ncrit=64, farfield="grid2",
         traversal_mode="gwalk", grid_level=3),
    dict(max_depth=10, max_leaf_n=16, ncrit=64, farfield="grid2",
         traversal_mode="gwalk", multipole_order=2),
    dict(max_depth=10, max_leaf_n=16, ncrit=64, farfield="grid2",
         grid_level=3),
])
def test_build_matches_jax(kw):
    ndim = kw.get("ndim", 3)
    pos, mass = plummer_np(N, 5, ndim)
    mass = mass * np.random.default_rng(6).uniform(0.5, 1.5, N).astype(
        np.float32)
    jtd, ttd = _both(pos, mass, **kw)
    want_code = ((np.asarray(jtd.code_hi).astype(np.int64) << 32)
                 | np.asarray(jtd.code_lo).astype(np.int64))
    np.testing.assert_array_equal(ttd.code.numpy(), want_code)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(ttd, f).numpy(), np.asarray(getattr(jtd, f)),
            err_msg=f)
    assert not bool(ttd.overflow)
    jc = JaxConfig(**kw)
    assert config_from_jax(jc).tile_capacity(N) == jc.tile_capacity(N)
    np.testing.assert_array_equal(ttd.pos.numpy(), np.asarray(jtd.pos))
    np.testing.assert_array_equal(ttd.mass.numpy(), np.asarray(jtd.mass))
    box = float(ttd.box_size)
    assert box == float(jtd.box_size)
    for f, atol in (("node_mass", 0.0), ("node_com", 1e-6 * box),
                    ("node_center", 1e-6 * box), ("node_delta", 1e-5 * box),
                    ("node_quad", 1e-5 * float(np.abs(jtd.node_quad).max()))):
        np.testing.assert_allclose(getattr(ttd, f).numpy(),
                                   np.asarray(getattr(jtd, f)), rtol=1e-5,
                                   atol=atol, err_msg=f)


def test_build_with_duplicate_positions_matches_jax():
    """Coincident particles share a code: the stable sort must keep them
    in input order, as the reference's (hi, lo, iota) sort does."""
    pos, mass = plummer_np(512, 8)
    pos[100:300] = pos[7]
    jtd, ttd = _both(pos, mass, max_depth=8, max_leaf_n=16, ncrit=64)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(ttd, f).numpy(), np.asarray(getattr(jtd, f)),
            err_msg=f)


def test_build_overflow_flag_matches_jax():
    pos, mass = plummer_np(N, 9)
    jtd, ttd = _both(pos, mass, max_depth=10, max_leaf_n=4, ncrit=64,
                     node_cap=64, tile_cap=8)
    assert bool(ttd.overflow) and bool(jtd.overflow)
    assert int(ttd.n_nodes) == int(jtd.n_nodes)
    assert int(ttd.n_tiles) == int(jtd.n_tiles)
