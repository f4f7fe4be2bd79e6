"""rakau_tpu_torch.traversal (the per-tile lists walk) against
rakau_tpu.traversal on one JAX-built tree handed over through
rakau_tpu_torch.convert: per chunk, the M2P node lists, the P2P particle
lists, their counts, the overflow flags (m2p, p2p_leaf, p2p_src,
frontier) and the maxima (m2p, p2p_src, frontier, p2p_leaf) must be
exactly equal, for the bh and bh_geom MACs, in 3-D and 2-D, and with each
capacity undersized in turn, so that each of the four flags is set once
and the truncated lists are compared too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu import traversal as jtr
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import traversal
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 2048
THETA = 0.6
BASE = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=8,
            m2p_cap=1024, p2p_leaf_cap=1024, p2p_src_cap=8192,
            frontier_cap=512, farfield="m2p")
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
jax_walk = jax.jit(jtr.build_interaction_lists, static_argnames=("cfg",))


def points_np(n, seed, ndim=3):
    """A Plummer sphere (3-D) or a uniform square (2-D), float32."""
    rng = np.random.default_rng(seed)
    if ndim == 2:
        pos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        return pos, np.full(n, 1.0 / n, np.float32)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


def _trees(jc, seed=21):
    pos, mass = points_np(N, seed, jc.ndim)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    return jtd, td


def _compare_chunks(jc, n_chunks=4, seed=21):
    """Walk a spread of live chunks with both packages; returns the
    OR of the reference's overflow flags over them."""
    cfg = config_from_jax(jc)
    jtd, td = _trees(jc, seed)
    jtiles = jengine._gather_tiles(jtd, jc)
    n_live = -(-int(jtd.n_tiles) // jc.tile_chunk)
    flags = np.zeros(4, bool)
    for ch in range(0, n_live, max(1, n_live // n_chunks)):
        blo, bhi = (np.array(jtiles[k][ch]) for k in (2, 3))
        want = jax_walk(jtd, jc, jnp.float32(THETA), jnp.asarray(blo),
                        jnp.asarray(bhi))
        got = traversal.build_interaction_lists(
            td, cfg, THETA, torch.as_tensor(blo), torch.as_tensor(bhi))
        for field in traversal.InteractionLists._fields:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"chunk {ch}: {field}")
        flags |= np.asarray(want.overflow)
    return flags


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("mac", ["bh", "bh_geom"])
def test_lists_match_jax(mac, ndim):
    kw = dict(BASE, mac=mac, ndim=ndim)
    flags = _compare_chunks(JaxConfig(**kw))
    assert not flags.any(), "the base caps must hold the lists"


# each capacity undersized in turn: the flag of that capacity is set
@pytest.mark.parametrize("field,cap", [("m2p_cap", 8), ("p2p_leaf_cap", 16),
                                       ("p2p_src_cap", 64),
                                       ("frontier_cap", 2)])
def test_undersized_caps_set_their_flag(field, cap):
    flags = _compare_chunks(JaxConfig(**dict(BASE, **{field: cap})))
    fields = ("m2p_cap", "p2p_leaf_cap", "p2p_src_cap", "frontier_cap")
    assert flags[fields.index(field)], (field, flags)


def test_helpers_match_jax():
    rng = np.random.default_rng(3)
    pos = rng.standard_normal((6 * 16, 3)).astype(np.float32)
    lo, hi = traversal.tile_aabbs(torch.as_tensor(pos), 6, 16)
    jlo, jhi = jtr.tile_aabbs(jnp.asarray(pos), 6, 16)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    p = rng.standard_normal((6, 40, 3)).astype(np.float32) * 2
    got = traversal.box_point_dist2(lo[:, None], hi[:, None],
                                    torch.as_tensor(p))
    want = jtr.box_point_dist2(jlo[:, None], jhi[:, None], jnp.asarray(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # _append: values past the cap are dropped and flagged
    lst = torch.full((2, 4), -1, dtype=torch.int64)
    mask = torch.tensor([[True, False, True], [True, True, True]])
    vals = torch.tensor([[5, 6, 7], [8, 9, 10]])
    cnt = torch.tensor([1, 2])
    out, c, o = traversal._append(lst, cnt, mask, vals, 4)
    jout, jc, jo = jtr._append(jnp.asarray(lst.numpy(), jnp.int32),
                               jnp.asarray(cnt.numpy(), jnp.int32),
                               jnp.asarray(mask.numpy()),
                               jnp.asarray(vals.numpy(), jnp.int32), 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
