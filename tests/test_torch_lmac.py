"""The lmac query (walk-free local MAC, rakau_tpu_torch.traversal3 through
engine.acc_pot_u_host and the Tree API) against rakau_tpu on one JAX-built
tree handed over through rakau_tpu_torch.convert: accelerations and
potentials to rtol 2e-5 / atol 1e-6 (the kernels sum in another order),
overflow flags and maxima exactly equal, the group table's row count in
maxima slot 2 included, with the same slices. Then the Tree API against
the float64 direct sum, and the bh_geom theta check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import Tree, engine, quadtree
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy
from rakau_tpu_torch.direct import direct_acc_pot_np

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 2048
THETA = 0.7
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
BASE = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=16,
            m2p_cap=2048, p2p_leaf_cap=1024, p2p_src_cap=4096,
            frontier_cap=4096, traversal_mode="lmac")
# low order and a narrow stencil keep the reference's trace short
GRID2 = dict(farfield="grid2", grid_level=3, grid_sep=2, local_order=3)
# (config, slice_chunks): None is the default slicing (one slice here)
CASES = {
    "m2p-slices4": (dict(farfield="m2p", tile_chunk=4), 4),
    "m2p-bh_geom": (dict(farfield="m2p", mac="bh_geom"), None),
    "local": (dict(farfield="local"), None),
    "grid-slices2": (dict(farfield="grid", grid_level=3, tile_chunk=4), 2),
    "grid2": (GRID2, None),
    "grid2-slices4": (dict(GRID2, tile_chunk=4), 4),
    "m2p-quad-comp": (dict(farfield="m2p", multipole_order=2,
                           accum="compensated"), None),
    "grid2-quad": (dict(GRID2, multipole_order=2), None),
    "2d-m2p": (dict(ndim=2, farfield="m2p"), None),
}


def particles_np(n, ndim, seed=41):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, ndim))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


def _rms(acc, ref):
    acc = np.asarray(acc, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    rel = np.linalg.norm(acc - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-300)
    return float(np.sqrt(np.mean(rel ** 2)))


@pytest.mark.parametrize("case", list(CASES))
def test_query_matches_jax_on_the_same_tree(case):
    kw, slice_chunks = CASES[case]
    jc = JaxConfig(**{**BASE, **kw})
    pos, mass = particles_np(N, jc.ndim)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    a_j, p_j, o_j, m_j = jengine.acc_pot_u_host(
        jtd, jc, jnp.float32(THETA), jnp.float32(0.0), 1.0,
        slice_chunks=slice_chunks)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    cfg = config_from_jax(jc)
    a, p, o, m = engine.acc_pot_u_host(td, cfg, THETA, 0.0, 1.0,
                                       slice_chunks=slice_chunks)
    assert not np.asarray(o_j).any()
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    assert 0 < int(m[2]) <= cfg.frontier_cap     # the group table's rows
    if jc.farfield == "grid":
        # The reference builds the dense grid far field for the shared and
        # the gwalk traversal only (rakau_tpu/engine.py:_grid_farfield), so
        # its lmac + "grid" query drops the stencil-covered pairs and adds
        # nothing for them (14 % force RMS against the direct sum on these
        # particles). The port adds the far field; its forces are held to
        # the direct sum, flags and maxima to the reference.
        acc_o, pot_o = direct_acc_pot_np(pos, mass)
        inv = np.asarray(jtd.inv_perm)
        assert _rms(a.numpy()[inv], acc_o) < 8e-3
        assert _rms(p.numpy()[inv], pot_o) < 4e-3
        return
    scale_a = float(np.abs(np.asarray(a_j)).max())
    scale_p = float(np.abs(np.asarray(p_j)).max())
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=2e-5,
                               atol=1e-6 * scale_a)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=2e-5,
                               atol=1e-6 * scale_p)
    if slice_chunks is not None:
        # the slices are real: more than one, the last one moved back
        n_live = engine.live_chunks(td, cfg)
        sl = engine._slices(n_live, cfg.tile_chunk, slice_chunks)
        assert len(sl) > 1 and sl[-1][1] == n_live - slice_chunks
        # and they change no result: one slice gives the same sums
        a1, p1, _, m1 = engine.acc_pot_u_host(td, cfg, THETA, 0.0, 1.0,
                                              slice_chunks=n_live)
        assert torch.equal(a1, a) and torch.equal(p1, p)
        assert torch.equal(m1[[0, 1, 3]], m[[0, 1, 3]])


def test_small_group_table_flags_the_frontier_slot_and_the_tree_grows_it():
    pos, mass = particles_np(N, 3)
    cfg = config_from_jax(JaxConfig(**{**BASE, "farfield": "m2p",
                                       "frontier_cap": 64}))
    t = Tree(coords=pos, masses=mass, config=cfg, device="cpu")
    _, _, ovf, mx = engine.acc_pot_u_host(t.tree_data, t.config, THETA, 0.0)
    assert ovf.tolist() == [False, False, False, True]
    assert int(mx[2]) > 64
    acc_o, _ = direct_acc_pot_np(pos, mass)
    acc, _ = t.accs_pots_o(THETA)
    assert t.config.frontier_cap >= int(mx[2])
    assert _rms(acc, acc_o) < 8e-3
    tuned = t.tune_caps()
    assert int(mx[2]) <= tuned.frontier_cap < 2 * int(mx[2]) + 256
    acc2, _ = t.accs_pots_o(THETA)
    assert _rms(acc2, acc) < 1e-5


@pytest.mark.parametrize("kw", [dict(farfield="grid2", local_order=4,
                                     grid_sep=2, grid_level=3),
                                dict(farfield="m2p"),
                                dict(farfield="grid", grid_level=3)],
                         ids=["grid2", "m2p", "grid"])
def test_tree_api_vs_oracle(kw):
    """The bound of the reference's fast net for lmac + grid2
    (tests/test_fast_smoke.py: 8e-3 at theta 0.75); box-distance
    acceptance is stricter than the walk's, so the other far fields meet
    it too. Accelerations-only and potentials-only queries give the same
    sums."""
    pos, mass = particles_np(N, 3)
    acc_o, pot_o = direct_acc_pot_np(pos, mass)
    cfg = config_from_jax(JaxConfig(**{**BASE, **kw, "tile_chunk": 8}))
    t = Tree(coords=pos, masses=mass, config=cfg, device="cpu")
    acc, pot = t.accs_pots_o(0.75)
    assert _rms(acc, acc_o) < 8e-3
    assert _rms(pot, pot_o) < 4e-3
    np.testing.assert_allclose(t.accs_o(0.75).numpy(), acc.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.pots_o(0.75).numpy(), pot.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_lmac_within_the_shared_envelope():
    """At equal theta lmac's error is at most the shared walk's (the
    reference holds it to 1.05x, tests/test_lmac.py)."""
    pos, mass = particles_np(N, 3)
    acc_o, _ = direct_acc_pot_np(pos, mass)
    errs = {}
    for mode in ("shared", "lmac"):
        cfg = config_from_jax(JaxConfig(**{**BASE, "farfield": "m2p",
                                           "traversal_mode": mode}))
        t = Tree(coords=pos, masses=mass, config=cfg, device="cpu")
        errs[mode] = _rms(t.accs_pots_o(0.75)[0], acc_o)
    assert errs["lmac"] <= 1.05 * errs["shared"], errs


def test_quadtree_float64_runs_lmac():
    pos, mass = particles_np(1024, 2)
    acc_o, _ = direct_acc_pot_np(pos.astype(np.float64),
                                 mass.astype(np.float64))
    t = quadtree(coords=pos.astype(np.float64),
                 masses=mass.astype(np.float64), device="cpu",
                 **{**BASE, "farfield": "m2p", "ndim": 2,
                    "dtype": "float64"})
    acc, _ = t.accs_pots_o(0.6)
    assert acc.dtype == torch.float64
    # the reference's bound for its 2-D lmac run (tests/test_lmac.py)
    assert _rms(acc, acc_o) < 1.1e-2


def test_bh_geom_theta_above_the_bound_raises():
    pos, mass = particles_np(512, 3)
    cfg = config_from_jax(JaxConfig(**{**BASE, "farfield": "m2p",
                                       "mac": "bh_geom"}))
    t = Tree(coords=pos, masses=mass, config=cfg, device="cpu")
    with pytest.raises(ValueError, match="monotonicity"):
        t.accs_pots_o(1.2)
    t.accs_pots_o(1.1)       # 2/sqrt(3) = 1.1547
    t2 = quadtree(coords=pos[:, :2], masses=mass, device="cpu",
                  **{**BASE, "farfield": "m2p", "mac": "bh_geom", "ndim": 2})
    t2.accs_pots_o(1.4)      # 2/sqrt(2) = 1.4142
    with pytest.raises(ValueError, match="monotonicity"):
        t2.accs_pots_o(1.42)
