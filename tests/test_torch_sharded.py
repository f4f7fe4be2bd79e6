"""rakau_tpu_torch.parallel.sharded on CPU shards (mirroring
tests/test_sharded.py): the sharded query is shard-count invariant at 1, 2
and 8 shards against the port's single-device query (rtol 1e-5, atol
1e-6; each shard evaluates its chunks as the single query does, so the
sums are in fact equal), for the shared and the lmac traversal;
farfield="grid" falls back to "local"; acc_pot_sharded returns input
order; leapfrog_step_sharded matches integrate.leapfrog_step; a gwalk
config runs the per-tile lists in its chunks, as the reference's does:
bit for bit, flags included, the sharded query of traversal_mode="lists"
on the same caps, in both twins. Under `slow`, the reference's
acc_pot_u_sharded on a 2-device mesh against the port's on the same
JAX-built tree, with the shared config and with gwalk.
tests/test_torch_sharded_whole.py holds the whole twins to the _host
twins."""
import numpy as np
import pytest
import torch

from rakau_tpu_torch import build, engine, integrate
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.parallel import sharded

torch.set_num_threads(1)

N = 2048
CFG = TreeConfig(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=8)
LMAC = CFG.with_(traversal_mode="lmac", farfield="m2p", frontier_cap=4096)
_STATE = {}


def _cloud():
    if not _STATE:
        rng = np.random.default_rng(31)
        u = rng.uniform(1e-6, 1 - 1e-6, N)
        r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
        v = rng.standard_normal((N, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        _STATE["pos"] = torch.tensor((v * r[:, None]).astype(np.float32))
        _STATE["mass"] = torch.full((N,), 1.0 / N)
    return _STATE["pos"], _STATE["mass"]


def _mesh(ndev):
    return sharded.default_mesh(ndev, device="cpu")


@pytest.mark.parametrize("cfg", [CFG, LMAC], ids=["shared", "lmac"])
@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_shard_count_invariance(ndev, cfg):
    pos, mass = _cloud()
    td = build.build_tree(pos, mass, cfg)
    acc_1, pot_1, ovf_1, _ = engine.acc_pot_u_host(td, cfg, 0.5, 0.01)
    acc_n, pot_n, ovf_n = sharded.acc_pot_u_sharded(td, cfg, 0.5, 0.01,
                                                    1.0, _mesh(ndev))
    assert not ovf_n.any() and torch.equal(ovf_n, ovf_1)
    np.testing.assert_allclose(acc_n.numpy(), acc_1.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pot_n.numpy(), pot_1.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_grid_falls_back_to_local():
    pos, mass = _cloud()
    cfg = CFG.with_(farfield="grid", grid_level=3)
    td = build.build_tree(pos, mass, cfg)
    acc_l, pot_l, _, _ = engine.acc_pot_u_host(
        td, cfg.with_(farfield="local"), 0.5, 0.01)
    acc_n, pot_n, ovf = sharded.acc_pot_u_sharded(td, cfg, 0.5, 0.01, 1.0,
                                                  _mesh(2))
    assert not ovf.any()
    np.testing.assert_allclose(acc_n.numpy(), acc_l.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pot_n.numpy(), pot_l.numpy(), rtol=1e-5,
                               atol=1e-6)
    # and it is not the grid query
    acc_g, _, _, _ = engine.acc_pot_u_host(td, cfg, 0.5, 0.01)
    assert not torch.allclose(acc_n, acc_g, rtol=1e-5, atol=1e-6)


def test_acc_pot_sharded_is_in_input_order():
    pos, mass = _cloud()
    acc_1, pot_1, _ = integrate.acc_pot(pos, mass, CFG, 0.6, 0.01)
    acc_n, pot_n, ovf = sharded.acc_pot_sharded(pos, mass, CFG, 0.6, 0.01,
                                                1.0, _mesh(8))
    assert not ovf.any()
    np.testing.assert_allclose(acc_n.numpy(), acc_1.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pot_n.numpy(), pot_1.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_sharded_leapfrog_matches_single():
    pos, mass = _cloud()
    state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)
    s1, o1 = integrate.leapfrog_step(state, 1e-3, CFG, 0.5, 0.05,
                                     box_size=64.0)
    s8, o8 = sharded.leapfrog_step_sharded(state, 1e-3, CFG, 0.5, 0.05, 1.0,
                                           _mesh(8), box_size=64.0)
    assert not o8.any() and torch.equal(o1, o8)
    np.testing.assert_allclose(s8.pos.numpy(), s1.pos.numpy(), atol=1e-6)
    np.testing.assert_allclose(s8.vel.numpy(), s1.vel.numpy(), atol=1e-5)
    assert torch.equal(s8.mass, s1.mass)


# CFG's tree as a gwalk config: its sharded chunks run the per-tile lists
# at the default caps, which hold
GWALK = CFG.with_(traversal_mode="gwalk", farfield="m2p")
SHARDED_TWINS = {"whole": sharded.acc_pot_u_sharded,
                 "host": sharded.acc_pot_u_sharded_host}


@pytest.mark.parametrize("twin", list(SHARDED_TWINS))
@pytest.mark.parametrize("ndev", [1, 2])
def test_gwalk_runs_the_lists_in_its_chunks(ndev, twin, diag_modes):
    """The reference's sharded query has no gwalk branch: a gwalk config
    runs the per-tile lists traversal in its chunks, with its caps
    (rakau_tpu/engine.py:276-281). The port's does the same: its sums and
    flags equal those of the same query with traversal_mode="lists"."""
    pos, mass = _cloud()
    td = build.build_tree(pos, mass, GWALK)
    fn = SHARDED_TWINS[twin]
    acc_g, pot_g, ovf_g = fn(td, GWALK, 0.5, 0.01, 1.0, _mesh(ndev))
    acc_l, pot_l, ovf_l = fn(td, GWALK.with_(traversal_mode="lists"), 0.5,
                             0.01, 1.0, _mesh(ndev))
    assert torch.equal(ovf_g, ovf_l) and not ovf_g.any()
    assert torch.equal(acc_g, acc_l) and torch.equal(pot_g, pot_l)


def _reference_sharded(jc):
    """The reference's acc_pot_u_sharded on a 2-device JAX CPU mesh and the
    port's on the same JAX-built tree: (port, reference) results."""
    import jax
    import jax.numpy as jnp
    from rakau_tpu import build as jbuild
    from rakau_tpu.parallel import sharded as jsharded
    from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy
    pos, mass = _cloud()
    jtd = jax.jit(jbuild.build_tree, static_argnames=("cfg",))(
        jnp.asarray(pos.numpy()), jnp.asarray(mass.numpy()), jc)
    ref = jsharded.acc_pot_u_sharded(
        jtd, jc, jnp.float32(0.5), jnp.float32(0.01), 1.0,
        jsharded.default_mesh(2))
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    got = sharded.acc_pot_u_sharded(td, config_from_jax(jc), 0.5, 0.01,
                                    1.0, _mesh(2))
    return got, ref


def _assert_matches_reference(got, ref):
    a, p, o = got
    a_j, p_j, o_j = ref
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_j))
    a_j, p_j = np.asarray(a_j, np.float64), np.asarray(p_j, np.float64)
    rel = np.linalg.norm(a.numpy() - a_j, axis=1) / np.linalg.norm(a_j,
                                                                   axis=1)
    assert np.sqrt(np.mean(rel ** 2)) <= 1e-5
    assert np.sqrt(np.mean(((p.numpy() - p_j) / p_j) ** 2)) <= 1e-5


@pytest.mark.slow
def test_sharded_matches_the_reference():
    from rakau_tpu.config import TreeConfig as JaxConfig
    _assert_matches_reference(*_reference_sharded(JaxConfig(
        max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=8)))


@pytest.mark.slow
def test_sharded_gwalk_matches_the_reference():
    """A gwalk config through the reference's acc_pot_u_sharded (the
    per-tile lists in its chunks) and the port's, on one tree."""
    from rakau_tpu.config import TreeConfig as JaxConfig
    _assert_matches_reference(*_reference_sharded(JaxConfig(
        max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=8,
        traversal_mode="gwalk", farfield="m2p")))
