"""The whole ported slice: rakau_tpu_torch.engine and the Tree API against
rakau_tpu on the same tree (per-particle relative force and potential RMS
<= 1e-5, the overflow flags and maxima exactly equal), for the monopole
fp32 far fields and for the compensated and quadrupole modes, and against
the float64 direct-sum oracle with the bounds of tests/test_fast_smoke.py
(force RMS < 8e-3, potential RMS < 4e-3 at theta=0.75); plus the u/o
duality, the update-versus-rebuild check, the overflow contract and the
default device."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import Tree, build, engine, quadtree
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy
from rakau_tpu_torch.direct import direct_acc_pot_np

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 2048
THETA = 0.75
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
_STATE = {}


def _data():
    """Plummer sample made with numpy, and its float64 oracle."""
    if not _STATE:
        rng = np.random.default_rng(11)
        u = rng.uniform(1e-6, 1 - 1e-6, N)
        r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
        v = rng.standard_normal((N, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pos = (v * r[:, None]).astype(np.float32)
        mass = np.full(N, 1.0 / N, np.float32)
        acc_o, pot_o = direct_acc_pot_np(pos, mass)
        _STATE.update(pos=pos, mass=mass, acc_o=acc_o, pot_o=pot_o)
    return _STATE["pos"], _STATE["mass"], _STATE["acc_o"], _STATE["pot_o"]


def _cfg(**kw):
    d = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=8,
             m2p_cap=2048, p2p_leaf_cap=512, p2p_src_cap=4096,
             frontier_cap=512)
    d.update(kw)
    if d.get("farfield") == "grid":
        d.setdefault("grid_level", 3)
    return JaxConfig(**d)


def _rms(acc, ref):
    acc = np.asarray(acc, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    rel = np.linalg.norm(acc - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-300)
    return float(np.sqrt(np.mean(rel ** 2)))


def _jax_query(**kw):
    """JAX-built tree, JAX results on it (Morton order), cached."""
    key = ("jax",) + tuple(sorted(kw.items()))
    if key not in _STATE:
        pos, mass, _, _ = _data()
        jc = _cfg(**kw)
        jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
        a, p, o, m = jengine.acc_pot_u_host(jtd, jc, jnp.float32(THETA),
                                            jnp.float32(0.0), 1.0)
        _STATE[key] = (jc, jtd, np.asarray(a), np.asarray(p),
                       np.asarray(o), np.asarray(m))
    return _STATE[key]


@pytest.mark.parametrize("farfield", ["grid", "local", "m2p"])
def test_query_matches_jax_on_the_same_tree(farfield):
    jc, jtd, a_j, p_j, o_j, m_j = _jax_query(farfield=farfield)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    a, p, o, m = engine.acc_pot_u_host(td, config_from_jax(jc), THETA,
                                       0.0, 1.0)
    assert not o_j.any()
    np.testing.assert_array_equal(o.numpy(), o_j)
    np.testing.assert_array_equal(m.numpy(), m_j)
    assert _rms(a, a_j) <= 1e-5
    assert _rms(p, p_j) <= 1e-5


@pytest.mark.parametrize("farfield", ["grid", "local", "m2p"])
def test_tree_api_matches_jax_and_oracle(farfield):
    pos, mass, acc_o, pot_o = _data()
    jc, jtd, a_j, p_j, _, _ = _jax_query(farfield=farfield)
    t = Tree(coords=pos, masses=mass, config=config_from_jax(jc),
             device="cpu")
    acc, pot = t.accs_pots_o(THETA)
    inv = np.asarray(jtd.inv_perm)
    assert _rms(acc, a_j[inv]) <= 1e-5
    assert _rms(pot, p_j[inv]) <= 1e-5
    # the oracle bounds of test_fast_smoke
    assert _rms(acc, acc_o) < 8e-3
    assert _rms(pot, pot_o) < 4e-3
    # accs-only / pots-only kernels give the same sums
    np.testing.assert_allclose(t.accs_o(THETA).numpy(), acc.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.pots_o(THETA).numpy(), pot.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_port_build_and_query_vs_oracle():
    """The port's own build (not the JAX tree) on the headline mode."""
    pos, mass, acc_o, pot_o = _data()
    cfg = config_from_jax(_cfg(farfield="grid"))
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    assert not bool(td.overflow)
    acc, pot, ovf, _ = engine.acc_pot_u_host(td, cfg, THETA, 0.0, 1.0)
    assert not ovf.any()
    inv = td.inv_perm
    assert _rms(acc[inv], acc_o) < 8e-3
    assert _rms(pot[inv], pot_o) < 4e-3


def test_tree_uo_duality_and_update_vs_rebuild():
    pos, mass, _, _ = _data()
    cfg = config_from_jax(_cfg(farfield="grid"))
    t = Tree(coords=pos, masses=mass, config=cfg, device="cpu")
    acc_o_view, _ = t.accs_pots_o(THETA)
    acc_u, _ = t.accs_pots_u(THETA)
    perm = t.perm.numpy()               # Morton slot -> user index
    np.testing.assert_array_equal(acc_u.numpy(), acc_o_view.numpy()[perm])
    np.testing.assert_array_equal(t.positions_o.numpy(), pos)
    # positions update keeps physics consistent with a fresh build
    p2 = pos.copy()
    p2[:64] += 0.01
    t.update_positions_o(p2)
    a2, _ = t.accs_pots_o(THETA)
    a2f, _ = Tree(coords=p2, masses=mass, config=cfg,
                  device="cpu").accs_pots_o(THETA)
    dev = np.max(np.linalg.norm(a2.numpy() - a2f.numpy(), axis=1))
    scale = np.max(np.linalg.norm(a2f.numpy(), axis=1))
    assert dev / scale < 2e-5, f"update vs rebuild dev {dev / scale:.2e}"
    np.testing.assert_array_equal(t.positions_o.numpy(), p2)
    # a mass update through a callable, in Morton order
    t.update_masses_u(lambda m: m * 2.0)
    a3, _ = t.accs_pots_o(THETA)
    np.testing.assert_allclose(a3.numpy(), 2.0 * a2.numpy(), rtol=1e-5,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(t.masses_o.numpy(), 2.0 * mass)


def test_exact_sums_match_oracle():
    pos, mass, acc_o, pot_o = _data()
    t = Tree(coords=pos, masses=mass, config=config_from_jax(_cfg()),
             device="cpu")
    acc, pot = t.exact_accs_pots_o()
    assert _rms(acc, acc_o) < 1e-5
    assert _rms(pot, pot_o) < 1e-5


def test_small_caps_flag_overflow_and_the_tree_grows_them():
    pos, mass, _, _ = _data()
    cfg = config_from_jax(_cfg(p2p_src_cap=128, m2p_cap=128,
                               p2p_leaf_cap=64))
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    _, _, ovf, _ = engine.acc_pot_u_host(td, cfg, 0.3, 0.0, 1.0)
    assert ovf[:3].all(), "tiny caps must overflow, never truncate silently"
    t = Tree(coords=pos, masses=mass, config=cfg, device="cpu")
    acc, _ = t.accs_pots_o(0.3)
    assert t.config.p2p_src_cap > 128 and t.config.m2p_cap > 128
    ref, _ = Tree(coords=pos, masses=mass, config=config_from_jax(_cfg()),
                  device="cpu").accs_pots_o(0.3)
    assert _rms(acc, ref) < 1e-5


def test_quadtree_from_xy_matches_jax_and_tune_caps():
    rng = np.random.default_rng(3)
    n = 1024
    pos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    jc = JaxConfig(ndim=2, max_depth=12, max_leaf_n=16, ncrit=64,
                   tile_chunk=8, m2p_cap=1024, p2p_leaf_cap=256,
                   p2p_src_cap=2048, frontier_cap=256, farfield="local")
    t = quadtree(x_coords=pos[:, 0], y_coords=pos[:, 1], masses=mass,
                 config=config_from_jax(jc), device="cpu")
    acc, pot = t.accs_pots_o(THETA)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    a_j, p_j, _, _ = jengine.acc_pot_u_host(jtd, jc, jnp.float32(THETA),
                                            jnp.float32(0.0), 1.0)
    inv = np.asarray(jtd.inv_perm)
    assert _rms(acc, np.asarray(a_j)[inv]) <= 1e-5
    assert _rms(pot, np.asarray(p_j)[inv]) <= 1e-5
    # snug caps from the measured maxima give the same answer
    tuned = t.tune_caps()
    assert tuned.m2p_cap < jc.m2p_cap or tuned.p2p_src_cap < jc.p2p_src_cap
    acc2, _ = t.accs_pots_o(THETA)
    assert _rms(acc2, acc) < 1e-5


def test_float64_tree_on_cpu():
    pos, mass, acc_o, pot_o = _data()
    cfg = config_from_jax(_cfg(farfield="grid", dtype="float64"))
    t = Tree(coords=pos.astype(np.float64), masses=mass.astype(np.float64),
             config=cfg, device="cpu")
    acc, pot = t.accs_pots_o(THETA)
    assert acc.dtype == torch.float64
    assert _rms(acc, acc_o) < 8e-3
    assert _rms(pot, pot_o) < 4e-3


@pytest.mark.parametrize("kw", [dict(traversal_mode="lmac"),
                                dict(traversal_mode="gwalk", farfield="grid2"),
                                dict(farfield="grid2")])
def test_modes_outside_the_slice_raise_at_query(kw):
    """gwalk with grid2 raises already in the build: its tiles would need
    grid2's cell clipping."""
    pos, mass, _, _ = _data()
    cfg = config_from_jax(_cfg(**kw))
    with pytest.raises(NotImplementedError):
        Tree(coords=pos[:256], masses=mass[:256], config=cfg,
             device="cpu").accs_pots_o(THETA)


MODES = {
    "m2p-quad": dict(farfield="m2p", multipole_order=2),
    "grid-comp": dict(farfield="grid", accum="compensated"),
    "local-comp": dict(farfield="local", accum="compensated"),
    "m2p-comp": dict(farfield="m2p", accum="compensated"),
    "m2p-quad-comp": dict(farfield="m2p", multipole_order=2,
                          accum="compensated"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax_on_the_same_tree(mode):
    """engine.acc_pot_u_host on the JAX-built tree: the quadrupole rows and
    the compensated sums give the reference's answer."""
    jc, jtd, a_j, p_j, o_j, m_j = _jax_query(**MODES[mode])
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    a, p, o, m = engine.acc_pot_u_host(td, config_from_jax(jc), THETA,
                                       0.0, 1.0)
    assert not o_j.any()
    np.testing.assert_array_equal(o.numpy(), o_j)
    np.testing.assert_array_equal(m.numpy(), m_j)
    assert _rms(a, a_j) <= 1e-5
    assert _rms(p, p_j) <= 1e-5


def test_quad_comp_tree_api_matches_jax_and_beats_monopole():
    """Tree.accs_pots_o with the energy configuration (m2p, quadrupole,
    compensated): the reference's answer on its tree, and closer to the
    oracle than the monopole at the same theta."""
    pos, mass, acc_o, pot_o = _data()
    jc, jtd, a_j, p_j, _, _ = _jax_query(**MODES["m2p-quad-comp"])
    t = Tree(coords=pos, masses=mass, config=config_from_jax(jc),
             device="cpu")
    acc, pot = t.accs_pots_o(THETA)
    inv = np.asarray(jtd.inv_perm)
    assert _rms(acc, a_j[inv]) <= 1e-5
    assert _rms(pot, p_j[inv]) <= 1e-5
    mono = Tree(coords=pos, masses=mass, config=config_from_jax(
        _cfg(farfield="m2p")), device="cpu")
    a0, p0 = mono.accs_pots_o(THETA)
    assert _rms(acc, acc_o) < _rms(a0, acc_o)
    assert _rms(pot, pot_o) < _rms(p0, pot_o)


def test_quad_with_tile_expansions_is_the_unported_lists_path(monkeypatch):
    monkeypatch.setenv("RAKAU_DIAG_MODES", "1")
    with pytest.raises(NotImplementedError, match="m2p"):
        engine.check_supported(config_from_jax(
            _cfg(farfield="local", multipole_order=2)))


def test_default_device_is_the_card(monkeypatch):
    """With no device given the tree goes to the card, whatever the input
    type; with no card it raises instead of running on the CPU."""
    pos, mass, _, _ = _data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for coords in (pos[:64], torch.as_tensor(pos[:64])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Tree(coords=coords, masses=mass[:64])
    t = Tree(coords=pos[:64], masses=mass[:64], device="cpu")
    assert t.device == torch.device("cpu")
