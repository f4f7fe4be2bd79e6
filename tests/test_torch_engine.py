"""The whole ported slice: rakau_tpu_torch.engine and the Tree API against
rakau_tpu on the same tree (per-particle relative force and potential RMS
<= 1e-5, the overflow flags and maxima exactly equal), for the monopole
fp32 far fields, for the compensated and quadrupole modes and for grid2
(monopole and quadrupole, fp32 and compensated), and against
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
    if d.get("farfield") == "grid2":
        # low order and a narrow stencil keep the reference's trace short
        for k, v in dict(grid_level=3, local_order=3, grid_sep=2).items():
            d.setdefault(k, v)
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


MODES = {
    "m2p-quad": dict(farfield="m2p", multipole_order=2),
    "grid-comp": dict(farfield="grid", accum="compensated"),
    "local-comp": dict(farfield="local", accum="compensated"),
    "m2p-comp": dict(farfield="m2p", accum="compensated"),
    "m2p-quad-comp": dict(farfield="m2p", multipole_order=2,
                          accum="compensated"),
    "grid2": dict(farfield="grid2"),
    "grid2-comp": dict(farfield="grid2", accum="compensated"),
    "grid2-quad": dict(farfield="grid2", multipole_order=2),
    "grid2-quad-comp": dict(farfield="grid2", multipole_order=2,
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


def _gauss(n, ndim=3, seed=4):
    rng = np.random.default_rng(seed)
    pos = np.clip(rng.normal(size=(n, ndim)) * 0.3, -1.4, 1.4)
    return (pos.astype(np.float32),
            rng.uniform(0.5, 1.5, size=n).astype(np.float32))


GRID2_KW = dict(max_leaf_n=16, ncrit=64, tile_chunk=8, m2p_cap=2048,
                p2p_leaf_cap=512, p2p_src_cap=4096, frontier_cap=512,
                farfield="grid2", grid_level=3)


def test_grid2_tree_api_vs_oracle():
    """tests/test_grid2.py:246-275 at a size that fits here: order 4
    inside the theta = 0.75 envelope (tiles of 64 span several of the
    512 leaf cells), the quadrupole closer, and order 6 at theta = 0.3
    close to the oracle."""
    pos, mass = _gauss(2048)
    acc_o, _ = direct_acc_pot_np(pos, mass)
    t = Tree(coords=pos, masses=mass, device="cpu", local_order=4,
             **GRID2_KW)
    acc, pot = t.accs_pots_o(THETA)
    rms4 = _rms(acc, acc_o)
    assert rms4 < 5.5e-3, rms4
    np.testing.assert_allclose(t.accs_o(THETA).numpy(), acc.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.pots_o(THETA).numpy(), pot.numpy(),
                               rtol=1e-6, atol=1e-7)
    tq = Tree(coords=pos, masses=mass, device="cpu", local_order=6,
              multipole_order=2, accum="compensated", **GRID2_KW)
    assert _rms(tq.accs_pots_o(THETA)[0], acc_o) < 0.6 * rms4
    t6 = Tree(coords=pos, masses=mass, device="cpu", local_order=6,
              **GRID2_KW)
    rms6 = _rms(t6.accs_pots_o(0.3)[0], acc_o)
    assert rms6 < 4e-4, rms6


def test_grid2_tune_caps_and_auto_level():
    """The occupancy-targeted level (n / 32 particles a cell: level 2 at
    2048), caps grown by the Tree and fitted by tune_caps."""
    pos, mass = _gauss(2048)
    acc_o, _ = direct_acc_pot_np(pos, mass)
    kw = dict(GRID2_KW, grid_level=None, m2p_cap=256, p2p_src_cap=1024)
    t = Tree(coords=pos, masses=mass, device="cpu", local_order=4, **kw)
    acc, _ = t.accs_pots_o(THETA)
    assert t.config.p2p_src_cap > 1024
    assert _rms(acc, acc_o) < 5.5e-3
    tuned = t.tune_caps()
    acc2, _ = t.accs_pots_o(THETA)
    assert t.config == tuned, "the fitted caps must hold the same query"
    assert _rms(acc2, acc) < 1e-5


def test_grid2_eps_and_G_thread_through():
    """tests/test_grid2.py:299-318: softening and G reach the far field."""
    pos, mass = _gauss(1024, seed=6)
    t = Tree(coords=pos, masses=mass, device="cpu", local_order=5,
             **dict(GRID2_KW, grid_level=2))
    acc, pot = t.accs_pots_o(0.4, eps=0.08, G=2.5)
    acc_o, pot_o = direct_acc_pot_np(pos, mass, eps=0.08, G=2.5)
    assert _rms(acc, acc_o) < 1e-3
    assert _rms(pot, pot_o) < 1e-3


def test_grid2_quadtree_and_float64():
    pos, mass = _gauss(1024, ndim=2, seed=7)
    acc_o, pot_o = direct_acc_pot_np(pos, mass)
    t = quadtree(x_coords=pos[:, 0], y_coords=pos[:, 1], masses=mass,
                 device="cpu", local_order=4, **GRID2_KW)
    acc, pot = t.accs_pots_o(0.5)
    assert acc.shape == (1024, 2)
    assert _rms(acc, acc_o) < 5e-3
    assert _rms(pot, pot_o) < 5e-3
    pos3, mass3 = _gauss(1024, seed=8)
    acc_o, _ = direct_acc_pot_np(pos3, mass3)
    t64 = Tree(coords=pos3.astype(np.float64), masses=mass3.astype(np.float64),
               device="cpu", local_order=6, **GRID2_KW)
    a64, _ = t64.accs_pots_o(0.3)
    assert a64.dtype == torch.float64
    assert _rms(a64, acc_o) < 4e-4


_EVERY = {}


@pytest.mark.parametrize("order,accum", [(0, "fp32"), (2, "compensated")])
@pytest.mark.parametrize("mode", ["shared", "gwalk"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_grid2_runs_in_every_mode(ndim, dtype, mode, order, accum):
    """farfield='grid2' through the Tree API on both traversals, with the
    monopole or the quadrupole, fp32 or compensated sums, in 2-D and 3-D,
    float32 and float64: inside the oracle bound at theta = 0.6, and the
    float64 tree agrees with the float32 one."""
    pos, mass = _gauss(1024, ndim=ndim, seed=9)
    caps = dict(m2p_cap=2048, p2p_leaf_cap=512, p2p_src_cap=4096,
                frontier_cap=512)
    if mode == "gwalk":
        caps = dict(m2p_cap=16384, p2p_leaf_cap=12288, p2p_src_cap=131072,
                    frontier_cap=2048, pool_window=32768, pool_block=128,
                    pool_group=2)
    t = Tree(coords=pos.astype(dtype), masses=mass.astype(dtype), ndim=ndim,
             device="cpu", max_leaf_n=16, ncrit=64, tile_chunk=8,
             farfield="grid2", grid_level=3, local_order=4, grid_sep=2,
             traversal_mode=mode, multipole_order=order, accum=accum, **caps)
    acc, pot = t.accs_pots_o(0.6)
    assert str(acc.dtype) == "torch." + dtype and acc.shape == (1024, ndim)
    acc_o, pot_o = direct_acc_pot_np(pos, mass)
    assert _rms(acc, acc_o) < 8e-3 and _rms(pot, pot_o) < 4e-3
    other = _EVERY.setdefault((ndim, mode, order), acc.double())
    assert _rms(acc.double(), other.numpy()) < 1e-5


def test_kernel_inputs_carry_the_cells():
    """engine.kernel_inputs hands out what a grid2 query passes to
    dispatch.eval_shared, cells included."""
    pos, mass, _, _ = _data()
    cfg = config_from_jax(_cfg(farfield="grid2", multipole_order=2))
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    out = engine.kernel_inputs(td, cfg, THETA, 0.0, 1)
    assert len(out) == 9
    S = cfg.m2p_cap + cfg.p2p_src_cap
    assert out[6].shape == (cfg.m2p_cap, 6)
    assert out[7].shape == (S, 3) and out[7].dtype == torch.int64
    assert out[8].shape == (cfg.tile_chunk, cfg.ncrit, 3)
    assert engine.kernel_inputs(td, cfg.with_(farfield="m2p"), THETA, 0.0,
                                1)[7:] == (None, None)


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
