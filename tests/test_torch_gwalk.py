"""The gwalk engine of rakau_tpu_torch (engine.acc_pot_u_host with
traversal_mode="gwalk", tune_gwalk and the Tree API) against
rakau_tpu.engine on the same JAX-built tree, for the "m2p", "grid" and
"grid2" far fields and the quadrupole with compensated sums (with "m2p"
and "grid2"): the overflow flags and
maxima exactly equal, accelerations and potentials to a per-particle
relative RMS <= 1e-5 (the reference's own gwalk test allows 1e-4 against
the shared engine), the fitted config equal; plus the grow-and-retry and
the float64 direct-sum oracle with the bounds of tests/test_fast_smoke.py
(force RMS < 8e-3, potential RMS < 4e-3 at theta=0.75)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import Tree, engine
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy
from rakau_tpu_torch.direct import direct_acc_pot_np
from rakau_tpu_torch.kernels import dispatch

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 2048
THETA = 0.75
BASE = dict(max_depth=9, max_leaf_n=16, ncrit=64, tile_chunk=8,
            m2p_cap=16384, p2p_leaf_cap=12288, p2p_src_cap=131072,
            frontier_cap=2048, pool_window=32768, pool_block=128,
            pool_group=2, traversal_mode="gwalk")
MODES = {
    "m2p": dict(farfield="m2p"),
    "grid": dict(farfield="grid", grid_level=3),
    "m2p-quad-comp": dict(farfield="m2p", multipole_order=2,
                          accum="compensated"),
    # tiles clipped at grid2's cells; low order and a narrow stencil keep
    # the reference's trace short
    "grid2": dict(farfield="grid2", grid_level=3, local_order=3,
                  grid_sep=2),
    "grid2-quad-comp": dict(farfield="grid2", grid_level=3, local_order=3,
                            grid_sep=2, multipole_order=2,
                            accum="compensated"),
}
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
_STATE = {}


def _data():
    """Plummer sample made with numpy, and its float64 oracle."""
    if not _STATE:
        rng = np.random.default_rng(17)
        u = rng.uniform(1e-6, 1 - 1e-6, N)
        r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
        v = rng.standard_normal((N, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pos = (v * r[:, None]).astype(np.float32)
        mass = np.full(N, 1.0 / N, np.float32)
        acc_o, pot_o = direct_acc_pot_np(pos, mass)
        _STATE.update(pos=pos, mass=mass, acc_o=acc_o, pot_o=pot_o)
    return _STATE["pos"], _STATE["mass"], _STATE["acc_o"], _STATE["pot_o"]


def _rms(acc, ref):
    acc = np.asarray(acc, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    rel = np.linalg.norm(acc - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-300)
    return float(np.sqrt(np.mean(rel ** 2)))


def _jax_case(mode):
    """JAX config and tree, the port's copy of the tree, and the
    reference's query on it (Morton order), cached per mode."""
    if mode not in _STATE:
        pos, mass, _, _ = _data()
        jc = JaxConfig(**BASE, **MODES[mode])
        jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
        td = treedata_from_numpy(
            {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
        _STATE[mode] = (jc, jtd, td, _jax_query(jtd, jc))
    return _STATE[mode]


def _jax_query(jtd, jc):
    return tuple(np.asarray(x) for x in jengine.acc_pot_u_host(
        jtd, jc, jnp.float32(THETA), jnp.float32(0.0), 1.0))


def _assert_matches(got, want):
    a, p, o, m = got
    a_j, p_j, o_j, m_j = want
    assert not o_j.any()
    np.testing.assert_array_equal(o.numpy(), o_j)
    np.testing.assert_array_equal(m.numpy(), m_j)
    assert _rms(a, a_j) <= 1e-5
    assert _rms(p, p_j) <= 1e-5


@pytest.mark.parametrize("mode", list(MODES))
def test_query_matches_jax_on_the_same_tree(mode):
    jc, _, td, want = _jax_case(mode)
    got = engine.acc_pot_u_host(td, config_from_jax(jc), THETA, 0.0, 1.0)
    _assert_matches(got, want)


def test_pool_inputs_are_what_the_query_hands_the_kernel(monkeypatch):
    """engine.pool_inputs (the kernel phase's operands in chip_smoke.py)
    returns exactly the tensors a query passes to dispatch.eval_pool."""
    jc, _, td, _ = _jax_case("m2p-quad-comp")
    cfg = config_from_jax(jc)
    seen = []

    class Seen(Exception):
        pass

    def spy(cfg_, *args, pool_quad=None, **kw):
        seen.append(args[:6] + (pool_quad,))
        raise Seen

    monkeypatch.setattr(dispatch, "eval_pool", spy)
    with pytest.raises(Seen):
        engine.acc_pot_u_host(td, cfg, THETA, 0.0, 1.0)
    got = engine.pool_inputs(td, cfg, THETA, 0.0)
    assert len(got) == 7 and got[6] is not None
    for g, w in zip(got, seen[0]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["m2p", "grid", "grid2"])
def test_tune_gwalk_matches_jax(mode):
    """tune_gwalk fits the same caps and round caps as the reference, and
    the unrolled walk it selects gives exactly the dynamic walk's query
    (which test_query_matches_jax_on_the_same_tree holds to the
    reference's; the unrolled lists themselves are held to the
    reference's in test_torch_traversal4.py)."""
    jc, jtd, td, _ = _jax_case(mode)
    want = jengine.tune_gwalk(jtd, jc, THETA, 0.0)
    cfg = config_from_jax(jc)
    got = engine.tune_gwalk(td, cfg, THETA, 0.0)
    assert got == config_from_jax(want)
    assert got.gwalk_round_caps is not None and len(got.gwalk_round_caps) > 2
    a, p, o, m = engine.acc_pot_u_host(td, got, THETA, 0.0, 1.0)
    a_d, p_d, o_d, m_d = engine.acc_pot_u_host(
        td, got.with_(gwalk_round_caps=None), THETA, 0.0, 1.0)
    assert not o.any() and not o_d.any()
    assert torch.equal(a, a_d) and torch.equal(p, p_d)
    # the frontier peak of the dynamic walk also counts the G root pairs
    assert m[[0, 1, 3]].tolist() == m_d[[0, 1, 3]].tolist()


def test_tree_grows_undersized_caps():
    """Undersized global caps flag overflow; the Tree doubles them until
    the query fits, and gets the answer of generous caps."""
    pos, mass, _, _ = _data()
    jc, jtd, td, _ = _jax_case("m2p")
    jsmall = jc.with_(m2p_cap=4096, p2p_leaf_cap=2048, p2p_src_cap=16384,
                      pool_window=16384)
    small = config_from_jax(jsmall)
    _, _, o_j, m_j = _jax_query(jtd, jsmall)
    assert o_j.tolist() == [True, True, True, False]
    _, _, ovf, mx = engine.acc_pot_u_host(td, small, THETA, 0.0)
    np.testing.assert_array_equal(ovf.numpy(), o_j)
    np.testing.assert_array_equal(mx.numpy(), m_j)
    t = Tree(coords=pos, masses=mass, config=small, device="cpu")
    acc, pot = t.accs_pots_o(THETA)
    assert t.config.m2p_cap > 4096 and t.config.p2p_src_cap > 32768
    ref = Tree(coords=pos, masses=mass, config=config_from_jax(jc),
               device="cpu")
    acc_r, pot_r = ref.accs_pots_o(THETA)
    assert _rms(acc, acc_r) < 1e-6 and _rms(pot, pot_r) < 1e-6


def test_tree_api_gwalk_grid_matches_jax_and_oracle():
    pos, mass, acc_o, pot_o = _data()
    jc, jtd, _, (a_j, p_j, _, _) = _jax_case("grid")
    t = Tree(coords=pos, masses=mass, config=config_from_jax(jc),
             device="cpu")
    acc, pot = t.accs_pots_o(THETA)
    inv = np.asarray(jtd.inv_perm)
    assert _rms(acc, a_j[inv]) <= 1e-5
    assert _rms(pot, p_j[inv]) <= 1e-5
    assert _rms(acc, acc_o) < 8e-3
    assert _rms(pot, pot_o) < 4e-3
    # accs-only / pots-only sums give the same answer
    np.testing.assert_allclose(t.accs_o(THETA).numpy(), acc.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.pots_o(THETA).numpy(), pot.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_quadrupole_beats_monopole():
    """As tests/test_gwalk.py:120-130 holds the reference: the quadrupole
    pool rows halve the force error of the monopole."""
    pos, mass, acc_o, _ = _data()
    cfg = config_from_jax(JaxConfig(**BASE, farfield="m2p"))
    a_m, _ = Tree(coords=pos, masses=mass, config=cfg,
                  device="cpu").accs_pots_o(THETA)
    a_q, _ = Tree(coords=pos, masses=mass, device="cpu",
                  config=cfg.with_(multipole_order=2,
                                   accum="compensated")).accs_pots_o(THETA)
    assert _rms(a_q, acc_o) < 0.5 * _rms(a_m, acc_o)


def test_tree_api_gwalk_grid2_matches_jax_and_oracle():
    """tests/test_gwalk.py:78-117 and tests/test_fast_smoke.py:80-95 at
    n = 2048: the Tree API with gwalk + grid2 gives the reference's answer
    on its tree, stays inside the oracle bounds, and the quadrupole +
    compensated form is closer to the oracle than the monopole."""
    pos, mass, acc_o, pot_o = _data()
    rms = {}
    for mode in ("grid2", "grid2-quad-comp"):
        jc, jtd, _, (a_j, p_j, _, _) = _jax_case(mode)
        t = Tree(coords=pos, masses=mass, config=config_from_jax(jc),
                 device="cpu")
        acc, pot = t.accs_pots_o(THETA)
        inv = np.asarray(jtd.inv_perm)
        assert _rms(acc, a_j[inv]) <= 1e-5
        assert _rms(pot, p_j[inv]) <= 1e-5
        assert _rms(acc, acc_o) < 8e-3
        assert _rms(pot, pot_o) < 4e-3
        rms[mode] = _rms(acc, acc_o)
    assert rms["grid2-quad-comp"] < rms["grid2"]


def test_gwalk_grid2_auto_level_order_4_and_the_shared_engine():
    """The auto level of gwalk + grid2 tracks n / ncrit (level 1 at 2048
    particles in tiles of 64: no stencil level, all near), a set level 3
    at order 4 and grid_sep 3 stays inside the oracle bounds and within
    15 % of the shared engine's error with the same far field
    (tests/test_gwalk.py:78-99)."""
    pos, mass, acc_o, pot_o = _data()
    cfg = config_from_jax(JaxConfig(**BASE, farfield="grid2",
                                    local_order=4))
    t = Tree(coords=pos, masses=mass, config=cfg, device="cpu")
    assert engine.grid2.effective_grid_level(cfg, N) == 1
    acc, pot = t.accs_pots_o(THETA)
    assert _rms(acc, acc_o) < 8e-3 and _rms(pot, pot_o) < 4e-3
    g = Tree(coords=pos, masses=mass, device="cpu",
             config=cfg.with_(grid_level=3)).accs_pots_o(THETA)[0]
    s = Tree(coords=pos, masses=mass, device="cpu", config=cfg.with_(
        grid_level=3, traversal_mode="shared", m2p_cap=2048,
        p2p_leaf_cap=512, p2p_src_cap=4096, frontier_cap=512)
    ).accs_pots_o(THETA)[0]
    assert _rms(g, acc_o) < 8e-3
    assert abs(_rms(g, acc_o) - _rms(s, acc_o)) < 0.15 * _rms(s, acc_o)
