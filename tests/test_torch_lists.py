"""The lists path of rakau_tpu_torch (traversal_mode="lists", and the
quadrupole with the "local" and "grid" far fields, which runs on it)
against rakau_tpu on the same JAX-built tree: per-particle relative force
and potential RMS <= 2e-4, the overflow flags and maxima exactly equal;
the Tree API's grow-and-retry on it; the mirror of
tests/test_engine.py::test_quadrupole_shared_matches_lists; and
metrics.collect_query_stats and fitted_caps against rakau_tpu.metrics
(every QueryStats field exactly equal)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu import metrics as jmetrics
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import Tree, build, engine, metrics
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy
from rakau_tpu_torch.direct import direct_acc_pot_np
from rakau_tpu_torch.kernels import shared, tiles

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

THETA = 0.6
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
BASE = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=8,
            m2p_cap=1024, p2p_leaf_cap=1024, p2p_src_cap=8192,
            frontier_cap=512)


def plummer_np(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


def _rms(acc, ref):
    acc = np.asarray(acc, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    rel = np.linalg.norm(acc - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-300)
    return float(np.sqrt(np.mean(rel ** 2)))


def _both(jc, n=2048, seed=11, theta=THETA, eps=0.0):
    """(port results, reference results), each (acc, pot, ovf, maxima) in
    Morton order on one JAX-built tree."""
    pos, mass = plummer_np(n, seed)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    want = jengine.acc_pot_u_host(jtd, jc, jnp.float32(theta),
                                  jnp.float32(eps), 1.0)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    got = engine.acc_pot_u_host(td, config_from_jax(jc), theta, eps, 1.0)
    return ([x.numpy() for x in got], [np.asarray(x) for x in want])


@pytest.mark.parametrize("kw", [
    dict(traversal_mode="lists", farfield="m2p"),
    dict(traversal_mode="lists", farfield="local", mac="bh_geom"),
    dict(farfield="local", multipole_order=2),
    dict(farfield="grid", grid_level=3, multipole_order=2),
    dict(traversal_mode="lmac", farfield="local", multipole_order=2),
], ids=["lists-m2p", "lists-local-geom", "quad-local", "quad-grid",
        "lmac-quad-local"])
def test_lists_query_matches_jax(kw, diag_modes):
    tiles.reset_launches()
    got, want = _both(JaxConfig(**dict(BASE, **kw)), eps=0.01)
    assert _rms(got[0], want[0]) <= 2e-4
    assert _rms(got[1], want[1]) <= 2e-4
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert not got[2].any()
    # the quadrupole takes the reference's plain-op route, the monopole the
    # per-tile kernel's plain version (CPU tensors)
    quad = kw.get("multipole_order", 0) == 2
    assert (tiles.launches["xla_quad"] > 0) == quad


def test_overflow_is_flagged_and_the_tree_grows_its_caps(diag_modes):
    jc = JaxConfig(**dict(BASE, traversal_mode="lists", farfield="m2p",
                          m2p_cap=32, p2p_src_cap=128, p2p_leaf_cap=32))
    got, want = _both(jc)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[2][:3].all()
    pos, mass = plummer_np(2048, 11)
    t = Tree(coords=pos, masses=mass, config=config_from_jax(jc),
             device="cpu")
    acc, pot = t.accs_pots_o(THETA)
    assert t.config.m2p_cap > 32 and t.config.p2p_src_cap > 128
    ref = Tree(coords=pos, masses=mass,
               config=config_from_jax(JaxConfig(**dict(
                   BASE, traversal_mode="lists", farfield="m2p"))),
               device="cpu")
    acc_r, pot_r = ref.accs_pots_o(THETA)
    assert _rms(acc, acc_r) < 1e-5 and _rms(pot, pot_r) < 1e-5
    # snug caps from the last query's maxima hold too
    t.tune_caps()
    acc2, _ = t.accs_pots_o(THETA)
    assert _rms(acc2, acc) < 1e-5


def test_quadrupole_shared_matches_lists(diag_modes):
    """Mirror of tests/test_engine.py::test_quadrupole_shared_matches_lists
    on the port: the quadrupole on the shared traversal and on the lists
    path agree, and both beat the monopole."""
    n = 4096
    pos, mass = plummer_np(n, 13)
    acc_o, _ = direct_acc_pot_np(pos, mass)
    base = config_from_jax(JaxConfig(max_depth=10, max_leaf_n=16, ncrit=64,
                                     tile_chunk=16, p2p_leaf_cap=2048,
                                     farfield="m2p"))

    def query(cfg):
        return Tree(coords=pos, masses=mass, config=cfg,
                    device="cpu").accs_pots_o(0.6)[0].numpy()

    a_mono = query(base)
    a_lists = query(base.with_(multipole_order=2, traversal_mode="lists"))
    a_shared = query(base.with_(multipole_order=2))
    e_mono, e_lists, e_shared = (_rms(a, acc_o)
                                 for a in (a_mono, a_lists, a_shared))
    assert e_shared < 0.5 * e_mono, (e_shared, e_mono)
    assert abs(e_shared - e_lists) < 0.1 * e_lists, (e_shared, e_lists)
    np.testing.assert_allclose(a_shared, a_lists, rtol=5e-3, atol=1e-7)


def test_tile_kernel_inputs_are_what_the_query_evaluates(diag_modes):
    pos, mass = plummer_np(2048, 11)
    cfg = config_from_jax(JaxConfig(**dict(BASE, traversal_mode="lists",
                                           farfield="m2p")))
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    inp = engine.tile_kernel_inputs(td, cfg, THETA, 0.0, 1)
    assert len(inp) == 10 and inp[4] is None
    C, T = cfg.tile_chunk, cfg.ncrit
    assert inp[2].shape == (C, cfg.m2p_cap, 3)
    assert inp[5].shape == (C, cfg.p2p_src_cap, 3)
    assert inp[8].shape == inp[9].shape == (C,)
    acc, pot = tiles.eval_tiles_plain(
        *inp[:4], *inp[5:8], shared.scalar_buffer(0.0, 1.0, inp[0]),
        m2p_cnt=inp[8], p2p_cnt=inp[9])
    full, _, _, _ = engine.acc_pot_u_host(td, cfg, THETA, 0.0)
    tidx = inp[1]
    real = tidx < td.pos.shape[0]
    torch.testing.assert_close(acc[real], full[tidx[real]], rtol=0, atol=0)
    with pytest.raises(ValueError, match="lists"):
        engine.tile_kernel_inputs(td, cfg.with_(traversal_mode="shared"),
                                  THETA, 0.0, 1)


def test_no_grid_far_field_is_built_for_the_lists_path(diag_modes):
    cfg = config_from_jax(JaxConfig(**dict(BASE, farfield="grid",
                                           grid_level=3)))
    pos, mass = plummer_np(512, 3)
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    assert engine._grid_farfield(td, cfg, 0.0) is not None
    for other in (cfg.with_(traversal_mode="lists"),
                  cfg.with_(multipole_order=2)):
        assert engine._grid_farfield(td, other, 0.0) is None


@pytest.mark.parametrize("max_chunks", [16, 3])
def test_query_stats_and_fitted_caps_match_jax(max_chunks, monkeypatch):
    """metrics.collect_query_stats (mirror of
    tests/test_checkpoint_metrics.py:45-63): every field equal to the
    reference's on the same tree, from a shared-mode config (the lists
    config is switched on for the call only), and the fitted caps hold."""
    monkeypatch.delenv("RAKAU_DIAG_MODES", raising=False)
    pos, mass = plummer_np(2048, 43)
    jc = JaxConfig(**dict(BASE, farfield="m2p"))
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    cfg = config_from_jax(jc)
    st = metrics.collect_query_stats(td, cfg, 0.5, max_chunks=max_chunks)
    want = jmetrics.collect_query_stats(jtd, jc, 0.5, max_chunks=max_chunks)
    assert st.as_dict() == want.as_dict()
    assert st.n == 2048 and 0 < st.tile_fill <= 1.0
    assert st.m2p_max <= cfg.m2p_cap and st.p2p_max <= cfg.p2p_src_cap
    caps = metrics.fitted_caps(st)
    assert caps == jmetrics.fitted_caps(want)
    # the diagnostic switch was on for the call only
    assert "RAKAU_DIAG_MODES" not in os.environ
    monkeypatch.setenv("RAKAU_DIAG_MODES", "1")
    cfg2 = cfg.with_(traversal_mode="lists", **caps)
    _, _, ovf, _ = engine.acc_pot_u_host(td, cfg2, 0.5, 0.0)
    assert not bool(ovf[:3].any())
