"""BASELINE.json's configurations #0, #1, #3 and #4 (benchmarks/configs.py)
at small N on the CPU, through rakau_tpu as configs.py calls it and
through rakau_tpu_torch on the same float32 arrays (made with numpy from
a seed): #0, 16,384 Plummer particles through the build and acc_pot_u;
#1, a 16,384-particle uniform cube through integrate.acc_pot at each
softening of the sweep; #3, an 8,192-particle disk galaxy with
compensated sums: a build, a rebuild of its Morton-ordered positions
after a 1e-4 drift, acc_pot_u_host; #4, a 16,384-particle uniform cube
through sharded.acc_pot_sharded on a 4-shard mesh (JAX's host devices, a
CPU mesh of four labels here). Integer outputs (the build's permutation,
the overflow flags and maxima) are held exactly equal, forces and
potentials within the reference's kernel tolerance (rtol 2e-4, atol 2e-5
of the largest, tests/test_pallas.py).

The reference's own error against the float64 direct sum on these inputs
(RMS of the relative force / potential error over every target, theta
0.75, at the caps below), from which chip_smoke.py's bounds for the
configurations are derived (CONFIG_ERRORS holds the port to them):
  * #0, Plummer 16,384:                 force 2.096e-3, pot 1.945e-4;
  * #1, uniform cube 16,384, eps 0:     force 2.340e-3, pot 1.159e-4;
                           eps 1e-3:     force 2.341e-3, pot 1.159e-4;
                           eps 1e-2:     force 2.465e-3, pot 1.162e-4;
  * #3, disk 8,192 (compensated):       force 1.163e-2, pot 3.291e-3;
  * #4, uniform cube 16,384 (sharded):  force 2.460e-3, pot 1.673e-4.
The cube's stay under the uniform-density bound chip_smoke.py already
holds (1.5e-2). The disk's exceed the Plummer bounds (5e-3 / 2e-3) and
grow with N, equal in both packages (test_disk_error_grows_with_n, RMS
at 256 sampled targets): force 1.303e-2, 1.911e-2, 2.247e-2 and
potential 3.199e-3, 6.027e-3, 7.227e-3 at 8,192, 65,536 and 262,144
particles; chip_smoke.py holds the card's 1 << 26 disk to 1.1 x the line
through the two largest, in log2 N, at 1 << 26 (3.95e-2 / 1.32e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu import integrate as jintegrate
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu.parallel import sharded as jsharded
from rakau_tpu_torch import engine, integrate
from rakau_tpu_torch.convert import config_from_jax
from rakau_tpu_torch.direct import direct_acc_pot_np
from rakau_tpu_torch.parallel import sharded

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

RTOL, ATOL_REL = 2e-4, 2e-5
THETA = 0.75
# benchmarks/configs.py's TreeConfigs
CFG0 = JaxConfig(max_depth=12, max_leaf_n=32, ncrit=128, tile_chunk=64,
                 p2p_leaf_cap=2048)
CFG1 = JaxConfig(max_depth=12, max_leaf_n=32, ncrit=512, tile_chunk=32,
                 p2p_leaf_cap=4096, p2p_src_cap=32768)
CFG3 = JaxConfig(max_depth=14, max_leaf_n=32, ncrit=512, tile_chunk=32,
                 p2p_leaf_cap=4096, p2p_src_cap=49152, m2p_cap=12288,
                 accum="compensated")
CFG4 = JaxConfig(max_depth=10, max_leaf_n=64, ncrit=256, tile_chunk=64,
                 p2p_leaf_cap=2048)
# configs.py's caps overflow p2p_src_cap (8192) on the inputs of #0 and #4
# in both packages (12,786 and 14,020 rows); the runs take it doubled, as
# a Tree query grows it (config.grow_overflowed)
RUN0 = CFG0.with_(p2p_src_cap=16384)
RUN4 = CFG4.with_(p2p_src_cap=16384)
EPS1 = (0.0, 1e-3, 1e-2)
# the reference's RMS errors in the docstring (#1: the largest of the
# sweep), each with 5 % of room: the port's own error must stay inside
CONFIG_ERRORS = {"0": (2.096e-3, 1.945e-4), "1": (2.465e-3, 1.162e-4),
                 "3": (1.163e-2, 3.291e-3), "4": (2.460e-3, 1.673e-4)}


def _plummer(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * r[:, None]


def _cube(n, seed):
    """particles.uniform_cube's distribution (side 0.999, centred)."""
    return np.random.default_rng(seed).uniform(-0.4995, 0.4995, (n, 3))


def _disk(n, seed):
    """particles.disk_galaxy's distribution (gamma(2) radius cut at 20,
    uniform azimuth, Gaussian height of scale 0.05)."""
    rng = np.random.default_rng(seed)
    r = np.minimum(-(np.log(rng.uniform(1e-6, 1 - 1e-6, n))
                     + np.log(rng.uniform(1e-6, 1 - 1e-6, n))), 20.0)
    phi = rng.uniform(0, 2 * np.pi, n)
    z = 0.05 * rng.standard_normal(n)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _f32(pos):
    pos = np.ascontiguousarray(pos, np.float32)
    return pos, np.full(pos.shape[0], 1.0 / pos.shape[0], np.float32)


def _close(got, want):
    """The port's array within the reference kernel's tolerance of the
    reference's."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = ATOL_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _errors(pos, mass, acc, pot, eps=0.0):
    """RMS relative force and potential errors over every target against
    the float64 direct sum (targets in the arrays' order)."""
    a_o, p_o = direct_acc_pot_np(pos.astype(np.float64),
                                 mass.astype(np.float64), eps=eps)
    acc, pot = np.asarray(acc, np.float64), np.asarray(pot, np.float64)
    f = np.linalg.norm(acc - a_o, axis=1) / np.linalg.norm(a_o, axis=1)
    p = np.abs(pot - p_o) / np.abs(p_o)
    return float(np.sqrt(np.mean(f ** 2))), float(np.sqrt(np.mean(p ** 2)))


def _within_reference_error(key, pos, mass, acc, pot, eps=0.0):
    f, p = _errors(pos, mass, acc, pot, eps)
    f_max, p_max = CONFIG_ERRORS[key]
    assert f <= 1.05 * f_max and p <= 1.05 * p_max, (f, p)


_build_j = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
# eps traced, as configs.py's sweep passes it: one executable for the sweep
_acc_pot_j = jax.jit(jintegrate.acc_pot, static_argnames=("cfg",))


def test_config0_plummer_accuracy():
    pos, mass = _f32(_plummer(16384, 0))
    jtd = _build_j(jnp.asarray(pos), jnp.asarray(mass), RUN0)
    acc_j, pot_j, ovf_j = jax.jit(jengine.acc_pot_u,
                                  static_argnames=("cfg",))(
        jtd, RUN0, jnp.float32(THETA), jnp.float32(0.0), jnp.float32(1.0))
    cfg = config_from_jax(RUN0)
    td = engine.build_tree(torch.from_numpy(pos), torch.from_numpy(mass), cfg)
    np.testing.assert_array_equal(td.perm.numpy(), np.asarray(jtd.perm))
    acc, pot, ovf = engine.acc_pot_u(td, cfg, THETA, 0.0, 1.0)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j))
    assert not ovf.any()
    _close(acc.numpy(), acc_j)
    _close(pot.numpy(), pot_j)
    _within_reference_error("0", td.pos.numpy(), td.mass.numpy(),
                            acc.numpy(), pot.numpy())


@pytest.mark.parametrize("eps", EPS1)
def test_config1_uniform_cube_softening(eps):
    pos, mass = _f32(_cube(16384, 1))
    acc_j, pot_j, ovf_j = _acc_pot_j(
        jnp.asarray(pos), jnp.asarray(mass), CFG1, jnp.float32(THETA),
        jnp.float32(eps))
    acc, pot, ovf = integrate.acc_pot(torch.from_numpy(pos),
                                      torch.from_numpy(mass),
                                      config_from_jax(CFG1), THETA, eps)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j))
    assert not ovf.any()
    _close(acc.numpy(), acc_j)
    _close(pot.numpy(), pot_j)
    _within_reference_error("1", pos, mass, acc.numpy(), pot.numpy(), eps)


def test_config3_disk_rebuild_compensated():
    pos, mass = _f32(_disk(8192, 3))
    drift = (1e-4 * np.random.default_rng(4).standard_normal(
        pos.shape)).astype(np.float32)
    # the reference: build, the drifted Morton-ordered positions rebuilt,
    # one compensated query (configs.py:163-177)
    jtd = _build_j(jnp.asarray(pos), jnp.asarray(mass), CFG3)
    jpos2 = jtd.pos + jnp.asarray(drift)
    jtd2 = _build_j(jpos2, jtd.mass, CFG3)
    acc_j, pot_j, ovf_j, mx_j = jengine.acc_pot_u_host(
        jtd2, CFG3, jnp.float32(THETA), jnp.float32(0.0), 1.0)
    cfg = config_from_jax(CFG3)
    td = engine.build_tree(torch.from_numpy(pos), torch.from_numpy(mass), cfg)
    np.testing.assert_array_equal(td.perm.numpy(), np.asarray(jtd.perm))
    td2 = engine.build_tree(td.pos + torch.from_numpy(drift), td.mass, cfg)
    np.testing.assert_array_equal(td2.perm.numpy(), np.asarray(jtd2.perm))
    np.testing.assert_array_equal(td2.pos.numpy(), np.asarray(jtd2.pos))
    acc, pot, ovf, mx = engine.acc_pot_u_host(td2, cfg, THETA, 0.0, 1.0)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j))
    np.testing.assert_array_equal(np.asarray(mx), np.asarray(mx_j))
    assert not ovf.any()
    _close(acc.numpy(), acc_j)
    _close(pot.numpy(), pot_j)
    _within_reference_error("3", td2.pos.numpy(), td2.mass.numpy(),
                            acc.numpy(), pot.numpy())


def test_config4_sharded_weak_scaling():
    pos, mass = _f32(_cube(16384, 5))
    acc_j, pot_j, ovf_j = jax.jit(
        lambda p, m: jsharded.acc_pot_sharded(
            p, m, RUN4, jnp.float32(THETA), jnp.float32(0.0), 1.0,
            jsharded.default_mesh(4)))(jnp.asarray(pos), jnp.asarray(mass))
    acc, pot, ovf = sharded.acc_pot_sharded(
        torch.from_numpy(pos), torch.from_numpy(mass), config_from_jax(RUN4),
        THETA, 0.0, 1.0, sharded.default_mesh(4, device="cpu"))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j))
    assert not ovf.any()
    _close(acc.numpy(), acc_j)
    _close(pot.numpy(), pot_j)
    _within_reference_error("4", pos, mass, acc.numpy(), pot.numpy())


@pytest.mark.parametrize("key", ("0", "4"))
def test_configs_own_caps_overflow_p2p_src_here(key):
    """At configs.py's own caps the queries of #0 and #4 flag p2p_src_cap
    (the reference's flags on these inputs too: [F, F, T, F]); the doubled
    cap of RUN0 / RUN4 holds every row."""
    jc, run, pos = {"0": (CFG0, RUN0, _plummer(16384, 0)),
                    "4": (CFG4, RUN4, _cube(16384, 5))}[key]
    pos, mass = _f32(pos)
    for c, want in ((jc, [False, False, True, False]), (run, [False] * 4)):
        cfg = config_from_jax(c)
        td = engine.build_tree(torch.from_numpy(pos), torch.from_numpy(mass),
                               cfg)
        _, _, ovf, mx = engine.acc_pot_u_host(td, cfg, THETA, 0.0, 1.0)
        assert ovf.tolist() == want
        assert int(mx[1]) == {"0": 12786, "4": 14020}[key] > jc.p2p_src_cap


# the disk's error at larger N (256 targets, seed 1 of numpy's default
# generator), the points chip_smoke.py's DISK_ERRORS holds: the caps of
# CFG3 with the p2p_leaf, p2p_src and frontier caps that hold every row
# up to 262,144 particles
DISK_RUN = CFG3.with_(p2p_leaf_cap=8192, p2p_src_cap=98304,
                      frontier_cap=2048)
DISK_ERRORS = {8192: (1.303e-2, 3.199e-3), 65536: (1.911e-2, 6.027e-3),
               262144: (2.247e-2, 7.227e-3)}


@pytest.mark.slow
@pytest.mark.parametrize("n", sorted(DISK_ERRORS))
def test_disk_error_grows_with_n(n):
    """#3's disk through both packages at n particles (the reference's
    acc_pot_u_host, the port's): within the kernel tolerance of each
    other, with no overflow; the RMS errors at 256 sampled targets against
    the float64 direct sum are DISK_ERRORS[n] (within 1 %), and grow with
    n: the monopole's error on a thin disk, which chip_smoke.py
    extrapolates to 1 << 26 for its bound."""
    pos, mass = _f32(_disk(n, 3))
    jtd = _build_j(jnp.asarray(pos), jnp.asarray(mass), DISK_RUN)
    acc_j, pot_j, ovf_j, _ = jengine.acc_pot_u_host(
        jtd, DISK_RUN, jnp.float32(THETA), jnp.float32(0.0), 1.0)
    cfg = config_from_jax(DISK_RUN)
    td = engine.build_tree(torch.from_numpy(pos), torch.from_numpy(mass), cfg)
    acc, pot, ovf, _ = engine.acc_pot_u_host(td, cfg, THETA, 0.0, 1.0)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j))
    assert not ovf.any()
    _close(acc.numpy(), acc_j)
    _close(pot.numpy(), pot_j)
    samp = np.sort(np.random.default_rng(1).choice(n, 256, replace=False))
    a_o, p_o = direct_acc_pot_np(td.pos.double().numpy(),
                                 td.mass.double().numpy(), targets=samp)
    a = acc.double().numpy()[samp]
    p = pot.double().numpy()[samp]
    f = np.linalg.norm(a - a_o, axis=1) / np.linalg.norm(a_o, axis=1)
    got = (float(np.sqrt(np.mean(f ** 2))),
           float(np.sqrt(np.mean(((p - p_o) / p_o) ** 2))))
    np.testing.assert_allclose(got, DISK_ERRORS[n], rtol=1e-2)
