"""rakau_tpu_torch.integrate against rakau_tpu.integrate on one numpy state
(float32 on both sides) and against the float64 direct sum: the Morton-
order leapfrog step, input-order accelerations, the cap-overflow retry,
KDK reversibility, the exact-energy drift, the tree energy of the
quadrupole + compensated configuration, and the sample generators."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import integrate as jintegrate
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import build, integrate, particles
from rakau_tpu_torch.convert import config_from_jax, nbody_state_from_numpy
from rakau_tpu_torch.direct import direct_acc_pot_np

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

JCFG = JaxConfig(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=8)
CFG = config_from_jax(JCFG)
BOX = 64.0
EPS = 0.05


def plummer_state(n=1024, seed=23):
    """Plummer positions with isotropic velocities of a crude virial
    dispersion (as tests/test_integrate.py), made with numpy."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = v * r[:, None]
    rr = np.linalg.norm(pos, axis=1)
    sigma = np.sqrt(1.0 / (6.0 * np.sqrt(rr ** 2 + 1.0)))
    vel = sigma[:, None] * rng.standard_normal((n, 3))
    mass = np.full(n, 1.0 / n)
    return tuple(a.astype(np.float32) for a in (pos, vel, mass))


def _user_order(x, perm):
    out = np.empty_like(x)
    out[perm] = x
    return out


def test_morton_step_matches_jax():
    pos, vel, mass = plummer_state(768)
    state = nbody_state_from_numpy(pos, vel, mass, "cpu")
    new, ovf, perm = integrate.leapfrog_step_morton_host(
        state, 1e-3, CFG, 0.6, EPS, box_size=BOX)
    jnew, jovf, jperm = jintegrate.leapfrog_step_morton_host(
        jintegrate.NBodyState(*(jnp.asarray(a) for a in (pos, vel, mass))),
        1e-3, JCFG, jnp.float32(0.6), jnp.float32(EPS), box_size=BOX)
    assert not ovf.any() and not np.asarray(jovf).any()
    # the first rebuild sorts the same positions: the same permutation
    td0 = build.build_tree(state.pos, state.mass, CFG, BOX)
    jtd0 = jax.jit(jbuild.build_tree, static_argnames=("cfg",))(
        jnp.asarray(pos), jnp.asarray(mass), JCFG, jnp.float32(BOX))
    np.testing.assert_array_equal(td0.perm.numpy(), np.asarray(jtd0.perm))
    # the state itself, in the user's order (the second sort may differ
    # where an ulp of difference in pos1 moves a Morton code)
    p, jp = perm.numpy(), np.asarray(jperm)
    np.testing.assert_allclose(_user_order(new.pos.numpy(), p),
                               _user_order(np.asarray(jnew.pos), jp),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_user_order(new.vel.numpy(), p),
                               _user_order(np.asarray(jnew.vel), jp),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_user_order(new.mass.numpy(), p), mass)


def test_acc_pot_is_in_input_order():
    pos, _, mass = plummer_state(512, seed=3)
    acc, pot, ovf = integrate.acc_pot_host(torch.as_tensor(pos),
                                           torch.as_tensor(mass), CFG, 0.2,
                                           0.01)
    assert not ovf.any()
    acc_d, pot_d = direct_acc_pot_np(pos, mass, eps=0.01)
    rel = np.linalg.norm(acc.numpy() - acc_d, axis=1) \
        / np.linalg.norm(acc_d, axis=1)
    assert float(np.sqrt(np.mean(rel ** 2))) < 2e-3
    prel = np.abs(pot.numpy() - pot_d) / np.abs(pot_d)
    assert float(np.sqrt(np.mean(prel ** 2))) < 2e-3


def test_safe_step_grows_caps_and_matches_a_straight_step():
    """Undersized caps are grown until the step runs clean (never a
    truncated-force step), and the result is the straight step's at the
    grown caps."""
    state = nbody_state_from_numpy(*plummer_state(512), "cpu")
    small = CFG.with_(m2p_cap=64, p2p_src_cap=256, p2p_leaf_cap=64)
    new, ovf, perm, grown, n_retries = \
        integrate.leapfrog_step_morton_host_safe(
            state, 1e-3, small, 0.6, EPS, box_size=BOX)
    assert not ovf.any() and n_retries >= 1
    assert (grown.m2p_cap > small.m2p_cap
            or grown.p2p_src_cap > small.p2p_src_cap
            or grown.p2p_leaf_cap > small.p2p_leaf_cap)
    ref, ovf_r, perm_r = integrate.leapfrog_step_morton_host(
        state, 1e-3, grown, 0.6, EPS, box_size=BOX)
    assert not ovf_r.any()
    np.testing.assert_array_equal(perm.numpy(), perm_r.numpy())
    np.testing.assert_allclose(new.pos.numpy(), ref.pos.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_kdk_is_reversible():
    state = nbody_state_from_numpy(*plummer_state(512), "cpu")
    s1, _ = integrate.leapfrog_step_host(state, 1e-3, CFG, 0.4, EPS,
                                         box_size=BOX)
    s2, _ = integrate.leapfrog_step_host(s1, -1e-3, CFG, 0.4, EPS,
                                         box_size=BOX)
    np.testing.assert_allclose(s2.pos.numpy(), state.pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(s2.vel.numpy(), state.vel.numpy(), atol=1e-4)


def test_exact_energy_drift_over_20_steps():
    state = nbody_state_from_numpy(*plummer_state(1024), "cpu")
    e0 = integrate.exact_total_energy(state, eps=EPS)
    for _ in range(20):
        state, ovf = integrate.leapfrog_step_host(state, 1e-3, CFG, 0.4, EPS,
                                                  box_size=BOX)
        assert not ovf.any()
    e1 = integrate.exact_total_energy(state, eps=EPS)
    assert abs(e1 - e0) / abs(e0) < 2e-3


def _energy_cfg(**kw):
    return JCFG.with_(multipole_order=2, accum="compensated",
                      farfield="m2p", **kw)


def test_tree_energy_quad_comp_matches_jax_and_the_exact_sum():
    pos, vel, mass = plummer_state(1024, seed=5)
    state = nbody_state_from_numpy(pos, vel, mass, "cpu")
    jc = _energy_cfg()
    e = integrate.total_energy_host(state, config_from_jax(jc), 0.25, 0.02,
                                    box_size=BOX)
    je = float(jintegrate.total_energy_host(
        jintegrate.NBodyState(*(jnp.asarray(a) for a in (pos, vel, mass))),
        jc, jnp.float32(0.25), jnp.float32(0.02), box_size=BOX))
    assert abs(e - je) / abs(je) <= 1e-5
    ex = integrate.exact_total_energy(state, eps=0.02)
    assert abs(e - ex) / abs(ex) < 1e-4


def test_tree_energy_raises_on_an_overflowed_query():
    state = nbody_state_from_numpy(*plummer_state(512), "cpu")
    cfg = config_from_jax(_energy_cfg(m2p_cap=64, p2p_src_cap=256))
    with pytest.raises(RuntimeError, match="overflow"):
        integrate.total_energy_host(state, cfg, 0.25, 0.02, box_size=BOX)


@pytest.mark.parametrize("name", ["uniform_cube", "cold_sphere",
                                  "disk_galaxy", "plummer"])
def test_generators(name):
    gen = torch.Generator().manual_seed(1)
    n = 4096
    pos, mass = getattr(particles, name)(n, generator=gen)
    assert pos.shape == (n, 3) and mass.shape == (n,)
    assert pos.dtype == mass.dtype == torch.float32
    assert bool(torch.isfinite(pos).all())
    assert abs(float(mass.double().sum()) - 1.0) < 1e-6
    r = torch.linalg.norm(pos.double(), dim=1)
    if name == "uniform_cube":
        assert float(pos.abs().max()) <= 0.5 * 0.999
        assert float(pos.abs().max()) > 0.49       # it fills the cube
    elif name == "cold_sphere":
        assert float(r.max()) <= 1.0 + 1e-6
        # uniform density: the fraction inside r is r^3
        assert abs(float((r < 0.5).double().mean()) - 0.125) < 0.02
    elif name == "disk_galaxy":
        rc = torch.linalg.norm(pos[:, :2].double(), dim=1)
        assert float(rc.max()) <= 20.0 + 1e-4
        assert abs(float(rc.mean()) - 2.0) < 0.1   # gamma(2) mean 2 rscale
        assert abs(float(pos[:, 2].double().std()) - 0.05) < 0.005
    else:
        assert float(r.max()) <= 10.0 + 1e-4
    again, _ = getattr(particles, name)(n, generator=torch.Generator()
                                        .manual_seed(1))
    assert torch.equal(pos, again)


def test_cold_sphere_step_forces_are_the_reference_forces():
    """BASELINE config #2's step configuration (farfield "local", theta
    0.75, eps 0.02, box 8) on a uniform-density sphere: the port gives the
    reference's forces, so its error against the direct sum is the
    reference's too (on this distribution it sits above the Plummer bound
    of 5e-3, which is why chip_smoke.py bounds it at 1.5e-2)."""
    rng = np.random.default_rng(12)
    n = 4096
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (v * rng.uniform(0, 1, (n, 1)) ** (1 / 3)).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    jc = JaxConfig(max_depth=12, max_leaf_n=32, ncrit=512, tile_chunk=32,
                   m2p_cap=1024, p2p_leaf_cap=512, p2p_src_cap=4096)
    acc, pot, ovf = integrate.acc_pot_host(torch.as_tensor(pos),
                                           torch.as_tensor(mass),
                                           config_from_jax(jc), 0.75, 0.02,
                                           box_size=8.0)
    jacc, jpot, jovf = jintegrate.acc_pot_host(
        jnp.asarray(pos), jnp.asarray(mass), jc, jnp.float32(0.75),
        jnp.float32(0.02), box_size=8.0)
    assert not ovf.any() and not np.asarray(jovf).any()
    acc_d, _ = direct_acc_pot_np(pos, mass, eps=0.02)

    def rms(a):
        rel = np.linalg.norm(a - acc_d, axis=1) / np.linalg.norm(acc_d,
                                                                axis=1)
        return float(np.sqrt(np.mean(rel ** 2)))
    jacc = np.asarray(jacc)
    rel = np.linalg.norm(acc.numpy() - jacc, axis=1) \
        / np.linalg.norm(jacc, axis=1)
    assert float(np.sqrt(np.mean(rel ** 2))) <= 1e-5
    assert rms(acc.numpy()) == pytest.approx(rms(jacc), rel=1e-4)
    assert 5e-3 < rms(jacc) < 2e-2
