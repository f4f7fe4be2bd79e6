"""The whole-call twins of rakau_tpu_torch.integrate (acc_pot,
leapfrog_step, leapfrog_step_morton, total_energy), which the card runs as
one CUDA graph each, on the CPU: against jax.jit of rakau_tpu.integrate's
namesakes on one numpy state (float32 on both sides; perm exactly equal
on the first build, the state within the tolerances of
tests/test_torch_integrate.py); bit-equal to their _host twins; the tree
build (with box_size None, a number or a tensor) and each whole call
issuing no host read and no host-to-device copy once their constant
tables exist (what a capture needs); the step size an input of the
graph, not part of its key; a build overflow raised after the call in
both twins; graph=True on CPU tensors refused."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import integrate as jintegrate
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import build, engine, integrate, particles
from rakau_tpu_torch.convert import config_from_jax, nbody_state_from_numpy

from .test_torch_acc_pot_u import _HostReads, forbid_host_copies
from .test_torch_integrate import _user_order, plummer_state

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

JCFG = JaxConfig(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=8)
BOX, EPS, DT, THETA, E_THETA = 64.0, 0.05, 1e-3, 0.6, 0.25
N = 768
CASES = {
    "shared+local": {},
    # the tile capacity cut to 8 chunks (6 live): every cell of the grid
    # may clip a tile, and the whole call walks the capacity
    "shared+grid": dict(farfield="grid", grid_level=3, tile_cap=64),
    "quad+comp": dict(farfield="m2p", multipole_order=2,
                      accum="compensated"),
}
WHOLE = ("acc_pot", "leapfrog_step", "leapfrog_step_morton", "total_energy")
STEPS = ("leapfrog_step", "leapfrog_step_morton")
# the bodies that a whole call captures, by twin name
BODIES = {"acc_pot": integrate._acc_pot, "leapfrog_step": integrate._step,
          "leapfrog_step_morton": integrate._step_morton,
          "total_energy": integrate._energy}


def _jcfg(name):
    return JCFG.with_(**CASES[name])


def _state(n=N):
    return plummer_state(n, seed=29)


def _args(name, state, cfg):
    """The positional arguments of integrate.<name>(...) (and of its
    _host twin) before G."""
    if name.startswith("acc_pot"):
        return (state.pos, state.mass, cfg, THETA, EPS)
    if name.startswith("total_energy"):
        return (state, cfg, E_THETA, EPS)
    return (state, DT, cfg, THETA, EPS)


def _body_args(name, state, cfg):
    """The positional arguments of integrate.<name>'s body before
    box_size, theta, eps and G as the whole call hands them to it
    (engine.scalars: theta, eps and the kernels' buffer)."""
    args = _args(name, state, cfg)
    return args[:-2] + engine.scalars(state.pos, *args[-2:], 1.0)


def _leaves(x):
    if isinstance(x, tuple):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(_leaves(a), _leaves(b), strict=True))


# ------------------------------------------ against jax.jit of the reference
def test_acc_pot_matches_jax_jit():
    pos, _, mass = _state()
    acc, pot, ovf = integrate.acc_pot(torch.as_tensor(pos),
                                      torch.as_tensor(mass),
                                      config_from_jax(JCFG), THETA, EPS,
                                      box_size=BOX)
    jacc, jpot, jovf = jax.jit(jintegrate.acc_pot, static_argnames=("cfg",))(
        jnp.asarray(pos), jnp.asarray(mass), JCFG, jnp.float32(THETA),
        jnp.float32(EPS), box_size=jnp.float32(BOX))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pot.numpy(), np.asarray(jpot), rtol=1e-5,
                               atol=1e-5)


def test_leapfrog_step_matches_jax_jit():
    pos, vel, mass = _state()
    state = nbody_state_from_numpy(pos, vel, mass, "cpu")
    new, ovf = integrate.leapfrog_step(state, DT, config_from_jax(JCFG),
                                       THETA, EPS, box_size=BOX)
    jnew, jovf = jintegrate.leapfrog_step(
        jintegrate.NBodyState(*(jnp.asarray(a) for a in (pos, vel, mass))),
        jnp.float32(DT), JCFG, jnp.float32(THETA), jnp.float32(EPS),
        box_size=jnp.float32(BOX))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    np.testing.assert_allclose(new.pos.numpy(), np.asarray(jnew.pos),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new.vel.numpy(), np.asarray(jnew.vel),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(new.mass.numpy(), mass)


def test_leapfrog_step_morton_matches_jax_jit():
    pos, vel, mass = _state()
    state = nbody_state_from_numpy(pos, vel, mass, "cpu")
    cfg = config_from_jax(JCFG)
    new, ovf, perm = integrate.leapfrog_step_morton(state, DT, cfg, THETA,
                                                    EPS, box_size=BOX)
    jnew, jovf, jperm = jintegrate.leapfrog_step_morton(
        jintegrate.NBodyState(*(jnp.asarray(a) for a in (pos, vel, mass))),
        jnp.float32(DT), JCFG, jnp.float32(THETA), jnp.float32(EPS),
        box_size=jnp.float32(BOX))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    # the first rebuild sorts the same positions: the same permutation
    td0 = build.build_tree(state.pos, state.mass, cfg, BOX)
    jtd0 = jax.jit(jbuild.build_tree, static_argnames=("cfg",))(
        jnp.asarray(pos), jnp.asarray(mass), JCFG, jnp.float32(BOX))
    np.testing.assert_array_equal(td0.perm.numpy(), np.asarray(jtd0.perm))
    # the state in the user's order (the second sort may differ where an
    # ulp of difference in pos1 moves a Morton code)
    p, jp = perm.numpy(), np.asarray(jperm)
    np.testing.assert_allclose(_user_order(new.pos.numpy(), p),
                               _user_order(np.asarray(jnew.pos), jp),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_user_order(new.vel.numpy(), p),
                               _user_order(np.asarray(jnew.vel), jp),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_user_order(new.mass.numpy(), p), mass)


def test_total_energy_matches_jax_jit():
    pos, vel, mass = _state()
    state = nbody_state_from_numpy(pos, vel, mass, "cpu")
    jc = _jcfg("quad+comp")
    e = integrate.total_energy(state, config_from_jax(jc), E_THETA, EPS,
                               box_size=BOX)
    je = float(jintegrate.total_energy(
        jintegrate.NBodyState(*(jnp.asarray(a) for a in (pos, vel, mass))),
        jc, jnp.float32(E_THETA), jnp.float32(EPS),
        box_size=jnp.float32(BOX)))
    assert abs(e - je) / abs(je) <= 1e-5


# ------------------------------------------------- against the _host twins
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", WHOLE)
def test_whole_call_equals_its_host_twin(name, case):
    """The whole call (every chunk of the tile capacity) and the _host
    twin (the live chunks in slices) give the same results bit for bit."""
    state = nbody_state_from_numpy(*_state(), "cpu")
    cfg = config_from_jax(_jcfg(case))
    args = _args(name, state, cfg)
    whole = getattr(integrate, name)(*args, box_size=BOX)
    host = getattr(integrate, name + "_host")(*args, box_size=BOX)
    assert _equal(whole, host)
    # and graph=False, the card's eager A/B, is the same call here
    assert _equal(getattr(integrate, name)(*args, box_size=BOX,
                                           graph=False), whole)


def test_box_size_as_a_tensor_or_a_number_builds_one_tree():
    state = nbody_state_from_numpy(*_state(), "cpu")
    cfg = config_from_jax(JCFG)
    a = integrate.leapfrog_step_morton(state, DT, cfg, THETA, EPS,
                                       box_size=BOX)
    b = integrate.leapfrog_step_morton(state, DT, cfg, THETA, EPS,
                                       box_size=torch.tensor(BOX))
    assert _equal(a, b)


# ---------------------------------------------------------- the step size
@pytest.mark.parametrize("dt", ["-dt", "2dt", "cpu tensor"])
@pytest.mark.parametrize("name", STEPS)
def test_step_size_is_an_input_not_part_of_the_key(name, dt, monkeypatch):
    """dt reaches the whole step as a 0-dim tensor of the state's dtype (as
    the reference traces it): another step size, a reversed one or a CPU
    tensor gives the key of the first call, and the step equals its _host
    twin bit for bit."""
    state = nbody_state_from_numpy(*_state(), "cpu")
    cfg = config_from_jax(JCFG)
    dt = {"-dt": -DT, "2dt": 2 * DT, "cpu tensor": torch.tensor(DT)}[dt]
    keys = []
    run = engine._run

    def keyed(graph, fn, *args, **kw):
        keys.append(engine._GRAPHS.key(fn, args, kw)[0])
        return run(graph, fn, *args, **kw)

    monkeypatch.setattr(engine, "_run", keyed)
    getattr(integrate, name)(state, DT, cfg, THETA, EPS, box_size=BOX)
    whole = getattr(integrate, name)(state, dt, cfg, THETA, EPS,
                                     box_size=BOX)
    assert keys[0] == keys[1]
    host = getattr(integrate, name + "_host")(state, dt, cfg, THETA, EPS,
                                              box_size=BOX)
    assert _equal(whole, host)


# ------------------------------------------------------ the numeric box
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("box", [0.1, 8.0, 2.0 / 3.0, np.float64(1e-3)])
def test_numeric_box_is_filled_with_the_same_bits(box, dtype):
    """A number filled in on the device rounds once to the tree's dtype,
    as torch.as_tensor rounds it: the same bits, so the same cells."""
    pos = torch.zeros(2, 3, dtype=dtype)
    got = particles.scalar_tensor(box, pos)
    want = torch.as_tensor(box, dtype=dtype)
    assert got.dtype == dtype and got.shape == ()
    assert torch.equal(got, want)
    x = torch.as_tensor(_state(64)[0], dtype=dtype) * float(box) / 64
    assert torch.equal(particles.discretize(x, box, 10),
                       particles.discretize(x, want, 10))


# ------------------------------------------------- what a capture rests on
@pytest.mark.parametrize("box", ["auto", "number", "tensor"])
def test_build_reads_nothing_from_the_host(box, monkeypatch):
    pos, _, mass = _state()
    pos, mass = torch.as_tensor(pos), torch.as_tensor(mass)
    cfg = config_from_jax(_jcfg("shared+grid"))
    box_size = {"auto": None, "number": BOX,
                "tensor": torch.tensor(BOX)}[box]
    td = build.build_tree(pos, mass, cfg, box_size)
    forbid_host_copies(monkeypatch)
    reads = _HostReads()
    with reads:
        again = build.build_tree(pos, mass, cfg, box_size)
    assert not reads.hits, reads.hits[:5]
    assert _equal(tuple(again), tuple(td))


@pytest.mark.parametrize("case", ["shared+grid", "quad+comp"])
@pytest.mark.parametrize("name", WHOLE)
def test_whole_call_reads_nothing_from_the_host(name, case, monkeypatch):
    """The body a whole call captures (builds, _query_impl, the step's
    arithmetic) issues no host read and, once its constant tables exist (a
    first run), no host-to-device copy."""
    state = nbody_state_from_numpy(*_state(), "cpu")
    cfg = config_from_jax(_jcfg(case))
    args = _body_args(name, state, cfg) + (BOX, build.build_tree,
                                           engine._query_impl)
    if name in STEPS:
        # the wrappers pass dt as a tensor (integrate._dt)
        args = (args[0], integrate._dt(DT, state.pos)) + args[2:]
    first = BODIES[name](*args)
    forbid_host_copies(monkeypatch)
    reads = _HostReads()
    with reads:
        again = BODIES[name](*args)
    assert not reads.hits, reads.hits[:5]
    assert _equal(again, first)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("cap", ["node_cap", "tile_cap"])
@pytest.mark.parametrize("name", WHOLE + tuple(w + "_host" for w in WHOLE))
def test_build_overflow_raises_after_the_call(name, cap):
    state = nbody_state_from_numpy(*_state(), "cpu")
    cfg = config_from_jax(JCFG).with_(**{cap: 4})
    args = _args(name, state, cfg)
    with pytest.raises(RuntimeError, match="build overflowed"):
        getattr(integrate, name)(*args, box_size=BOX)
    if name in BODIES:
        # the whole call ran to its end and returned the builds' flag
        out = BODIES[name](*_body_args(name, state, cfg), BOX,
                           build.build_tree, engine._query_impl)
        assert bool(out[-1])


@pytest.mark.parametrize("name", WHOLE + tuple(w + "_host" for w in WHOLE)
                         + ("leapfrog_step_morton_host_safe",))
def test_graph_true_on_cpu_tensors_raises(name):
    state = nbody_state_from_numpy(*_state(256), "cpu")
    args = _args(name, state, config_from_jax(JCFG))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(integrate, name)(*args, box_size=BOX, graph=True)


def test_engine_build_tree_runs_eagerly_on_cpu_tensors():
    pos, _, mass = _state()
    pos, mass = torch.as_tensor(pos), torch.as_tensor(mass)
    cfg = config_from_jax(JCFG)
    want = build.build_tree(pos, mass, cfg, BOX)
    assert _equal(tuple(engine.build_tree(pos, mass, cfg, BOX)), tuple(want))
    with pytest.raises(ValueError, match="CUDA"):
        engine.build_tree(pos, mass, cfg, BOX, graph=True)
