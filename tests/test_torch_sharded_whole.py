"""The whole twins of rakau_tpu_torch.parallel (sharded.acc_pot_u_sharded,
acc_pot_sharded, leapfrog_step_sharded and let.acc_pot_let), which the
card runs as one CUDA graph each on a one-card mesh and as one graph a
card and stage on a mesh over several cards, on CPU meshes of 1, 2 and 4
shards: each, run eagerly (graph=False, what a CPU mesh runs anyway),
bit-equal to its _host twin (sums and input-order results; flags at caps
that do not overflow); the whole sharded query bit-equal to
engine.acc_pot_u, flags included; both LET phase-0 modes; each whole twin
on a mesh over two device labels (its stages grouped by device, the
collectives copying between them) bit-equal to the same call on one
label, at 2, 3 and 4 shards; the bodies that a whole call captures, and
the staged bodies, issuing no host read and, after a first run, no
host-to-device copy; a build overflow raised after the call; graph=True on
a CPU mesh and stage_seconds() around a whole LET refused; the whole
sharded step at __graft_entry__.dryrun_multichip's configuration
reproducing the reference's recorded step (MULTICHIP_r05.json)."""
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from rakau_tpu import particles as jparticles
from rakau_tpu_torch import build, engine, integrate
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.parallel import let, sharded
from rakau_tpu_torch.parallel import mesh as _mesh_mod
from rakau_tpu_torch.parallel.mesh import Mesh

from .test_torch_acc_pot_u import _HostReads, forbid_host_copies

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 2048
BOX, THETA, EPS, DT = 64.0, 0.5, 0.01, 1e-3
CFG = TreeConfig(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=8)
CONFIGS = {
    "shared+local": CFG,
    "lmac+m2p": CFG.with_(traversal_mode="lmac", farfield="m2p",
                          frontier_cap=4096),
    "shared+grid2": CFG.with_(farfield="grid2", local_order=4, grid_sep=2,
                              grid_level=3),
}
# tests/test_torch_let.py's LET config, and its export slots a destination
LET_CFG = TreeConfig(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=16,
                     m2p_cap=2048, p2p_leaf_cap=2048, p2p_src_cap=8192,
                     frontier_cap=1024)
LET_THETA = 0.6
EXPORT_CAP = {1: 512, 2: 2048, 4: 1024}
SHARDS = (1, 2, 4)
_CLOUD = {}


def _cloud():
    """N Plummer particles from a seed (float32 CPU tensors)."""
    if not _CLOUD:
        rng = np.random.default_rng(37)
        u = rng.uniform(1e-6, 1 - 1e-6, N)
        r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
        v = rng.standard_normal((N, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        _CLOUD["pos"] = torch.tensor((v * r[:, None]).astype(np.float32))
        _CLOUD["mass"] = torch.tensor(rng.uniform(0.5, 1.5, N).astype(
            np.float32) / N)
        _CLOUD["vel"] = torch.tensor(
            0.1 * rng.standard_normal((N, 3)).astype(np.float32))
    return _CLOUD["pos"], _CLOUD["mass"], _CLOUD["vel"]


def _cube():
    """BASELINE config #4's particles (benchmarks/configs.py:191): N
    uniform in 0.999 of a unit cube, mass 1/N each (float32 CPU tensors,
    from a seed; zero velocities)."""
    rng = np.random.default_rng(41)
    pos = torch.tensor(rng.uniform(-0.4995, 0.4995, (N, 3)).astype(
        np.float32))
    return pos, torch.full((N,), 1.0 / N), torch.zeros_like(pos)


# config #4's configuration (configs.py:192-193) on its cube, through the
# call configs.py makes (acc_pot_sharded, the box fitted to the particles)
CUBE = "cube+config4"
CUBE_CFG = TreeConfig(max_depth=10, max_leaf_n=64, ncrit=256, tile_chunk=64,
                      p2p_leaf_cap=2048)


def _mesh(ndev):
    return sharded.default_mesh(ndev, device="cpu")


def _leaves(x):
    if isinstance(x, tuple):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(_leaves(a), _leaves(b), strict=True))


def _calls(name, cfg, mesh, cloud=_cloud, box=BOX):
    """(whole twin, _host twin) of parallel.sharded's `name` as functions
    of graph (the _host twin takes none), on the particles of `cloud`
    (CFG's by default) in a box of `box` (None: fitted)."""
    pos, mass, vel = cloud()
    if name == "acc_pot_u_sharded":
        td = build.build_tree(pos, mass, cfg)
        args = (td, cfg, THETA, EPS, 1.0, mesh)
        return (lambda graph=None: sharded.acc_pot_u_sharded(
            *args, graph=graph),
            lambda: sharded.acc_pot_u_sharded_host(*args))
    if name == "acc_pot_sharded":
        args = (pos, mass, cfg, THETA, EPS, 1.0, mesh)
    else:
        args = (integrate.NBodyState(pos, vel, mass), DT, cfg, THETA, EPS,
                1.0, mesh)
    whole = getattr(sharded, name)
    host = getattr(sharded, name + "_host")
    return (lambda graph=None: whole(*args, box_size=box, graph=graph),
            lambda: host(*args, box_size=box))


SHARDED = ("acc_pot_u_sharded", "acc_pot_sharded", "leapfrog_step_sharded")
# grid2 (its far field added once, on the first shard) through the query;
# the build and the step around it are those of the other configs
PAIRS = [(name, case) for name in SHARDED for case in CONFIGS
         if name == "acc_pot_u_sharded" or case != "shared+grid2"] + [
             ("acc_pot_sharded", CUBE)]


# ------------------------------------------------- against the _host twins
@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("name,case", PAIRS)
def test_whole_twin_equals_its_host_twin(name, case, ndev):
    """The whole twin (every chunk of the tile capacity, padded to a
    multiple of the shard count and cut into equal ranges) and the _host
    twin (the live chunks, split) give the same results bit for bit, and
    neither overflows; config #4's cube through acc_pot_sharded among
    them."""
    if case == CUBE:
        whole, host = _calls(name, CUBE_CFG, _mesh(ndev), _cube, None)
    else:
        whole, host = _calls(name, CONFIGS[case], _mesh(ndev))
    w = whole(graph=False)
    h = host()
    assert not w[-1].any() and torch.equal(w[-1], h[-1])
    assert _equal(w, h)


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("case", list(CONFIGS))
def test_whole_query_equals_acc_pot_u(case, ndev):
    """The whole sharded query against the single-device one-executable
    query: the same sums and the same flags (both run lmac's un-sliced
    predicate)."""
    cfg = CONFIGS[case]
    pos, mass, _ = _cloud()
    td = build.build_tree(pos, mass, cfg)
    acc_1, pot_1, ovf_1 = engine.acc_pot_u(td, cfg, THETA, EPS)
    acc, pot, ovf = sharded.acc_pot_u_sharded(td, cfg, THETA, EPS, 1.0,
                                              _mesh(ndev))
    assert torch.equal(ovf, ovf_1)
    assert torch.equal(acc, acc_1) and torch.equal(pot, pot_1)


def test_step_equals_the_single_device_step():
    """The whole sharded step at 4 shards and integrate.leapfrog_step: the
    same builds, the same chunk sums, the same KDK arithmetic."""
    pos, mass, vel = _cloud()
    state = integrate.NBodyState(pos, vel, mass)
    s1, o1 = integrate.leapfrog_step(state, DT, CFG, THETA, EPS,
                                     box_size=BOX)
    s4, o4 = sharded.leapfrog_step_sharded(state, DT, CFG, THETA, EPS, 1.0,
                                           _mesh(4), box_size=BOX)
    assert torch.equal(o1, o4) and _equal(tuple(s1), tuple(s4))


def _let_calls(phase0, ndev):
    pos, mass, _ = _cloud()
    args = (pos, mass, LET_CFG, LET_THETA, EPS, 1.0, _mesh(ndev))
    kw = dict(export_cap=EXPORT_CAP[ndev], box_size=32.0, phase0=phase0,
              with_stats=True)
    return (lambda graph=None: let.acc_pot_let(*args, graph=graph, **kw),
            lambda: let.acc_pot_let_host(*args, **kw))


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("phase0", ["distributed", "global"])
def test_let_whole_equals_its_host_twin(phase0, ndev):
    """The whole LET (its local queries over every chunk of each shard's
    tile capacity) and acc_pot_let_host: the same sums, flags, export
    overflow and export counts."""
    whole, host = _let_calls(phase0, ndev)
    w = whole(graph=False)
    h = host()
    assert not w[2].any() and not w[3]
    assert w[4].shape == (ndev, ndev) and not w[4].diagonal().any()
    assert _equal(w, h)


# ------------------------------------------------- what a capture rests on
WHOLE = ("acc_pot_u_sharded", "acc_pot_sharded", "leapfrog_step_sharded",
         "acc_pot_let distributed", "acc_pot_let global")
BODIES = WHOLE + tuple(name + " staged" for name in WHOLE)


def _body(name):
    """The body that the whole call `name` captures on a one-card mesh
    (2 shards), or with " staged" the stages it runs on a mesh over two
    devices (2 shards, one a device, N_X particles; run eagerly, as
    stage_map does with staged=False; X_CFG, X_EXPORT_CAP), as a
    function of nothing (its arguments as the wrapper passes them)."""
    base, staged = name.removesuffix(" staged"), name.endswith(" staged")
    pos, mass, vel = _cloud()
    mesh, stages, cfg, cap = _mesh(2), None, CFG, EXPORT_CAP[2]
    if staged:
        pos, mass, vel = pos[:N_X], mass[:N_X], vel[:N_X]
        mesh, stages, cfg, cap = _two_devices(2), False, X_CFG, X_EXPORT_CAP[2]
    td = build.build_tree(pos, mass, cfg)
    state = integrate.NBodyState(pos, vel, mass)
    if staged:
        def whole(body, *args):
            return sharded._whole(False, mesh, body, *args)
    else:
        def whole(body, *args):
            return body(*args, build.build_tree, sharded._Query(mesh))
    # theta, eps and G as the whole twins hand them to their bodies
    scal = engine.scalars(pos, THETA, EPS, 1.0)
    bodies = {
        "acc_pot_u_sharded": lambda: sharded._query_impl(
            td, cfg, *scal, mesh, stages),
        "acc_pot_sharded": lambda: whole(
            integrate._acc_pot, pos, mass, cfg, *scal, BOX),
        "leapfrog_step_sharded": lambda: whole(
            integrate._step, state, integrate._dt(DT, pos), cfg, *scal,
            BOX)}
    caps = (cap, 8192, 32768, 4096, 1024)
    for phase0 in ("distributed", "global"):
        bodies["acc_pot_let " + phase0] = (
            lambda phase0=phase0: let._let(
                pos, mass, LET_CFG,
                *engine.scalars(pos, LET_THETA, EPS, 1.0), mesh, 32.0, caps,
                phase0, 2.0, 128, build.build_tree, engine._query_impl,
                stages))
    return bodies[base]


@pytest.mark.parametrize("name", BODIES)
def test_whole_body_reads_nothing_from_the_host(name, monkeypatch):
    """The body that a whole call captures (builds, each shard's chunk
    loop, the gathers, the LET's phase 0, exchange and return route), and
    on a mesh over two devices its stages with the collectives between
    them, issue no host read and, once the constant tables exist (a first
    run), no host-to-device copy."""
    body = _body(name)
    first = body()
    forbid_host_copies(monkeypatch)
    reads = _HostReads()
    with reads:
        again = body()
    assert not reads.hits, reads.hits[:5]
    assert _equal(again, first)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("cap", ["node_cap", "tile_cap"])
@pytest.mark.parametrize("twin", ["whole", "host"])
@pytest.mark.parametrize("name", ["acc_pot_sharded",
                                  "leapfrog_step_sharded"])
def test_build_overflow_raises_after_the_call(name, twin, cap):
    whole, host = _calls(name, CFG.with_(**{cap: 4}), _mesh(2))
    with pytest.raises(RuntimeError, match="build overflowed"):
        whole() if twin == "whole" else host()


def _whole_call(name, mesh):
    if name == "acc_pot_let":
        pos, mass, _ = _cloud()
        return lambda graph: let.acc_pot_let(
            pos, mass, LET_CFG, LET_THETA, EPS, 1.0, mesh,
            export_cap=EXPORT_CAP[2], box_size=32.0, graph=graph)
    return _calls(name, CFG, mesh)[0]


@pytest.mark.parametrize("name", SHARDED + ("acc_pot_let",))
def test_graph_true_on_a_cpu_mesh_raises(name):
    with pytest.raises(ValueError, match="CUDA"):
        _whole_call(name, _mesh(2))(True)


# ------------------------------------------- a mesh over several devices
# the particles (the first N_X of the cloud), the configuration (a tile
# capacity near the live tiles: fewer padding chunks) and the LET's export
# slots a destination of the comparisons across devices
N_X = 1024
X_CFG = CFG.with_(tile_cap=64)
X_EXPORT_CAP = {2: 576, 3: 384, 4: 320}


def _two_devices(ndev):
    """ndev shards over two device labels, shard r on cpu:(r % 2), as
    default_mesh lays shards over two cards: torch keeps the labels
    apart, although both put tensors on the CPU."""
    return Mesh(tuple(torch.device("cpu", r % 2) for r in range(ndev)))


def _x_call(name, mesh):
    """The whole twin `name` (or the LET in phase0 mode `name`) on N_X
    particles and `mesh`, with graph=None."""
    pos, mass, vel = (x[:N_X] for x in _cloud())
    if name in ("distributed", "global"):
        return let.acc_pot_let(
            pos, mass, LET_CFG, LET_THETA, EPS, 1.0, mesh, box_size=32.0,
            export_cap=X_EXPORT_CAP[mesh.size], phase0=name,
            with_stats=True)
    if name == "acc_pot_u_sharded":
        td = build.build_tree(pos, mass, X_CFG)
        return sharded.acc_pot_u_sharded(td, X_CFG, THETA, EPS, 1.0, mesh)
    first = (pos, mass) if name == "acc_pot_sharded" else (
        integrate.NBodyState(pos, vel, mass), DT)
    return getattr(sharded, name)(*first, X_CFG, THETA, EPS, 1.0, mesh,
                                  box_size=BOX)


@pytest.mark.parametrize("ndev", [2, 3, 4])
@pytest.mark.parametrize("name", SHARDED + ("distributed", "global"))
def test_whole_twin_over_two_devices_equals_one_device(name, ndev):
    """On a mesh whose shards sit on two devices the whole twin runs in
    stages, each device's shards together, the collectives copying
    between the devices (an uneven split at 3 shards): sums, flags,
    export overflow and export counts (the LET), pos and vel (the step)
    bit-equal to the same call on one device, none overflowing, and the
    collectives' copies counted."""
    _mesh_mod.reset_copied()
    got = _x_call(name, _two_devices(ndev))
    assert _mesh_mod.copied
    _mesh_mod.reset_copied()
    want = _x_call(name, _mesh(ndev))
    assert not _mesh_mod.copied
    flags = want[2:4] if name in ("distributed", "global") else want[-1:]
    assert not any(bool(f.any()) for f in flags)
    assert _equal(got, want)


def test_stage_seconds_refuses_a_whole_let():
    """stage_seconds() synchronises the mesh between the stages of
    acc_pot_let_host; the whole call has none and refuses it."""
    whole, host = _let_calls("distributed", 2)
    with let.stage_seconds() as stages:
        with pytest.raises(ValueError, match="acc_pot_let_host"):
            whole()
        host()
    assert set(stages) == {"phase0", "local_build", "export_walk",
                           "exchange", "local_query", "return_route"}


# ------------------------------------------ the reference's recorded step
def test_dryrun_step_reproduces_the_reference_record():
    """__graft_entry__.dryrun_multichip's tile-sharded step at its
    configuration (N=2048 from rakau_tpu.particles.plummer(PRNGKey(1)), 8
    shards, box 64, theta 0.75, eps 0.05, dt 1e-3, zero velocities): the
    step's largest position change, printed as the reference printed its
    own ("pos delta"), equals MULTICHIP_r05.json's; the whole sharded step
    equals the port's single-device step bit for bit (so its distance to
    it is within the reference's recorded delta), and its _host twin."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"]
    want = re.search(r"pos delta (\S+),", tail).group(1)
    pos, mass = (torch.tensor(np.asarray(a))
                 for a in jparticles.plummer(jax.random.PRNGKey(1), 2048))
    cfg = TreeConfig(max_depth=6, max_leaf_n=16, ncrit=32, tile_chunk=8,
                     m2p_cap=512, p2p_leaf_cap=256, p2p_src_cap=2048,
                     frontier_cap=512)
    state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)
    args = (state, 1e-3, cfg, 0.75, 0.05)
    new, ovf = sharded.leapfrog_step_sharded(*args, 1.0, _mesh(8),
                                             box_size=64.0)
    host, ovf_h = sharded.leapfrog_step_sharded_host(*args, 1.0, _mesh(8),
                                                     box_size=64.0)
    one, ovf_1 = integrate.leapfrog_step(*args, box_size=64.0)
    assert not ovf.any() and torch.equal(ovf, ovf_h) and torch.equal(ovf,
                                                                     ovf_1)
    assert f"{float((new.pos - pos).abs().max()):.3e}" == want
    assert torch.equal(new.pos, one.pos) and torch.equal(new.vel, one.vel)
    assert _equal(tuple(new), tuple(host))
