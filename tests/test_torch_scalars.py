"""theta, eps and G as 0-dim tensors: the inputs of rakau_tpu_torch's CUDA
graphs, as the reference traces them (`jnp.asarray(x, dt)`,
rakau_tpu/tree.py:148-150), on the CPU. Every public entry (the Tree
queries, engine.acc_pot_u_host and acc_pot_u, the four whole integrate
twins and a _host twin, sharded.acc_pot_sharded on two shards,
let.acc_pot_let in both phase-0 modes) gives the same bits with the three
given as numbers and as tensors, over float32 and float64 trees and the
shared, lmac, gwalk and lists traversals with the local, grid and grid2
far fields; the cache key of a graph (GraphCache.key on the arguments
that each call hands to engine._run) is the same for two calls that
differ only in their values, so a sweep replays; the plain versions of
the six kernels give the same bits on a scalar buffer made from tensors
as on one made from numbers; eps^2 is the square the kernels were handed
by value before (eps rounded to the tree's type, squared there)."""
import numpy as np
import pytest
import torch

from rakau_tpu_torch import engine, graphs, integrate
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.kernels import pool, shared, tiles
from rakau_tpu_torch.parallel import let, sharded
from rakau_tpu_torch.parallel.mesh import Mesh
from rakau_tpu_torch.tree import Tree

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 768
BOX = 64.0
# eps and G not representable in float32: the tensor path rounds them
# once, as the number path does
VALUES = (0.6, 0.013, 0.7)
OTHER = {"theta": (0.45, 0.013, 0.7), "eps": (0.6, 0.05, 0.7),
         "G": (0.6, 0.013, 1.3)}
BASE = dict(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=8)
MODES = {
    "shared+local": {},
    "shared+grid": dict(farfield="grid", grid_level=3),
    "shared+grid2": dict(farfield="grid2", local_order=4, grid_sep=2,
                         grid_level=3),
    "lmac+grid2": dict(traversal_mode="lmac", farfield="grid2",
                       local_order=4, grid_sep=2, grid_level=3,
                       frontier_cap=4096),
    "gwalk+grid": dict(traversal_mode="gwalk", farfield="grid", grid_level=3,
                       m2p_cap=16384, p2p_leaf_cap=12288,
                       p2p_src_cap=131072, frontier_cap=2048,
                       pool_window=32768, pool_block=128, pool_group=2),
    "lists+local": dict(traversal_mode="lists"),
}
DTYPES = {"f32": np.float32, "f64": np.float64}
ENGINE = ("Tree", "acc_pot_u_host", "acc_pot_u")
INTEGRATE = ("acc_pot", "acc_pot_host", "leapfrog_step",
             "leapfrog_step_morton", "total_energy")
LET_CFG = TreeConfig(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=16,
                     m2p_cap=2048, p2p_leaf_cap=2048, p2p_src_cap=8192,
                     frontier_cap=1024)
CASES = (
    [(e, m, d) for e in ENGINE for m in MODES for d in DTYPES]
    + [(e, m, d) for e in INTEGRATE
       for m, d in (("shared+local", "f32"), ("shared+local", "f64"))]
    + [("acc_pot_sharded", "shared+local", "f32"),
       ("acc_pot_sharded", "shared+grid2", "f64"),
       ("acc_pot_let distributed", "shared+local", "f32"),
       ("acc_pot_let global", "shared+local", "f32"),
       ("acc_pot_let distributed", "shared+local", "f64")])


def _cloud(dtype, n=N, seed=31):
    """A Plummer sphere inside BOX, with velocities, made with numpy."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = v * r[:, None]
    vel = 0.1 * rng.standard_normal((n, 3))
    mass = np.full(n, 1.0 / n)
    return tuple(torch.from_numpy(a.astype(dtype)) for a in (pos, vel, mass))


def _tensors(values):
    """The values as 0-dim float64 tensors (the entries round them to the
    tree's type, as they round numbers)."""
    return tuple(torch.tensor(v, dtype=torch.float64) for v in values)


def _cfg(mode):
    return TreeConfig(**BASE, **MODES[mode])


def _call(entry, mode, dtype, values):
    """What `entry` returns for the cloud of `dtype`, on the CPU, with
    (theta, eps, G) = values."""
    pos, vel, mass = _cloud(DTYPES[dtype])
    th, eps, G = values
    if entry == "Tree":
        t = Tree(pos.numpy(), mass.numpy(), box_size=BOX, device="cpu",
                 config=_cfg(mode))
        return (t.accs_pots_u(th, eps, G), t.accs_o(th, eps, G),
                t.pots_o(th, eps, G))
    if entry in ("acc_pot_u_host", "acc_pot_u"):
        cfg = _cfg(mode)
        td = engine.build_tree(pos, mass, cfg, BOX)
        return getattr(engine, entry)(td, cfg, th, eps, G)
    if entry in INTEGRATE:
        cfg = _cfg(mode)
        state = integrate.NBodyState(pos, vel, mass)
        fn = getattr(integrate, entry)
        if entry.startswith("acc_pot"):
            return fn(pos, mass, cfg, th, eps, G, box_size=BOX)
        if entry == "total_energy":
            return fn(state, cfg, th, eps, G, box_size=BOX)
        return fn(state, 1e-3, cfg, th, eps, G, box_size=BOX)
    if entry == "acc_pot_sharded":
        return sharded.acc_pot_sharded(
            pos, mass, _cfg(mode), th, eps, G,
            sharded.default_mesh(2, device="cpu"), box_size=BOX)
    phase0 = entry.split()[1]
    return let.acc_pot_let(pos, mass, LET_CFG, th, eps, G,
                           sharded.default_mesh(2, device="cpu"),
                           box_size=32.0, export_cap=2048, phase0=phase0)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(_leaves(a), _leaves(b), strict=True))


@pytest.mark.parametrize("entry,mode,dtype", CASES,
                         ids=["-".join(c) for c in CASES])
def test_tensor_scalars_give_the_bits_of_numbers(entry, mode, dtype,
                                                  monkeypatch):
    if mode.startswith("lists"):
        monkeypatch.setenv("RAKAU_DIAG_MODES", "1")
    numbers = _call(entry, mode, dtype, VALUES)
    assert _equal(numbers, _call(entry, mode, dtype, _tensors(VALUES)))
    out = [torch.as_tensor(x) for x in _leaves(numbers)
           if isinstance(x, float) or x.is_floating_point()]
    assert out and all(torch.isfinite(x).all() for x in out)


# ------------------------------------------------------------ the graph key
KEYED = ("acc_pot_u_host", "acc_pot_u", "acc_pot", "leapfrog_step",
         "total_energy", "acc_pot_sharded one device",
         "acc_pot_sharded two devices", "acc_pot_let one device")


def _keyed_call(entry, values):
    """entry's call with `values` on a shared+grid2 float32 cloud (the LET:
    LET_CFG), graph=False: what engine._run receives is what a card's
    graph is keyed on."""
    pos, vel, mass = _cloud(np.float32, n=512)
    cfg = _cfg("shared+grid2")
    th, eps, G = values
    if entry in ("acc_pot_u_host", "acc_pot_u"):
        td = engine.build_tree(pos, mass, cfg, BOX)
        return getattr(engine, entry)(td, cfg, th, eps, G, graph=False)
    if entry == "acc_pot":
        return integrate.acc_pot(pos, mass, cfg, th, eps, G, box_size=BOX,
                                 graph=False)
    if entry == "leapfrog_step":
        return integrate.leapfrog_step(integrate.NBodyState(pos, vel, mass),
                                       1e-3, cfg, th, eps, G, box_size=BOX,
                                       graph=False)
    if entry == "total_energy":
        return integrate.total_energy(integrate.NBodyState(pos, vel, mass),
                                      cfg, th, eps, G, box_size=BOX,
                                      graph=False)
    if entry.startswith("acc_pot_sharded"):
        mesh = (sharded.default_mesh(2, device="cpu")
                if entry.endswith("one device")
                else Mesh((torch.device("cpu", 0), torch.device("cpu", 1))))
        return sharded.acc_pot_sharded(pos, mass, cfg, th, eps, G, mesh,
                                       box_size=BOX, graph=False)
    return let.acc_pot_let(pos, mass, LET_CFG, th, eps, G,
                           sharded.default_mesh(2, device="cpu"),
                           box_size=32.0, export_cap=2048, graph=False)


@pytest.mark.parametrize("entry", KEYED)
def test_graph_keys_do_not_hold_the_values(entry, monkeypatch):
    """GraphCache.key on the arguments of every graph a call would replay
    is the same for calls that differ only in theta, eps or G, while their
    results differ: one capture serves a sweep."""
    calls = []
    run = engine._run

    def keyed(graph, fn, *args, **kw):
        calls[-1].append(graphs.GraphCache().key(fn, args, kw)[0])
        return run(graph, fn, *args, **kw)

    monkeypatch.setattr(engine, "_run", keyed)
    outs = []
    for values in (VALUES,) + tuple(OTHER.values()):
        calls.append([])
        outs.append(_keyed_call(entry, values))
    assert calls[0] and all(c == calls[0] for c in calls[1:])
    assert all(not _equal(outs[0], o) for o in outs[1:])


# ------------------------------------------------------- the plain kernels
def _row(mode, dtype, **kw):
    """A tree of the cloud of `dtype` and its config (`mode`, with kw)."""
    pos, _, mass = _cloud(DTYPES[dtype])
    cfg = _cfg(mode).with_(**kw)
    return engine.build_tree(pos, mass, cfg, BOX), cfg


PLAIN = ("shared", "shared_comp_quad", "shared_cell", "mma", "blocks",
         "pool", "pool_quad", "tiles", "pairwise")


def _plain(kernel, dtype, eps, G):
    """The plain version `kernel` on rows of a query, with the scalar
    buffer of (eps, G)."""
    if kernel in ("pool", "pool_quad"):
        mode = dict(farfield="m2p")
        if kernel == "pool_quad":
            mode.update(multipole_order=2)
        pos, _, mass = _cloud(DTYPES[dtype])
        cfg = TreeConfig(**BASE, **{**MODES["gwalk+grid"], **mode})
        td = engine.build_tree(pos, mass, cfg, BOX)
        tp, ti, pp, pm, pi, sched, pq = engine.pool_inputs(td, cfg, 0.6, eps)
        return pool.eval_pool_plain(tp, ti, pp, pm, pi, sched,
                                    cfg.pool_window,
                                    shared.scalar_buffer(eps, G, tp),
                                    cfg.pool_block, compensated=True,
                                    pool_quad=pq)
    if kernel in ("tiles", "pairwise"):
        td, cfg = _row("lists+local", dtype, farfield="m2p")
        (tp, ti, mp, mm, _, pp, pm, pi, mc,
         pc) = engine.tile_kernel_inputs(td, cfg, 0.6, eps, 0)
        scal = shared.scalar_buffer(eps, G, tp)
        if kernel == "tiles":
            return tiles.eval_tiles_plain(tp, ti, mp, mm, pp, pm, pi, scal,
                                          m2p_cnt=mc, p2p_cnt=pc)
        return tiles.eval_pairwise_plain(tp, ti, pp, pm, pi, scal, True,
                                         cnt=pc)
    mode = {"shared": "shared+grid", "mma": "shared+grid",
            "blocks": "shared+grid", "shared_cell": "shared+grid2",
            "shared_comp_quad": "shared+local"}[kernel]
    kw = (dict(farfield="m2p", multipole_order=2)
          if kernel == "shared_comp_quad" else {})
    td, cfg = _row(mode, dtype, **kw)
    tp, ti, sp, sm, si, mask, sq, sc, tc = engine.kernel_inputs(
        td, cfg, 0.6, eps, 1)
    scal = shared.scalar_buffer(eps, G, tp)
    if kernel == "mma":
        return shared.eval_shared_mma_plain(tp, ti, sp, sm, si, mask, scal)
    if kernel == "blocks":
        return shared.eval_shared_blocks_plain(tp, ti, sp, sm, si, mask, scal)
    if sq is not None:
        # the quadrupole rides the M2P node rows, the first m2p_cap
        U = sq.shape[0]
        sp, sm, si, mask = sp[:U], sm[:U], si[:U], mask[:, :U].contiguous()
    return shared.eval_shared_plain(
        tp, ti, sp, sm, si, mask, scal, compensated=sq is not None,
        src_quad=sq, src_cell=sc, tgt_cell=tc,
        grid_sep=cfg.grid_sep if sc is not None else 0)


@pytest.mark.parametrize("kernel", PLAIN)
def test_plain_kernels_take_tensor_scalars(kernel, monkeypatch):
    monkeypatch.setenv("RAKAU_DIAG_MODES", "1")
    dtype = "f64" if kernel in ("pool_quad", "pairwise") else "f32"
    _, eps, G = VALUES
    numbers = _plain(kernel, dtype, eps, G)
    t_eps, t_G = _tensors((eps, G))
    assert _equal(numbers, _plain(kernel, dtype, t_eps, t_G))
    assert all(torch.isfinite(x).all() for x in numbers)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_the_kernels_scalar_buffer(dtype):
    """scalar_buffer holds [eps^2, G, eps^2, 1] in the tree's type: eps^2
    the bits that the launches were handed by value (eps rounded to the
    type, squared there), from a number or a tensor of any float type;
    engine.scalars makes it beside theta and eps."""
    like = torch.zeros(2, 3, dtype=dtype)
    for eps in (0.0, 0.013, 0.01, 1e-3, 0.02, 0.25):
        want = float(torch.tensor(eps, dtype=dtype) ** 2)
        for given in (eps, torch.tensor(eps, dtype=torch.float64),
                      torch.tensor(eps, dtype=dtype)):
            buf = shared.scalar_buffer(given, 0.7, like)
            assert buf.dtype == dtype and buf.shape == (4,)
            assert float(buf[0]) == want and float(buf[2]) == want
            assert float(buf[1]) == float(torch.tensor(0.7, dtype=dtype))
            assert float(buf[3]) == 1.0
            th, e, scal = engine.scalars(like, 0.75, given, 0.7)
            assert torch.equal(scal, buf) and e.dtype == th.dtype == dtype
