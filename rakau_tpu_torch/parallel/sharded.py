"""Tile-sharded query and leapfrog step over a Mesh. Counterpart of
`rakau_tpu.parallel.sharded`.

The tree and the query's per-tree state (tile table, traversal tables)
are replicated to each shard's device (no copy where shards share a
device); the tile chunks are split into contiguous ranges, one per shard,
and each shard runs the single-device chunk loop over its range. The tile
results are gathered to the first shard's device and assembled there; the
overflow flags are OR-reduced over the shards (the reference's `pmax`).
Each shard evaluates its chunks exactly as the single-device query does,
so the sums are the same. A gwalk config runs the per-tile lists in its
chunks, with its own caps, as the reference's does (its chunk evaluation
has no gwalk branch).

As in `integrate`, each function comes in twins:

  * the whole twins (`acc_pot_u_sharded`, `acc_pot_sharded`,
    `leapfrog_step_sharded`), the reference's executables: every chunk of
    the tile capacity, the chunk axis padded to a multiple of the shard
    count with the reference's fills and cut into equal ranges, each
    shard's range through `engine._chunk_loop` (lmac's un-sliced
    predicate), no host read. On a mesh whose shards share one card each
    call is one CUDA graph (`engine._run`); one graph cannot span cards,
    so on a mesh over several `graph=None` or `True` raises ValueError
    and `graph=False` runs the body eagerly (on any mesh);
  * the `_host` twins, which read n_tiles once a query
    (`engine.live_chunks`), split the live chunks, and run each shard's
    range through `engine.run_chunks` (its sliced graphs) and each build
    through `engine.build_tree`.

Both twins of a pair give the same sums bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import engine, integrate
from ..build import TreeData
from ..config import TreeConfig
from . import mesh as _mesh
from .mesh import Mesh, default_mesh

__all__ = ["default_mesh", "acc_pot_u_sharded", "acc_pot_sharded",
           "leapfrog_step_sharded", "acc_pot_u_sharded_host",
           "acc_pot_sharded_host", "leapfrog_step_sharded_host"]


def chunk_ranges(n_live: int, ndev: int) -> list:
    """Contiguous [first, last) chunk ranges, one per shard, as even as
    the count allows (a shard may get none when ndev > n_live)."""
    return [(r * n_live // ndev, (r + 1) * n_live // ndev)
            for r in range(ndev)]


# ------------------------------------------------------------ the whole twins
def _pad_chunks(tiles, ndev: int, n: int):
    """The gathered tiles [nc, CH, ...] with the chunk axis padded to a
    multiple of ndev by the reference's fills
    (rakau_tpu/parallel/sharded.py:89-98): targets at 0 with index n
    (dropped at assembly), inverted AABBs, cell 0, and with grid2 cells 0
    and an inverted cell range."""
    pad = -tiles[0].shape[0] % ndev
    big = torch.finfo(tiles[0].dtype).max
    fills = (0, n, big, -big, 0, 0, 0, -1)
    return tuple(torch.cat([t, t.new_full((pad,) + t.shape[1:], f)])
                 for t, f in zip(tiles, fills))


def _query_impl(td: TreeData, cfg: TreeConfig, theta, eps, G, mesh: Mesh):
    """acc_pot_u_sharded's computation: tiles and tables built once and
    replicated, each shard's equal range of the padded capacity chunks,
    the flags OR-ed, the tiles' sums gathered to the first shard and the
    tail (assembly, grid2's far field) run there once."""
    if cfg.farfield == "grid":
        cfg = cfg.with_(farfield="local")
    tiles = _pad_chunks(engine._gather_tiles(td, cfg), mesh.size,
                        td.pos.shape[0])
    tables = (engine._traversal_mod(cfg).make_tables(td, cfg)
              if engine._use_shared(cfg) else None)
    K = tiles[0].shape[0] // mesh.size
    accs, pots, ovfs = [], [], []
    for r, (td_r, (tiles_r, tables_r)) in enumerate(zip(
            _mesh.to_shards(mesh, td), _mesh.to_shards(mesh,
                                                       (tiles, tables)))):
        a, p, o, _ = engine._chunk_loop(
            td_r, cfg, theta, eps, G,
            tuple(t[r * K:(r + 1) * K] for t in tiles_r), tables_r, None)
        accs.append(a)
        pots.append(p)
        ovfs.append(o)
    dev0 = mesh.devices[0]
    Lgrid = (engine._grid_farfield(td, cfg, eps)
             if cfg.farfield == "grid2" else None)
    acc_u, pot_u = engine._tail_impl(
        td, cfg, eps, G, Lgrid, torch.cat([a.to(dev0) for a in accs]),
        torch.cat([p.to(dev0) for p in pots]))
    return acc_u, pot_u, _mesh.any(ovfs)[0]


class _Query(NamedTuple):
    """The sharded query as integrate's bodies call theirs
    (engine._query_impl's arguments and results; no maxima), the mesh
    held in a named tuple, so that a graph's key takes it as any other
    argument."""
    mesh: Mesh

    def __call__(self, td, cfg, theta, eps, G):
        return _query_impl(td, cfg, theta, eps, G, self.mesh) + (None,)


def acc_pot_u_sharded(td: TreeData, cfg: TreeConfig, theta, eps, G,
                      mesh: Mesh, graph=None):
    """The reference's sharded query (jittable there): accelerations
    [N, D] and potentials [N] in Morton order and the overflow flags [4]
    OR-ed over the shards, on the first shard's device. Every chunk of
    the tile capacity runs, split evenly over the mesh (no read of
    n_tiles); lmac runs its un-sliced predicate, so its flags are the
    reference's. farfield="grid" falls back to "local", as in the
    reference (the replicated path carries no dense stencil grids);
    grid2's far field is added once, on the first shard. On a one-card
    mesh the call is one CUDA graph (graph as in the module's docstring).
    theta, eps and G are numbers."""
    td = _mesh._to(td, mesh.devices[0])
    graph = _mesh.one_card(engine._use_graph(graph, td.pos, cfg), mesh)
    return engine._run(graph, _query_impl, td, cfg, float(theta),
                       float(eps), float(G), mesh)


def acc_pot_sharded(pos, mass, cfg: TreeConfig, theta, eps, G, mesh: Mesh,
                    box_size=None, graph=None):
    """Build (once, on the first shard's device) + the sharded query, on a
    one-card mesh one CUDA graph. Returns acc [N, D] and pot [N] in the
    input order, and the overflow flags [4]; raises after the call if the
    build overflowed its node or tile capacity."""
    dev0 = mesh.devices[0]
    pos, mass = pos.to(dev0), mass.to(dev0)
    graph, box_size, theta, eps, G = integrate._scalars(
        pos, cfg, graph, box_size, theta, eps, G)
    acc, pot, ovf, b_ovf = integrate._whole(
        _mesh.one_card(graph, mesh), integrate._acc_pot, pos, mass, cfg,
        theta, eps, G, box_size, query=_Query(mesh))
    integrate._check_build(b_ovf)
    return acc, pot, ovf


def leapfrog_step_sharded(state, dt, cfg: TreeConfig, theta, eps, G,
                          mesh: Mesh, box_size=None, graph=None):
    """KDK leapfrog step with a rebuild for each force evaluation, the
    queries sharded over the mesh, on a one-card mesh one CUDA graph (dt
    an input of it, as in integrate.leapfrog_step). Returns (new
    integrate.NBodyState on the first shard's device, overflow flags
    [4]); raises after the call if a build overflowed."""
    state = _mesh._to(state, mesh.devices[0])
    graph, box_size, theta, eps, G = integrate._scalars(
        state.pos, cfg, graph, box_size, theta, eps, G)
    new, ovf, b_ovf = integrate._whole(
        _mesh.one_card(graph, mesh), integrate._step, state,
        integrate._dt(dt, state.pos), cfg, theta, eps, G, box_size,
        query=_Query(mesh))
    integrate._check_build(b_ovf)
    return new, ovf


# ------------------------------------------------------------- the _host twins
def acc_pot_u_sharded_host(td: TreeData, cfg: TreeConfig, theta, eps, G,
                           mesh: Mesh):
    """acc_pot_u_sharded's _host twin, the sharded counterpart of
    engine.acc_pot_u_host: one host read of n_tiles, the live chunks
    split over `mesh`, each shard's range in sliced graphs on the card.
    Returns what acc_pot_u_sharded returns."""
    if cfg.farfield == "grid":
        cfg = cfg.with_(farfield="local")
    theta, eps, G = float(theta), float(eps), float(G)
    dev0 = mesh.devices[0]
    td = _mesh._to(td, dev0)
    tiles, tables, Lgrid = engine._query_state(td, cfg, eps)
    # the one host read of the query: how many chunks hold real tiles
    n_live = engine.live_chunks(td, cfg)
    tds = _mesh.to_shards(mesh, td)
    # with "grid" gone, the chunk loop reads no far-field state (grid2's
    # leaf locals stay on the first shard for the per-particle far field)
    states = _mesh.to_shards(mesh, (tiles, tables, None))
    accs, pots, ovfs = [], [], []
    for r, (first, last) in enumerate(chunk_ranges(n_live, mesh.size)):
        if first == last:
            ovfs.append(torch.zeros(4, dtype=torch.bool,
                                    device=mesh.devices[r]))
            continue
        a, p, o, _ = engine.run_chunks(tds[r], cfg, theta, eps, G,
                                       states[r], first, last)
        accs.append(a)
        pots.append(p)
        ovfs.append(o)
    ovf = _mesh.any(ovfs)[0]
    acc_u, pot_u = engine._assemble_impl(
        td, cfg, torch.cat([a.to(dev0) for a in accs]),
        torch.cat([p.to(dev0) for p in pots]))
    acc_u, pot_u = engine._add_grid2(td, cfg, eps, G, Lgrid, acc_u, pot_u)
    return acc_u, pot_u, ovf


def acc_pot_sharded_host(pos, mass, cfg: TreeConfig, theta, eps, G,
                         mesh: Mesh, box_size=None):
    """acc_pot_sharded's _host twin: the build's graph, then
    acc_pot_u_sharded_host."""
    dev0 = mesh.devices[0]
    td = integrate._host_build(pos.to(dev0), mass.to(dev0), cfg, box_size,
                               graph=None)
    acc_u, pot_u, ovf = acc_pot_u_sharded_host(td, cfg, theta, eps, G, mesh)
    return acc_u[td.inv_perm], pot_u[td.inv_perm], ovf


def leapfrog_step_sharded_host(state, dt, cfg: TreeConfig, theta, eps, G,
                               mesh: Mesh, box_size=None):
    """leapfrog_step_sharded's _host twin."""
    acc0, _, ovf0 = acc_pot_sharded_host(state.pos, state.mass, cfg, theta,
                                         eps, G, mesh, box_size)
    dev0 = acc0.device
    vel_h = state.vel.to(dev0) + 0.5 * dt * acc0
    pos1 = state.pos.to(dev0) + dt * vel_h
    mass = state.mass.to(dev0)
    acc1, _, ovf1 = acc_pot_sharded_host(pos1, mass, cfg, theta, eps, G,
                                         mesh, box_size)
    vel1 = vel_h + 0.5 * dt * acc1
    return integrate.NBodyState(pos1, vel1, mass), ovf0 | ovf1
