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
    call is one CUDA graph (`engine._run`). One graph cannot span cards:
    on a mesh over several the call runs in stages (`_query_impl`: the
    tiles and tables on the first shard's card, each card's shards'
    ranges, the tail on the first card), each stage with `graph=None` or
    `True` one CUDA graph on its card, the copies between cards between
    them (parallel.mesh); `graph=False` runs eagerly on any mesh;
  * the `_host` twins, which read n_tiles once a query
    (`engine.live_chunks`), split the live chunks, and run each shard's
    range through `engine.run_chunks` (its sliced graphs) and each build
    through `engine.build_tree`.

Both twins of a pair give the same sums bit for bit.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import engine, integrate
from ..build import TreeData
from ..config import TreeConfig
from ..utils.timing import span
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


def _tiles_tables(td: TreeData, cfg: TreeConfig, ndev: int):
    """The first stage, on the first shard's device: the tiles gathered
    and padded to a multiple of ndev chunks, and the traversal tables."""
    tiles = _pad_chunks(engine._gather_tiles(td, cfg), ndev, td.pos.shape[0])
    tables = (engine._traversal_mod(cfg).make_tables(td, cfg)
              if engine._use_shared(cfg) else None)
    return tiles, tables


def _shard_chunks(td: TreeData, cfg: TreeConfig, theta, eps, scal, panels,
                  tables):
    """One shard's stage: its range of the chunks (acc, pot, flags)."""
    return engine._chunk_loop(td, cfg, theta, eps, scal, panels, tables,
                              None)[:3]


def _tail(td: TreeData, cfg: TreeConfig, eps, scal, acc, pot, ovfs):
    """The last stage, on the first shard's device: the tiles' sums (the
    shards' in shard order, gathered) through the tail (assembly, grid2's
    far field) and the flags OR-ed."""
    Lgrid = (engine._grid_farfield(td, cfg, eps)
             if cfg.farfield == "grid2" else None)
    acc_u, pot_u = engine._tail_impl(td, cfg, eps, scal, Lgrid, acc, pot)
    return acc_u, pot_u, torch.stack(ovfs).any(0)


def _query_impl(td: TreeData, cfg: TreeConfig, theta, eps, scal, mesh: Mesh,
                staged=None):
    """acc_pot_u_sharded's computation in three stages (`staged` as in
    parallel.mesh): the tiles and tables on the first shard's device; each
    shard's equal range of the padded capacity chunks on its own device,
    the tree and tables copied there; the tiles' sums and flags gathered
    to the first shard, the tail run there once."""
    if cfg.farfield == "grid":
        cfg = cfg.with_(farfield="local")
    tiles, tables = _mesh.on_first(mesh, _tiles_tables, staged, td, cfg,
                                   mesh.size)
    K = tiles[0].shape[0] // mesh.size
    panels = _mesh.scatter(mesh, [tuple(t[r * K:(r + 1) * K] for t in tiles)
                                  for r in range(mesh.size)])
    sums = _mesh.stage_map(mesh, _shard_chunks, [
        (td_r, cfg) + scal_r + (panels_r, tables_r)
        for td_r, scal_r, panels_r, tables_r in zip(
            _mesh.to_shards(mesh, td),
            _mesh.to_shards(mesh, (theta, eps, scal)), panels,
            _mesh.to_shards(mesh, tables))], staged)
    dev0 = mesh.devices[0]
    accs, pots, ovfs = zip(*sums)
    return _mesh.on_first(mesh, _tail, staged, td, cfg, eps, scal,
                          _mesh.gather_cat(accs, dev0),
                          _mesh.gather_cat(pots, dev0),
                          _mesh.gather(ovfs, dev0))


class _Query(NamedTuple):
    """The sharded query as integrate's bodies call theirs
    (engine._query_impl's arguments and results; no maxima), the mesh and
    the stages held in a named tuple, so that a graph's key takes it as
    any other argument."""
    mesh: Mesh
    staged: Optional[bool] = None

    def __call__(self, td, cfg, theta, eps, scal):
        return _query_impl(td, cfg, theta, eps, scal, self.mesh,
                           self.staged) + (None,)


def _whole(graph: bool, mesh: Mesh, body, *args):
    """body(*args, build, query) of a whole twin: on a one-card mesh one
    call (integrate._whole: one CUDA graph with graph); on a mesh over
    several cards uncaptured, each build replayed from its graph on the
    first shard's card (engine.build_tree), each query in _query_impl's
    stages (per-card graphs with graph, else eager) and the rest (the
    kick and drift) run there eagerly."""
    if _mesh.one_card(mesh):
        return integrate._whole(graph, body, *args, query=_Query(mesh))
    build = functools.partial(engine.build_tree, graph=graph)
    with _mesh._on(mesh.devices[0]):
        return body(*args, build, _Query(mesh, graph))


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
    mesh the call is one CUDA graph, on several cards a CUDA graph a card
    and stage (graph as in the module's docstring). theta, eps and G are
    numbers or 0-dim tensors, the graphs' inputs (engine.scalars)."""
    td = _mesh._to(td, mesh.devices[0])
    graph = engine._use_graph(graph, td.pos, cfg)
    args = (td, cfg) + engine.scalars(td.pos, theta, eps, G) + (mesh,)
    if _mesh.one_card(mesh):
        return engine._run(graph, _query_impl, *args)
    return _query_impl(*args, staged=graph)


def acc_pot_sharded(pos, mass, cfg: TreeConfig, theta, eps, G, mesh: Mesh,
                    box_size=None, graph=None):
    """Build (once, on the first shard's device) + the sharded query, on a
    one-card mesh one CUDA graph (on several, _whole's stages). Returns
    acc [N, D] and pot [N] in the input order, and the overflow flags
    [4]; raises after the call if the build overflowed its node or tile
    capacity."""
    dev0 = mesh.devices[0]
    pos, mass = pos.to(dev0), mass.to(dev0)
    graph, box_size, theta, eps, scal = integrate._scalars(
        pos, cfg, graph, box_size, theta, eps, G)
    acc, pot, ovf, b_ovf = _whole(graph, mesh, integrate._acc_pot, pos, mass,
                                  cfg, theta, eps, scal, box_size)
    integrate._check_build(b_ovf)
    return acc, pot, ovf


def leapfrog_step_sharded(state, dt, cfg: TreeConfig, theta, eps, G,
                          mesh: Mesh, box_size=None, graph=None):
    """KDK leapfrog step with a rebuild for each force evaluation, the
    queries sharded over the mesh, on a one-card mesh one CUDA graph (dt
    an input of it, as in integrate.leapfrog_step; on several cards,
    _whole's stages). Returns (new integrate.NBodyState on the first
    shard's device, overflow flags [4]); raises after the call if a build
    overflowed."""
    state = _mesh._to(state, mesh.devices[0])
    graph, box_size, theta, eps, scal = integrate._scalars(
        state.pos, cfg, graph, box_size, theta, eps, G)
    new, ovf, b_ovf = _whole(graph, mesh, integrate._step, state,
                             integrate._dt(dt, state.pos), cfg, theta, eps,
                             scal, box_size)
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
    dev0 = mesh.devices[0]
    with span("query"):
        td = _mesh._to(td, dev0)
        tiles, tables, Lgrid = engine._query_state(td, cfg, eps)
        theta, eps, scal = engine.scalars(td.pos, theta, eps, G)
        scals = _mesh.to_shards(mesh, (theta, eps, scal))
        # the one host read of the query: how many chunks hold real tiles
        n_live = engine.live_chunks(td, cfg)
        tds = _mesh.to_shards(mesh, td)
        # with "grid" gone, the chunk loop reads no far-field state
        # (grid2's leaf locals stay on the first shard for the
        # per-particle far field)
        states = _mesh.to_shards(mesh, (tiles, tables, None))
        accs, pots, ovfs = [], [], []
        for r, (first, last) in enumerate(chunk_ranges(n_live, mesh.size)):
            if first == last:
                ovfs.append(torch.zeros(4, dtype=torch.bool,
                                        device=mesh.devices[r]))
                continue
            with span("shard"):
                a, p, o, _ = engine.run_chunks(tds[r], cfg, *scals[r],
                                               states[r], first, last)
            accs.append(a)
            pots.append(p)
            ovfs.append(o)
        ovf = _mesh.any(ovfs)[0]
        with span("tail"):
            acc_u, pot_u = engine._assemble_impl(
                td, cfg, _mesh.gather_cat(accs, dev0),
                _mesh.gather_cat(pots, dev0))
            acc_u, pot_u = engine._add_grid2(td, cfg, eps, scal, Lgrid,
                                             acc_u, pot_u)
        return acc_u, pot_u, ovf


def acc_pot_sharded_host(pos, mass, cfg: TreeConfig, theta, eps, G,
                         mesh: Mesh, box_size=None):
    """acc_pot_sharded's _host twin: the build's graph, then
    acc_pot_u_sharded_host."""
    dev0 = mesh.devices[0]
    td = integrate._host_build(pos.to(dev0), mass.to(dev0), cfg, box_size,
                               graph=None)
    acc_u, pot_u, ovf = acc_pot_u_sharded_host(td, cfg, theta, eps, G, mesh)
    with span("reorder"):
        return acc_u[td.inv_perm], pot_u[td.inv_perm], ovf


def leapfrog_step_sharded_host(state, dt, cfg: TreeConfig, theta, eps, G,
                               mesh: Mesh, box_size=None):
    """leapfrog_step_sharded's _host twin."""
    with span("step"):
        acc0, _, ovf0 = acc_pot_sharded_host(state.pos, state.mass, cfg,
                                             theta, eps, G, mesh, box_size)
        dev0 = acc0.device
        vel_h = state.vel.to(dev0) + 0.5 * dt * acc0
        pos1 = state.pos.to(dev0) + dt * vel_h
        mass = state.mass.to(dev0)
        acc1, _, ovf1 = acc_pot_sharded_host(pos1, mass, cfg, theta, eps, G,
                                             mesh, box_size)
        vel1 = vel_h + 0.5 * dt * acc1
        return integrate.NBodyState(pos1, vel1, mass), ovf0 | ovf1
