"""Tile-sharded query and leapfrog step over a Mesh. Counterpart of
`rakau_tpu.parallel.sharded`.

The tree and the query's per-tree state (tile table, traversal tables)
are built once and replicated to each shard's device (no copy where
shards share a device); the live tile chunks are split into contiguous
ranges, one per shard, and each shard runs the single-device chunk loop
(`engine.run_chunks`) over its range. The tile results are gathered to
the first shard's device and assembled there by `engine._assemble_impl`;
the overflow flags are OR-reduced over the shards (the reference's
`pmax`). Each shard evaluates its chunks exactly as the single-device
query does, so the sums are the same.
"""
from __future__ import annotations

import torch

from .. import engine, integrate
from ..build import TreeData
from ..config import TreeConfig
from . import mesh as _mesh
from .mesh import Mesh, default_mesh

__all__ = ["default_mesh", "acc_pot_u_sharded", "acc_pot_sharded",
           "leapfrog_step_sharded"]


def chunk_ranges(n_live: int, ndev: int) -> list:
    """Contiguous [first, last) chunk ranges, one per shard, as even as
    the count allows (a shard may get none when ndev > n_live)."""
    return [(r * n_live // ndev, (r + 1) * n_live // ndev)
            for r in range(ndev)]


def acc_pot_u_sharded(td: TreeData, cfg: TreeConfig, theta, eps, G,
                      mesh: Mesh):
    """Sharded counterpart of engine.acc_pot_u_host: the same sums, the
    tile chunks split over `mesh`. Returns (acc_u [N, D], pot_u [N],
    overflow [4]) in Morton order on the first shard's device.
    farfield="grid" falls back to "local", as in the reference (the
    replicated path carries no dense stencil grids); grid2's far field is
    added once, on the first shard. gwalk has one global walk and no
    chunks to split: NotImplementedError."""
    if cfg.traversal_mode == "gwalk":
        raise NotImplementedError("the sharded query splits tile chunks; "
                                  "gwalk has none")
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


def acc_pot_sharded(pos, mass, cfg: TreeConfig, theta, eps, G, mesh: Mesh,
                    box_size=None):
    """Build (once, on the first shard's device) + sharded query. Returns
    acc [N, D] and pot [N] in the input order, and the overflow flags [4].
    A build that overflows its node or tile capacity raises, as
    integrate's does."""
    dev0 = mesh.devices[0]
    td = integrate._host_build(pos.to(dev0), mass.to(dev0), cfg, box_size,
                               graph=None)
    acc_u, pot_u, ovf = acc_pot_u_sharded(td, cfg, theta, eps, G, mesh)
    return acc_u[td.inv_perm], pot_u[td.inv_perm], ovf


def leapfrog_step_sharded(state, dt, cfg: TreeConfig, theta, eps, G,
                          mesh: Mesh, box_size=None):
    """KDK leapfrog step with a rebuild for each force evaluation, the
    queries sharded over the mesh. Returns (new integrate.NBodyState on
    the first shard's device, overflow flags [4])."""
    acc0, _, ovf0 = acc_pot_sharded(state.pos, state.mass, cfg, theta, eps,
                                    G, mesh, box_size)
    dev0 = acc0.device
    vel_h = state.vel.to(dev0) + 0.5 * dt * acc0
    pos1 = state.pos.to(dev0) + dt * vel_h
    mass = state.mass.to(dev0)
    acc1, _, ovf1 = acc_pot_sharded(pos1, mass, cfg, theta, eps, G, mesh,
                                    box_size)
    vel1 = vel_h + 0.5 * dt * acc1
    return integrate.NBodyState(pos1, vel1, mass), ovf0 | ovf1
