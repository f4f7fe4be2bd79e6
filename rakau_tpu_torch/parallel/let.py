"""Locally-essential-tree (LET) execution: Morton-range domain
decomposition with a coarsened halo exchange. Counterpart of
`rakau_tpu.parallel.let`.

Unlike parallel/sharded.py, which replicates the tree and splits only the
work, each shard holds only its contiguous Morton range of particles plus
a conservative coarsened view of the rest:

  1. Phase 0 assigns the ranges. The default ("distributed") never forms
     a global array: each shard sorts its own rows, all shards agree on
     range splitters from a gathered regular sample of the sorted codes
     (sample sort), and rows move to their owner through fixed-capacity
     `all_to_all`s. A capacity overflow (imbalance beyond
     `exchange_slack`) is reported in export_ovf, never truncated.
     phase0="global" keeps one global sort and equal ranges.
  2. Each shard builds a local tree over its range against the global box
     (cells align across shards).
  3. Export sets: each shard walks its local tree against every other
     domain's bounding box with the same theta MAC, the walk being
     traversal2.build_shared_sources with the domain boxes as tiles.
     Accepted nodes export as macro-particles (COM, mass), opened leaves
     their particles. dist(domain box, COM) <= dist(any tile inside it,
     COM), so every export would also pass the destination's own MAC.
  4. The exports move by one `all_to_all` into fixed [ndev, export_cap]
     slots.
  5. Each shard queries its local tree with the imports as extra sources
     of every tile: far imports go into the tile expansions, near ones
     ride the pairwise kernel.
  6. The results return to their input shard through the inverse
     permutations and one `all_to_all`.

The shards run in turn on one controller (parallel/mesh.py). The twins,
as in parallel/sharded.py, run one pipeline (`_let`) given a build and a
query: `acc_pot_let`, the reference's executable, with build.build_tree
and engine._query_impl(extra=) (every chunk of the tile capacity), no
host read and on a one-card mesh one CUDA graph; `acc_pot_let_host` with
engine.build_tree and engine.acc_pot_u_host(extra=) (one host read of
n_tiles a shard, the live chunks in sliced graphs). Inside
`stage_seconds()` acc_pot_let_host synchronises the mesh around each
stage and records its seconds.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from .. import build as _build
from .. import engine as _engine
from .. import morton, particles as _particles, traversal2
from .. import scan_utils as su
from ..config import TreeConfig
from ..tree import _inverse
from . import mesh as _mesh
from .mesh import Mesh

_timing = None


@contextmanager
def stage_seconds():
    """Inside the block, acc_pot_let_host synchronises the mesh's devices
    around each of its stages ("phase0", "local_build", "export_walk",
    "exchange", "local_query", "return_route") and adds the stage's
    seconds to the yielded dict."""
    global _timing
    saved, _timing = _timing, {}
    try:
        yield _timing
    finally:
        _timing = saved


@contextmanager
def _stage(mesh: Mesh, name: str):
    if _timing is None:
        yield
        return
    _mesh.synchronize(mesh)
    t0 = time.perf_counter()
    yield
    _mesh.synchronize(mesh)
    _timing[name] = _timing.get(name, 0.0) + time.perf_counter() - t0


def _export_cfg(cfg: TreeConfig, node_cap: int, part_cap: int,
                leaf_cap: int, frontier_cap: int) -> TreeConfig:
    """The export walk's config: farfield "local" (no grid-coverage drops:
    the dense stencil grids are per shard and never span shards) and
    multipole_order 0 (the walk ships monopole macro-particles only),
    local_order clamped to 3 (a grid2-only range), and the export caps."""
    return cfg.with_(farfield="local", multipole_order=0,
                     local_order=min(cfg.local_order, 3),
                     m2p_cap=node_cap, p2p_src_cap=part_cap,
                     p2p_leaf_cap=leaf_cap, frontier_cap=frontier_cap)


def _query_cfg(cfg: TreeConfig) -> TreeConfig:
    """The local query's config: the dense stencil far fields (grid,
    grid2) are per-shard pyramids that cannot span shards, so the
    monopole maps to "local" and the quadrupole to "m2p"."""
    if cfg.farfield in ("grid", "grid2"):
        ff = "m2p" if cfg.multipole_order >= 2 else "local"
        return cfg.with_(farfield=ff, local_order=min(cfg.local_order, 3))
    return cfg


def _codes(pos, box_size, depth: int):
    return morton.encode(_particles.discretize(pos, box_size, depth),
                         pos.shape[1], depth)


def _route(codes_s: list, nl: int, cap: int, s_smp: int) -> list:
    """Phase 0's routing from each shard's sorted codes [nl]: the
    splitters from a gathered regular sample of `s_smp` codes a shard,
    each row's owner `dest` [nl] (nondecreasing), the first row `start`
    [ndev] and the count `cnt` [ndev] of each owner's run, and `x_ovf`,
    set when a run bound for another shard exceeds `cap` (rows that stay
    never ride the exchange). One int64 comparison replaces the
    reference's (hi, lo) word-pair test. Returns [(dest, start, cnt,
    x_ovf)] per shard."""
    ndev = len(codes_s)
    smp = _mesh.all_gather([
        c[(torch.arange(s_smp, device=c.device) * nl) // s_smp
          + nl // (2 * s_smp)] for c in codes_s])
    out = []
    for me, (code, sm) in enumerate(zip(codes_s, smp)):
        dev = code.device
        ranks = torch.arange(1, ndev, device=dev) * s_smp
        sp = torch.sort(sm.reshape(-1)).values[ranks]          # [ndev-1]
        dest = torch.searchsorted(sp, code, right=True)        # [nl]
        ids = torch.arange(ndev, device=dev)
        start = su.searchsorted_1d(dest, ids)
        cnt = torch.cat([start[1:], start.new_full((1,), nl)]) - start
        x_ovf = ((cnt > cap) & (ids != me)).any()
        out.append((dest, start, cnt, x_ovf))
    return out


def _export_rows(td, cfg_e: TreeConfig, theta, dlo, dhi, not_me,
                 export_cap: int, box_size):
    """One shard's export walk (the domains as tiles) and its compaction
    into [ndev, export_cap] slots: (e_pos, e_mass, cnt [ndev] the rows
    each domain takes, exp_ovf). Unused slots sit at the 4 * box sentinel
    with mass 0. exp_ovf is set when a count exceeds export_cap or the
    walk overflowed its caps."""
    src = traversal2.build_shared_sources(td, cfg_e, theta, dlo, dhi,
                                          tile_valid=not_me)
    S = src.pos.shape[0]
    idxs, cnt = su.compact_indices(src.mask, export_cap)
    safe = idxs.clamp(max=S - 1)
    valid = idxs < S
    e_pos = torch.where(valid[..., None], src.pos[safe], 4.0 * box_size)
    e_mass = torch.where(valid, src.mass[safe], 0.0)
    exp_ovf = (cnt > export_cap).any() | src.overflow.any()
    return e_pos, e_mass, cnt, exp_ovf


def _export_query(mesh: Mesh, tds: list, cfg_q, cfg_e, theta, eps, G,
                  box_size: list, export_cap: int, dlo: list, dhi: list,
                  not_me: list, query):
    """The LET's back half on every shard: export walk, exchange, local
    query with the imports. Returns per shard the results in the local
    pre-build order (acc, pot), the overflow flags [4] and export_ovf
    OR-reduced over the shards, and each shard's export counts [ndev]."""
    ndev = mesh.size
    with _stage(mesh, "export_walk"):
        ex = [_export_rows(td, cfg_e, theta, lo, hi, nm, export_cap, box)
              for td, lo, hi, nm, box in zip(tds, dlo, dhi, not_me,
                                             box_size)]
    with _stage(mesh, "exchange"):
        imp_pos = _mesh.all_to_all([e[0] for e in ex])
        imp_mass = _mesh.all_to_all([e[1] for e in ex])
    accs, pots, ovfs = [], [], []
    with _stage(mesh, "local_query"):
        for td, ip, im in zip(tds, imp_pos, imp_mass):
            ndim = td.pos.shape[1]
            a, p, o, _ = query(
                td, cfg_q, theta, eps, G,
                extra=(ip.reshape(ndev * export_cap, ndim),
                       im.reshape(ndev * export_cap)))
            accs.append(a[td.inv_perm])
            pots.append(p[td.inv_perm])
            ovfs.append(o)
    ovf = _mesh.any(ovfs)
    exp_ovf = _mesh.any([e[3] for e in ex])
    return accs, pots, ovf, exp_ovf, [e[2] for e in ex]


def acc_pot_let(pos, mass, cfg: TreeConfig, theta, eps, G, mesh: Mesh,
                box_size=None, export_cap: int = 16384,
                export_node_cap: int = 8192, export_part_cap: int = 32768,
                export_leaf_cap: int = 4096, export_frontier_cap: int = 1024,
                phase0: str = "distributed", exchange_slack: float = 2.0,
                splitter_samples: int = 128, with_stats: bool = False,
                graph=None):
    """The whole LET pipeline, the reference's executable: phase 0, the
    local builds (build.build_tree), the domains, the export walk, the
    exchange, the local queries (engine._query_impl(extra=), every chunk
    of each shard's tile capacity) and the return route, with no host
    read; on a one-card mesh one CUDA graph (graph as in
    parallel.sharded: on a mesh over several cards graph=None or True
    raises ValueError, graph=False runs eagerly). Returns (acc [N, D],
    pot [N], overflow [4], export_ovf) in the input order on the first
    shard's device, and with with_stats the export-count matrix [ndev,
    ndev] (exports[src, dst], the halo volume): all of them outputs of
    the graph, read by the caller after the call. theta, eps and G are
    numbers. stage_seconds() times acc_pot_let_host only: inside it this
    raises ValueError.

    phase0="distributed" (the default) runs the sample-sort assignment:
    each shard's local sort, splitters from a gathered regular sample,
    fixed-capacity exchange buffers of ceil(nl * exchange_slack / ndev)
    rows a destination; a capacity overflow sets export_ovf (retry with a
    larger exchange_slack), as does an export count above export_cap or
    an overflowed export walk. phase0="global" sorts globally on the
    first shard and cuts equal ranges."""
    if _timing is not None:
        raise ValueError("stage_seconds() synchronises the mesh between "
                         "the stages of acc_pot_let_host; the whole call "
                         "has no stages to time: call acc_pot_let_host")
    dev0 = mesh.devices[0]
    pos, mass = pos.to(dev0), mass.to(dev0)
    graph = _mesh.one_card(_engine._use_graph(graph, pos, cfg), mesh)
    if isinstance(box_size, torch.Tensor):
        box_size = box_size.to(dev0)
    out = _engine._run(
        graph, _let, pos, mass, cfg, float(theta), float(eps), float(G),
        mesh, box_size, (export_cap, export_node_cap, export_part_cap,
                         export_leaf_cap, export_frontier_cap),
        phase0, exchange_slack, splitter_samples, _build.build_tree,
        _engine._query_impl)
    return out if with_stats else out[:4]


def acc_pot_let_host(pos, mass, cfg: TreeConfig, theta, eps, G, mesh: Mesh,
                     box_size=None, export_cap: int = 16384,
                     export_node_cap: int = 8192,
                     export_part_cap: int = 32768,
                     export_leaf_cap: int = 4096,
                     export_frontier_cap: int = 1024,
                     phase0: str = "distributed",
                     exchange_slack: float = 2.0,
                     splitter_samples: int = 128, with_stats: bool = False):
    """acc_pot_let's _host twin: each local build through
    engine.build_tree (its graph on the card) and each local query through
    engine.acc_pot_u_host(extra=) (one host read of n_tiles, the live
    chunks in sliced graphs). Returns what acc_pot_let returns, the same
    sums bit for bit; inside stage_seconds() each stage is timed."""
    out = _let(pos, mass, cfg, float(theta), float(eps), float(G), mesh,
               box_size, (export_cap, export_node_cap, export_part_cap,
                          export_leaf_cap, export_frontier_cap),
               phase0, exchange_slack, splitter_samples, _engine.build_tree,
               _engine.acc_pot_u_host)
    return out if with_stats else out[:4]


def _let(pos, mass, cfg, theta, eps, G, mesh, box_size, caps, phase0,
         slack, samples, build, query):
    """Both twins' pipeline, given `build(pos, mass, cfg, box_size)` and
    `query(td, cfg, theta, eps, G, extra=)`. Returns (acc, pot, overflow,
    export_ovf, the export counts [ndev, ndev] on the first shard)."""
    ndev = mesh.size
    n, ndim = pos.shape
    dtype = pos.dtype
    box_size = (_particles.auto_box_size(pos) if box_size is None
                else _particles.scalar_tensor(box_size, pos))
    depth = cfg.max_depth
    cfg_q = _query_cfg(cfg)
    cfg_e = _export_cfg(cfg, *caps[1:])
    n_pad = -(-n // ndev) * ndev
    nl = n_pad // ndev
    boxes = _mesh.to_shards(mesh, box_size)
    corner = torch.full((n_pad - n, ndim), 0.4999, dtype=dtype,
                        device=pos.device) * box_size
    zeros = torch.zeros(n_pad - n, dtype=dtype, device=pos.device)
    args = (mesh, cfg_q, cfg_e, theta, eps, G, boxes, caps[0], n, nl,
            depth, build, query)
    if phase0 == "global":
        out = _let_global(pos, mass, corner, zeros, *args)
    elif phase0 == "distributed":
        # zero-mass rows in the upper box corner (results dropped below;
        # they source nothing)
        pos_p = torch.cat([pos, corner])
        mass_p = torch.cat([mass, zeros])
        out = _let_distributed(
            [pos_p[r * nl:(r + 1) * nl].to(d)
             for r, d in enumerate(mesh.devices)],
            [mass_p[r * nl:(r + 1) * nl].to(d)
             for r, d in enumerate(mesh.devices)],
            slack, samples, *args)
    else:
        raise ValueError("phase0 must be 'distributed' or 'global'")
    acc, pot, ovf, exp_ovf, cnts = out
    dev0 = mesh.devices[0]
    return acc, pot, ovf, exp_ovf, torch.stack([c.to(dev0) for c in cnts])


def _domains(lo: list, hi: list, nonempty: list):
    """Each shard's view of every domain box and which domains it exports
    to (every other nonempty one)."""
    dlo, dhi = _mesh.all_gather(lo), _mesh.all_gather(hi)
    ne = _mesh.all_gather(nonempty)
    not_me = [(torch.arange(len(lo), device=x.device) != r) & x
              for r, x in enumerate(ne)]
    return dlo, dhi, not_me


def _let_distributed(pos_sh, mass_sh, slack, samples, mesh, cfg_q, cfg_e,
                     theta, eps, G, boxes, export_cap, n, nl, depth, build,
                     query):
    ndev = mesh.size
    ndim = pos_sh[0].shape[1]
    cap = max(1, -(-int(nl * slack) // ndev))
    s_smp = min(samples, nl)
    with _stage(mesh, "phase0"):
        # ---- local Morton sort, splitters, owners ------------------------
        sorted_ = [_build.sort_by_code(_codes(p, box, depth), p, m)
                   for p, m, box in zip(pos_sh, mass_sh, boxes)]
        route = _route([s[0] for s in sorted_], nl, cap, s_smp)
        # ---- fixed-size self and send buffers ----------------------------
        self_rows, sends = [], ([], [], [])
        for me, ((_, _, (pos_ls, mass_ls)), (dest, start, cnt, _)) in \
                enumerate(zip(sorted_, route)):
            dev = pos_ls.device
            corner_p = 0.4999 * boxes[me]
            kk_n = torch.arange(nl, device=dev)
            rows = (start[me] + kk_n).clamp(0, nl - 1)
            val = kk_n < cnt[me]
            self_rows.append((
                torch.where(val[:, None], pos_ls[rows], corner_p),
                torch.where(val, mass_ls[rows], 0.0), val))
            kk = torch.arange(cap, device=dev)
            rows = (start[:, None] + kk).clamp(0, nl - 1)      # [ndev, cap]
            s_val = (kk < cnt[:, None]) & (
                torch.arange(ndev, device=dev) != me)[:, None]
            sends[0].append(torch.where(s_val[..., None], pos_ls[rows],
                                        corner_p))
            sends[1].append(torch.where(s_val, mass_ls[rows], 0.0))
            sends[2].append(s_val)
        # ---- the one redistribution: three all_to_alls -------------------
        f_pos, f_mass, f_val = (_mesh.all_to_all(x) for x in sends)
        # ---- the received rows in local Morton order ---------------------
        recv = []
        for me in range(ndev):
            r_pos = torch.cat([self_rows[me][0], f_pos[me].reshape(-1, ndim)])
            r_mass = torch.cat([self_rows[me][1], f_mass[me].reshape(-1)])
            r_val = torch.cat([self_rows[me][2], f_val[me].reshape(-1)])
            _, perm_r, (pos_r, mass_r, val_r) = _build.sort_by_code(
                _codes(r_pos, boxes[me], depth), r_pos, r_mass, r_val)
            recv.append((perm_r, pos_r, torch.where(val_r, mass_r, 0.0),
                         val_r))
    with _stage(mesh, "local_build"):
        tds, lo, hi, ne = [], [], [], []
        for (_, pos_r, mass_r, val_r), box in zip(recv, boxes):
            tds.append(build(pos_r, mass_r, cfg_q, box))
            big = 2.0 * box
            lo.append(torch.where(val_r[:, None], pos_r, big).amin(0))
            hi.append(torch.where(val_r[:, None], pos_r, -big).amax(0))
            ne.append(val_r.any())
        dlo, dhi, not_me = _domains(lo, hi, ne)
    accs, pots, ovf, exp_ovf, cnts = _export_query(
        mesh, tds, cfg_q, cfg_e, theta, eps, G, boxes, export_cap, dlo, dhi,
        not_me, query)
    with _stage(mesh, "return_route"):
        # ---- each received row's result back to the shard it came from ---
        acc_rcv, pot_rcv = [], []
        for (perm_r, *_), a, p in zip(recv, accs, pots):
            inv = _inverse(perm_r)
            acc_rcv.append(a[inv])                             # [nl2, D]
            pot_rcv.append(p[inv])
        b_acc = _mesh.all_to_all([a[nl:].reshape(ndev, cap, ndim)
                                  for a in acc_rcv])
        b_pot = _mesh.all_to_all([p[nl:].reshape(ndev, cap)
                                  for p in pot_rcv])
        x_ovf = _mesh.any([r[3] for r in route])
        dev0 = mesh.devices[0]
        acc_out, pot_out = [], []
        for me, ((_, perm_l, _), (dest, start, _, _)) in enumerate(
                zip(sorted_, route)):
            jj = torch.arange(nl, device=dest.device)
            is_self = dest == me
            slot = jj - start[dest]
            slot_f = slot.clamp(0, cap - 1)
            slot_s = slot.clamp(0, nl - 1)
            acc_ls = torch.where(is_self[:, None], acc_rcv[me][slot_s],
                                 b_acc[me][dest, slot_f])
            pot_ls = torch.where(is_self, pot_rcv[me][slot_s],
                                 b_pot[me][dest, slot_f])
            inv_l = _inverse(perm_l)
            acc_out.append(acc_ls[inv_l].to(dev0))
            pot_out.append(pot_ls[inv_l].to(dev0))
        acc = torch.cat(acc_out)[:n]
        pot = torch.cat(pot_out)[:n]
    return acc, pot, ovf[0], exp_ovf[0] | x_ovf[0], cnts


def _let_global(pos, mass, corner, zeros, mesh, cfg_q, cfg_e, theta, eps,
                G, boxes, export_cap, n, nl, depth, build, query):
    """phase0="global": one global Morton sort on the input's device and
    equal contiguous ranges (O(N) memory on one device)."""
    with _stage(mesh, "phase0"):
        box = boxes[0].to(pos.device)
        _, perm, (pos_s, mass_s) = _build.sort_by_code(
            _codes(pos, box, depth), pos, mass)
        pos_s = torch.cat([pos_s, corner])
        mass_s = torch.cat([mass_s, zeros])
        pos_sh = [pos_s[r * nl:(r + 1) * nl].to(d)
                  for r, d in enumerate(mesh.devices)]
        mass_sh = [mass_s[r * nl:(r + 1) * nl].to(d)
                   for r, d in enumerate(mesh.devices)]
    with _stage(mesh, "local_build"):
        tds = [build(p, m, cfg_q, b)
               for p, m, b in zip(pos_sh, mass_sh, boxes)]
        # domain boxes over every row, the zero-mass ones included
        # (conservative)
        dlo, dhi, not_me = _domains([p.amin(0) for p in pos_sh],
                                    [p.amax(0) for p in pos_sh],
                                    [torch.ones((), dtype=torch.bool,
                                                device=p.device)
                                     for p in pos_sh])
    accs, pots, ovf, exp_ovf, cnts = _export_query(
        mesh, tds, cfg_q, cfg_e, theta, eps, G, boxes, export_cap, dlo, dhi,
        not_me, query)
    with _stage(mesh, "return_route"):
        dev0 = mesh.devices[0]
        inv = _inverse(perm).to(dev0)
        acc = torch.cat([a.to(dev0) for a in accs])[:n][inv]
        pot = torch.cat([p.to(dev0) for p in pots])[:n][inv]
    return acc, pot, ovf[0], exp_ovf[0], cnts
