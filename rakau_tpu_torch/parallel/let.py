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

The shards run on one controller (parallel/mesh.py): each numbered step
above is a per-shard stage, run for every shard (`mesh.stage_map`) between
the collectives that move rows between shards. The twins, as in
parallel/sharded.py, run one pipeline (`_let`) given a build and a query:
`acc_pot_let`, the reference's executable, with build.build_tree and
engine._query_impl(extra=) (every chunk of the tile capacity), no host
read, on a one-card mesh one CUDA graph and on a mesh over several cards
one CUDA graph a card and stage, the collectives between them;
`acc_pot_let_host` with engine.build_tree and engine.acc_pot_u_host(extra=)
(one host read of n_tiles a shard, the live chunks in sliced graphs), its
stages eager under each card's device. Each stage is the span
`let.<stage>` (utils.timing); inside `stage_seconds()` acc_pot_let_host
also synchronises the mesh around each stage and records its seconds.
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
from ..utils.timing import span
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
    """A stage of the pipeline: always the span `let.<name>`; inside
    stage_seconds() also synchronised and timed."""
    with span("let." + name):
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


def _export_shard(me: int, td, cfg_e: TreeConfig, theta, dlo, dhi, ne,
                  export_cap: int, box_size):
    """Shard `me`'s export stage: _export_rows to every other nonempty
    domain (ne [ndev], gathered)."""
    not_me = (torch.arange(ne.shape[0], device=ne.device) != me) & ne
    return _export_rows(td, cfg_e, theta, dlo, dhi, not_me, export_cap,
                        box_size)


def _local_query(td, imp_pos, imp_mass, cfg_q, theta, eps, G, query,
                 perm_r):
    """One shard's local query with its imports [ndev, export_cap] as extra
    sources. Returns (acc, pot) in the rows' pre-build order (with phase0
    "distributed", perm_r: in the order the rows were received) and the
    overflow flags [4]."""
    ndim = td.pos.shape[1]
    E = imp_mass.numel()
    a, p, o, _ = query(td, cfg_q, theta, eps, G,
                       extra=(imp_pos.reshape(E, ndim), imp_mass.reshape(E)))
    a, p = a[td.inv_perm], p[td.inv_perm]
    if perm_r is not None:
        inv = _inverse(perm_r)
        a, p = a[inv], p[inv]
    return a, p, o


def _export_query(mesh: Mesh, tds: list, cfg_q, cfg_e, theta, eps, G,
                  boxes: list, export_cap: int, lo: list, hi: list,
                  ne: list, perms: list, query, staged):
    """The LET's back half on every shard: the domains, the export walk,
    the exchange, the local query with the imports. Returns per shard the
    results (acc, pot; _local_query's order), the overflow flags [4], the
    export overflow and the export counts [ndev]."""
    ndev = mesh.size
    scals = _mesh.to_shards(mesh, (theta, eps, G))
    with _stage(mesh, "export_walk"):
        dlo, dhi, ne = (_mesh.all_gather(x) for x in (lo, hi, ne))
        ex = _mesh.stage_map(mesh, _export_shard, [
            (me, tds[me], cfg_e, scals[me][0], dlo[me], dhi[me], ne[me],
             export_cap, boxes[me]) for me in range(ndev)], staged)
    with _stage(mesh, "exchange"):
        imp_pos = _mesh.all_to_all([e[0] for e in ex])
        imp_mass = _mesh.all_to_all([e[1] for e in ex])
    with _stage(mesh, "local_query"):
        res = _mesh.stage_map(mesh, _local_query, [
            (tds[me], imp_pos[me], imp_mass[me], cfg_q) + scals[me]
            + (query, perms[me]) for me in range(ndev)], staged)
    return ([r[0] for r in res], [r[1] for r in res], [r[2] for r in res],
            [e[3] for e in ex], [e[2] for e in ex])


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
    read; on a one-card mesh one CUDA graph, on a mesh over several cards
    one graph a card and stage with the collectives between them (graph
    as in parallel.sharded: graph=False runs eagerly). Returns (acc [N,
    D], pot [N], overflow [4], export_ovf) in the input order on the first
    shard's device, and with with_stats the export-count matrix [ndev,
    ndev] (exports[src, dst], the halo volume): all of them outputs of
    the graphs, read by the caller after the call. theta, eps and G are
    numbers or 0-dim tensors, the graphs' inputs (engine.scalars).
    stage_seconds() times acc_pot_let_host only: inside it this
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
    graph = _engine._use_graph(graph, pos, cfg)
    if isinstance(box_size, torch.Tensor):
        box_size = box_size.to(dev0)
    caps = (export_cap, export_node_cap, export_part_cap, export_leaf_cap,
            export_frontier_cap)
    args = ((pos, mass, cfg) + _engine.scalars(pos, theta, eps, G)
            + (mesh, box_size, caps, phase0, exchange_slack,
               splitter_samples, _build.build_tree, _engine._query_impl))
    if _mesh.one_card(mesh):
        out = _engine._run(graph, _let, *args)
    else:
        out = _let(*args, staged=graph)
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
    engine.acc_pot_u_host(extra=) (one host read of n_tiles a shard, the
    live chunks in sliced graphs), each card's shards together under its
    device (the stages run eagerly around those graphs). Returns what
    acc_pot_let returns, the same sums bit for bit; inside
    stage_seconds() each stage is timed."""
    out = _let(pos, mass, cfg, theta, eps, G, mesh, box_size,
               (export_cap, export_node_cap, export_part_cap,
                export_leaf_cap, export_frontier_cap), phase0,
               exchange_slack, splitter_samples, _engine.build_tree,
               _engine.acc_pot_u_host, staged=False)
    return out if with_stats else out[:4]


def _split(pos, mass, box_size, ndev: int, depth: int, global_sort: bool):
    """Phase 0's first stage, on the first shard's device: the box (a
    0-dim tensor), with global_sort the one global Morton sort's
    permutation (else None), and the rows (sorted with global_sort)
    padded to ndev equal ranges by zero-mass rows in the upper box corner
    (results dropped at the end; they source nothing), one range a
    shard."""
    n, ndim = pos.shape
    nl = -(-n // ndev)
    box = (_particles.auto_box_size(pos) if box_size is None
           else _particles.scalar_tensor(box_size, pos))
    corner = torch.full((nl * ndev - n, ndim), 0.4999, dtype=pos.dtype,
                        device=pos.device) * box
    zeros = torch.zeros(nl * ndev - n, dtype=pos.dtype, device=pos.device)
    perm = None
    if global_sort:
        _, perm, (pos, mass) = _build.sort_by_code(_codes(pos, box, depth),
                                                   pos, mass)
    pos_p = torch.cat([pos, corner])
    mass_p = torch.cat([mass, zeros])
    return (box, perm, tuple(pos_p[r * nl:(r + 1) * nl] for r in range(ndev)),
            tuple(mass_p[r * nl:(r + 1) * nl] for r in range(ndev)))


def _collect(accs, pots, ovfs, flags, cnts, n: int, perm):
    """The last stage, on the first shard's device: the shards' results
    (gathered there, in shard order) cut to the n input rows, in the input
    order (perm: the global sort's, phase0 "global"), the overflow flags
    and the export overflows OR-ed, the export counts stacked."""
    acc = torch.cat(accs)[:n]
    pot = torch.cat(pots)[:n]
    if perm is not None:
        inv = _inverse(perm)
        acc, pot = acc[inv], pot[inv]
    return (acc, pot, torch.stack(ovfs).any(0), torch.stack(flags).any(),
            torch.stack(cnts))


def _let(pos, mass, cfg, theta, eps, G, mesh, box_size, caps, phase0,
         slack, samples, build, query, staged=None):
    """Both twins' pipeline, given `build(pos, mass, cfg, box_size)` and
    `query(td, cfg, theta, eps, G, extra=)` (theta, eps and G as the
    query takes them: engine.scalars' tensors, G the kernels' buffer, for
    engine._query_impl), its per-shard stages run as `staged` names
    (parallel.mesh). Returns (acc, pot, overflow,
    export_ovf, the export counts [ndev, ndev] on the first shard)."""
    if phase0 not in ("distributed", "global"):
        raise ValueError("phase0 must be 'distributed' or 'global'")
    ndev = mesh.size
    n = pos.shape[0]
    depth = cfg.max_depth
    cfg_q = _query_cfg(cfg)
    cfg_e = _export_cfg(cfg, *caps[1:])
    with _stage(mesh, "phase0"):
        box, perm, pos_sh, mass_sh = _mesh.on_first(
            mesh, _split, staged, pos, mass, box_size, ndev, depth,
            phase0 == "global")
        boxes = _mesh.to_shards(mesh, box)
        pos_sh = _mesh.scatter(mesh, list(pos_sh))
        mass_sh = _mesh.scatter(mesh, list(mass_sh))
    args = (mesh, cfg_q, cfg_e, theta, eps, G, boxes, caps[0], depth, build,
            query, staged)
    if phase0 == "global":
        out = _let_global(pos_sh, mass_sh, *args)
    else:
        out = _let_distributed(pos_sh, mass_sh, slack, samples, *args)
    accs, pots, ovfs, flags, cnts = out
    dev0 = mesh.devices[0]
    with _stage(mesh, "return_route"):
        return _mesh.on_first(
            mesh, _collect, staged, *(_mesh.gather(x, dev0) for x in (
                accs, pots, ovfs, flags, cnts)), n, perm)


# ------------------------------------------------- phase0 "distributed"
def _sort_sample(p, m, box, depth: int, s_smp: int):
    """A shard's local Morton sort and its regular sample of s_smp codes:
    (codes, perm, pos, mass, sample)."""
    nl = p.shape[0]
    code, perm, (pos_ls, mass_ls) = _build.sort_by_code(
        _codes(p, box, depth), p, m)
    sample = code[(torch.arange(s_smp, device=code.device) * nl) // s_smp
                  + nl // (2 * s_smp)]
    return code, perm, pos_ls, mass_ls, sample


def _route_rows(me: int, code, pos_ls, mass_ls, smp, box, cap: int,
                s_smp: int):
    """Shard `me`'s routing from its sorted codes [nl] and the gathered
    samples smp [ndev, s_smp]: the splitters, each row's owner `dest`
    [nl] (nondecreasing), the first row `start` [ndev] of each owner's
    run, `x_ovf`, set when a run bound for another shard exceeds `cap`
    (rows that stay never ride the exchange), the rows that stay (pos,
    mass, valid [nl]) and the send buffers (pos, mass, valid [ndev, cap])
    padded in the upper box corner with mass 0. One int64 comparison
    replaces the reference's (hi, lo) word-pair test."""
    ndev = smp.shape[0]
    nl = code.shape[0]
    dev = code.device
    ranks = torch.arange(1, ndev, device=dev) * s_smp
    sp = torch.sort(smp.reshape(-1)).values[ranks]              # [ndev-1]
    dest = torch.searchsorted(sp, code, right=True)             # [nl]
    ids = torch.arange(ndev, device=dev)
    start = su.searchsorted_1d(dest, ids)
    cnt = torch.cat([start[1:], start.new_full((1,), nl)]) - start
    x_ovf = ((cnt > cap) & (ids != me)).any()
    corner_p = 0.4999 * box
    kk_n = torch.arange(nl, device=dev)
    rows = (start[me] + kk_n).clamp(0, nl - 1)
    val = kk_n < cnt[me]
    stay = (torch.where(val[:, None], pos_ls[rows], corner_p),
            torch.where(val, mass_ls[rows], 0.0), val)
    kk = torch.arange(cap, device=dev)
    rows = (start[:, None] + kk).clamp(0, nl - 1)               # [ndev, cap]
    s_val = (kk < cnt[:, None]) & (ids != me)[:, None]
    send = (torch.where(s_val[..., None], pos_ls[rows], corner_p),
            torch.where(s_val, mass_ls[rows], 0.0), s_val)
    return dest, start, x_ovf, stay, send


def _receive(stay, f_pos, f_mass, f_val, box, depth: int):
    """A shard's rows after the exchange (its own, then what each shard
    sent) in local Morton order: (perm_r, pos, mass (0 where not valid),
    valid)."""
    ndim = f_pos.shape[-1]
    r_pos = torch.cat([stay[0], f_pos.reshape(-1, ndim)])
    r_mass = torch.cat([stay[1], f_mass.reshape(-1)])
    r_val = torch.cat([stay[2], f_val.reshape(-1)])
    _, perm_r, (pos_r, mass_r, val_r) = _build.sort_by_code(
        _codes(r_pos, box, depth), r_pos, r_mass, r_val)
    return perm_r, pos_r, torch.where(val_r, mass_r, 0.0), val_r


def _local_build(pos_r, mass_r, val_r, box, cfg_q, build):
    """A shard's local tree and its domain box over its valid rows (lo,
    hi, nonempty)."""
    td = build(pos_r, mass_r, cfg_q, box)
    big = 2.0 * box
    lo = torch.where(val_r[:, None], pos_r, big).amin(0)
    hi = torch.where(val_r[:, None], pos_r, -big).amax(0)
    return td, lo, hi, val_r.any()


def _return_rows(me: int, dest, start, perm_l, acc_rcv, pot_rcv, b_acc,
                 b_pot):
    """Shard `me`'s results in its input order: each row's result from its
    owner (its own rows from acc_rcv [nl2], the others from the returned
    buffers [ndev, cap]), then the local sort undone."""
    nl = dest.shape[0]
    cap = b_pot.shape[1]
    jj = torch.arange(nl, device=dest.device)
    is_self = dest == me
    slot = jj - start[dest]
    slot_f = slot.clamp(0, cap - 1)
    slot_s = slot.clamp(0, nl - 1)
    acc_ls = torch.where(is_self[:, None], acc_rcv[slot_s],
                         b_acc[dest, slot_f])
    pot_ls = torch.where(is_self, pot_rcv[slot_s], b_pot[dest, slot_f])
    inv_l = _inverse(perm_l)
    return acc_ls[inv_l], pot_ls[inv_l]


def _let_distributed(pos_sh, mass_sh, slack, samples, mesh, cfg_q, cfg_e,
                     theta, eps, G, boxes, export_cap, depth, build, query,
                     staged):
    ndev = mesh.size
    nl = pos_sh[0].shape[0]
    ndim = pos_sh[0].shape[1]
    cap = max(1, -(-int(nl * slack) // ndev))
    s_smp = min(samples, nl)
    shards = range(ndev)
    with _stage(mesh, "phase0"):
        # ---- local Morton sort, splitters, owners ------------------------
        sorted_ = _mesh.stage_map(mesh, _sort_sample, [
            (pos_sh[r], mass_sh[r], boxes[r], depth, s_smp) for r in shards],
            staged)
        smp = _mesh.all_gather([s[4] for s in sorted_])
        route = _mesh.stage_map(mesh, _route_rows, [
            (r, sorted_[r][0], sorted_[r][2], sorted_[r][3], smp[r], boxes[r],
             cap, s_smp) for r in shards], staged)
        # ---- the one redistribution: three all_to_alls -------------------
        f_pos, f_mass, f_val = (_mesh.all_to_all([x[4][i] for x in route])
                                for i in range(3))
        # ---- the received rows in local Morton order ---------------------
        recv = _mesh.stage_map(mesh, _receive, [
            (route[r][3], f_pos[r], f_mass[r], f_val[r], boxes[r], depth)
            for r in shards], staged)
    with _stage(mesh, "local_build"):
        built = _mesh.stage_map(mesh, _local_build, [
            recv[r][1:] + (boxes[r], cfg_q, build) for r in shards], staged)
    accs, pots, ovfs, exp_ovf, cnts = _export_query(
        mesh, [b[0] for b in built], cfg_q, cfg_e, theta, eps, G, boxes,
        export_cap, *([b[i] for b in built] for i in (1, 2, 3)),
        [r[0] for r in recv], query, staged)
    with _stage(mesh, "return_route"):
        # ---- each received row's result back to the shard it came from ---
        b_acc = _mesh.all_to_all([a[nl:].reshape(ndev, cap, ndim)
                                  for a in accs])
        b_pot = _mesh.all_to_all([p[nl:].reshape(ndev, cap) for p in pots])
        back = _mesh.stage_map(mesh, _return_rows, [
            (r, route[r][0], route[r][1], sorted_[r][1], accs[r], pots[r],
             b_acc[r], b_pot[r]) for r in shards], staged)
    return ([b[0] for b in back], [b[1] for b in back], ovfs,
            exp_ovf + [r[2] for r in route], cnts)


# ------------------------------------------------------- phase0 "global"
def _global_build(p, m, box, cfg_q, build):
    """A shard's local tree over its range of the global order and its
    domain box over every row, the zero-mass ones included
    (conservative)."""
    return (build(p, m, cfg_q, box), p.amin(0), p.amax(0),
            torch.ones((), dtype=torch.bool, device=p.device))


def _let_global(pos_sh, mass_sh, mesh, cfg_q, cfg_e, theta, eps, G, boxes,
                export_cap, depth, build, query, staged):
    """phase0="global": the one global Morton sort (in _split, on the first
    shard's device: O(N) memory there) and equal contiguous ranges."""
    ndev = mesh.size
    with _stage(mesh, "local_build"):
        built = _mesh.stage_map(mesh, _global_build, [
            (pos_sh[r], mass_sh[r], boxes[r], cfg_q, build)
            for r in range(ndev)], staged)
    return _export_query(
        mesh, [b[0] for b in built], cfg_q, cfg_e, theta, eps, G, boxes,
        export_cap, *([b[i] for b in built] for i in (1, 2, 3)),
        [None] * ndev, query, staged)
