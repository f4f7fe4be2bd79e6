"""Shared-candidate traversal: one union walk per tile-chunk with exact
per-tile decision masks. Counterpart of `rakau_tpu.traversal2`.

  * ONE union frontier per chunk of C tiles walks the tree (one row
    gather of node fields per round);
  * per-tile MAC decisions are dense [C, K] panels over the shared
    candidates (distance from tile AABB to node COM; bh or bh_geom);
  * the per-round decision masks go to [rounds, K, C] stacks;
    materialisation turns the union into one shared source row per
    chunk (M2P node entries + P2P leaves expanded to particles) and
    row-gathers the exact per-tile masks.

The reference packs integer node fields into float columns (a TPU
workaround); here the tables keep them as int64 columns of their own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import scan_utils as su
from .build import TreeData
from .config import MAC_BH_GEOM, TreeConfig
from .grid2 import particle_cells

I64 = torch.int64


class SharedSources(NamedTuple):
    """Per-chunk shared source row (static shapes) with exact per-tile
    contribution masks. S = m2p_cap + p2p_src_cap."""
    pos: torch.Tensor        # [S, D] node COM or particle position
    mass: torch.Tensor       # [S]
    idx: torch.Tensor        # [S] int64 Morton particle id; -1 for nodes
    mask: torch.Tensor       # [C, S] bool: source contributes to tile c
    count: torch.Tensor      # [] valid entries
    overflow: torch.Tensor   # [4] bool, aligned with config.OVF_FIELDS
    maxima: torch.Tensor     # [4] int64 (union nodes, total sources,
                             # frontier, p2p leaves)
    quad: torch.Tensor = None  # [m2p_cap, Q] raw second moments of the
                               # M2P node rows (multipole_order=2 only;
                               # zero on invalid rows)
    cell: torch.Tensor = None  # [S, D] int64 leaf-grid cell (grid2 only):
                               # the kernel's per-pair coverage operand;
                               # -1 marks rows exempt from the test


class TraversalTables(NamedTuple):
    """Node and particle fields packed for row gathers.

    ff [M, 6(+Q)] float: com (padded to 3), mass, size, bh_geom delta
        (or 0), and with multipole_order=2 the Q = D(D+1)/2 raw second
        moments (node_quad), which the M2P materialisation gathers.
    fi [M, 5] int64: level, leaf flag, child_begin, child_count, packed
        effective cell (cell coords at min(level, L0), D fields of L0
        bits each).
    pm [N, 4] float: particle pos (padded to 3) + mass."""
    ff: torch.Tensor
    fi: torch.Tensor
    pm: torch.Tensor


def _grid_l0(cfg: TreeConfig, n: int) -> int:
    if cfg.farfield == "grid":
        from .grid import effective_grid_level
        return effective_grid_level(cfg, n)
    if cfg.farfield == "grid2":
        from .grid2 import effective_grid_level
        return effective_grid_level(cfg, n)
    return 0


def _grid_sep(cfg: TreeConfig) -> int:
    """Cell separation from which the grid far field covers a pair."""
    return cfg.grid_sep if cfg.farfield == "grid2" else 3


def make_tables(td: TreeData, cfg: TreeConfig) -> TraversalTables:
    dtype = td.pos.dtype
    M = td.node_level.shape[0]
    n, D = td.pos.shape
    dev = td.pos.device
    size = td.box_size * torch.exp2(-td.node_level.to(dtype))
    L0 = _grid_l0(cfg, n)
    sh = torch.clamp(td.node_level - L0, min=0)
    cpack = torch.zeros(M, dtype=I64, device=dev)
    for d in range(D):
        cpack = cpack | ((td.node_cell[:, d] >> sh) << (d * L0))
    zeros = torch.zeros(M, dtype=dtype, device=dev)
    cols = [td.node_com[:, d] for d in range(D)] + [zeros] * (3 - D)
    cols += [td.node_mass, size,
             td.node_delta if cfg.mac == MAC_BH_GEOM else zeros]
    if cfg.multipole_order >= 2:
        cols += list(td.node_quad.unbind(1))
    ff = torch.stack(cols, dim=1)
    fi = torch.stack([td.node_level, td.node_is_leaf.to(I64),
                      td.node_child_begin, td.node_child_count, cpack], dim=1)
    pz = torch.zeros(n, dtype=dtype, device=dev)
    pm = torch.stack([td.pos[:, d] for d in range(D)] + [pz] * (3 - D)
                     + [td.mass], dim=1)
    return TraversalTables(ff=ff, fi=fi, pm=pm)


def _point_dist2(lo, hi, p):
    """Squared distance from tile AABBs [C,1,D] to points p [K,D]."""
    d = torch.maximum(torch.maximum(lo - p[None], p[None] - hi),
                      torch.zeros((), dtype=p.dtype, device=p.device))
    return (d * d).sum(-1)


def build_shared_sources(td: TreeData, cfg: TreeConfig, theta,
                         box_lo, box_hi,
                         tables: TraversalTables = None,
                         tile_cell=None, tile_valid=None,
                         tcell_lo=None, tcell_hi=None) -> SharedSources:
    """One chunk's union walk. box_lo/hi: [C, D] tile AABBs.

    With cfg.farfield in ("grid", "grid2"), candidates covered by the
    dense stencil far field are dropped and nodes above the leaf-grid
    level are never MAC-accepted. The drop test is against the tile's
    leaf-grid cell RANGE [tcell_lo, tcell_hi] ([C, D] each): a node is
    dropped iff its interval separation from it is >= S, i.e. every
    particle of the tile has that pair covered by the stencil. With
    "grid" the tiles are cell-clipped, lo == hi == tile_cell, and S = 3;
    with "grid2" S = cfg.grid_sep, the tiles span several cells, and the
    sources carry their leaf cells (SharedSources.cell) for the kernel's
    exact per-pair test. tile_valid [C] masks padding tiles out of the
    walk.

    The walk runs all max_depth+1 rounds and never syncs with the host:
    a round whose frontier is empty changes nothing, and stopping early
    would cost one device-to-host read per round."""
    C, D = box_lo.shape
    dtype = td.pos.dtype
    dev = td.pos.device
    n = td.pos.shape[0]
    theta_inv = 1.0 / torch.full((), theta, dtype=dtype, device=dev)
    lo = box_lo[:, None, :]
    hi = box_hi[:, None, :]
    if tables is None:
        tables = make_tables(td, cfg)
    L0 = _grid_l0(cfg, n)
    use_grid = L0 > 0
    emit_cells = use_grid and cfg.farfield == "grid2"
    S_sep = _grid_sep(cfg)
    if tcell_lo is None:
        tcell_lo = tile_cell
    if tcell_hi is None:
        tcell_hi = tile_cell
    if tile_valid is None:
        tile_valid = torch.ones(C, dtype=torch.bool, device=dev)

    fcap = cfg.frontier_cap
    k8 = 2 ** cfg.ndim
    K = fcap * k8
    R = cfg.max_depth + 1          # rounds (root round included)
    arK = torch.arange(K, device=dev)

    def classify(ids, par_active_kc):
        """ids [K] node slots (-1 invalid); par_active [K, C]: tile c
        opened the parent. Returns (m2p accept, p2p leaf-open, next
        frontier activity), each [K, C]."""
        valid = ids >= 0
        ids_c = torch.where(valid, ids, 0)
        row = tables.ff[ids_c]                          # one row gather
        irow = tables.fi[ids_c]
        com = row[:, :D]
        mass = row[:, 3]
        lvl = irow[:, 0]
        leaf = irow[:, 1] > 0
        d2 = _point_dist2(lo, hi, com)                  # [C, K]
        thresh = row[:, 4] * theta_inv + row[:, 5]
        acc = d2 > (thresh * thresh)[None, :]
        use = par_active_kc.T & valid[None, :]          # [C, K]
        if use_grid:
            cp = irow[:, 4]                             # packed eff cell
            # node cell is at min(level, L0); shift the tile cell range
            # down when the node is shallower
            sh_t = torch.clamp(L0 - lvl, min=0)         # [K]
            fmask = (1 << L0) - 1
            sep = torch.zeros((C, K), dtype=I64, device=dev)
            for d in range(D):
                ncell = (cp >> (d * L0)) & fmask        # [K]
                tl = tcell_lo[:, None, d] >> sh_t[None, :]
                th = tcell_hi[:, None, d] >> sh_t[None, :]
                sep = torch.maximum(sep, torch.maximum(
                    ncell[None, :] - th, tl - ncell[None, :]))
            use = use & (sep < S_sep)                   # covered -> drop
            acc = acc & (lvl >= L0)[None, :]            # never accept above
        # zero-mass nodes source nothing: never accept and never open
        live = use & (mass > 0)[None, :]
        accepted = acc & live
        opened = ~acc & live
        return (accepted.T, (opened & leaf[None, :]).T,
                (opened & ~leaf[None, :]).T)

    m2p_stack = torch.zeros((R, K, C), dtype=torch.bool, device=dev)
    p2p_stack = torch.zeros((R, K, C), dtype=torch.bool, device=dev)
    id_stack = torch.full((R, K), -1, dtype=I64, device=dev)

    def advance(ids, next_a):
        """Compact the opened internal nodes into the next frontier."""
        idxs, cnt = su.compact_indices(next_a.any(1), fcap)
        idxs_c = torch.clamp(idxs, max=K - 1)
        inb = idxs < K
        frontier = torch.where(inb, ids[idxs_c], 0)
        f_active = next_a[idxs_c] & inb[:, None]
        return frontier, torch.clamp(cnt, max=fcap), f_active, cnt

    # round 0: the root alone (padding tiles excluded from the walk)
    root_ids = torch.where(arK < 1, 0, -1)
    root_act = (arK < 1)[:, None] & tile_valid[None, :]
    m0, p0, next0 = classify(root_ids, root_act)
    m2p_stack[0] = m0
    p2p_stack[0] = p0
    id_stack[0] = root_ids
    frontier, f_cnt, f_active, cnt0 = advance(root_ids, next0)
    f_max = torch.clamp(cnt0, min=1)
    ovf_frontier = torch.zeros((), dtype=torch.bool, device=dev)

    arF = torch.arange(fcap, device=dev)
    ar8 = torch.arange(k8, device=dev)
    for r in range(1, R):
        fvalid = arF < f_cnt
        rowi = tables.fi[torch.where(fvalid, frontier, 0)]
        cb = rowi[:, 2]
        cc = rowi[:, 3]
        kids = (cb[:, None] + ar8).reshape(-1)
        kval = ((ar8[None, :] < cc[:, None]) & fvalid[:, None]).reshape(-1)
        ids = torch.where(kval, kids, -1)
        par_active = f_active.repeat_interleave(k8, dim=0)   # [K, C]
        m2p_m, p2p_m, next_a = classify(ids, par_active)
        m2p_stack[r] = m2p_m
        p2p_stack[r] = p2p_m
        id_stack[r] = ids
        frontier, f_cnt, f_active, cnt = advance(ids, next_a)
        ovf_frontier = ovf_frontier | (cnt > fcap)
        f_max = torch.maximum(f_max, cnt)

    # ---- materialize the union ------------------------------------------
    RK = R * K
    ids_flat = id_stack.reshape(RK)
    m2p_flat = m2p_stack.reshape(RK, C)
    p2p_flat = p2p_stack.reshape(RK, C)
    sentinel = 4.0 * td.box_size

    # M2P rows: nodes accepted by >= 1 tile, re-sorted by node_begin
    # (Morton position) so a tile's active rows cluster into few kernel
    # blocks. The sort is stable: a parent and its first child share
    # node_begin and keep their walk order.
    ucap = cfg.m2p_cap
    uidx, ucnt = su.compact_indices(m2p_flat.any(1), ucap)
    uvalid = uidx < RK
    uidx_c = torch.clamp(uidx, max=RK - 1)
    un_ids = torch.where(uvalid, ids_flat[uidx_c], 0)
    order = torch.sort(torch.where(uvalid, td.node_begin[un_ids], n),
                       stable=True).indices
    uidx_c, un_ids, uvalid = uidx_c[order], un_ids[order], uvalid[order]
    m_row = tables.ff[un_ids]
    m_pos = torch.where(uvalid[:, None], m_row[:, :D], sentinel)
    m_mass = torch.where(uvalid, m_row[:, 3], 0.0)
    m_idx = torch.full((ucap,), -1, dtype=I64, device=dev)
    m_mask = m2p_flat[uidx_c] & uvalid[:, None]          # [ucap, C]
    m_quad = None
    if cfg.multipole_order >= 2:
        m_quad = torch.where(uvalid[:, None], m_row[:, 6:], 0.0)
    m_cell = None
    if emit_cells:
        # accepted nodes have level >= L0, so the packed effective cell
        # is the leaf-grid cell (padding rows read node 0: cell 0)
        cp = tables.fi[un_ids, 4]
        fmask = (1 << L0) - 1
        m_cell = torch.stack([(cp >> (d * L0)) & fmask for d in range(D)],
                             dim=1)                      # [ucap, D]

    # P2P rows: leaves opened by >= 1 tile (same stable spatial sort),
    # expanded to their particles
    pcap = cfg.p2p_src_cap
    lcap = cfg.p2p_leaf_cap
    lidx, lcnt = su.compact_indices(p2p_flat.any(1), lcap)
    lvalid = lidx < RK
    lidx_c = torch.clamp(lidx, max=RK - 1)
    lf_ids = torch.where(lvalid, ids_flat[lidx_c], 0)
    order = torch.sort(torch.where(lvalid, td.node_begin[lf_ids], n),
                       stable=True).indices
    lidx_c, lf_ids, lvalid = lidx_c[order], lf_ids[order], lvalid[order]
    lb = torch.where(lvalid, td.node_begin[lf_ids], 0)
    lc = torch.where(lvalid, td.node_end[lf_ids] - td.node_begin[lf_ids], 0)
    offs = torch.cumsum(lc, 0) - lc
    total_p = offs[-1] + lc[-1]
    # row of each particle slot: start marks + cumsum
    kq = torch.arange(pcap, device=dev)
    marks = torch.zeros(pcap + 1, dtype=I64, device=dev)
    marks.index_add_(0, torch.where(lc > 0, torch.clamp(offs, max=pcap),
                                    pcap), torch.ones_like(lc))
    row = torch.clamp(torch.cumsum(marks[:pcap], 0) - 1, min=0)
    rvalid = kq < torch.clamp(total_p, max=pcap)
    row_c = torch.clamp(row, max=lcap - 1)
    pidx = torch.where(rvalid, lb[row_c] + (kq - offs[row_c]), -1)
    p_row = tables.pm[torch.clamp(pidx, 0, n - 1)]
    p_pos = torch.where(rvalid[:, None], p_row[:, :D], sentinel)
    p_mass = torch.where(rvalid, p_row[:, 3], 0.0)
    leaf_mask = p2p_flat[lidx_c] & lvalid[:, None]       # [lcap, C]
    p_mask = leaf_mask[row_c] & (rvalid & (p_mass > 0))[:, None]
    if use_grid:
        # leaves above the grid level span several leaf-grid cells; their
        # particles in stencil-covered cells are already in the dense far
        # field: filter them per particle against the tile's cell range
        # (grid2 closes the per-pair remainder in the kernel). The cells
        # come from the gathered positions through the one cell map;
        # padding rows sit at the 4 * box sentinel, which it clamps to
        # the last cell of every dimension.
        pcell = particle_cells(p_pos, td.box_size, cfg.max_depth, L0)
        psep = torch.maximum(pcell[:, None, :] - tcell_hi[None, :, :],
                             tcell_lo[None, :, :] - pcell[:, None, :]
                             ).amax(-1)                   # [pcap, C]
        p_mask = p_mask & (psep < S_sep)

    return SharedSources(
        pos=torch.cat([m_pos, p_pos], 0).to(dtype),
        mass=torch.cat([m_mass, p_mass], 0).to(dtype),
        idx=torch.cat([m_idx, pidx], 0),
        mask=torch.cat([m_mask, p_mask], 0).T.contiguous(),  # [C, S]
        count=torch.clamp(ucnt, max=ucap) + torch.clamp(total_p, max=pcap),
        overflow=torch.stack([ucnt > ucap, lcnt > lcap, total_p > pcap,
                              ovf_frontier]),
        maxima=torch.stack([ucnt, ucnt + total_p, f_max, lcnt]),
        quad=m_quad,
        cell=torch.cat([m_cell, pcell], 0) if emit_cells else None)
