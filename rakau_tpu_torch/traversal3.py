"""Walk-free shared-candidate traversal by a monotone local MAC
(`traversal_mode="lmac"`). Counterpart of `rakau_tpu.traversal3`.

The acceptance criterion is measured box to box:

    A(t, v) :=  dist_min(tile_box_t, cell_box_v)^2  >  R_v^2,
    R_v     :=  edge_v / theta  (+ delta_v for mac="bh_geom").

A child's cell box lies inside its parent's and R halves with the edge,
so A(t, parent) implies A(t, child) (with bh_geom for theta <= 2/sqrt(D),
to which theta is clamped here). Along a root-to-leaf path A is 0..0 1..1,
and the path-dependent walk collapses to a rule per node:

    tile t takes node v as M2P  iff  A(t, v) and not A(t, parent(v));
    tile t takes leaf v as P2P  iff  not A(t, v).

Every unit of mass is counted exactly once, with no traversal state: one
elementwise [C, K] predicate panel over the candidate rows of a chunk, one
compaction and one row gather give the same SharedSources that
traversal2's union walk gives, so the engine's far-field gates and the
kernels take them unchanged.

With a grid or grid2 far field acceptance is gated to levels >= L0 and
pairs covered by the stencil (cell separation >= S at the node's
effective grid level) are dropped, as in traversal2; coverage persists
under refinement, so the combined predicate stays monotone.

A slice of chunks first runs the same selection against the slice's
bounding box (build_group_candidates), a conservative superset of every
chunk's selection, and hands the chunks a table of `frontier_cap` rows in
place of the whole node table; the results are bit-identical.

The reference packs integer node fields into float columns (a TPU
workaround); here they are int64 columns of their own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import scan_utils as su
from .build import TreeData
from .config import MAC_BH_GEOM, TreeConfig
from .grid2 import particle_cells
from .traversal2 import SharedSources, _grid_l0, _grid_sep

I64 = torch.int64


class LmacTables(NamedTuple):
    """Per-node tables for the predicate pass and the row gathers
    (D = ndim, Q = D(D+1)/2 with multipole_order=2, else 0).

    ff [M, 3D+3+Q] float: com (D), mass (0 on invalid nodes), own cell-box
        centre (D), bh_geom delta (else 0), the parent's delta (else 0),
        the parent's cell-box centre (D), the second moments (Q).
    fi [M, 4] int64: level, leaf flag, parent level (-9 for the root, so
        that its parent's R is out of reach), packed effective grid cell
        (cell at min(level, L0), D fields of L0 bits; 0 without a grid).
    pm [N, 4] float: particle pos (padded to 3) + mass.
    L0: the grid level of the far field (0 without one)."""
    ff: torch.Tensor
    fi: torch.Tensor
    pm: torch.Tensor
    L0: int


class GroupCand(NamedTuple):
    """Candidate node rows of a slice of chunks (the lmac pre-filter):
    the rows of LmacTables.ff / .fi that some tile of the slice may take,
    sorted once by (node_begin, node index), which is the order the
    per-chunk sorts of build_shared_sources give; compaction keeps row
    order, so with a cand table those sorts are skipped. Padding rows are
    zero (mass 0: never taken)."""
    ff: torch.Tensor        # [GCAP, W]
    fi: torch.Tensor        # [GCAP, 4]
    begin: torch.Tensor     # [GCAP] int64 node_begin (0 on padding)
    end: torch.Tensor       # [GCAP] int64 node_end (0 on padding)
    overflow: torch.Tensor  # [] bool
    count: torch.Tensor     # [] int64


def make_tables(td: TreeData, cfg: TreeConfig) -> LmacTables:
    dtype = td.pos.dtype
    dev = td.pos.device
    M = td.node_level.shape[0]
    n, D = td.pos.shape
    L0 = _grid_l0(cfg, n)
    box = td.box_size
    lvl = td.node_level
    sh = torch.clamp(lvl - L0, min=0)
    cpack = torch.zeros(M, dtype=I64, device=dev)
    if L0 > 0:
        for d in range(D):
            cpack = cpack | ((td.node_cell[:, d] >> sh) << (d * L0))

    # the parent's cell-box centre in closed form from the node's own cell
    # coordinates (a child lies inside its parent's cell)
    plvl = torch.clamp(lvl - 1, min=0)
    pcs = box * torch.exp2(-plvl.to(dtype))
    pcenter = ((td.node_cell >> 1).to(dtype) + 0.5) * pcs[:, None] - box / 2
    is_root = torch.arange(M, device=dev) == 0
    pcenter = torch.where(is_root[:, None], td.node_center, pcenter)
    plvl_i = torch.where(is_root, -9, lvl - 1)

    zeros = torch.zeros(M, dtype=dtype, device=dev)
    if cfg.mac == MAC_BH_GEOM:
        delta = td.node_delta
        pdelta = torch.where(is_root, zeros, td.node_delta[td.node_parent])
    else:
        delta = pdelta = zeros
    cols = [td.node_com[:, d] for d in range(D)] + [td.node_mass]
    cols += [td.node_center[:, d] for d in range(D)] + [delta, pdelta]
    cols += [pcenter[:, d] for d in range(D)]
    if cfg.multipole_order >= 2:
        cols += list(td.node_quad.unbind(1))
    ff = torch.stack(cols, dim=1)
    fi = torch.stack([lvl, td.node_is_leaf.to(I64), plvl_i, cpack], dim=1)
    pz = torch.zeros(n, dtype=dtype, device=dev)
    pm = torch.stack([td.pos[:, d] for d in range(D)] + [pz] * (3 - D)
                     + [td.mass], dim=1)
    return LmacTables(ff=ff, fi=fi, pm=pm, L0=L0)


def _box_dist2_min(alo, ahi, blo, bhi):
    """Min squared distance between boxes: the arguments are D-tuples of
    broadcastable coordinate planes. Summed dimension by dimension, in
    order, so that no [..., D] temporary is made."""
    d2 = None
    for al, ah, bl, bh in zip(alo, ahi, blo, bhi):
        d = torch.clamp(torch.maximum(bl - ah, al - bh), min=0.0)
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def _box_dist2_max_pt(alo, ahi, blo, bhi):
    """max over a in A of dist(a, B)^2 (the every-tile-accepts test),
    arguments as in _box_dist2_min."""
    d2 = None
    for al, ah, bl, bh in zip(alo, ahi, blo, bhi):
        d = torch.clamp(torch.maximum(bl - al, ah - bh), min=0.0)
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def _clamp_theta(cfg: TreeConfig, theta, dtype, device, D: int):
    """theta as a 0-d tensor, with the bh_geom monotonicity clamp: the
    partition argument needs A(t, parent) => A(t, child), which with
    bh_geom's delta holds only for theta <= 2/sqrt(D). Clamped here, not
    at the API, so that no direct caller can run a non-monotone
    acceptance; the clamp only tightens the MAC."""
    theta = torch.full((), theta, dtype=dtype, device=device)
    if cfg.mac == MAC_BH_GEOM:
        theta = torch.minimum(theta, torch.full((), 2.0 / D ** 0.5,
                                                dtype=dtype, device=device))
    return theta


class _Rows(NamedTuple):
    """The predicate's operands of K candidate rows: per-dimension planes
    of the node's and the parent's cell box, both radii squared, and the
    integer columns."""
    vlo: tuple
    vhi: tuple
    plo: tuple
    phi: tuple
    rad2: torch.Tensor
    prad2: torch.Tensor
    mass: torch.Tensor
    lvl: torch.Tensor
    leaf: torch.Tensor
    plvl: torch.Tensor
    cpack: torch.Tensor


def _rows(ff, fi, D: int, box, theta_inv, bh_geom: bool) -> _Rows:
    dtype = ff.dtype
    lvl, plvl = fi[:, 0], fi[:, 2]
    e = box * torch.exp2(-lvl.to(dtype))
    pe = box * torch.exp2(-plvl.to(dtype))
    R = e * theta_inv
    pR = pe * theta_inv
    if bh_geom:
        R = R + ff[:, 2 * D + 1]
        pR = pR + ff[:, 2 * D + 2]
    ctr = ff[:, D + 1:2 * D + 1]
    pctr = ff[:, 2 * D + 3:3 * D + 3]
    return _Rows(
        vlo=tuple(ctr[:, d] - 0.5 * e for d in range(D)),
        vhi=tuple(ctr[:, d] + 0.5 * e for d in range(D)),
        plo=tuple(pctr[:, d] - 0.5 * pe for d in range(D)),
        phi=tuple(pctr[:, d] + 0.5 * pe for d in range(D)),
        rad2=R * R, prad2=pR * pR, mass=ff[:, D], lvl=lvl, leaf=fi[:, 1] > 0,
        plvl=plvl, cpack=fi[:, 3])


def _cell_sep(r: _Rows, D: int, L0: int, clo, chi):
    """Chebyshev separation, at each row's effective grid level, between
    the row's cell and the cell range [clo, chi] (D-tuples of planes that
    broadcast against the rows)."""
    sh_t = torch.clamp(L0 - r.lvl, min=0)
    fmask = (1 << L0) - 1
    sep = None
    for d in range(D):
        nc = (r.cpack >> (d * L0)) & fmask
        sd = torch.clamp(torch.maximum(nc - (chi[d] >> sh_t),
                                       (clo[d] >> sh_t) - nc), min=0)
        sep = sd if sep is None else torch.maximum(sep, sd)
    return sep


def _box_selection(r: _Rows, D, use_grid, L0, S_sep, lo, hi, clo, chi):
    """The relevance pass over node rows against one bounding box (lo, hi
    [D]; clo, chi [D] its cell range with a grid). Returns (m2p_sel,
    p2p_sel): supersets of "some target box inside it takes this row as
    M2P / P2P". Enlarging the box only enlarges both sets (dist_min
    shrinks, dist_max grows, cell separations shrink), which is what makes
    the slice-level pre-filter sound."""
    blo = tuple(lo[d] for d in range(D))
    bhi = tuple(hi[d] for d in range(D))
    # some target may open the parent: the box is within R_p of the
    # parent's cell box, or the parent can never be accepted (above L0)
    par_acc_all = _box_dist2_min(blo, bhi, r.plo, r.phi) > r.prad2
    if use_grid:
        par_acc_all = par_acc_all & (r.plvl >= L0)
    relevant = ~par_acc_all & (r.mass > 0)
    if use_grid:
        # the whole box covered by the stencil at v: v adds nothing
        sep = _cell_sep(r, D, L0, tuple(clo[d] for d in range(D)),
                        tuple(chi[d] for d in range(D)))
        relevant = relevant & (sep < S_sep)
    some_accepts = _box_dist2_max_pt(blo, bhi, r.vlo, r.vhi) > r.rad2
    some_opens = _box_dist2_min(blo, bhi, r.vlo, r.vhi) <= r.rad2
    if use_grid:
        some_accepts = some_accepts & (r.lvl >= L0)
        some_opens = some_opens | (r.lvl < L0)
    return relevant & some_accepts, relevant & r.leaf & some_opens


def build_group_candidates(td: TreeData, cfg: TreeConfig, theta,
                           box_lo, box_hi, tables: LmacTables,
                           tile_valid=None, tcell_lo=None, tcell_hi=None,
                           cap: int = None) -> GroupCand:
    """The relevance pre-filter for a group of tiles. box_lo/box_hi
    [G, D]: every tile box of the group (one slice of chunks);
    tile_valid [G]; tcell_lo/tcell_hi [G, D] with a grid far field. cap
    defaults to cfg.frontier_cap: lmac has no walk frontier, so that
    capacity, its overflow flag and its maxima slot carry the group
    table, and the overflow retry and tune_caps size it."""
    dtype = td.pos.dtype
    dev = td.pos.device
    D = box_lo.shape[1]
    n = td.pos.shape[0]
    theta_inv = 1.0 / _clamp_theta(cfg, theta, dtype, dev, D)
    M = tables.ff.shape[0]
    use_grid = cfg.farfield in ("grid", "grid2") and tables.L0 > 0
    L0 = tables.L0 if use_grid else 0
    if cap is None:
        cap = cfg.frontier_cap
    if tile_valid is None:
        tile_valid = torch.ones(box_lo.shape[0], dtype=torch.bool, device=dev)
    big = torch.finfo(dtype).max / 4
    tv = tile_valid[:, None]
    g_lo = torch.where(tv, box_lo, big).amin(0)
    g_hi = torch.where(tv, box_hi, -big).amax(0)
    g_clo = g_chi = None
    if use_grid:
        g_clo = torch.where(tv, tcell_lo, 1 << 30).amin(0)
        g_chi = torch.where(tv, tcell_hi, -1).amax(0)

    r = _rows(tables.ff, tables.fi, D, td.box_size, theta_inv,
              cfg.mac == MAC_BH_GEOM)
    m2p_sel, p2p_sel = _box_selection(r, D, use_grid, L0, _grid_sep(cfg),
                                      g_lo, g_hi, g_clo, g_chi)
    gidx, gcnt = su.compact_indices(m2p_sel | p2p_sel, cap)
    gvalid = gidx < M
    gidx_c = torch.clamp(gidx, max=M - 1)
    # one stable sort by node_begin of the ascending node indices: the
    # (begin, node index) order of the per-chunk sorts
    order = torch.sort(torch.where(gvalid, td.node_begin[gidx_c], n),
                       stable=True).indices
    gidx_c, gvalid = gidx_c[order], gvalid[order]
    gv = gvalid[:, None]
    return GroupCand(
        ff=torch.where(gv, tables.ff[gidx_c], 0.0),
        fi=torch.where(gv, tables.fi[gidx_c], 0),
        begin=torch.where(gvalid, td.node_begin[gidx_c], 0),
        end=torch.where(gvalid, td.node_end[gidx_c], 0),
        overflow=gcnt > cap, count=gcnt)


def build_shared_sources(td: TreeData, cfg: TreeConfig, theta,
                         box_lo, box_hi, tables: LmacTables = None,
                         tile_cell=None, tile_valid=None,
                         tcell_lo=None, tcell_hi=None,
                         cand: GroupCand = None) -> SharedSources:
    """One chunk's shared sources by the local-MAC predicate. The contract
    of traversal2.build_shared_sources. With `cand` (the slice's
    pre-filter from build_group_candidates) the predicate runs over the
    candidate rows instead of the whole node table: bit-identical results
    at O(frontier_cap) instead of O(node capacity) a chunk. lmac has no
    walk frontier: overflow[3] carries cand's own overflow, and maxima[2]
    stays 0 here (the engine writes cand.count there)."""
    C, D = box_lo.shape
    dtype = td.pos.dtype
    dev = td.pos.device
    n = td.pos.shape[0]
    theta_inv = 1.0 / _clamp_theta(cfg, theta, dtype, dev, D)
    if tables is None:
        tables = make_tables(td, cfg)
    if cand is not None:
        ff, fi = cand.ff, cand.fi
        node_begin, node_end = cand.begin, cand.end
        ovf_cand = cand.overflow
    else:
        ff, fi = tables.ff, tables.fi
        node_begin, node_end = td.node_begin, td.node_end
        ovf_cand = torch.zeros((), dtype=torch.bool, device=dev)
    M = ff.shape[0]
    use_grid = cfg.farfield in ("grid", "grid2") and tables.L0 > 0
    emit_cells = cfg.farfield == "grid2" and use_grid
    L0 = tables.L0 if use_grid else 0
    S_sep = _grid_sep(cfg)
    if tcell_lo is None:
        tcell_lo = tile_cell
    if tcell_hi is None:
        tcell_hi = tile_cell
    if tile_valid is None:
        tile_valid = torch.ones(C, dtype=torch.bool, device=dev)
    box = td.box_size

    # ---- exact per-tile membership panels over all candidate rows -------
    # Selection by the chunk's bounding box would size the rows by what no
    # tile uses (a chunk of scattered tiles wraps the whole core); the
    # [C, K] panels give the exact per-tile predicate before compaction,
    # rows are kept iff some tile takes them, and the per-tile masks are
    # sliced from the same panels.
    r = _rows(ff, fi, D, box, theta_inv, cfg.mac == MAC_BH_GEOM)
    tlo = tuple(box_lo[:, d:d + 1] for d in range(D))       # [C, 1] planes
    thi = tuple(box_hi[:, d:d + 1] for d in range(D))

    def row_planes(planes):
        return tuple(p[None, :] for p in planes)

    acc_v = _box_dist2_min(tlo, thi, row_planes(r.vlo),
                           row_planes(r.vhi)) > r.rad2[None, :]   # [C, K]
    acc_p = _box_dist2_min(tlo, thi, row_planes(r.plo),
                           row_planes(r.phi)) > r.prad2[None, :]
    if use_grid:
        acc_v = acc_v & (r.lvl >= L0)[None, :]
        acc_p = acc_p & (r.plvl >= L0)[None, :]
    live = tile_valid[:, None] & (r.mass > 0)[None, :]
    m2p_pan = acc_v & ~acc_p & live
    p2p_pan = ~acc_v & r.leaf[None, :] & live
    if use_grid:
        # per-tile stencil drop (separation >= S at the row's effective
        # grid level against the tile's cell range); sound for leaves
        # above L0 too: a separation only scales up under refinement
        keep = _cell_sep(r, D, L0,
                         tuple(tcell_lo[:, d:d + 1] for d in range(D)),
                         tuple(tcell_hi[:, d:d + 1] for d in range(D))
                         ) < S_sep
        m2p_pan = m2p_pan & keep
        p2p_pan = p2p_pan & keep

    sentinel = 4.0 * box
    ucap = cfg.m2p_cap

    def compact_sorted(sel, cap):
        """Compacted row ids of `sel` in (node_begin, row) order, their
        validity and the count. A cand table is sorted already."""
        idx, cnt = su.compact_indices(sel, cap)
        valid = idx < M
        ids = torch.clamp(idx, max=M - 1)
        if cand is None:
            order = torch.sort(torch.where(valid, node_begin[ids], n),
                               stable=True).indices
            ids, valid = ids[order], valid[order]
        return ids, valid, cnt

    # M2P rows, clustered by Morton position for the kernel's block lists
    un_ids, uvalid, ucnt = compact_sorted(m2p_pan.any(0), ucap)
    m_row = ff[un_ids]                                   # one row gather
    m_pos = torch.where(uvalid[:, None], m_row[:, :D], sentinel)
    m_mass = torch.where(uvalid, m_row[:, D], 0.0)
    m_idx = torch.full((ucap,), -1, dtype=I64, device=dev)
    m_mask = m2p_pan[:, un_ids] & uvalid[None, :]        # [C, ucap]
    m_cell = None
    if emit_cells:
        m_cpack = fi[un_ids, 3]
        fmask = (1 << L0) - 1
        m_cell = torch.stack([(m_cpack >> (d * L0)) & fmask
                              for d in range(D)], dim=1)
        m_cell = torch.where(uvalid[:, None], m_cell, -1)
    m_quad = None
    if cfg.multipole_order >= 2:
        m_quad = torch.where(uvalid[:, None], m_row[:, 3 * D + 3:], 0.0)

    # ---- P2P: leaves some tile opens, expanded to their particles -------
    pcap = cfg.p2p_src_cap
    lcap = cfg.p2p_leaf_cap
    lf_ids, lvalid, lcnt = compact_sorted(p2p_pan.any(0), lcap)
    leaf_mask = p2p_pan[:, lf_ids].T & lvalid[:, None]   # [lcap, C]
    lb = torch.where(lvalid, node_begin[lf_ids], 0)
    lc = torch.where(lvalid, node_end[lf_ids] - node_begin[lf_ids], 0)
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
    p_row = tables.pm[torch.clamp(pidx, 0, n - 1)]       # one row gather
    p_pos = torch.where(rvalid[:, None], p_row[:, :D], sentinel)
    p_mass = torch.where(rvalid, p_row[:, 3], 0.0)
    p_mask = leaf_mask[row_c] & (rvalid & (p_mass > 0))[:, None]
    pcell = None
    if use_grid:
        # per-particle coverage refinement for leaves above L0, against
        # the tile's cell range (the kernel closes the per-pair remainder
        # with grid2)
        pcell = particle_cells(p_pos, box, cfg.max_depth, L0)
        psep = torch.clamp(torch.maximum(
            pcell[:, None, :] - tcell_hi[None, :, :],
            tcell_lo[None, :, :] - pcell[:, None, :]), min=0).amax(-1)
        p_mask = p_mask & (psep < S_sep)

    zero = torch.zeros((), dtype=I64, device=dev)
    return SharedSources(
        pos=torch.cat([m_pos, p_pos], 0).to(dtype),
        mass=torch.cat([m_mass, p_mass], 0).to(dtype),
        idx=torch.cat([m_idx, pidx], 0),
        mask=torch.cat([m_mask, p_mask.T], 1).contiguous(),     # [C, S]
        count=torch.clamp(ucnt, max=ucap) + torch.clamp(total_p, max=pcap),
        overflow=torch.stack([ucnt > ucap, lcnt > lcap, total_p > pcap,
                              ovf_cand]),
        maxima=torch.stack([ucnt, ucnt + total_p, zero, lcnt]),
        quad=m_quad,
        cell=torch.cat([m_cell, pcell], 0) if emit_cells else None)
