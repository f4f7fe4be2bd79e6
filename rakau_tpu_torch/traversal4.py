"""Global (tile, node) incidence walk and block-aligned source pool: the
front half of the gwalk engine. Counterpart of `rakau_tpu.traversal4`.

The shared engine walks the top of the tree again for every chunk of
tiles. This module walks once per query over a global frontier of
(tile, node) pairs:

  frontier_0 = {(t, root) : t valid}
  round:  expand each pair to the node's children, classify each
          (tile, child) with the COM MAC of traversal2 (and its grid
          coverage drops), emit accepted pairs to the M2P incidence list
          and opened leaves to the leaf incidence list, and keep opened
          internal nodes as the next frontier.

Work follows the real pair population, and the lists stay tile-major:
the root frontier is in tile order, expansion keeps pairs in place and
compaction is stable, so one stable sort by tile turns the round-major
emissions into per-tile segments. `build_pool` then lays each tile's
sources out as two contiguous, block-aligned segments of one flat pool:
its M2P node rows, then its opened leaves' particles. The pool kernel
(kernels/pool.py) streams each tile's segments with no mask.

Capacities (global meaning, the standard overflow contract): m2p_cap
bounds the M2P incidences, p2p_leaf_cap the leaf incidences,
frontier_cap (or the per-round caps of the unrolled walk) the frontier,
and p2p_src_cap the pool rows. Overflow is flagged, never truncated
silently.

The reference stores integer columns as float values in its row tables
(a TPU workaround for denormals); here they stay int64, and the cell
coordinates are not bit-packed. Buffers are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import scan_utils as su
from .build import TreeData
from .config import MAC_BH_GEOM, TreeConfig
from .traversal2 import _grid_l0, _grid_sep

I64 = torch.int64


class GlobalLists(NamedTuple):
    """Tile-sorted global incidence lists.

    m2p_tile/m2p_node [MCAP]: accepted (tile, node) pairs sorted by tile
    (padding: tile G, node -1); leaf_tile/leaf_node [LCAP]: opened
    (tile, leaf) pairs, likewise."""
    m2p_tile: torch.Tensor
    m2p_node: torch.Tensor
    m2p_cnt: torch.Tensor     # [] kept M2P incidences
    leaf_tile: torch.Tensor
    leaf_node: torch.Tensor
    leaf_cnt: torch.Tensor    # [] kept leaf incidences
    overflow: torch.Tensor    # [4] bool (m2p, leaf, False, frontier)
    maxima: torch.Tensor      # [4] (m2p, leaf, 0, peak frontier)
    round_counts: torch.Tensor  # [R + 1] open pairs after each round
                                # (config.fit_round_caps input)


def build_global_incidences(td: TreeData, cfg: TreeConfig, theta,
                            box_lo, box_hi, tile_valid=None,
                            tcell_lo=None, tcell_hi=None) -> GlobalLists:
    """One walk over all G tiles. box_lo/box_hi [G, D]: tile AABBs;
    tcell_lo/tcell_hi [G, D]: the tiles' leaf-grid cell ranges (needed by
    the grid far fields); tile_valid [G] leaves padding tiles out.

    With cfg.gwalk_round_caps None, the dynamic walk: every round runs at
    frontier_cap shape, all max_depth + 1 of them with no host sync (a
    round on an empty frontier emits nothing, so the lists, counts and
    peaks equal those of a walk that stops there). Otherwise the unrolled
    walk: round r runs at its own fitted cap, rounds past the caps are
    not run, and any round over its cap (or any pair still open after
    the last) flags frontier overflow."""
    G, D = box_lo.shape
    dtype = td.pos.dtype
    dev = td.pos.device
    n = td.pos.shape[0]
    theta_inv = 1.0 / torch.full((), theta, dtype=dtype, device=dev)
    use_grid = cfg.farfield in ("grid", "grid2")
    L0 = _grid_l0(cfg, n) if use_grid else 0
    use_grid = use_grid and L0 > 0
    S_sep = _grid_sep(cfg)
    if tile_valid is None:
        tile_valid = torch.ones(G, dtype=torch.bool, device=dev)
    if tcell_lo is None and use_grid:
        raise ValueError("grid far fields need tile cell ranges")

    FCAP = cfg.frontier_cap
    MCAP = cfg.m2p_cap
    LCAP = cfg.p2p_leaf_cap
    k8 = 2 ** D
    R = cfg.max_depth + 1
    ar8 = torch.arange(k8, device=dev)

    # per-node rows: com, mass, squared MAC threshold | level, leaf, cell
    # packed at min(level, L0) (D fields of L0 bits)
    size = td.box_size * torch.exp2(-td.node_level.to(dtype))
    thresh = size * theta_inv
    if cfg.mac == MAC_BH_GEOM:
        thresh = thresh + td.node_delta
    nf = torch.cat([td.node_com, td.node_mass[:, None],
                    (thresh * thresh)[:, None]], dim=1)
    cpack = torch.zeros_like(td.node_level)
    if use_grid:
        sh = torch.clamp(td.node_level - L0, min=0)
        for d in range(D):
            cpack = cpack | ((td.node_cell[:, d] >> sh) << (d * L0))
    ni = torch.stack([td.node_level, td.node_is_leaf.to(I64), cpack], 1)
    tf = torch.cat([box_lo, box_hi], dim=1)
    if use_grid:
        ti = torch.cat([tcell_lo, tcell_hi], dim=1).to(I64)
    child = torch.stack([td.node_child_begin, td.node_child_count], 1)

    def classify(tiles, nodes, pvalid):
        """[K] pairs -> (accept, open leaf, open internal) bools."""
        nid = torch.where(pvalid, nodes, 0)
        tid = torch.where(pvalid, tiles, 0)
        nrow = nf[nid]
        irow = ni[nid]
        trow = tf[tid]
        com = nrow[:, :D]
        d = torch.clamp(torch.maximum(trow[:, :D] - com, com - trow[:, D:]),
                        min=0.0)
        d2 = d[:, 0] * d[:, 0]
        for k in range(1, D):
            d2 = d2 + d[:, k] * d[:, k]
        acc = d2 > nrow[:, D + 1]
        lvl = irow[:, 0]
        leaf = irow[:, 1] > 0
        use = pvalid & (nrow[:, D] > 0)
        if use_grid:
            sh_t = torch.clamp(L0 - lvl, min=0)
            fmask = (1 << L0) - 1
            trc = ti[tid]
            sep = None
            for dd in range(D):
                nc = (irow[:, 2] >> (dd * L0)) & fmask
                tl = trc[:, dd] >> sh_t
                th = trc[:, D + dd] >> sh_t
                sd = torch.clamp(torch.maximum(nc - th, tl - nc), min=0)
                sep = sd if sep is None else torch.maximum(sep, sd)
            use = use & (sep < S_sep)                   # covered -> drop
            acc = acc & (lvl >= L0)
        accepted = acc & use
        opened = ~acc & use
        return accepted, opened & leaf, opened & ~leaf

    def emit(buf_t, buf_n, off, cap, sel, tiles, nodes):
        """Write the selected pairs at off, off+1, ... of (buf_t, buf_n)
        (entries past cap and unselected ones go to the dump slot cap).
        Returns the new offset (the true count, may exceed cap)."""
        csum = torch.cumsum(sel, 0)
        pos = torch.where(sel, off + csum - 1, cap).clamp_(max=cap)
        buf_t.scatter_(0, pos, tiles)
        buf_n.scatter_(0, pos, nodes)
        return off + csum[-1]

    def compact(opens, tiles_arr, nodes_arr, cap):
        """Open pairs -> a [cap] frontier, its kept count and the true
        count (may exceed cap; the caller flags it)."""
        K = opens.shape[0]
        idx, cnt = su.compact_indices(opens, cap)
        iv = idx < K
        ic = torch.clamp(idx, max=K - 1)
        ft = torch.where(iv, tiles_arr[ic], 0)
        fn = torch.where(iv, nodes_arr[ic], 0)
        return ft, fn, torch.clamp(cnt, max=cap), cnt

    mt = torch.full((MCAP + 1,), G, dtype=I64, device=dev)
    mn = torch.full((MCAP + 1,), -1, dtype=I64, device=dev)
    lt = torch.full((LCAP + 1,), G, dtype=I64, device=dev)
    ln = torch.full((LCAP + 1,), -1, dtype=I64, device=dev)
    zero = torch.zeros((), dtype=I64, device=dev)

    def expand_round(ft, fn, fc, in_cap, m_off, l_off):
        """Expand an [in_cap] frontier to its children, classify, emit."""
        fvalid = torch.arange(in_cap, device=dev) < fc
        crow = child[torch.where(fvalid, fn, 0)]
        kids = (crow[:, :1] + ar8).reshape(-1)
        ktile = ft[:, None].expand(in_cap, k8).reshape(-1)
        kval = ((ar8 < crow[:, 1:]) & fvalid[:, None]).reshape(-1)
        accs, leafs, opens = classify(ktile, kids, kval)
        m_off = emit(mt, mn, m_off, MCAP, accs, ktile, kids)
        l_off = emit(lt, ln, l_off, LCAP, leafs, ktile, kids)
        return opens, ktile, kids, m_off, l_off

    rcaps = cfg.gwalk_round_caps
    if rcaps is not None:
        # unrolled walk: round r at its fitted cap
        tiles0 = torch.arange(G, device=dev)
        nodes0 = torch.zeros(G, dtype=I64, device=dev)
        acc0, leaf0, open0 = classify(tiles0, nodes0, tile_valid)
        m_off = emit(mt, mn, zero, MCAP, acc0, tiles0, nodes0)
        l_off = emit(lt, ln, zero, LCAP, leaf0, tiles0, nodes0)
        K = min(len(rcaps), R - 1)
        ft, fn, fc, cnt = compact(open0, tiles0, nodes0,
                                  rcaps[0] if K else 1)
        counts = [cnt]
        f_ovf = cnt > (rcaps[0] if K else 0)
        f_peak = cnt
        for r in range(1, K + 1):
            opens, ktile, kids, m_off, l_off = expand_round(
                ft, fn, fc, rcaps[r - 1], m_off, l_off)
            ft, fn, fc, cnt = compact(opens, ktile, kids,
                                      rcaps[r] if r < K else 1)
            counts.append(cnt)
            f_peak = torch.maximum(f_peak, cnt)
            f_ovf = f_ovf | (cnt > (rcaps[r] if r < K else 0))
    else:
        # dynamic walk: round 0 holds (tile, root) for the first FCAP
        # tiles, in tile order
        ar = torch.arange(FCAP, device=dev)
        tiles0 = ar % max(G, 1)
        nodes0 = torch.zeros(FCAP, dtype=I64, device=dev)
        fvalid0 = (ar < G) & tile_valid[torch.clamp(ar, max=G - 1)]
        acc0, leaf0, open0 = classify(tiles0, nodes0, fvalid0)
        m_off = emit(mt, mn, zero, MCAP, acc0, tiles0, nodes0)
        l_off = emit(lt, ln, zero, LCAP, leaf0, tiles0, nodes0)
        ft, fn, fc, cnt = compact(open0, tiles0, nodes0, FCAP)
        counts = [cnt]
        # the peak includes the G-pair root frontier (flags G > FCAP)
        f_peak = torch.clamp(cnt, min=G)
        for _ in range(1, R):
            opens, ktile, kids, m_off, l_off = expand_round(
                ft, fn, fc, FCAP, m_off, l_off)
            ft, fn, fc, cnt = compact(opens, ktile, kids, FCAP)
            counts.append(cnt)
            f_peak = torch.maximum(f_peak, cnt)
        f_ovf = f_peak > FCAP
    round_counts = F.pad(torch.stack(counts), (0, R + 1 - len(counts)))

    # per-round emissions are tile-sorted, their concatenation is
    # round-major: one stable sort by tile makes the per-tile segments
    def by_tile(buf_t, buf_n, off, cap):
        key = torch.where(torch.arange(cap + 1, device=dev) < off, buf_t,
                          G)[:cap]
        key_s, order = torch.sort(key, stable=True)
        return key_s, torch.where(key_s < G, buf_n[:cap][order], -1)

    m_tile, m_node = by_tile(mt, mn, m_off, MCAP)
    l_tile, l_node = by_tile(lt, ln, l_off, LCAP)
    return GlobalLists(
        m2p_tile=m_tile, m2p_node=m_node,
        m2p_cnt=torch.clamp(m_off, max=MCAP),
        leaf_tile=l_tile, leaf_node=l_node,
        leaf_cnt=torch.clamp(l_off, max=LCAP),
        overflow=torch.stack([m_off > MCAP, l_off > LCAP,
                              torch.zeros((), dtype=torch.bool, device=dev),
                              f_ovf]),
        maxima=torch.stack([m_off, l_off, zero, f_peak]),
        round_counts=round_counts)


class GlobalPool(NamedTuple):
    """Block-aligned per-tile source pool, the pool kernel's input.

    Every tile owns two contiguous block-aligned segments of the flat
    pool: its M2P node rows, then its expanded P2P particle rows.
    Padding rows carry mass 0, idx -1 and the 4 * box_size sentinel
    position, so a kernel that streams whole blocks adds exactly nothing
    for them.

    pos [P, D] / mass [P] / idx [P]: the source planes (idx -1 for node
    and padding rows). quad [P, Q] (multipole_order=2): the node rows'
    raw second moments, zero elsewhere; else None.
    m2p_blk/m2p_nblk [G]: first block and block count of each tile's
    node segment; p2p_blk/p2p_nblk [G] likewise for its particle
    segment. p2p_cnt []: expanded particle rows. overflow []: pool
    capacity or window exceeded. total_rows []: blocks used * block."""
    pos: torch.Tensor
    mass: torch.Tensor
    idx: torch.Tensor
    m2p_blk: torch.Tensor
    m2p_nblk: torch.Tensor
    p2p_blk: torch.Tensor
    p2p_nblk: torch.Tensor
    p2p_cnt: torch.Tensor
    overflow: torch.Tensor
    total_rows: torch.Tensor
    quad: torch.Tensor = None


def build_pool(td: TreeData, gl: GlobalLists, G: int, block: int,
               pool_cap: int, sentinel=None, window_blocks: int = 0,
               pcell=None, tcell_lo=None, tcell_hi=None, sep: int = 0,
               quad_dim: int = 0, group: int = 1,
               row_chunk: int = 4 * 1048576) -> GlobalPool:
    """Lay out the pool of pool_cap rows from the tile-sorted lists.

    window_blocks > 0: pack the segments so that no group of `group`
    consecutive tiles straddles a boundary of window_blocks blocks (the
    reference's kernel keeps one window resident per group). Packing is
    scan-free: the plain offsets are cut into virtual windows of wb -
    wb // 4 blocks, virtual window v placed at v * wb; a group wider than
    wb // 4 blocks flags overflow (a wider window is the fix).

    pcell [N, D] + tcell_lo/tcell_hi [G, D] + sep > 0 (farfield="grid"):
    particle rows whose leaf-grid Chebyshev separation from their tile's
    cell range is >= sep are dropped (the dense far field covers them).

    quad_dim > 0: node rows carry td.node_quad in pool.quad.

    The leaf expansion runs over the pool in chunks of row_chunk rows,
    which bounds its temporaries; the result does not depend on it."""
    dtype = td.pos.dtype
    dev = td.pos.device
    n, D = td.pos.shape
    if sentinel is None:
        sentinel = 4.0 * td.box_size
    if isinstance(sentinel, torch.Tensor):
        sentinel = sentinel.to(device=dev, dtype=dtype)
    else:   # filled in on the device: no host-to-device copy of a number
        sentinel = torch.full((), sentinel, dtype=dtype, device=dev)
    MCAP = gl.m2p_tile.shape[0]
    LCAP = gl.leaf_tile.shape[0]
    fences = torch.arange(G + 1, device=dev)

    # ---- per-tile counts from the fences of the tile-sorted lists ----
    mb = torch.searchsorted(gl.m2p_tile, fences)          # [G + 1]
    m_cnt = mb[1:] - mb[:-1]
    lnode = torch.clamp(gl.leaf_node, min=0)
    lsz = torch.where(gl.leaf_node >= 0,
                      td.node_end[lnode] - td.node_begin[lnode], 0)
    lb = torch.searchsorted(gl.leaf_tile, fences)         # [G + 1]
    lcum = F.pad(torch.cumsum(lsz, 0), (1, 0))            # [LCAP + 1]
    p_cnt = lcum[lb[1:]] - lcum[lb[:-1]]

    # ---- block-aligned segment offsets ----
    m_nblk = -(-m_cnt // block)
    p_nblk = -(-p_cnt // block)
    tile_blocks = m_nblk + p_nblk
    win_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    if window_blocks:
        wb = window_blocks
        tbmax = max(1, wb // 4)
        wbp = wb - tbmax
        gp = max(1, int(group))
        NGp = -(-G // gp)
        tb_g = F.pad(tile_blocks, (0, NGp * gp - G)).reshape(NGp, gp)
        within = torch.cumsum(tb_g, 1) - tb_g
        gb = tb_g.sum(1)                                  # group blocks
        win_ovf = (gb > tbmax).any()
        off = torch.cumsum(gb, 0) - gb                    # exclusive
        v = off // wbp
        g_start = v * wb + (off - v * wbp)
        m2p_blk = (g_start[:, None] + within).reshape(-1)[:G]
        end = g_start[-1] + gb[-1] if G > 0 else torch.zeros(
            (), dtype=I64, device=dev)
    else:
        blk_off = F.pad(torch.cumsum(tile_blocks, 0), (1, 0))
        m2p_blk = blk_off[:-1]
        end = blk_off[-1]
    p2p_blk = m2p_blk + m_nblk
    total_rows = end * block
    overflow = (total_rows > pool_cap) | win_ovf

    # ---- M2P node rows: incidence i of tile t at m2p_blk[t]*block+rank ----
    m_t = torch.clamp(gl.m2p_tile, 0, G - 1)
    ranks = torch.arange(MCAP, device=dev) - mb[m_t]
    valid_m = gl.m2p_node >= 0
    pos_m = torch.where(valid_m, m2p_blk[m_t] * block + ranks, pool_cap)
    pos_m = torch.clamp(pos_m, max=pool_cap)              # dump row
    nid = torch.clamp(gl.m2p_node, min=0)
    pool_pos = sentinel.expand(pool_cap + 1, D).clone()
    pool_mass = torch.zeros(pool_cap + 1, dtype=dtype, device=dev)
    pool_idx = torch.full((pool_cap + 1,), -1, dtype=I64, device=dev)
    pool_pos[pos_m] = torch.where(valid_m[:, None], td.node_com[nid],
                                  sentinel)
    pool_mass[pos_m] = torch.where(valid_m, td.node_mass[nid], 0.0)
    pool_quad = None
    if quad_dim:
        pool_quad = torch.zeros((pool_cap + 1, quad_dim), dtype=dtype,
                                device=dev)
        pool_quad[pos_m] = torch.where(valid_m[:, None], td.node_quad[nid],
                                       0.0)
        pool_quad = pool_quad[:pool_cap]
    pool_pos = pool_pos[:pool_cap]
    pool_mass = pool_mass[:pool_cap]
    pool_idx = pool_idx[:pool_cap]

    # ---- leaf incidences expanded to particle rows ----
    # leaf incidence j of tile t starts at p2p_blk[t]*block + (lcum[j] -
    # lcum[first leaf of t]) and holds the particles node_begin..node_end
    l_t = torch.clamp(gl.leaf_tile, 0, G - 1)
    l_start = p2p_blk[l_t] * block + (lcum[:-1] - lcum[lb[l_t]])
    nb_leaf = td.node_begin[lnode]
    use_cov = bool(sep) and pcell is not None
    # each row finds its leaf incidence: mark every leaf's start row with
    # its ordinal + 1, then a running max carries it down the leaf
    marks = torch.zeros(pool_cap + 1, dtype=I64, device=dev)
    lpos = torch.where((gl.leaf_node >= 0) & (lsz > 0),
                       torch.clamp(l_start, max=pool_cap), pool_cap)
    marks.scatter_reduce_(0, lpos, torch.arange(1, LCAP + 1, device=dev),
                          reduce="amax")
    lead = torch.cummax(marks[:pool_cap], 0).values
    RC = min(pool_cap, max(int(row_chunk), 1))
    for s0 in range(0, pool_cap, RC):
        s1 = min(s0 + RC, pool_cap)
        lead_c = lead[s0:s1]
        j = torch.clamp(lead_c - 1, min=0)
        within = torch.arange(s0, s1, device=dev) - l_start[j]
        inleaf = (lead_c > 0) & (within >= 0) & (within < lsz[j])
        pidx = torch.where(inleaf, nb_leaf[j] + within, -1)
        pidx_c = torch.clamp(pidx, 0, n - 1)
        if use_cov:
            # the particle's cell separation from its tile's cell range
            pc = pcell[pidx_c]
            tl = tcell_lo[l_t[j]]
            th = tcell_hi[l_t[j]]
            cov = torch.clamp(torch.maximum(pc - th, tl - pc), min=0)
            inleaf = inleaf & (cov.amax(1) < sep)
        pool_pos[s0:s1] = torch.where(inleaf[:, None], td.pos[pidx_c],
                                      pool_pos[s0:s1])
        pool_mass[s0:s1] = torch.where(inleaf, td.mass[pidx_c],
                                       pool_mass[s0:s1])
        pool_idx[s0:s1] = torch.where(inleaf, pidx, pool_idx[s0:s1])

    return GlobalPool(pos=pool_pos, mass=pool_mass, idx=pool_idx,
                      m2p_blk=m2p_blk, m2p_nblk=m_nblk,
                      p2p_blk=p2p_blk, p2p_nblk=p_nblk, p2p_cnt=lcum[-1],
                      overflow=overflow | (lcum[-1] > pool_cap),
                      total_rows=total_rows, quad=pool_quad)
