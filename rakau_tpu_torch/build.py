"""Tree construction from sorted Morton codes. Counterpart of
`rakau_tpu.build`.

The tree follows from the common-prefix-length (LCP) structure of the
sorted codes (Cornerstone lineage):

  1. one stable sort of the int64 codes; positions, masses and cells are
     gathered by the permutation, and the inverse permutation is a
     scatter;
  2. cpl[i] = LCP level of neighbours (i-1, i); one pass of running
     scans per level gives each particle its leaf level (deepest
     ancestor that still splits) and tile-group level;
  3. every node is (level, head particle): particle i heads the levels
     (cpl[i], leaf_level[i]], so the node table is a cumsum, a binary
     search and one sort into level-major order (children contiguous);
  4. node mass/COM come from float64 prefix sums read at node bounds.

Static capacities (node_cap, tile_cap) keep shapes fixed; exceeding
them sets `overflow`, never truncates silently.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import morton, particles
from . import scan_utils as su
from .config import TreeConfig

I64 = torch.int64
# level-major node key: level in the high word, head particle below
_KEY_SHIFT = 32
_KEY_INVALID = 1 << 62


class TreeData(NamedTuple):
    """Flat tree + Morton-ordered particle store.

    Particle arrays are in internal Morton order (the `_u` view);
    `perm[i]` is the original index of Morton slot i, `inv_perm` its
    inverse. Nodes are level-major (slot 0 = root); each node's children
    occupy contiguous slots. Index arrays are int64.
    """
    # particles (Morton order)
    pos: torch.Tensor          # [N, D]
    mass: torch.Tensor         # [N]
    code: torch.Tensor         # [N] int64 Morton code
    perm: torch.Tensor         # [N]
    inv_perm: torch.Tensor     # [N]
    # flat nodes
    node_com: torch.Tensor     # [M, D]
    node_mass: torch.Tensor    # [M]
    node_begin: torch.Tensor   # [M] particle range start
    node_end: torch.Tensor     # [M] particle range end (exclusive)
    node_child_begin: torch.Tensor  # [M] first child slot
    node_child_count: torch.Tensor  # [M]
    node_is_leaf: torch.Tensor      # [M] bool
    node_level: torch.Tensor        # [M]
    node_delta: torch.Tensor        # [M] dist(COM, cell geometric center)
    node_quad: torch.Tensor         # [M, Q] quadrupole moments about COM
    node_center: torch.Tensor       # [M, D] geometric cell center
    node_parent: torch.Tensor       # [M] parent slot (root -> 0)
    node_cell: torch.Tensor         # [M, D] cell coords at own level
    n_nodes: torch.Tensor           # [] total nodes used
    overflow: torch.Tensor          # [] bool node or tile capacity exceeded
    box_size: torch.Tensor          # [] dtype
    # target tiles: ncrit-wide Morton slices within each deepest >ncrit
    # node; with farfield="grid" (and gwalk with "grid2") also clipped at
    # leaf-grid cell boundaries, so every tile lies in exactly one grid
    # cell
    tile_begin: torch.Tensor        # [TC] first particle
    tile_cnt: torch.Tensor          # [TC] particle count (0 = padding)
    tile_cell: torch.Tensor         # [TC, D] leaf-grid cell coords
    n_tiles: torch.Tensor           # []


def _quad_dim(ndim: int) -> int:
    return ndim * (ndim + 1) // 2


def sort_by_code(code: torch.Tensor, *arrays):
    """Stable sort by code (ties keep the original order, as the
    reference's sort of (hi, lo, iota) does), carrying `arrays`.
    Returns (sorted codes, perm, sorted arrays)."""
    code_s, perm = torch.sort(code, stable=True)
    return code_s, perm, tuple(a[perm] for a in arrays)


def _tile_grid_level(cfg: TreeConfig, n: int) -> int:
    if cfg.farfield == "grid":
        from .grid import effective_grid_level
        return effective_grid_level(cfg, n)
    if cfg.farfield == "grid2" and cfg.traversal_mode == "gwalk":
        # gwalk has no per-pair coverage test in its kernel; single-cell
        # tiles make the pool's per-row drop exact per pair, so its
        # tiles are clipped as with farfield="grid"
        from .grid2 import effective_grid_level
        return effective_grid_level(cfg, n)
    return 0


def build_tree(pos: torch.Tensor, mass: torch.Tensor, cfg: TreeConfig,
               box_size=None) -> TreeData:
    """Construct the tree on pos.device: no host read and, with box_size
    None, a tensor or a number (filled in on the device), no
    host-to-device copy, so that a CUDA graph can capture it whole
    (engine.build_tree)."""
    dev = pos.device
    box_size = (particles.auto_box_size(pos) if box_size is None
                else particles.scalar_tensor(box_size, pos))
    n, ndim = pos.shape
    depth = cfg.max_depth
    B = cfg.code_bits
    dtype = pos.dtype

    # ---- 1. encode + sort ---------------------------------------------
    cells = particles.discretize(pos, box_size, depth)
    code = morton.encode(cells, ndim, depth)
    code_s, perm, (pos_s, mass_s, cells_s) = sort_by_code(
        code, pos, mass, cells)
    pidx = torch.arange(n, device=dev)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = pidx

    # ---- 2. LCP structure ---------------------------------------------
    eqbits = su.clz64(code_s[1:] ^ code_s[:-1]) - (64 - B)
    cpl = torch.cat([torch.zeros(1, dtype=I64, device=dev),
                     torch.clamp(eqbits // ndim, max=depth)])
    tail = torch.full((1,), n, dtype=I64, device=dev)

    def level_bounds(lvl: int):
        """Per particle: end of its level-`lvl` cell (R) and the cell's
        particle count."""
        is_head = (pidx == 0) | (cpl < lvl)
        left = torch.cummax(torch.where(is_head, pidx, -1), 0).values
        nxt = torch.cat([torch.where(is_head, pidx, n)[1:], tail])
        right = torch.cummin(nxt.flip(0), 0).values.flip(0)
        return right, right - left

    s_leaf = torch.full((n,), -1, dtype=I64, device=dev)
    s_grp = s_leaf.clone()
    rights = []
    for lvl in range(depth + 1):
        right, cnt = level_bounds(lvl)
        rights.append(right)
        if lvl < depth:
            s_leaf = torch.where(cnt > cfg.max_leaf_n, lvl, s_leaf)
        s_grp = torch.where(cnt > cfg.ncrit, lvl, s_grp)
    lam = torch.clamp(s_leaf + 1, 0, depth)    # leaf level per particle
    glvl = torch.clamp(s_grp, min=0)            # tile-group level

    # ---- 3. node table --------------------------------------------------
    nc = torch.clamp(lam - cpl, min=0)
    cum_nc = torch.cumsum(nc, 0)
    m1 = cum_nc[-1]
    M = cfg.node_capacity(n)
    overflow = (m1 + 1) > M

    k = torch.arange(M - 1, device=dev)
    p_c = torch.clamp(su.searchsorted_1d(cum_nc, k + 1), 0, n - 1)
    valid_k = k < m1
    prev_cum = torch.where(p_c > 0, cum_nc[torch.clamp(p_c - 1, min=0)], 0)
    l_k = cpl[p_c] + 1 + (k - prev_cum)
    key = torch.where(valid_k, (l_k << _KEY_SHIFT) | p_c, _KEY_INVALID)
    skey = torch.sort(key).values
    svalid = skey != _KEY_INVALID
    low_mask = (1 << _KEY_SHIFT) - 1
    zero1 = torch.zeros(1, dtype=I64, device=dev)
    node_key = torch.cat([zero1, skey])
    node_level = torch.cat([zero1, torch.where(svalid, skey >> _KEY_SHIFT, 0)])
    node_begin = torch.cat([zero1, torch.where(svalid, skey & low_mask, 0)])
    node_valid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            svalid])
    n_nodes = m1 + 1

    # ---- 4. per-node counts from the per-level cell ends ---------------
    bc = torch.clamp(node_begin, 0, n - 1)
    node_cnt = torch.zeros(M, dtype=I64, device=dev)
    for lvl, right in enumerate(rights):
        inb = node_valid & (node_level == lvl)
        node_cnt = torch.where(inb, right[bc] - node_begin, node_cnt)
    node_end = node_begin + node_cnt

    # leaf flag: node level equals its head particle's leaf level
    node_is_leaf = torch.where(node_valid, node_level >= lam[bc], True)

    # ---- 5. children: binary search in the level-major key order -------
    lvl1 = torch.clamp(node_level + 1, 0, 31) << _KEY_SHIFT
    cb = su.searchsorted_1d(node_key, lvl1 | node_begin)
    ce = su.searchsorted_1d(node_key, lvl1 | node_end)
    internal = node_valid & ~node_is_leaf
    node_child_begin = torch.where(internal, cb, 0)
    node_child_count = torch.where(internal, ce - cb, 0)

    # ---- 6. mass/COM (+ quad) from float64 prefix sums -----------------
    m64 = mass_s.to(torch.float64)
    p64 = pos_s.to(torch.float64)
    mcols = [m64] + [m64 * p64[:, d] for d in range(ndim)]
    if cfg.multipole_order >= 2:
        for a in range(ndim):
            for b2 in range(a, ndim):
                mcols.append(m64 * p64[:, a] * p64[:, b2])
    msegs = su.segment_sum_from_prefix(
        su.prefix_sums(torch.stack(mcols, 1)), node_begin, node_end)
    msum = msegs[:, 0]
    node_mass = torch.where(node_valid, msum, 0.0).to(dtype)
    safe_m = torch.where(msum != 0, msum, 1.0)
    com64 = msegs[:, 1:1 + ndim] / safe_m[:, None]
    node_com = com64.to(dtype)
    if cfg.multipole_order >= 2:
        comps = []
        ci = 1 + ndim
        for a in range(ndim):
            for b2 in range(a, ndim):
                # parallel-axis shift about the COM: S_ab - M c_a c_b
                comps.append(msegs[:, ci] - msum * com64[:, a] * com64[:, b2])
                ci += 1
        node_quad = torch.where(node_valid[:, None],
                                torch.stack(comps, 1), 0.0).to(dtype)
    else:
        node_quad = torch.zeros((M, _quad_dim(ndim)), dtype=dtype,
                                device=dev)

    # ---- 7. cell centers, bh_geom delta, parents ------------------------
    head_cells = cells_s[bc]
    centers = particles.cell_center(head_cells, box_size, depth, node_level)
    dvec = node_com - centers
    node_delta = torch.where(node_valid, torch.sqrt((dvec * dvec).sum(-1)),
                             0.0).to(dtype)
    node_center = torch.where(node_valid[:, None], centers, 0.0).to(dtype)

    # parent: child ranges are disjoint and their starts grow with the
    # parent slot, so the last range start at or before a slot names its
    # parent candidate
    slots = torch.arange(M, device=dev)
    start = torch.full((M + 1,), -1, dtype=I64, device=dev)
    has_kids = node_child_count > 0
    start.scatter_(0, torch.where(has_kids, node_child_begin, M), slots)
    cand = torch.cummax(start[:M], 0).values
    cand_c = torch.clamp(cand, min=0)
    par_ok = ((cand >= 0) & (slots >= node_child_begin[cand_c])
              & (slots < node_child_begin[cand_c] + node_child_count[cand_c])
              & node_valid)
    node_parent = torch.where(par_ok, cand_c, 0)

    # ---- 8. tile table ------------------------------------------------
    glvl_prev = torch.cat([zero1, glvl[:-1]])
    head_g = (pidx == 0) | (glvl != glvl_prev) | (cpl < glvl)
    L0 = _tile_grid_level(cfg, n)
    if L0 > 0:
        # clip tile runs at leaf-grid cell boundaries (exact per-tile
        # stencil-coverage drops, grid.py)
        head_g = head_g | (cpl < L0)
    seg_begin = torch.cummax(torch.where(head_g, pidx, 0), 0).values
    head_t = head_g | ((pidx - seg_begin) % cfg.ncrit == 0)
    cum_t = torch.cumsum(head_t, 0)
    n_tiles = cum_t[-1]
    TC = cfg.tile_capacity(n)
    overflow = overflow | (n_tiles > TC)
    tq = torch.arange(1, TC + 1, device=dev)
    tile_begin = su.searchsorted_1d(cum_t, tq)          # == n if none
    tnext = torch.cat([tile_begin[1:], tail])
    tvalid = tq <= n_tiles
    tile_begin = torch.where(tvalid, tile_begin, 0)
    tile_cnt = torch.where(tvalid, torch.clamp(tnext, max=n) - tile_begin, 0)
    tile_cell = torch.where(tvalid[:, None],
                            cells_s[tile_begin] >> (depth - L0), 0)

    # per-node cell coords at the node's own level
    shift_node = torch.clamp(depth - node_level, 0, 31)
    node_cell = torch.where(node_valid[:, None],
                            head_cells >> shift_node[:, None], 0)

    return TreeData(
        pos=pos_s, mass=mass_s, code=code_s, perm=perm, inv_perm=inv_perm,
        node_com=node_com, node_mass=node_mass,
        node_begin=torch.where(node_valid, node_begin, 0),
        node_end=torch.where(node_valid, node_end, 0),
        node_child_begin=node_child_begin,
        node_child_count=node_child_count,
        node_is_leaf=node_is_leaf, node_level=node_level,
        node_delta=node_delta, node_quad=node_quad,
        node_center=node_center, node_parent=node_parent,
        node_cell=node_cell,
        n_nodes=n_nodes, overflow=overflow, box_size=box_size,
        tile_begin=tile_begin, tile_cnt=tile_cnt, tile_cell=tile_cell,
        n_tiles=n_tiles)
