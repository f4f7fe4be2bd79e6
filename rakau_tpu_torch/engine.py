"""Query engine: tree + per-call (theta, eps, G) -> accelerations and
potentials. Counterpart of `rakau_tpu.engine`, shared traversal only.

Target tiles are processed in chunks of `tile_chunk` (chunking bounds the
peak memory of the padded source rows): per chunk, the union walk
(traversal2) builds one shared source row with per-tile masks; accepted
nodes far from a tile go to its local Taylor expansion, together with
the dense grid far field handed down to the tile (farfield="grid"); the
rest goes through the pairwise kernel (kernels.dispatch). Results come
back in internal Morton order (the `_u` view).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import expansion
from . import grid as gridmod
from . import traversal2
from .build import TreeData
from .config import TreeConfig
from .kernels import dispatch


def check_supported(cfg: TreeConfig):
    """Raise NotImplementedError for modes outside the ported slice.

    Ported: the shared traversal with the "local", "m2p" and "grid" far
    fields, fp32 or compensated accumulation, and the quadrupole with
    "m2p". The quadrupole with "local"/"grid" (RAKAU_DIAG_MODES=1 only)
    runs on the reference's lists path, which is not ported."""
    if cfg.traversal_mode != "shared":
        raise NotImplementedError(
            f"traversal_mode={cfg.traversal_mode!r} is not ported "
            "(only 'shared')")
    if cfg.farfield == "grid2":
        raise NotImplementedError("farfield='grid2' is not ported")
    if cfg.multipole_order == 2 and cfg.farfield != "m2p":
        raise NotImplementedError(
            "multipole_order=2 is ported with farfield='m2p' only (the "
            "reference runs it on the unported lists path otherwise)")


def _gather_tiles(td: TreeData, cfg: TreeConfig):
    """Per-tile targets from the tile table, stacked by chunk:
    (pos [nc, CH, T, D], idx [nc, CH, T], AABB lo/hi [nc, CH, D],
    leaf-grid cell [nc, CH, D]).

    Padding targets get index N (never a source index; dropped at
    assembly). Empty tiles get an inverted AABB and are left out of the
    walk through tile_valid."""
    n, ndim = td.pos.shape
    T = cfg.ncrit
    TC = td.tile_begin.shape[0]
    CH = min(cfg.tile_chunk, TC)
    n_chunks = -(-TC // CH)
    pad = n_chunks * CH - TC
    big = torch.finfo(td.pos.dtype).max
    tb = F.pad(td.tile_begin, (0, pad))
    tc = F.pad(td.tile_cnt, (0, pad))
    ar = torch.arange(T, device=td.pos.device)
    idx = tb[:, None] + ar                      # [TCp, T]
    mask = ar < tc[:, None]
    tiles_pos = td.pos[torch.where(mask, idx, 0)]
    tiles_idx = torch.where(mask, idx, n)
    tlo = torch.where(mask[..., None], tiles_pos, big).amin(1)
    thi = torch.where(mask[..., None], tiles_pos, -big).amax(1)
    tcell = F.pad(td.tile_cell, (0, 0, 0, pad))
    shape = (n_chunks, CH)
    return (tiles_pos.reshape(shape + (T, ndim)),
            tiles_idx.reshape(shape + (T,)),
            tlo.reshape(shape + (ndim,)),
            thi.reshape(shape + (ndim,)),
            tcell.reshape(shape + (ndim,)))


def _chunk_sources(td: TreeData, cfg: TreeConfig, theta, eps, G,
                   tpos, tidx, blo, bhi, tables, tcell, Lgrid):
    """Walk + far field for one chunk of C tiles. Returns (src, mask,
    acc_l, pot_l): the shared sources, the per-tile kernel mask [C, S]
    and the local-expansion field at the targets (None with "m2p")."""
    n, ndim = td.pos.shape
    dtype = td.pos.dtype
    tvalid = tidx[:, 0] < n
    src = traversal2.build_shared_sources(
        td, cfg, theta, blo, bhi, tables=tables, tile_cell=tcell,
        tile_valid=tvalid)
    mask = src.mask
    acc_l = pot_l = None
    if cfg.farfield in ("local", "grid"):
        # Far/near gate on the M2P node rows (the first m2p_cap entries):
        # far nodes collapse into per-tile local expansions, near nodes
        # stay on the kernel path. Empty tiles have inverted AABBs ->
        # rad2 = inf -> everything routes near and their L is zero.
        U = cfg.m2p_cap
        order = cfg.local_order
        center = 0.5 * (blo + bhi)
        rad2 = ((0.5 * (bhi - blo)) ** 2).sum(-1)
        if cfg.local_gamma < 1e9:
            far, near = expansion.far_split(
                center, rad2, src.pos[:U], src.mass[:U], mask[:, :U],
                cfg.local_gamma)
            mask = torch.cat([near, mask[:, U:]], dim=1)
            L = expansion.m2l(center, src.pos[:U], src.mass[:U], far, eps,
                              order)
        else:
            # local_gamma >= 1e9 disables the gate: every accepted node
            # stays on the kernel path
            L = torch.zeros((center.shape[0], expansion.n_coeffs(ndim, order)),
                            dtype=dtype, device=center.device)
        if cfg.farfield == "grid" and Lgrid is not None:
            # inherit the dense stencil far field: the tile's leaf-grid
            # cell expansion recentred to the tile centre
            L0 = gridmod.effective_grid_level(cfg, n)
            Lg = Lgrid[gridmod.rowmajor_cell_index(tcell, ndim, L0)]
            s0 = td.box_size * 2.0 ** -L0
            ccenter = (tcell.to(dtype) + 0.5) * s0 - td.box_size / 2
            tv = tvalid[:, None]
            shift = torch.where(tv, center - ccenter, 0.0)
            L = L + torch.where(tv, expansion.l2l(Lg, shift, order), 0.0)
        acc_l, pot_l = expansion.l2p(L, center, tpos, G, order)
    return src, mask, acc_l, pot_l


def _eval_chunk(td: TreeData, cfg: TreeConfig, theta, eps, G,
                tpos, tidx, blo, bhi, tables, tcell, Lgrid, mode="both"):
    """Walk + far field + kernel for one chunk of C tiles. Returns
    (acc [C, T, D], pot [C, T], overflow [4], maxima [4])."""
    src, mask, acc_l, pot_l = _chunk_sources(
        td, cfg, theta, eps, G, tpos, tidx, blo, bhi, tables, tcell, Lgrid)
    acc, pot = dispatch.eval_shared(cfg, tpos, tidx, src.pos, src.mass,
                                    src.idx, mask, eps, G, mode=mode,
                                    src_quad=src.quad)
    if acc_l is not None:
        acc = acc + acc_l
        pot = pot + pot_l
    return acc, pot, src.overflow, src.maxima


def _grid_farfield(td, cfg, eps):
    """Dense stencil far field (grid.py) when enabled; else None."""
    if cfg.farfield != "grid":
        return None
    n, ndim = td.pos.shape
    L0 = gridmod.effective_grid_level(cfg, n)
    if L0 <= 0:
        return None
    pyr = gridmod.build_pyramid(td, ndim, cfg.max_depth, L0)
    return gridmod.dense_far_field(pyr, ndim, L0, td.box_size, eps,
                                   cfg.local_order)


def _assemble_impl(td, cfg, acc_tiles, pot_tiles):
    """Map per-tile results back to Morton particle order: particle i
    lives in the last tile whose begin is <= i, at offset i - begin."""
    n, ndim = td.pos.shape
    T = cfg.ncrit
    acc_flat = acc_tiles.reshape(-1, T, ndim)
    pot_flat = pot_tiles.reshape(-1, T)
    TCp = acc_flat.shape[0]
    TC = td.tile_begin.shape[0]
    dev = td.pos.device
    tb_padded = F.pad(td.tile_begin, (0, max(0, TCp - TC)), value=n)
    seq = torch.where(torch.arange(TCp, device=dev) < td.n_tiles,
                      tb_padded[:TCp], n)
    p = torch.arange(n, device=dev)
    t_of_p = torch.clamp(torch.searchsorted(seq, p + 1) - 1, 0, TCp - 1)
    off = p - tb_padded[torch.clamp(t_of_p, 0, TC - 1)]
    off = torch.clamp(off, 0, T - 1)
    return acc_flat[t_of_p, off], pot_flat[t_of_p, off]


# Derived per-tree query state (tiles gather + traversal tables + grid far
# field), reused across repeated queries on one tree. Entries pin device
# memory, so only the last two trees are kept.
_QUERY_STATE_CACHE: dict = {}


def _query_state(td, cfg, eps):
    # keyed and guarded on BOTH pos and mass identity: the tables embed
    # node mass/COM, so a tree sharing a position buffer with different
    # masses must miss
    key = (id(td.pos), id(td.mass), cfg, float(eps))
    hit = _QUERY_STATE_CACHE.get(key)
    # id() can be reused after GC; verify the cached tree is the caller's
    if hit is not None and hit[0] is td.pos and hit[1] is td.mass:
        return hit[2]
    state = (_gather_tiles(td, cfg), traversal2.make_tables(td, cfg),
             _grid_farfield(td, cfg, eps))
    while len(_QUERY_STATE_CACHE) >= 2:
        _QUERY_STATE_CACHE.pop(next(iter(_QUERY_STATE_CACHE)))
    _QUERY_STATE_CACHE[key] = (td.pos, td.mass, state)
    return state


def live_chunks(td: TreeData, cfg: TreeConfig) -> int:
    """Number of tile chunks a query evaluates (chunks holding real
    tiles; one host read of n_tiles)."""
    TC = td.tile_begin.shape[0]
    CH = min(cfg.tile_chunk, TC)
    return min(max(1, -(-int(td.n_tiles) // CH)), -(-TC // CH))


def kernel_inputs(td: TreeData, cfg: TreeConfig, theta, eps, chunk: int):
    """The pairwise kernel's arguments for chunk `chunk` of a query:
    (tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask, src_quad),
    exactly as acc_pot_u_host hands them to kernels.dispatch.eval_shared
    (src_quad [m2p_cap, Q] with multipole_order=2, else None)."""
    tiles, tables, Lgrid = _query_state(td, cfg, eps)
    tpos, tidx, blo, bhi, tcell = (t[chunk] for t in tiles)
    src, mask, _, _ = _chunk_sources(td, cfg, theta, eps, 1.0, tpos, tidx,
                                     blo, bhi, tables, tcell, Lgrid)
    return tpos, tidx, src.pos, src.mass, src.idx, mask, src.quad


def acc_pot_u_host(td: TreeData, cfg: TreeConfig, theta, eps, G=1.0,
                   mode: str = "both"):
    """Accelerations [N, D] and potentials [N] in Morton order, plus the
    overflow flags [4] and maxima [4] (aligned with config.OVF_FIELDS)
    of the query. A Python loop over the chunks that hold real tiles;
    theta, eps and G are Python numbers."""
    check_supported(cfg)
    tiles, tables, Lgrid = _query_state(td, cfg, eps)
    tpos, tidx, blo, bhi, tcell = tiles
    dev = td.pos.device
    ovf = torch.zeros(4, dtype=torch.bool, device=dev)
    mx = torch.zeros(4, dtype=torch.int64, device=dev)
    accs, pots = [], []
    for i in range(live_chunks(td, cfg)):
        a, p, o, m = _eval_chunk(td, cfg, theta, eps, G, tpos[i], tidx[i],
                                 blo[i], bhi[i], tables, tcell[i], Lgrid,
                                 mode=mode)
        accs.append(a)
        pots.append(p)
        ovf = ovf | o
        mx = torch.maximum(mx, m)
    acc_u, pot_u = _assemble_impl(td, cfg, torch.cat(accs), torch.cat(pots))
    return acc_u, pot_u, ovf, mx
