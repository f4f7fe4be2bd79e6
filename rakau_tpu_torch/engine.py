"""Query engine: tree + per-call (theta, eps, G) -> accelerations and
potentials. Counterpart of `rakau_tpu.engine`: the shared, lmac, gwalk
and lists traversals.

Shared and lmac: target tiles are processed in chunks of `tile_chunk`
(chunking bounds the peak memory of the padded source rows): per chunk,
the union walk (traversal2) or the walk-free local-MAC predicate
(traversal3) builds one shared source row with per-tile masks; accepted
nodes far from a tile go to its local Taylor expansion, together with the
dense grid far field handed down to the tile (farfield="grid"); the rest
goes through the pairwise kernel (kernels.dispatch). lmac runs the chunks
in slices: each slice first filters the node table against its bounding
box (traversal3.build_group_candidates), and its chunks run their
predicate over that candidate table.

gwalk: one global (tile, node) walk and one block-aligned source pool
for all tiles (traversal4), one launch of the pool kernel, and with
farfield="grid" the dense far field handed down to every tile.

lists (the reference's diagnostic mode, RAKAU_DIAG_MODES=1; also the
route of the quadrupole with the "local" and "grid" far fields, see
_use_shared): per chunk, per-tile interaction lists (traversal.py), their
sources gathered into dense rows, and the per-tile list kernel
(kernels.dispatch.eval_tiles). Its far field is the M2P rows alone: the
tile expansions and the grid far field are not built there.

farfield="grid2" (shared, lmac, gwalk): the conv-M2L far field of grid2.py,
evaluated per particle and added once per query; the near field is
closed per pair, in the shared path by the kernel's cell-separation test
(tiles span several leaf-grid cells), in gwalk by cell-clipped tiles and
the pool's per-row drop. The normalized leaf locals depend on the tree
and eps only and are kept with the query state; the L2P runs per query.

Imported sources (`extra=(pos, mass)`, the LET imports of
parallel/let.py) join every valid tile's row in the shared and lmac
queries, through the far/near gate of the tile expansions with "local"
and "grid". The chunk loop (run_chunks) runs any range of chunks: the
single-device query all live ones, each shard of parallel/sharded.py
its own.

On the card each of the reference's executables is a CUDA graph
(graphs.py), captured at its first call and replayed after: one for each
slice of chunks (`_slice_impl`, the counterpart of `_slice_query_jit`),
one for the gwalk walk, pool and launch (`_gwalk_query`, `_gwalk_jit`
with `_far_jit`), one for the assembly and grid2's far field
(`_tail_impl`, `_assemble_jit` with `_far_jit`), and `acc_pot_u` whole as
one; `build_tree` replays the tree build (the reference's `_build_jit`),
integrate.py's whole-call twins put builds and `_query_impl` in one
graph, and parallel/'s whole twins their builds with `_chunk_loop` over
each shard's chunks or with `_query_impl(extra=)` (the LET). The
per-tree state and the query's one host read (`live_chunks`) stay
outside every graph of `acc_pot_u_host`. `graph=None` takes graphs
on CUDA tensors and runs eagerly on CPU tensors; `graph=False` runs
eagerly on the card too (the A/B and the per-layer timing), `graph=True`
on CPU tensors raises.

Results come back in internal Morton order (the `_u` view).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build as _build
from . import expansion
from . import grid as gridmod
from . import graphs, grid2, traversal, traversal2, traversal3, traversal4
from . import particles as _particles
from .build import TreeData, _quad_dim
from .config import OVF_FIELDS, TreeConfig, fit_caps, fit_round_caps
from .kernels import dispatch, pool, shared, tiles

# The captured pieces of queries (graphs.py; graphs.SIZE of them, each
# pinning a copy of its tree). clear_graphs() releases them.
_GRAPHS = graphs.GraphCache(
    counters=(shared.launches, pool.launches, tiles.launches))


def clear_graphs():
    """Drop every captured query graph and hand the memory they held (their
    static copies of trees and tables, and the shared pool) back to the
    card."""
    _GRAPHS.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _use_graph(graph, t, cfg: TreeConfig) -> bool:
    """Whether a query on tensor t replays CUDA graphs. `graph` None
    takes them on CUDA tensors with the hand-written kernels, and runs
    eagerly on CPU tensors and under kernel_backend="xla" (the plain
    versions bound their loops by host reads, which a capture refuses);
    True where there is none raises ValueError."""
    possible = t.is_cuda and cfg.kernel_backend != "xla"
    if graph is None:
        return possible
    if graph and not possible:
        raise ValueError("graph=True needs CUDA tensors and the kernels: "
                         "the CPU has no CUDA graphs, and "
                         "kernel_backend='xla' runs the plain versions, "
                         "which read the host (use graph=None or False)")
    return bool(graph)


def _run(graph: bool, fn, *args, **kw):
    """fn(*args, **kw), replayed from its CUDA graph when `graph`; the
    key adds the global switches a capture reads (dispatch.capture_key)."""
    if not graph:
        return fn(*args, **kw)
    return _GRAPHS(fn, *args, key=dispatch.capture_key(), **kw)


def scalars(like, theta, eps, G) -> tuple:
    """(theta, eps, scal) from theta, eps and G, numbers or tensors: theta
    and eps as 0-dim tensors of like's dtype on its device (the
    counterpart of the reference's `jnp.asarray(x, dt)`), and the kernels'
    buffer scal = [eps^2, G, eps^2, 1] (kernels.shared.scalar_buffer),
    made here once a call: the far fields take eps, the kernels and the
    plain versions scal, and G is scal[1]. A graph takes them as inputs,
    not in its key, so a call with a new theta, eps or G replays the graph
    that the first call captured. A number is filled in on the device, as
    dt is (particles.scalar_tensor). The functions below that take
    (theta, eps, scal) take what this returns."""
    theta, eps = (_particles.scalar_tensor(x, like) for x in (theta, eps))
    return theta, eps, shared.scalar_buffer(eps, G, like)


def build_tree(pos, mass, cfg: TreeConfig, box_size=None,
               graph=None) -> TreeData:
    """build.build_tree, on CUDA tensors replayed from its CUDA graph (the
    counterpart of the reference's `_build_jit`): one graph per cfg, box
    size (a number is part of the key, a tensor an input) and shapes.
    graph as in acc_pot_u_host. The caller reads td.overflow."""
    return _run(_use_graph(graph, pos, cfg), _build.build_tree, pos, mass,
                cfg, box_size)


def _use_shared(cfg: TreeConfig) -> bool:
    """The query runs on shared source rows: the "shared" union walk or
    the "lmac" local MAC, both of which give SharedSources. The
    quadrupole rides them with the "m2p" and "grid2" far fields (the M2P
    node rows carry their second moments into the kernel); with "local"
    and "grid" the tile expansions are monopole-sourced, so it goes to the
    per-tile lists instead, as in the reference."""
    if cfg.traversal_mode not in ("shared", "lmac"):
        return False
    return cfg.multipole_order < 2 or cfg.farfield in ("m2p", "grid2")


def _traversal_mod(cfg: TreeConfig):
    return traversal3 if cfg.traversal_mode == "lmac" else traversal2


def _gather_tiles(td: TreeData, cfg: TreeConfig):
    """Per-tile targets from the tile table, stacked by chunk:
    (pos [nc, CH, T, D], idx [nc, CH, T], AABB lo/hi [nc, CH, D],
    leaf-grid cell [nc, CH, D]).

    Padding targets get index N (never a source index; dropped at
    assembly). Empty tiles get an inverted AABB and are left out of the
    walk through tile_valid.

    With the shared traversal and farfield="grid2" three more arrays
    follow: the targets' leaf-grid cells [nc, CH, T, D] (the kernel's
    per-pair coverage operand) and each tile's cell range lo/hi
    [nc, CH, D] (the walk's drop test): tiles are not clipped at cell
    boundaries there. gwalk's tiles are, so tile_cell carries its test."""
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
    out = (tiles_pos.reshape(shape + (T, ndim)),
           tiles_idx.reshape(shape + (T,)),
           tlo.reshape(shape + (ndim,)),
           thi.reshape(shape + (ndim,)),
           tcell.reshape(shape + (ndim,)))
    if cfg.farfield == "grid2" and cfg.traversal_mode != "gwalk":
        L0 = grid2.effective_grid_level(cfg, n)
        if _use_shared(cfg) and dispatch._kernel(cfg, td.pos):
            # the kernels' packed cell test bounds the leaf-grid level
            shared.check_cell_level(L0, ndim)
        tpc = grid2.particle_cells(td.pos, td.box_size, cfg.max_depth,
                                   L0)[torch.where(mask, idx, 0)]
        clo = torch.where(mask[..., None], tpc, 1 << 30).amin(1)
        chi = torch.where(mask[..., None], tpc, -1).amax(1)
        out += (tpc.reshape(shape + (T, ndim)),
                clo.reshape(shape + (ndim,)),
                chi.reshape(shape + (ndim,)))
    return out


def _chunk_tiles(tiles, chunk: int):
    """Chunk `chunk` of the gathered tiles: the five base arrays and the
    grid2 extras (tgt_cell, tcell_lo, tcell_hi), or None without them."""
    sl = tuple(t[chunk] for t in tiles)
    return sl[:5], (sl[5:] if len(sl) > 5 else None)


def _chunk_sources(td: TreeData, cfg: TreeConfig, theta, eps, scal,
                   tpos, tidx, blo, bhi, tables, tcell, Lgrid, tcells=None,
                   cand=None, extra=None):
    """Traversal + far field for one chunk of C tiles. Returns (src, mask,
    acc_l, pot_l): the shared sources, the per-tile kernel mask [C, S]
    and the local-expansion field at the targets (None with "m2p" and
    "grid2"). tcells (grid2): the chunk's (tgt_cell, tcell_lo,
    tcell_hi); the drop test then takes the tile's cell range. cand
    (lmac): the candidate table of the chunk's slice.

    extra: (pos [E, D], mass [E]) sources applied to every valid tile,
    the LET imports (parallel/let.py), as the reference's `_eval_chunk`
    takes them: with "local" and "grid" they pass the same far/near gate
    as the walk's nodes (far ones into the tile's expansion); the near
    ones (all of them with "m2p" and "grid2") are appended to the row
    with idx -1, with "grid2" at cell -1 (exempt from the coverage test:
    the local pyramid holds no remote mass). src then carries the
    appended rows."""
    n, ndim = td.pos.shape
    dtype = td.pos.dtype
    tvalid = tidx[:, 0] < n
    ckw = dict(tile_cell=tcell)
    if tcells is not None:
        ckw = dict(tcell_lo=tcells[1], tcell_hi=tcells[2])
    if cand is not None:
        ckw["cand"] = cand
    src = _traversal_mod(cfg).build_shared_sources(
        td, cfg, theta, blo, bhi, tables=tables, tile_valid=tvalid, **ckw)
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
        if extra is not None:
            far_e, near_e = expansion.far_split(
                center, rad2, extra[0], extra[1], _every_tile(tvalid, extra),
                cfg.local_gamma)
            L = L + expansion.m2l(center, extra[0], extra[1], far_e, eps,
                                  order)
        acc_l, pot_l = expansion.l2p(L, center, tpos, scal[1], order)
    elif extra is not None:
        near_e = _every_tile(tvalid, extra)
    if extra is not None:
        e_pos, e_mass = extra
        E = e_pos.shape[0]
        cell = src.cell
        if cell is not None:
            cell = torch.cat([cell, cell.new_full((E, cell.shape[1]), -1)])
        src = src._replace(
            pos=torch.cat([src.pos, e_pos]),
            mass=torch.cat([src.mass, e_mass]),
            idx=torch.cat([src.idx, src.idx.new_full((E,), -1)]),
            cell=cell)
        mask = torch.cat([mask, near_e], dim=1)
    return src, mask, acc_l, pot_l


def _every_tile(tvalid, extra):
    """[C, E]: every import row for every valid tile."""
    return tvalid[:, None].expand(tvalid.shape[0], extra[0].shape[0])


def _gather_sources(td: TreeData, cfg: TreeConfig,
                    il: traversal.InteractionLists):
    """Interaction lists -> the tiles' dense padded rows: (m_pos [C, Sm, D],
    m_mass, m_quad [C, Sm, Q] with multipole_order=2 else None, p_pos
    [C, Sp, D], p_mass, p_idx). M2P entries are node COMs and masses (and
    second moments), P2P entries particles with their Morton indices;
    padding sits at the 4 * box_size sentinel with mass 0 and index -1,
    and adds nothing."""
    sentinel = 4.0 * td.box_size
    mvalid = il.m2p_nodes >= 0
    mns = torch.where(mvalid, il.m2p_nodes, 0)
    m_pos = torch.where(mvalid[..., None], td.node_com[mns], sentinel)
    m_mass = torch.where(mvalid, td.node_mass[mns], 0.0)
    m_quad = None
    if cfg.multipole_order >= 2:
        m_quad = torch.where(mvalid[..., None], td.node_quad[mns], 0.0)
    pvalid = il.p2p_src >= 0
    pns = torch.where(pvalid, il.p2p_src, 0)
    p_pos = torch.where(pvalid[..., None], td.pos[pns], sentinel)
    p_mass = torch.where(pvalid, td.mass[pns], 0.0)
    p_idx = torch.where(pvalid, il.p2p_src, -1)
    return m_pos, m_mass, m_quad, p_pos, p_mass, p_idx


def _tile_sources(td: TreeData, cfg: TreeConfig, theta, blo, bhi):
    """The lists traversal of one chunk and its gathered rows: (lists,
    the dispatch.eval_tiles source arguments)."""
    il = traversal.build_interaction_lists(td, cfg, theta, blo, bhi)
    return il, _gather_sources(td, cfg, il)


def _eval_chunk(td: TreeData, cfg: TreeConfig, theta, eps, scal,
                tpos, tidx, blo, bhi, tables, tcell, Lgrid, mode="both",
                tcells=None, cand=None, extra=None):
    """Traversal + far field + kernel for one chunk of C tiles. Returns
    (acc [C, T, D], pot [C, T], overflow [4], maxima [4]). The grid2 far
    field is not added here: it is per particle, once per query. The
    lists path computes both outputs whatever the mode, as the
    reference's. extra: the imported sources of _chunk_sources."""
    if not _use_shared(cfg):
        if extra is not None:
            # the reference's lists branch never reads `extra` and returns
            # forces without the imports; refuse instead
            raise ValueError("imported sources (extra=) ride the shared "
                             "and lmac engines; the lists path would "
                             "drop them")
        il, rows = _tile_sources(td, cfg, theta, blo, bhi)
        acc, pot = dispatch.eval_tiles(cfg, tpos, tidx, *rows, scal,
                                       m2p_cnt=il.m2p_count,
                                       p2p_cnt=il.p2p_count)
        return acc, pot, il.overflow, il.maxima
    src, mask, acc_l, pot_l = _chunk_sources(
        td, cfg, theta, eps, scal, tpos, tidx, blo, bhi, tables, tcell, Lgrid,
        tcells, cand, extra)
    acc, pot = dispatch.eval_shared(
        cfg, tpos, tidx, src.pos, src.mass, src.idx, mask, scal,
        mode=mode, src_quad=src.quad, src_cell=src.cell,
        tgt_cell=None if tcells is None else tcells[0])
    if acc_l is not None:
        acc = acc + acc_l
        pot = pot + pot_l
    return acc, pot, src.overflow, src.maxima


def _grid_farfield(td, cfg, eps):
    """Dense stencil far field (grid.py) when enabled; else None. With
    "grid2": what grid2.leaf_locals returns (the normalized leaf locals
    and the particles' leaf cells), for _add_grid2. The lists path and
    the quadrupole read no grid far field (rakau_tpu/engine.py:488-493),
    so none is built for them."""
    if cfg.farfield == "grid2":
        return grid2.leaf_locals(td, cfg, eps)
    if (cfg.farfield != "grid" or cfg.traversal_mode == "lists"
            or cfg.multipole_order >= 2):
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


def _add_grid2(td, cfg, eps, scal, Lgrid, acc_u, pot_u):
    """Add grid2's per-particle far field (L2P of the kept leaf locals)
    to a query's Morton-order sums, whatever its mode, as the reference
    does."""
    if cfg.farfield != "grid2":
        return acc_u, pot_u
    acc_f, pot_f = grid2.far_field(td, cfg, eps, scal[1], locals_=Lgrid)
    return acc_u + acc_f, pot_u + pot_f


# Derived per-tree query state (tiles gather + traversal tables + grid far
# field), reused across repeated queries on one tree. Entries pin device
# memory, so only the last two trees are kept.
_QUERY_STATE_CACHE: dict = {}


def _query_state(td, cfg, eps):
    # keyed and guarded on BOTH pos and mass identity: the tables embed
    # node mass/COM, so a tree sharing a position buffer with different
    # masses must miss; the far field depends on eps, whose value the key
    # takes (a host read where the caller hands in a tensor: the public
    # entries pass the number they were given)
    key = (id(td.pos), id(td.mass), cfg, float(eps))
    hit = _QUERY_STATE_CACHE.get(key)
    # id() can be reused after GC; verify the cached tree is the caller's
    if hit is not None and hit[0] is td.pos and hit[1] is td.mass:
        return hit[2]
    tables = (_traversal_mod(cfg).make_tables(td, cfg)
              if _use_shared(cfg) else None)
    state = (_gather_tiles(td, cfg), tables, _grid_farfield(td, cfg, eps))
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


def _slices(n_live: int, tile_chunk: int, slice_chunks=None):
    """The slices of a query's live chunks, as (first new chunk, first
    chunk, chunks) each: `slice_chunks` chunks a slice (default about
    1024 tiles, at least 32 chunks), the last one moved back to end at
    n_live, so that every slice has the same number of chunks; its chunks
    before `first new chunk` belong to the slice before."""
    if slice_chunks is None:
        slice_chunks = max(32, 1024 // max(tile_chunk, 1))
    K = min(slice_chunks, n_live)
    return [(s, min(s, n_live - K), K) for s in range(0, n_live, K)]


def _slice_cand(td: TreeData, cfg: TreeConfig, theta, panels, tables):
    """The lmac candidate table of a slice, from its tile panels (each
    array of the gathered tiles cut to the slice's chunks): one relevance
    pass and compaction over the whole node table against the slice's
    bounding box, so that each chunk's predicate runs over frontier_cap
    candidate rows instead of every node."""
    n, ndim = td.pos.shape
    flat = [t.reshape((-1,) + t.shape[2:]) for t in panels]
    # grid2: each tile's cell range; "grid": cell-clipped tiles, one cell
    clo, chi = (flat[6], flat[7]) if len(flat) > 5 else (flat[4], flat[4])
    return traversal3.build_group_candidates(
        td, cfg, theta, flat[2], flat[3], tables,
        tile_valid=flat[1][:, 0] < n, tcell_lo=clo, tcell_hi=chi)


def kernel_inputs(td: TreeData, cfg: TreeConfig, theta, eps, chunk: int):
    """The pairwise kernel's arguments for chunk `chunk` of a query:
    (tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask, src_quad,
    src_cell, tgt_cell), exactly as acc_pot_u_host hands them to
    kernels.dispatch.eval_shared (src_quad [m2p_cap, Q] with
    multipole_order=2, src_cell [S, D] and tgt_cell [C, T, D] with
    farfield="grid2", else None)."""
    tiles, tables, Lgrid = _query_state(td, cfg, eps)
    (tpos, tidx, blo, bhi, tcell), tcells = _chunk_tiles(tiles, chunk)
    cand = None
    if cfg.traversal_mode == "lmac":
        _, start, K = [sl for sl in _slices(live_chunks(td, cfg),
                                            cfg.tile_chunk)
                       if sl[0] <= chunk][-1]
        cand = _slice_cand(td, cfg, theta,
                           tuple(t[start:start + K] for t in tiles), tables)
    src, mask, _, _ = _chunk_sources(
        td, cfg, theta, eps, shared.scalar_buffer(eps, 1.0, td.pos), tpos,
        tidx, blo, bhi, tables, tcell, Lgrid, tcells, cand)
    return (tpos, tidx, src.pos, src.mass, src.idx, mask, src.quad,
            src.cell, None if tcells is None else tcells[0])


def tile_kernel_inputs(td: TreeData, cfg: TreeConfig, theta, eps,
                       chunk: int):
    """The per-tile list kernel's arguments for chunk `chunk` of a lists
    query: (tgt_pos, tgt_idx, m2p_pos, m2p_mass, m2p_quad, p2p_pos,
    p2p_mass, p2p_idx, m2p_cnt, p2p_cnt), exactly as acc_pot_u_host hands
    them to kernels.dispatch.eval_tiles (m2p_quad [C, Sm, Q] with
    multipole_order=2, else None)."""
    if _use_shared(cfg):
        raise ValueError("tile_kernel_inputs takes a query on the lists "
                         "path")
    tiles, _, _ = _query_state(td, cfg, eps)
    (tpos, tidx, blo, bhi, _), _ = _chunk_tiles(tiles, chunk)
    il, rows = _tile_sources(td, cfg, theta, blo, bhi)
    return (tpos, tidx) + rows + (il.m2p_count, il.p2p_count)


def _gwalk_sources(td: TreeData, cfg: TreeConfig, theta, tiles):
    """The gwalk walk and pool for all tiles. Returns the flat tiles
    (tpos [G, T, D], tidx [G, T], lo, hi, cell [G, D], valid [G]), the
    GlobalLists, the GlobalPool and the kernel's schedule sched [G, 4]
    (window, start block in it, node blocks, particle blocks)."""
    n, ndim = td.pos.shape
    flat = tuple(t.reshape((-1,) + t.shape[2:]) for t in tiles)
    tpos, tidx, blo, bhi, tcell = flat
    tvalid = tidx[:, 0] < n
    G0 = tpos.shape[0]
    use_grid = cfg.farfield in ("grid", "grid2")
    kw = dict(tcell_lo=tcell, tcell_hi=tcell) if use_grid else {}
    gl = traversal4.build_global_incidences(td, cfg, theta, blo, bhi,
                                            tile_valid=tvalid, **kw)
    block = cfg.pool_block
    W = cfg.pool_window
    Wb = W // block
    # a whole number of windows, as the reference sizes it
    pool_cap = -(-cfg.p2p_src_cap // W) * W
    pkw = {}
    L0 = traversal2._grid_l0(cfg, n) if use_grid else 0
    if L0 > 0:
        pkw = dict(pcell=grid2.particle_cells(td.pos, td.box_size,
                                              cfg.max_depth, L0),
                   tcell_lo=tcell, tcell_hi=tcell,
                   sep=traversal2._grid_sep(cfg))
    qd = _quad_dim(ndim) if cfg.multipole_order >= 2 else 0
    pool = traversal4.build_pool(td, gl, G0, block, pool_cap,
                                 window_blocks=Wb, quad_dim=qd,
                                 group=cfg.pool_group, **pkw)
    # overflow-safe clamps: an overflowed pool is flagged and the query
    # retried; the clamped schedule keeps the kernel's reads in the pool
    NW = pool_cap // W
    win = torch.clamp(pool.m2p_blk // Wb, 0, NW - 1)
    start = torch.clamp(pool.m2p_blk - win * Wb, 0, Wb - 1)
    m_nb = torch.minimum(torch.clamp(pool.m2p_nblk, min=0),
                         torch.clamp(Wb - start, min=0))
    p_nb = torch.minimum(torch.clamp(pool.p2p_nblk, min=0),
                         torch.clamp(Wb - start - m_nb, min=0))
    sched = torch.stack([win, start, m_nb, p_nb], dim=1)
    return flat + (tvalid,), gl, pool, sched


def _gwalk_farfield(td: TreeData, cfg: TreeConfig, G, flat, Lgrid, acc,
                    pot, mode):
    """Add the dense grid far field, handed down to every valid tile
    (L2L from its leaf-grid cell, then L2P), to the tiles' kernel sums."""
    n, ndim = td.pos.shape
    tpos, _, blo, bhi, tcell, tvalid = flat
    order = cfg.local_order
    L0 = gridmod.effective_grid_level(cfg, n)
    Lg = Lgrid[gridmod.rowmajor_cell_index(tcell, ndim, L0)]
    s0 = td.box_size * 2.0 ** -L0
    ccenter = (tcell.to(td.pos.dtype) + 0.5) * s0 - td.box_size / 2
    center = 0.5 * (blo + bhi)
    tv = tvalid[:, None]
    shift = torch.where(tv, center - ccenter, 0.0)
    L = torch.where(tv, expansion.l2l(Lg, shift, order), 0.0)
    acc_l, pot_l = expansion.l2p(L, center, tpos, G, order)
    if mode in ("both", "acc"):
        acc = acc + torch.where(tv[..., None], acc_l, 0.0)
    if mode in ("both", "pot"):
        pot = pot + torch.where(tv, pot_l, 0.0)
    return acc, pot


def _gwalk_impl(td: TreeData, cfg: TreeConfig, theta, eps, scal, tiles,
                Lgrid, mode: str = "both"):
    """gwalk query: one global walk, one pool, one kernel launch; with
    farfield="grid" the dense far field on top (no local_gamma gate: every
    accepted node goes through the kernel). With "grid2" the tiles are
    cell-clipped at its level, so the walk's drop and the pool's per-row
    drop at cfg.grid_sep are exact per pair; its far field is added by
    the caller (acc_pot_u_host). Returns (acc_u, pot_u,
    overflow [4], maxima [4], round_counts); the flags and maxima are in
    the standard cap order, maxima (m2p incidences, pool rows, frontier
    peak, leaf incidences)."""
    flat, gl, pool, sched = _gwalk_sources(td, cfg, theta, tiles)
    acc, pot = dispatch.eval_pool(
        cfg, flat[0], flat[1], pool.pos, pool.mass, pool.idx, sched,
        cfg.pool_window, cfg.pool_block, scal, mode=mode,
        pool_quad=pool.quad)
    if Lgrid is not None and cfg.farfield == "grid":
        acc, pot = _gwalk_farfield(td, cfg, scal[1], flat, Lgrid, acc, pot,
                                   mode)
    acc_u, pot_u = _assemble_impl(td, cfg, acc, pot)
    ovf = torch.stack([gl.overflow[0], gl.overflow[1], pool.overflow,
                       gl.overflow[3]])
    mx = torch.stack([gl.maxima[0], pool.total_rows, gl.maxima[3],
                      gl.maxima[1]])
    return acc_u, pot_u, ovf, mx, gl.round_counts


def pool_inputs(td: TreeData, cfg: TreeConfig, theta, eps):
    """The pool kernel's arguments in a gwalk query: (tgt_pos, tgt_idx,
    pool_pos, pool_mass, pool_idx, sched, pool_quad), exactly as
    acc_pot_u_host hands them to kernels.dispatch.eval_pool (pool_quad
    None for the monopole)."""
    tiles, _, _ = _query_state(td, cfg, eps)
    flat, _, pool, sched = _gwalk_sources(td, cfg, theta, tiles)
    return (flat[0], flat[1], pool.pos, pool.mass, pool.idx, sched,
            pool.quad)


def tune_gwalk(td: TreeData, cfg: TreeConfig, theta, eps, G=1.0,
               max_retries: int = 6) -> TreeConfig:
    """Fit the gwalk global caps and the per-round frontier caps from a
    dynamic-walk query (repeated with grown caps while one overflows).
    Returns the fitted config, gwalk_round_caps set: later queries run the
    unrolled walk at the measured frontier sizes. theta, eps and G are
    numbers or 0-dim tensors; the sizing reads only the query's flags and
    maxima."""
    cfg_dyn = cfg.with_(gwalk_round_caps=None)
    theta_t, eps_t, scal = scalars(td.pos, theta, eps, G)
    for _ in range(max_retries):
        tiles, _, Lgrid = _query_state(td, cfg_dyn, eps)
        _, _, ovf, mx, rcnt = _gwalk_impl(td, cfg_dyn, theta_t, eps_t, scal,
                                          tiles, Lgrid)
        flags = ovf.cpu().tolist()
        mx = mx.cpu().tolist()
        if not any(flags):
            break
        if flags[2] and mx[1] <= cfg_dyn.p2p_src_cap:
            # the pool flag with the rows under their cap: a group of
            # tiles straddled a window, and a wider window is the fix
            cfg_dyn = cfg_dyn.with_(pool_window=2 * cfg_dyn.pool_window)
            flags[2] = False
        cfg_dyn = cfg_dyn.with_(**{f: 2 * getattr(cfg_dyn, f)
                                   for f, hit in zip(OVF_FIELDS, flags)
                                   if hit})
    fitted = fit_caps(cfg_dyn, mx)
    return fitted.with_(gwalk_round_caps=fit_round_caps(rcnt.cpu()))


def _chunk_loop(td: TreeData, cfg: TreeConfig, theta, eps, scal, panels,
                tables, Lgrid, mode: str = "both", extra=None, cand=None):
    """Every chunk of the tile panels (arrays [K, CH, ...]) in order.
    Returns acc [K * CH, T, D], pot, the overflow flags [4] OR-ed and the
    maxima [4] max-ed over the chunks."""
    dev = td.pos.device
    ovf = torch.zeros(4, dtype=torch.bool, device=dev)
    mx = torch.zeros(4, dtype=torch.int64, device=dev)
    accs, pots = [], []
    for i in range(panels[0].shape[0]):
        base, tcells = _chunk_tiles(panels, i)
        a, p, o, m = _eval_chunk(td, cfg, theta, eps, scal, *base[:4], tables,
                                 base[4], Lgrid, mode=mode, tcells=tcells,
                                 cand=cand, extra=extra)
        accs.append(a)
        pots.append(p)
        ovf = ovf | o
        mx = torch.maximum(mx, m)
    return torch.cat(accs), torch.cat(pots), ovf, mx


def _slice_impl(td: TreeData, cfg: TreeConfig, theta, eps, scal, panels,
                tables, Lgrid, mode: str = "both", extra=None):
    """One slice of a query, the counterpart of the reference's
    `_slice_query_jit`: lmac's candidate table built from the slice's
    tile panels (whose overflow and row count ride the frontier slots,
    flag 3 and maximum 2), then every chunk of the panels. Returns what
    _chunk_loop returns."""
    cand = None
    if cfg.traversal_mode == "lmac" and _use_shared(cfg):
        cand = _slice_cand(td, cfg, theta, panels, tables)
    acc, pot, ovf, mx = _chunk_loop(td, cfg, theta, eps, scal, panels, tables,
                                    Lgrid, mode, extra, cand)
    if cand is not None:
        ovf[3] |= cand.overflow
        mx[2] = torch.maximum(mx[2], cand.count)
    return acc, pot, ovf, mx


def _tail_impl(td: TreeData, cfg: TreeConfig, eps, scal, Lgrid, acc_tiles,
               pot_tiles):
    """Assembly of the tiles' sums into Morton order, then grid2's
    per-particle far field (Lgrid: its leaf locals, None otherwise): the
    counterpart of `_assemble_jit` and `_far_jit`."""
    acc_u, pot_u = _assemble_impl(td, cfg, acc_tiles, pot_tiles)
    return _add_grid2(td, cfg, eps, scal, Lgrid, acc_u, pot_u)


def _gwalk_query(td: TreeData, cfg: TreeConfig, theta, eps, scal, tiles,
                 Lgrid, mode: str = "both"):
    """A gwalk query whole (walk, pool, K2, far fields, assembly): the
    counterpart of `_gwalk_jit` and `_far_jit`. Returns (acc_u, pot_u,
    overflow [4], maxima [4])."""
    acc_u, pot_u, ovf, mx = _gwalk_impl(td, cfg, theta, eps, scal, tiles,
                                        Lgrid, mode=mode)[:4]
    acc_u, pot_u = _add_grid2(td, cfg, eps, scal, Lgrid, acc_u, pot_u)
    return acc_u, pot_u, ovf, mx


def evaluated_chunks(n_chunks: int, tile_chunk: int,
                     slice_chunks: int = None) -> int:
    """Chunk evaluations of a chunk loop over n_chunks chunks (run_chunks'
    range): every slice evaluates its K chunks, the last one moved back
    included, so a query launches its kernel this many times."""
    return sum(K for _, _, K in _slices(n_chunks, tile_chunk, slice_chunks))


def run_chunks(td: TreeData, cfg: TreeConfig, theta, eps, scal, state,
               first: int, last: int, slice_chunks: int = None,
               mode: str = "both", extra=None, graph=None,
               rows: int = None):
    """The shared, lmac or lists chunk loop over chunks [first, last) of a
    query whose per-tree state (_query_state: tiles, tables, far field) is
    `state`, in slices of `slice_chunks` (_slices, over this range): each
    slice is one _slice_impl over its K chunks, on the card one CUDA graph
    replay (graph=None: on CUDA tensors; False: eagerly). The last slice,
    moved back to end at `last`, evaluates all its K chunks and drops the
    rows before its first new chunk, as the reference does: those chunks
    are evaluated twice with the same sums, and OR and max over them
    change no flag. The sums do not depend on the slicing; lmac's
    candidate table, whose overflow and row count ride the frontier slots
    (flag 3, maximum 2), follows it. Returns the tiles' acc [(last -
    first) * CH, T, D] and pot (with `rows`, that many rows: the rest
    zeros), the overflow flags [4] and the maxima [4]. The single-device
    query runs every live chunk through it, each shard of
    parallel.sharded its own range. theta, eps and scal, as scalars
    returns them, enter each slice's graph as inputs. Each slice's rows go into the
    result as it comes, so that the slices' outputs are not held beside
    it (2 GB of tile sums at 64M particles)."""
    graph = _use_graph(graph, td.pos, cfg)
    tiles, tables, Lgrid = state
    CH = tiles[0].shape[1]
    if rows is None:
        rows = (last - first) * CH
    if cfg.farfield != "grid":
        Lgrid = None        # read by the chunks with "grid" only
    ovf = mx = acc = pot = None
    for s, start, K in _slices(last - first, cfg.tile_chunk, slice_chunks):
        a, p, o, m = _run(graph, _slice_impl, td, cfg, theta, eps, scal,
                          tuple(t[first + start:first + start + K]
                                for t in tiles), tables,
                          Lgrid, mode=mode, extra=extra)
        if acc is None:
            acc = a.new_zeros((rows,) + a.shape[1:])
            pot = p.new_zeros((rows,) + p.shape[1:])
        acc[s * CH:(start + K) * CH] = a[(s - start) * CH:]
        pot[s * CH:(start + K) * CH] = p[(s - start) * CH:]
        del a, p
        ovf = o if ovf is None else ovf | o
        mx = m if mx is None else torch.maximum(mx, m)
    return acc, pot, ovf, mx


def acc_pot_u_host(td: TreeData, cfg: TreeConfig, theta, eps, G=1.0,
                   slice_chunks: int = None, mode: str = "both",
                   extra=None, graph=None):
    """Accelerations [N, D] and potentials [N] in Morton order, plus the
    overflow flags [4], in the order of config.OVF_FIELDS (m2p,
    p2p_leaf, p2p_src, frontier), and the maxima [4], in the order that
    config.fit_caps reads (m2p, p2p_src, frontier, p2p_leaf), of the
    query. Shared, lmac and lists: run_chunks over the chunks that hold
    real tiles, then the tail (assembly, grid2's far field); gwalk: one
    walk, pool and kernel launch for all tiles. On CUDA tensors each of
    these replays a CUDA graph (graph=None; graph=False runs eagerly,
    graph=True on CPU tensors raises ValueError); the per-tree state and
    the one host read (live_chunks) stay outside. theta, eps and G are
    numbers or 0-dim tensors, inputs of the graphs (scalars): a new value
    captures nothing; the per-tree state takes eps's value in its key
    (pass the number, which is read on the host). extra: optional
    (pos [E, D], mass [E]) sources added to every tile, the LET imports
    (shared and lmac only: gwalk raises NotImplementedError, as the
    reference does, and the lists path
    ValueError)."""
    graph = _use_graph(graph, td.pos, cfg)
    if cfg.traversal_mode == "gwalk" and extra is not None:
        raise NotImplementedError(
            "LET imports ride the shared/lmac engines, not gwalk")
    tiles, tables, Lgrid = _query_state(td, cfg, eps)
    theta, eps, scal = scalars(td.pos, theta, eps, G)
    if cfg.traversal_mode == "gwalk":
        return _run(graph, _gwalk_query, td, cfg, theta, eps, scal, tiles,
                    Lgrid, mode=mode)
    # the padding chunks' rows as zeros (the reference's tail shape), so
    # that one tail serves every n_live
    acc, pot, ovf, mx = run_chunks(td, cfg, theta, eps, scal,
                                   (tiles, tables, Lgrid), 0,
                                   live_chunks(td, cfg), slice_chunks, mode,
                                   extra, graph,
                                   rows=tiles[0].shape[0] * tiles[0].shape[1])
    acc_u, pot_u = _run(graph, _tail_impl, td, cfg, eps, scal,
                        Lgrid if cfg.farfield == "grid2" else None, acc, pot)
    return acc_u, pot_u, ovf, mx


def _query_impl(td: TreeData, cfg: TreeConfig, theta, eps, scal,
                mode: str = "both", extra=None):
    """acc_pot_u's computation: tiles, tables and far field, every chunk of
    the tile capacity, the tail. Returns (acc_u, pot_u, ovf, maxima)."""
    if cfg.traversal_mode == "gwalk" and extra is not None:
        raise NotImplementedError(
            "LET imports ride the shared/lmac engines, not gwalk")
    tiles = _gather_tiles(td, cfg)
    Lgrid = _grid_farfield(td, cfg, eps)
    if cfg.traversal_mode == "gwalk":
        return _gwalk_query(td, cfg, theta, eps, scal, tiles, Lgrid, mode)
    tables = (_traversal_mod(cfg).make_tables(td, cfg)
              if _use_shared(cfg) else None)
    acc, pot, ovf, mx = _chunk_loop(
        td, cfg, theta, eps, scal, tiles, tables,
        Lgrid if cfg.farfield == "grid" else None, mode, extra)
    acc_u, pot_u = _tail_impl(td, cfg, eps, scal,
                              Lgrid if cfg.farfield == "grid2" else None,
                              acc, pot)
    return acc_u, pot_u, ovf, mx


def acc_pot_u(td: TreeData, cfg: TreeConfig, theta, eps, G=1.0,
              with_stats: bool = False, extra=None, mode: str = "both",
              graph=None):
    """The reference's single-executable query (`rakau_tpu.engine
    .acc_pot_u`): accelerations [N, D] and potentials [N] in Morton
    order and the overflow flags [4], with `with_stats` also the maxima
    [4]. The tiles gather, the tables and the far field are made inside
    (no _QUERY_STATE_CACHE), every chunk of the tile capacity runs (no
    read of n_tiles: padding chunks walk with tile_valid false and add
    nothing), and lmac runs its un-sliced predicate (no candidate table:
    its flags and maxima are the reference's). On the card the whole call
    is one CUDA graph (graph=None; graph=False runs eagerly, graph=True on
    CPU tensors raises). Its sums equal acc_pot_u_host's. theta, eps and
    G are numbers or 0-dim tensors, the graph's inputs (scalars); extra
    as in acc_pot_u_host (gwalk raises NotImplementedError, the lists
    path ValueError)."""
    graph = _use_graph(graph, td.pos, cfg)
    theta, eps, scal = scalars(td.pos, theta, eps, G)
    acc_u, pot_u, ovf, mx = _run(graph, _query_impl, td, cfg, theta, eps,
                                 scal,
                                 mode=mode, extra=extra)
    if with_stats:
        return acc_u, pot_u, ovf, mx
    return acc_u, pot_u, ovf
