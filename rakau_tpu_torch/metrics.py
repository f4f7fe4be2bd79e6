"""Per-query metrics: list occupancy of the per-tile lists, useful-pair
density of the shared-row kernels, their measured dense roof, and cap
fitting. Counterpart of `rakau_tpu.metrics`.

Static capacities against actual list sizes, and the kernel's processed
pairs against the pairs the physics needs, are the numbers that say
whether a traversal feeds the kernel well."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from . import engine, traversal
from .build import TreeData
from .config import TreeConfig
from .kernels import dispatch, shared


@dataclass
class QueryStats:
    """List occupancy of the per-tile lists traversal."""
    n: int
    n_nodes: int
    n_tiles: int
    tile_fill: float              # mean tile occupancy / ncrit
    m2p_mean: float
    m2p_p95: float
    m2p_max: int
    m2p_cap: int
    p2p_mean: float
    p2p_p95: float
    p2p_max: int
    p2p_src_cap: int
    m2p_waste: float              # 1 - mean/cap (padded work fraction)
    p2p_waste: float
    interactions_m2p: float       # total useful pair interactions
    interactions_p2p: float

    def as_dict(self) -> Dict:
        return self.__dict__.copy()


def collect_query_stats(td: TreeData, cfg: TreeConfig, theta,
                        max_chunks: int = 16) -> QueryStats:
    """List occupancy statistics of the per-tile lists traversal
    (traversal.build_interaction_lists) over the first
    min(chunks, max_chunks) tile chunks, whatever cfg's own traversal:
    the per-tile list sizes are the padding-waste diagnostic (the shared,
    lmac and gwalk engines size their caps from their own query maxima).
    The interaction totals are extrapolated to all chunks. Runs the walk
    only, no kernel; the counts are read on the host."""
    import os
    # the lists config is diagnostic: allow it for this call only
    prev = os.environ.get("RAKAU_DIAG_MODES")
    os.environ["RAKAU_DIAG_MODES"] = "1"
    try:
        cfg = cfg.with_(traversal_mode="lists")
    finally:
        if prev is None:
            os.environ.pop("RAKAU_DIAG_MODES", None)
        else:
            os.environ["RAKAU_DIAG_MODES"] = prev
    tiles = engine._gather_tiles(td, cfg)
    blo, bhi = tiles[2], tiles[3]
    nch = tiles[0].shape[0]
    m2p, p2p = [], []
    for c in range(min(nch, max_chunks)):
        il = traversal.build_interaction_lists(td, cfg, theta, blo[c], bhi[c])
        m2p.append(il.m2p_count)
        p2p.append(il.p2p_count)
    m2p = torch.cat(m2p).cpu().numpy().astype(np.float64)
    p2p = torch.cat(p2p).cpu().numpy().astype(np.float64)
    n_tiles = int(td.n_tiles)
    tc = td.tile_cnt[:n_tiles].cpu().numpy().astype(np.float64)
    scale = nch / max(1, min(nch, max_chunks))
    return QueryStats(
        n=int(td.pos.shape[0]), n_nodes=int(td.n_nodes), n_tiles=n_tiles,
        tile_fill=float(tc.mean() / cfg.ncrit) if n_tiles else 0.0,
        m2p_mean=float(m2p.mean()), m2p_p95=float(np.percentile(m2p, 95)),
        m2p_max=int(m2p.max()), m2p_cap=cfg.m2p_cap,
        p2p_mean=float(p2p.mean()), p2p_p95=float(np.percentile(p2p, 95)),
        p2p_max=int(p2p.max()), p2p_src_cap=cfg.p2p_src_cap,
        m2p_waste=float(1.0 - m2p.mean() / cfg.m2p_cap),
        p2p_waste=float(1.0 - p2p.mean() / cfg.p2p_src_cap),
        interactions_m2p=float(m2p.sum() * cfg.ncrit * scale),
        interactions_p2p=float(p2p.sum() * cfg.ncrit * scale))


@dataclass
class SharedDensityStats:
    """Useful-pair density of the shared-row kernels.

    `useful_pairs` counts (valid target, mask-on source) pairs, the
    physics the query needs. `processed_pairs` counts the pairs the
    selected evaluator of the row computes after its per-tile plan
    (active entries x its unit x T per tile, processed_pairs), the work it
    does. `density` is their ratio. `slot_pairs` is the uncompacted
    S * T * C slot count. Pairs that grid2's per-pair cell test kills
    inside the kernel count as useful: they are mask-on, and compaction
    cannot skip them. `block` is the unit of the plan of the particle
    rows (kernels.shared.PLAN_BLOCK: K1's granule by default)."""
    useful_pairs: float
    processed_pairs: float
    slot_pairs: float
    density: float                # useful / processed
    slot_density: float           # useful / slot
    pairs_per_particle: float     # useful / N
    chunks_sampled: int
    block: int
    subblock: int                 # always 0: a plan entry is one block

    def as_dict(self) -> Dict:
        return self.__dict__.copy()


def sample_chunks(n_live: int, max_chunks: int):
    """Midpoints of min(n_live, max_chunks) equal bins of the live chunks:
    clipped tiles are heterogeneous (the first chunks are near-empty halo
    tiles) and the last live chunk is partly padding, so neither a prefix
    nor the endpoints extrapolate linearly."""
    take = min(n_live, max_chunks)
    return sorted({int((i + 0.5) * n_live / take) for i in range(take)})


def _plan_block(cfg: TreeConfig, quad: bool, variant: str = None) -> int:
    """The unit of the plan that evaluates one launch of `cfg`'s row
    (quad: the node rows of a quadrupole query) under the shared variant
    `variant` (default: the one selected now): K1's granule unless the
    variant takes the launch, which K6 and K5 do only for the monopole in
    fp32 sums (kernels.dispatch._eval)."""
    name = dispatch._variant[0] if variant is None else variant
    if quad or cfg.accum == "compensated":
        name = "fused"
    return shared.PLAN_BLOCK[name]


def processed_pairs(cfg: TreeConfig, mask: torch.Tensor,
                    variant: str = None) -> torch.Tensor:
    """Pairs the kernels compute for one chunk's mask [C, S], from the
    plan of the evaluator that takes each launch (_plan_block; 0-d
    tensor): active entries x unit x T. With the quadrupole the node rows
    [0, m2p_cap) and the particle rows are two launches, each with its own
    plan, as kernels.dispatch.eval_shared splits them."""
    U = cfg.m2p_cap
    segs = ([(mask[:, :U], True), (mask[:, U:], False)]
            if cfg.multipole_order >= 2 else [(mask, False)])
    total = torch.zeros((), dtype=torch.int64, device=mask.device)
    for m, quad in segs:
        if m.shape[1]:
            blk = _plan_block(cfg, quad, variant)
            total = total + shared.active_blocks(
                m.contiguous(), blk)[1].sum() * blk
    return total * cfg.ncrit


def collect_shared_density(td: TreeData, cfg: TreeConfig, theta, eps=0.0,
                           max_chunks: int = 8) -> SharedDensityStats:
    """Useful-pair density of a shared or lmac query on sampled chunks
    (sample_chunks), extrapolated to the live chunks. Each sampled chunk's
    mask is the one the engine hands to the kernel
    (engine.kernel_inputs: the traversal, the lmac candidate table of the
    chunk's slice and the far/near gate), and the processed pairs replay
    the plan of the evaluator selected now (processed_pairs: K1's
    granules by default); no kernel is launched."""
    if not engine._use_shared(cfg):
        raise ValueError("density stats require the shared or the lmac "
                         "traversal")
    n = int(td.pos.shape[0])
    n_live = engine.live_chunks(td, cfg)
    CH = min(cfg.tile_chunk, td.tile_begin.shape[0])
    T = cfg.ncrit
    s0 = cfg.m2p_cap + cfg.p2p_src_cap
    sample = sample_chunks(n_live, max_chunks)
    useful = torch.zeros((), dtype=torch.float64, device=td.pos.device)
    processed = torch.zeros_like(useful)
    for c in sample:
        inp = engine.kernel_inputs(td, cfg, theta, eps, c)
        tidx, mask = inp[1], inp[5]
        tcnt = (tidx < n).sum(1).double()
        useful += (mask.sum(1).double() * tcnt).sum()
        processed += processed_pairs(cfg, mask)
    scale = n_live / len(sample)
    useful = float(useful) * scale
    processed = float(processed) * scale
    slots = float(CH * s0 * T) * len(sample) * scale
    return SharedDensityStats(
        useful_pairs=useful, processed_pairs=processed, slot_pairs=slots,
        density=useful / max(processed, 1.0),
        slot_density=useful / max(slots, 1.0),
        pairs_per_particle=useful / max(n, 1),
        chunks_sampled=len(sample), block=_plan_block(cfg, False),
        subblock=0)


def measure_kernel_roof(cfg: TreeConfig, n_src: int = 262144, reps: int = 8,
                        variant: str = "fused", prec: str = "x3",
                        device=None) -> float:
    """Measured dense ceiling of a shared-row kernel, in pairs per second:
    the kernel configuration a query with `cfg` launches (the cell planes
    with farfield="grid2", the second moments with multipole_order=2),
    through kernels.dispatch under shared_variant(variant, prec), with an
    all-on mask and every pair passing the cell test, `reps` launches
    between two CUDA events after one warm-up launch. Needs a CUDA
    device: a CPU run times no kernel."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError("measure_kernel_roof times the CUDA kernels")
    C, T, D = cfg.tile_chunk, cfg.ncrit, cfg.ndim
    S = n_src
    # deterministic non-degenerate positions; r2 > 0 for every pair
    tgt = (torch.arange(C * T * D, dtype=torch.float32, device=dev)
           .reshape(C, T, D) % 251.0) * 1e-3 + 1.0
    src = (torch.arange(S * D, dtype=torch.float32, device=dev)
           .reshape(S, D) % 257.0) * 1e-3 - 1.0
    smass = torch.ones(S, dtype=torch.float32, device=dev)
    sidx = torch.full((S,), -1, dtype=torch.int64, device=dev)
    tidx = torch.arange(C * T, device=dev).reshape(C, T)
    mask = torch.ones((C, S), dtype=torch.bool, device=dev)
    grid2_mode = cfg.farfield == "grid2"
    scell = (torch.zeros((S, D), dtype=torch.int64, device=dev)
             if grid2_mode else None)
    tcell = (torch.zeros((C, T, D), dtype=torch.int64, device=dev)
             if grid2_mode else None)
    squad = (torch.full((S, D * (D + 1) // 2), 1e-6, dtype=torch.float32,
                        device=dev) if cfg.multipole_order >= 2 else None)

    scal = shared.scalar_buffer(0.0, 1.0, tgt)

    def run():
        return dispatch.eval_shared(cfg, tgt, tidx, src, smass, sidx, mask,
                                    scal, src_cell=scell, tgt_cell=tcell,
                                    src_quad=squad)

    with dispatch.shared_variant(variant, prec):
        run()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        stop.synchronize()
    return reps * C * T * S / (start.elapsed_time(stop) * 1e-3)


def fitted_caps(stats: QueryStats, slack: float = 1.25,
                quantum: int = 512) -> Dict[str, int]:
    """Shrink-to-fit capacities from measured list maxima."""
    def fit(mx):
        return max(quantum, int(np.ceil(mx * slack / quantum)) * quantum)

    return {
        "m2p_cap": fit(stats.m2p_max),
        "p2p_src_cap": fit(stats.p2p_max),
        "p2p_leaf_cap": max(256, fit(stats.p2p_max) // 4),
    }
