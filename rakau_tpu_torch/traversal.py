"""Per-tile list traversal: tree -> dense padded interaction lists, one
list pair per tile. Counterpart of `rakau_tpu.traversal` (the lists path,
`traversal_mode="lists"`).

Each tile of a chunk carries a frontier of undecided nodes, expanded one
tree level per round: every candidate child is MAC-tested against the
tile's AABB (the distance from the box to the node's COM; bh or bh_geom).
Accepted nodes append to the tile's M2P list, rejected leaves to its P2P
leaf list, rejected internal nodes to the next frontier. The P2P leaves
are then expanded into a particle list. All lists are [C, cap] with
counts and overflow flags, never truncated silently.

The walk runs round 0 on the root and rounds 1..max_depth on frontiers of
the uniform width frontier_cap, all of them, with no host sync. Indices
are int64 (the reference's int32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .build import TreeData
from .particles import scalar_tensor
from .config import MAC_BH, TreeConfig

I64 = torch.int64


class InteractionLists(NamedTuple):
    m2p_nodes: torch.Tensor  # [C, m2p_cap] node slots (-1 pad)
    m2p_count: torch.Tensor  # [C]
    p2p_src: torch.Tensor    # [C, p2p_src_cap] particle slots (-1 pad)
    p2p_count: torch.Tensor  # [C]
    overflow: torch.Tensor   # [4] bool, in the order of config.OVF_FIELDS:
                             # (m2p, p2p_leaf, p2p_src, frontier)
    maxima: torch.Tensor     # [4] in the order config.fit_caps reads:
                             # (m2p, p2p_src, frontier, p2p_leaf)


def tile_aabbs(pos, n_tiles: int, tile: int):
    """AABB (lo, hi) of each tile of `tile` consecutive Morton-ordered
    particles; pos is padded to n_tiles * tile rows that must be neutral
    for min and max."""
    p = pos.reshape(n_tiles, tile, pos.shape[-1])
    return p.amin(1), p.amax(1)


def _append(lst, cnt, mask, values, cap: int):
    """Append `values` where `mask` to per-row padded lists: lst [C, cap],
    cnt [C], mask / values [C, K]. Returns (lst, cnt capped at cap, the
    rows that overflowed [C])."""
    pos = cnt[:, None] + torch.cumsum(mask.to(I64), 1) - 1
    idx = torch.where(mask & (pos < cap), pos, cap)
    out = torch.cat([lst, lst[:, :1]], 1)       # column cap: the drop slot
    out.scatter_(1, idx, values)
    new_cnt = cnt + mask.sum(1)
    return out[:, :cap], torch.clamp(new_cnt, max=cap), new_cnt > cap


def box_point_dist2(lo, hi, p):
    """Squared distance from the boxes [lo, hi] ([C, 1, D]) to the points
    p [C, K, D] (0 inside) -> [C, K]."""
    d = torch.clamp(torch.maximum(lo - p, p - hi), min=0.0)
    return (d * d).sum(-1)


def build_interaction_lists(td: TreeData, cfg: TreeConfig, theta,
                            box_lo, box_hi) -> InteractionLists:
    """One chunk's walk. box_lo / box_hi: [C, D] tile AABBs; theta a
    number or a 0-dim tensor. Padding tiles (inverted boxes) take the root as an M2P
    entry; their results are never read."""
    C = box_lo.shape[0]
    dtype = td.pos.dtype
    dev = td.pos.device
    inv_theta = 1.0 / scalar_tensor(theta, td.pos)
    lo = box_lo[:, None, :]
    hi = box_hi[:, None, :]
    fcap = cfg.frontier_cap
    k = 2 ** cfg.ndim

    m2p = torch.full((C, cfg.m2p_cap), -1, dtype=I64, device=dev)
    m2p_cnt = torch.zeros(C, dtype=I64, device=dev)
    leaf = torch.full((C, cfg.p2p_leaf_cap), -1, dtype=I64, device=dev)
    leaf_cnt = torch.zeros(C, dtype=I64, device=dev)
    ovf_m2p = torch.zeros(C, dtype=torch.bool, device=dev)
    ovf_leaf = torch.zeros_like(ovf_m2p)

    def classify(cand, cvalid, size):
        """MAC decisions of the candidates [C, K]: appends the accepted to
        the M2P lists and the rejected leaves to the leaf lists; returns
        the rejected internal nodes [C, K]."""
        nonlocal m2p, m2p_cnt, leaf, leaf_cnt, ovf_m2p, ovf_leaf
        cand_s = torch.where(cvalid, cand, 0)
        com = td.node_com[cand_s]                       # [C, K, D]
        is_leaf = td.node_is_leaf[cand_s]
        mass = td.node_mass[cand_s]
        d2 = box_point_dist2(lo, hi, com)
        thresh = size * inv_theta
        if cfg.mac != MAC_BH:       # bh_geom: d > size / theta + delta
            thresh = thresh + td.node_delta[cand_s]
        accept = (d2 > thresh * thresh) & cvalid & (mass > 0)
        reject = cvalid & ~accept
        m2p, m2p_cnt, o1 = _append(m2p, m2p_cnt, accept, cand, cfg.m2p_cap)
        leaf, leaf_cnt, o2 = _append(leaf, leaf_cnt, reject & is_leaf, cand,
                                     cfg.p2p_leaf_cap)
        ovf_m2p = ovf_m2p | o1
        ovf_leaf = ovf_leaf | o2
        return reject & ~is_leaf

    # round 0: the root alone
    to_next = classify(torch.zeros((C, 1), dtype=I64, device=dev),
                       torch.ones((C, 1), dtype=torch.bool, device=dev),
                       td.box_size)
    nf = to_next.sum(1)                                 # 0 or 1
    nf_max = nf.max()
    # the frontier of round 1 is the root (node 0) where it was opened
    frontier = torch.zeros((C, fcap), dtype=I64, device=dev)
    ovf_frontier = torch.zeros((), dtype=torch.bool, device=dev)
    arF = torch.arange(fcap, device=dev)
    arK = torch.arange(k, device=dev)
    for r in range(1, cfg.max_depth + 1):
        f_valid = arF[None, :] < nf[:, None]
        fr = torch.where(f_valid, frontier, 0)
        cb = td.node_child_begin[fr]
        cc = td.node_child_count[fr]
        cand = (cb[:, :, None] + arK).reshape(C, -1)
        cvalid = ((arK < cc[:, :, None]) & f_valid[:, :, None]).reshape(C, -1)
        to_next = classify(cand, cvalid, td.box_size * 2.0 ** -r)
        # compact the next frontier
        pos = torch.cumsum(to_next.to(I64), 1) - 1
        idx = torch.where(to_next & (pos < fcap), pos, fcap)
        frontier = torch.zeros((C, fcap + 1), dtype=I64, device=dev)
        frontier.scatter_(1, idx, cand)
        frontier = frontier[:, :fcap]
        nf_new = to_next.sum(1)
        # the last round's frontier is empty (nodes at max_depth are
        # leaves), so no unflushed entry can be lost
        ovf_frontier = ovf_frontier | (nf_new > fcap).any()
        nf_max = torch.maximum(nf_max, nf_new.max())
        nf = torch.clamp(nf_new, max=fcap)

    # expand the P2P leaves into a compact per-tile particle list
    lvalid = leaf >= 0
    leaf_s = torch.where(lvalid, leaf, 0)
    lb = torch.where(lvalid, td.node_begin[leaf_s], 0)
    lc = torch.where(lvalid, td.node_end[leaf_s] - td.node_begin[leaf_s], 0)
    offs = torch.cumsum(lc, 1) - lc                      # exclusive prefix
    total = offs[:, -1] + lc[:, -1]
    arL = torch.arange(cfg.max_leaf_n, device=dev)
    pos2 = offs[:, :, None] + arL                        # [C, P, L]
    val2 = arL < lc[:, :, None]
    vals = lb[:, :, None] + arL
    scap = cfg.p2p_src_cap
    idx2 = torch.where(val2 & (pos2 < scap), pos2, scap).reshape(C, -1)
    p2p = torch.full((C, scap + 1), -1, dtype=I64, device=dev)
    p2p.scatter_(1, idx2, vals.reshape(C, -1))
    return InteractionLists(
        m2p_nodes=m2p, m2p_count=m2p_cnt,
        p2p_src=p2p[:, :scap], p2p_count=torch.clamp(total, max=scap),
        overflow=torch.stack([ovf_m2p.any(), ovf_leaf.any(),
                              (total > scap).any(), ovf_frontier]),
        maxima=torch.stack([m2p_cnt.max(), total.max(), nf_max,
                            leaf_cnt.max()]))
