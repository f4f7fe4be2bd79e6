"""The plan and the span sums shared by K2 (kernels/pool.py) and K3
(kernels/tiles.py): the PyTorch side of csrc/rows.cuh.

Each tile owns private, contiguous source rows, cut into granules of
GRANULE entries (K2: the runs of a pool block; K3: the M2P row's, then
the P2P row's, up to each count). A tile's granules are cut into spans of
`span` consecutive granules; the work list holds the spans tile after
tile. A granule's partial sum enters its span's sum, and each target's
span sums are added in span order; with compensated sums both additions
go through Knuth's TwoSum and the error terms are added at the end. The
kernels run this plan on the card; the plain versions follow it on any
device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Entries a granule: the unit of a tile's rows and of one staging step in
# the kernels (csrc/rows.cuh:kGranule, checked when a library loads).
GRANULE = 128


class RowsPlan(NamedTuple):
    """The work list of one launch. first [G + 1] int32: the spans before
    each tile (first[G]: all of them); work [cap] int32: the tile of each
    span, span s of tile g being its granules [(s - first[g]) * span,
    min((s - first[g] + 1) * span, granules[g])), padded with G; n_work
    [1] int32: the spans, or -1 where a tile's rows are out of range
    (granules < 0) or the spans exceed cap (the kernels then write NaN)."""
    first: torch.Tensor
    work: torch.Tensor
    n_work: torch.Tensor


def span_plan(granules: torch.Tensor, span: int, cap: int) -> RowsPlan:
    """The plan of tiles with `granules` [G] granules each (-1: out of
    range), spans of `span` granules, at most `cap` spans; on the device
    of `granules`, with no host sync."""
    G = granules.shape[0]
    dev = granules.device
    g = granules.to(torch.int64)
    ns = (g.clamp(min=0) + span - 1) // span
    first = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                       torch.cumsum(ns, 0)])
    s = torch.arange(cap, device=dev)
    tile = torch.searchsorted(first[1:], s, right=True)
    work = torch.where(s < first[G], tile, G)
    bad = (g < 0).any() | (first[G] > cap)
    n_work = torch.where(bad, -1, first[G]).reshape(1)
    return RowsPlan(first.to(torch.int32), work.to(torch.int32),
                    n_work.to(torch.int32))


def plan_views(plan: torch.Tensor, G: int, cap: int) -> RowsPlan:
    """first, work and n_work as views of one int32 tensor [G + cap + 2]
    (a wrapper's single allocation for the plan its kernels write)."""
    return RowsPlan(plan[:G + 1], plan[G + 1:G + 1 + cap], plan[G + 1 + cap:])


def span_ends(k: int, granules: torch.Tensor, span: int) -> torch.Tensor:
    """[G] bool: granule k ends a span of its tile (its span is full, or
    it is the tile's last); span 0 is one span a tile."""
    last = granules == k + 1
    if span and (k + 1) % span == 0:
        return granules > k
    return last


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


class SpanSums:
    """Each target's sums in the plan's order: add() a granule's partial
    into its span's sum where `take`, and the span's sum into the total
    where `end` (both [G] bool); total() the sums (plus the TwoSum errors
    with compensated)."""

    def __init__(self, like: torch.Tensor, compensated: bool):
        self.comp = compensated
        self.tot, self.tot_e, self.run, self.run_e = (
            torch.zeros_like(like) for _ in range(4))

    def add(self, part, take, end):
        shape = (-1,) + (1,) * (part.dim() - 1)
        tk, ek = take.reshape(shape), end.reshape(shape)
        if self.comp:
            s, e = _two_sum(self.run, part)
            self.run_e = torch.where(tk, self.run_e + e, self.run_e)
        else:
            s = self.run + part
        self.run = torch.where(tk, s, self.run)
        if self.comp:
            s, e = _two_sum(self.tot, self.run)
            self.tot_e = torch.where(ek, (self.tot_e + e) + self.run_e,
                                     self.tot_e)
            self.run_e = torch.where(ek, 0.0, self.run_e)
        else:
            s = self.tot + self.run
        self.tot = torch.where(ek, s, self.tot)
        self.run = torch.where(ek, 0.0, self.run)

    def total(self):
        return self.tot + self.tot_e if self.comp else self.tot
