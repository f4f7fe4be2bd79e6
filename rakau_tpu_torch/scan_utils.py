"""Scan, search and compaction primitives. Counterpart of
`rakau_tpu.scan_utils`.

The reference's double-double fp32 prefix sums were a TPU workaround (no
fast fp64 there); here a float64 cumsum and boundary differences give
segment sums to better than fp32 accuracy. Every function keeps static
output shapes and never syncs with the host.
"""
from __future__ import annotations

import torch


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of non-negative int64 values (64 for 0).

    A branch-free binary search over shift widths; exact at every
    magnitude (a float log2 is not above 2^53)."""
    n = torch.zeros_like(x)
    for w in (32, 16, 8, 4, 2, 1):
        # top (n + w) bits all zero?
        empty = (x >> (64 - n - w)) == 0
        n = n + torch.where(empty, w, 0)
    return torch.where(x == 0, 64, n)


def searchsorted_1d(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Leftmost position where a[pos] >= v (a 1-D sorted), in [0, K]."""
    return torch.searchsorted(a, v.to(a.dtype).contiguous())


def searchsorted_rows(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched rows: a [..., K] sorted rows, v [..., Q] queries ->
    leftmost position where a[..., pos] >= v, in [0, K]."""
    return torch.searchsorted(a.contiguous(), v.to(a.dtype).contiguous())


def compact_indices(mask: torch.Tensor, cap: int):
    """Left-compact the True positions of mask [..., K] into [..., cap]
    int64 index arrays (K for padding), plus int64 counts [...].

    Each True element scatters its own index to its compacted slot
    (slots are unique; entries past `cap` land in a dump column that is
    cut off)."""
    K = mask.shape[-1]
    lead = mask.shape[:-1]
    m2 = mask.reshape(-1, K)
    R = m2.shape[0]
    csum = torch.cumsum(m2, dim=-1)
    cnt = csum[:, -1] if K else torch.zeros(R, dtype=torch.int64,
                                            device=mask.device)
    pos = torch.where(m2, csum - 1, cap).clamp_(max=cap)
    row = torch.arange(R, device=mask.device)[:, None] * (cap + 1)
    out = torch.full((R * (cap + 1),), K, dtype=torch.int64,
                     device=mask.device)
    src = torch.arange(K, device=mask.device).expand(R, K)
    out.scatter_(0, (row + pos).reshape(-1), src.reshape(-1))
    idx = out.reshape(R, cap + 1)[:, :cap]
    return idx.reshape(lead + (cap,)), cnt.reshape(lead)


def prefix_sums(v: torch.Tensor) -> torch.Tensor:
    """Inclusive float64 prefix sums along dim 0 of v [N, ...]."""
    return torch.cumsum(v.to(torch.float64), dim=0)


def segment_sum_from_prefix(prefix: torch.Tensor, begin: torch.Tensor,
                            end: torch.Tensor) -> torch.Tensor:
    """Sums over [begin, end) ranges from an inclusive prefix [N, ...]
    (float64); empty ranges give 0. Returns [len(begin), ...]."""
    n = prefix.shape[0]

    def at(i):
        vals = prefix[(i - 1).clamp(0, n - 1)]
        valid = (i > 0).reshape(i.shape + (1,) * (prefix.ndim - 1))
        return torch.where(valid, vals, 0.0)

    s = at(end) - at(begin)
    nonempty = (end > begin).reshape(end.shape + (1,) * (prefix.ndim - 1))
    return torch.where(nonempty, s, 0.0)
