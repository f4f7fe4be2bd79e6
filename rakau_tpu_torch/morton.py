"""Morton (Z-order) codes as one int64 per particle.

Counterpart of `rakau_tpu.morton`, which keeps each code in a (hi, lo)
pair of uint32 words. Codes use at most 63 bits, so an int64 holds them
non-negative and sorts them in the same order as the word pairs.

Bit layout (shared with grid.py): the code occupies bits
[0, depth*ndim) LSB-aligned; bit b of dimension d lands at position
b*ndim + (ndim-1-d), so dimension 0 is the most significant within each
bit group. The prefix of a code at tree level L is
`code >> (ndim*(max_depth - L))`.
"""
from __future__ import annotations

import torch


def encode(cells: torch.Tensor, ndim: int, depth: int) -> torch.Tensor:
    """cells: [..., ndim] integer in [0, 2**depth) -> [...] int64 codes."""
    if cells.shape[-1] != ndim:
        raise ValueError(f"cells must be [..., {ndim}], got {tuple(cells.shape)}")
    if depth * ndim > 63:
        raise ValueError("depth*ndim must be <= 63")
    cells = cells.to(torch.int64)
    code = torch.zeros(cells.shape[:-1], dtype=torch.int64,
                       device=cells.device)
    for d in range(ndim):
        v = cells[..., d]
        for b in range(depth):
            p = b * ndim + (ndim - 1 - d)
            code |= ((v >> b) & 1) << p
    return code


def decode(code: torch.Tensor, ndim: int, depth: int) -> torch.Tensor:
    """Inverse of encode: [...] int64 -> [..., ndim] int64 cells."""
    dims = []
    for d in range(ndim):
        v = torch.zeros_like(code)
        for b in range(depth):
            p = b * ndim + (ndim - 1 - d)
            v |= ((code >> p) & 1) << b
        dims.append(v)
    return torch.stack(dims, dim=-1)
