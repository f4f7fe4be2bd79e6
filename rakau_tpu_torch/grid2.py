"""Leaf-grid cell map. Counterpart of `rakau_tpu.grid2`, which also
holds the conv-M2L far field (not ported yet); here only the function
the gwalk pool's per-particle coverage drop needs.
"""
from __future__ import annotations

import torch

from . import particles


def particle_cells(pos: torch.Tensor, box_size, depth: int,
                   L0: int) -> torch.Tensor:
    """Leaf-grid cells [N, D] int64 of positions [N, D]: the cell of each
    particle at level L0 of the depth-`depth` grid. Every coverage test
    uses this one map, so that rounding at a cell face cannot put a
    particle in one cell on one side of a test and in another on the
    other."""
    return particles.discretize(pos, box_size, depth) >> (depth - L0)
