"""Dense-grid stencil far field (FMM-style M2L on regular per-level
grids). Counterpart of `rakau_tpu.grid`.

Coverage: a (target-cell, source-cell) pair at level l with Chebyshev
separation sep_l is handled by the level-l stencil iff 3 <= sep_l and the
parent pair has sep_{l-1} <= 2. Since sep_{l+1} >= 2*sep_l - 1, every pair
with leaf-grid separation >= 3 is covered at exactly one level <= L0; the
walk (traversal2) drops exactly those candidates and only resolves the
5^D-cell near neighbourhood.
"""
from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import expansion
from .graphs import device_constant

# Stencil geometry: children of parents with sep<=2 span offsets in
# [-5, 5]; covered offsets are 3 <= maxcomp <= 5.
_PAD = 5
# entries of one batched [offsets, cells] M2L panel (bounds its memory)
_BATCH_ENTRIES = 1 << 21


@lru_cache(maxsize=None)
def stencil_offsets(ndim: int):
    """Static stencil: (offsets [NO, D] int64, parity_bits [NO] int64).

    parity_bits packs, per offset o, a bitmask over the 2^D target-cell
    parities b for which the pair is NOT already covered at the parent
    level: bit(b) = 1 iff maxcomp(floor((b + o)/2)) <= 2."""
    offs = []
    bits = []
    for o in itertools.product(range(-_PAD, _PAD + 1), repeat=ndim):
        if not 3 <= max(abs(c) for c in o) <= _PAD:
            continue
        mask = 0
        for bidx in range(2 ** ndim):
            b = [(bidx >> d) & 1 for d in range(ndim)]
            q = [(b[d] + o[d]) // 2 for d in range(ndim)]
            if max(abs(c) for c in q) <= 2:
                mask |= 1 << bidx
        if mask:
            offs.append(o)
            bits.append(mask)
    return np.asarray(offs, np.int64), np.asarray(bits, np.int64)


@device_constant
def _stencil_tensors(ndim: int, device):
    """stencil_offsets(ndim) as tensors on `device`, made once."""
    offs, bits = stencil_offsets(ndim)
    return (torch.as_tensor(offs, device=device),
            torch.as_tensor(bits, device=device))


def effective_grid_level(cfg, n: int) -> int:
    """Leaf-grid level L0: ~n/ncrit cells, memory-capped."""
    if cfg.grid_level is not None:
        return cfg.grid_level
    if n <= cfg.ncrit:
        return 0
    l0 = int(math.floor(math.log(max(n / cfg.ncrit, 1.0), 2 ** cfg.ndim)))
    cap = {1: 16, 2: 9, 3: 6}[cfg.ndim]   # <= ~262k cells
    return max(0, min(l0, cap, cfg.max_depth))


class Pyramid(NamedTuple):
    """Dense per-level monopole grids, levels 0..L0 (row-major [G]*D).

    mass[l]: [G^D]; wsum[l]: [G^D, D] mass-weighted positions (absolute
    coordinates), so COM = wsum/mass."""
    mass: tuple
    wsum: tuple


def rowmajor_cell_index(cell: torch.Tensor, ndim: int, L0: int):
    """[..., D] integer per-dim cell coords -> row-major flat index."""
    G = 1 << L0
    flat = cell[..., 0]
    for d in range(1, ndim):
        flat = flat * G + cell[..., d]
    return flat


def build_pyramid(td, ndim: int, depth: int, L0: int) -> Pyramid:
    """Bin the particles into the leaf grid (float64 sums, one index_add
    per quantity) and reduce upward by 2^D-child sums."""
    from . import particles as pmod
    G = 1 << L0
    ncells = G ** ndim
    dtype = td.pos.dtype
    dev = td.pos.device

    cells = pmod.discretize(td.pos, td.box_size, depth) >> (depth - L0)
    flat = rowmajor_cell_index(cells, ndim, L0)
    m64 = td.mass.to(torch.float64)
    vals = torch.cat([m64[:, None], m64[:, None] * td.pos.to(torch.float64)],
                     dim=1)                                  # [N, 1+D]
    sums = torch.zeros((ncells, 1 + ndim), dtype=torch.float64, device=dev)
    sums.index_add_(0, flat, vals)
    sums = sums.to(dtype)

    masses = {L0: sums[:, 0]}
    wsums = {L0: sums[:, 1:]}
    for lvl in range(L0 - 1, -1, -1):
        Gc = 1 << (lvl + 1)
        shape = (Gc // 2, 2) * ndim
        axes = tuple(2 * i + 1 for i in range(ndim))
        masses[lvl] = masses[lvl + 1].reshape(shape).sum(axes).reshape(-1)
        wsums[lvl] = wsums[lvl + 1].reshape(shape + (ndim,)).sum(
            axes).reshape(-1, ndim)
    return Pyramid(mass=tuple(masses[lvl] for lvl in range(L0 + 1)),
                   wsum=tuple(wsums[lvl] for lvl in range(L0 + 1)))


def _cell_coords(ndim: int, lvl: int, device) -> torch.Tensor:
    """Row-major [G^D, D] int64 cell coordinates at level lvl."""
    G = 1 << lvl
    ax = [torch.arange(G, device=device)] * ndim
    grids = torch.meshgrid(*ax, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=1)


def dense_far_field(pyr: Pyramid, ndim: int, L0: int, box_size, eps,
                    order: int = 3) -> torch.Tensor:
    """M2L over the separation stencil at every level + L2L chain.

    Returns L_leaf [G^D, NC] (row-major): local expansions about the
    leaf cell centres, covering exactly the sep>=3 pair decomposition.

    The reference scans the stencil offsets one by one; here they go in
    batches of offsets (bounded by _BATCH_ENTRIES), each batch one
    gathered [offsets, cells] panel, so a level costs a few launches."""
    dev = pyr.mass[0].device
    dtype = pyr.mass[0].dtype
    offs, bits = _stencil_tensors(ndim, dev)
    NC = expansion.n_coeffs(ndim, order)

    Lcur = None
    for lvl in range(2, L0 + 1):
        G = 1 << lvl
        Gp = G + 2 * _PAD
        shape = (G,) * ndim
        Mp = torch.nn.functional.pad(
            pyr.mass[lvl].reshape(shape), (_PAD, _PAD) * ndim).reshape(-1)
        Wp = torch.nn.functional.pad(
            pyr.wsum[lvl].reshape(shape + (ndim,)),
            (0, 0) + (_PAD, _PAD) * ndim).reshape(-1, ndim)
        coords = _cell_coords(ndim, lvl, dev)                  # [G^D, D]
        centers = (coords.to(dtype) + 0.5) * (box_size * 2.0 ** -lvl) \
            - box_size / 2
        parity = torch.zeros(G ** ndim, dtype=torch.int64, device=dev)
        for d in range(ndim):
            parity = parity | ((coords[:, d] & 1) << d)

        Ll = torch.zeros((G ** ndim, NC), dtype=dtype, device=dev)
        nb = max(1, _BATCH_ENTRIES // G ** ndim)
        for s in range(0, offs.shape[0], nb):
            o = offs[s:s + nb]                                  # [B, D]
            src = coords[None, :, :] + o[:, None, :] + _PAD     # [B, G^D, D]
            flat = src[..., 0]
            for d in range(1, ndim):                # row-major in padded grid
                flat = flat * Gp + src[..., d]
            Msh = Mp[flat]                                      # [B, G^D]
            Wsh = Wp[flat]                                      # [B, G^D, D]
            ok = ((bits[s:s + nb, None] >> parity[None, :]) & 1) > 0
            m = torch.where(ok & (Msh > 0), Msh, 0.0)
            com = Wsh / torch.clamp(Msh, min=1e-30)[..., None]
            Dv = com - centers[None]
            Ll = Ll + expansion.m2l_terms(Dv, m, eps, order).sum(0)

        if Lcur is not None:
            # L2L: upsample the parent-level expansions and recentre by
            # the parity-dependent child-centre offset
            Lp = Lcur.reshape((G // 2,) * ndim + (NC,))
            for d in range(ndim):
                Lp = torch.repeat_interleave(Lp, 2, dim=d)
            Lp = Lp.reshape(-1, NC)
            s_child = box_size * 2.0 ** -lvl
            shift = torch.stack(
                [(((parity >> d) & 1).to(dtype) - 0.5) * s_child
                 for d in range(ndim)], dim=1)
            Ll = Ll + expansion.l2l(Lp, shift, order)
        Lcur = Ll
    if Lcur is None:   # L0 < 2: no covered pairs, all near
        Lcur = torch.zeros(((1 << L0) ** ndim, NC), dtype=dtype,
                           device=dev)
    return Lcur
