"""Decoupled dense-grid far field (conv-M2L, any order). Counterpart of
`rakau_tpu.grid2`.

  * multipoles are about CELL CENTRES, so the M2L operator for a fixed
    integer cell offset is a linear map [NM -> NL], and the per-level M2L
    over the separation stencil is a convolution: one strided
    `torch.nn.functional.conv{1,2,3}d` per target-parity class (the
    parity masks fold into 2^D kernels);
  * expansions are Cartesian Taylor series of any order: multipole order
    q and local order p are config knobs, and the tensors
    T_gamma = D^gamma (|d|^2 + eps^2)^(-1/2) come from an exact symbolic
    coefficient recursion;
  * L2P is evaluated per particle at its own leaf cell, so nothing of the
    far field refers to tiles: the near field is closed per pair in the
    force kernels by the cell-separation test (sep < grid_sep).

All grid tensors are cell-size-normalized: multipoles
M~_alpha = sum m (delta/s_l)^alpha, locals L~_beta = L_beta s_l^{|beta|+1},
and the M2L kernels are the T tensors at INTEGER cell offsets with
eps/s_l, so every coefficient is O(1) at any level and order. Physical
units come back at L2P.

Coverage: a cell pair at level l with Chebyshev separation sep_l is
handled by the level-l stencil iff S <= sep_l and the parent pair has
sep_{l-1} <= S-1. Since sep_{l+1} >= 2*sep_l - 1, every pair with leaf
separation >= S is covered at exactly one level, and the near field is
the (2S-1)^D-cell neighbourhood.

Precision on the card. The small tables (T tensors, M2L kernels, shift
matrices) are evaluated in float64 and rounded once to the working type.
The convolutions and the shift products run in the working type with
TF32 switched off for their duration (`_full_precision`): PyTorch's
convolutions take TF32 by default, which keeps three digits and would
undo every order above 2. The convolutions also leave cuDNN aside and
take PyTorch's own matrix-product form: for these kernels (11^3 taps at
grid_sep=3, stride 2, 35 to 84 channels) cuDNN's float32 path was
measured 2 to 7 times slower on an H100 and several times less accurate
(chip_smoke.py, phase grid2_layers, times both).
"""
from __future__ import annotations

import itertools
import math
from contextlib import contextmanager
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import morton, particles
from . import scan_utils as su
from .graphs import device_constant
from .grid import rowmajor_cell_index

F64 = torch.float64


@contextmanager
def _full_precision(cudnn: bool = False):
    """float32 convolutions and matrix products in full float32 (no
    TF32) for the duration, whatever the global switches say; the
    convolutions through cuDNN only if `cudnn` (see _parity_conv)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = saved


# ------------------------------------------------------------------ tables
@lru_cache(maxsize=None)
def multi_indices(ndim: int, order: int):
    """All multi-indices |alpha| <= order, graded-lex order.

    Returns (tuple of tuples, {alpha: position}, factorial array)."""
    idx = []
    for total in range(order + 1):
        for alpha in itertools.product(range(total + 1), repeat=ndim):
            if sum(alpha) == total:
                idx.append(alpha)
    lookup = {a: i for i, a in enumerate(idx)}
    fact = np.array([math.prod(math.factorial(a) for a in al)
                     for al in idx], np.float64)
    return tuple(idx), lookup, fact


def n_coeffs(ndim: int, order: int) -> int:
    return math.comb(order + ndim, ndim)


@lru_cache(maxsize=None)
def _t_tensor_terms(ndim: int, gamma: tuple):
    """Symbolic terms of T_gamma = D^gamma (|d|^2 + eps^2)^(-1/2).

    Each term is c * prod_d x_d^{a_d} * rho^{-(2k+1)/2} with
    rho = |d|^2 + eps^2; represented as {(a_tuple, k): c}. Built by
    exact coefficient recursion on differentiation."""
    terms = {(tuple([0] * ndim), 0): 1.0}
    for d in range(ndim):
        for _ in range(gamma[d]):
            new = {}
            for (a, k), c in terms.items():
                # d/dx_d [ x^a rho^{-(2k+1)/2} ]
                if a[d] > 0:
                    am = list(a)
                    am[d] -= 1
                    key = (tuple(am), k)
                    new[key] = new.get(key, 0.0) + c * a[d]
                ap = list(a)
                ap[d] += 1
                key = (tuple(ap), k + 1)
                new[key] = new.get(key, 0.0) - c * (2 * k + 1)
            terms = new
    return tuple(sorted(terms.items()))


@lru_cache(maxsize=None)
def _t_tensor_basis(ndim: int, order: int):
    """The T tensors of all |gamma| <= order as one matrix product: the
    distinct (exponents a, power k) terms as (A [J, D] int64, K [J] int64)
    and the coefficient matrix C [J, NG] float64, so that
    T[..., g] = sum_j C[j, g] * prod_d x_d^{A[j, d]} * rho^{-(2 K[j]+1)/2}."""
    gammas, _, _ = multi_indices(ndim, order)
    cols: dict = {}
    entries = []
    for g, gamma in enumerate(gammas):
        for key, c in _t_tensor_terms(ndim, gamma):
            entries.append((cols.setdefault(key, len(cols)), g, c))
    C = np.zeros((len(cols), len(gammas)), np.float64)
    for j, g, c in entries:
        C[j, g] = c
    A = np.asarray([a for a, _ in cols], np.int64).reshape(len(cols), ndim)
    K = np.asarray([k for _, k in cols], np.int64)
    return A, K, C


@device_constant
def _t_basis_tensors(ndim: int, order: int, device):
    """_t_tensor_basis as tensors on `device` (K, A, C), made once."""
    A, K, C = _t_tensor_basis(ndim, order)
    return (torch.as_tensor(K, device=device),
            torch.as_tensor(A, device=device),
            torch.as_tensor(C, device=device))


def _f64(x, device) -> torch.Tensor:
    """x, a number or a tensor, as a float64 0-d tensor on `device`; a
    number is filled in on the device, not copied from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F64)
    return torch.full((), x, dtype=F64, device=device)


def _powers(x: torch.Tensor, order: int) -> torch.Tensor:
    """x [...] -> [..., order + 1] with x^0 .. x^order, by repeated
    products (0^0 = 1)."""
    cols = [torch.ones_like(x)]
    for _ in range(order):
        cols.append(cols[-1] * x)
    return torch.stack(cols, dim=-1)


def t_tensors(d: torch.Tensor, eps, ndim: int, order: int) -> torch.Tensor:
    """All T_gamma, |gamma| <= order, at offsets d [..., D]: [..., NG] in
    graded-lex order, of d's dtype. Evaluated in float64 (the terms of a
    high-order T cancel by several digits) and rounded once."""
    dev = d.device
    Kt, At, Ct = _t_basis_tensors(ndim, order, dev)
    d64 = d.to(F64)
    rho = (d64 * d64).sum(-1) + _f64(eps, dev) ** 2
    inv = 1.0 / rho
    rpow = torch.rsqrt(rho)[..., None] * _powers(inv, order)   # [..., k]
    basis = rpow[..., Kt]                                      # [..., J]
    for dd in range(ndim):
        basis = basis * _powers(d64[..., dd], order)[..., At[:, dd]]
    return (basis @ Ct).to(d.dtype)


# ------------------------------------------------------------- stencil
@lru_cache(maxsize=None)
def stencil_offsets(ndim: int, sep: int):
    """Offsets with sep <= maxcomp <= 2*sep-1, and per-offset packed
    parity bits: bit(b) = 1 iff the pair is NOT covered at the parent
    level, i.e. maxcomp(floor((b + o)/2)) <= sep-1."""
    pad = 2 * sep - 1
    offs, bits = [], []
    for o in itertools.product(range(-pad, pad + 1), repeat=ndim):
        mc = max(abs(c) for c in o)
        if not (sep <= mc <= pad):
            continue
        mask = 0
        for bidx in range(2 ** ndim):
            b = [(bidx >> d) & 1 for d in range(ndim)]
            q = [(b[d] + o[d]) // 2 for d in range(ndim)]
            if max(abs(c) for c in q) <= sep - 1:
                mask |= 1 << bidx
        if mask:
            offs.append(o)
            bits.append(mask)
    return np.asarray(offs, np.int32), np.asarray(bits, np.int32)


@lru_cache(maxsize=None)
def _m2l_index_maps(ndim: int, p: int, q: int):
    """Static index plumbing for the M2L matrix K[beta, alpha] =
    (-1)^|alpha| T_{alpha+beta} / alpha!: for each (beta, alpha), the
    position of alpha+beta in the order-(p+q) gamma table and the
    scalar coefficient."""
    betas, _, _ = multi_indices(ndim, p)
    alphas, _, afact = multi_indices(ndim, q)
    _, glookup, _ = multi_indices(ndim, p + q)
    NB, NA = len(betas), len(alphas)
    gpos = np.zeros((NB, NA), np.int32)
    coef = np.zeros((NB, NA), np.float64)
    for i, b in enumerate(betas):
        for j, a in enumerate(alphas):
            g = tuple(b[d] + a[d] for d in range(ndim))
            gpos[i, j] = glookup[g]
            coef[i, j] = ((-1.0) ** sum(a)) / afact[j]
    return gpos, coef


@device_constant
def _m2l_tables(ndim: int, p: int, q: int, sep: int, device):
    """The constant operands of m2l_kernels on `device`, made once: the
    offsets d [NO, D] (float64), the gamma position [NL * NM] and the
    coefficient [NL * NM] of each kernel entry, and for each target
    parity the kernel slots and the offsets that fill them."""
    offs_np, bits_np = stencil_offsets(ndim, sep)
    K = 2 * (2 * sep - 1) + 1
    gpos, coef = _m2l_index_maps(ndim, p, q)
    flat_idx = np.zeros(offs_np.shape[0], np.int64)
    for dd in range(ndim):
        flat_idx = flat_idx * K + (offs_np[:, dd] + 2 * sep - 1)
    parity = []
    for b in range(2 ** ndim):
        sel = np.nonzero((bits_np >> b) & 1)[0]
        parity.append((torch.as_tensor(flat_idx[sel], device=device),
                       torch.as_tensor(sel, device=device)))
    return (-torch.as_tensor(offs_np, dtype=F64, device=device),
            torch.as_tensor(gpos.reshape(-1).astype(np.int64),
                            device=device),
            torch.as_tensor(coef.reshape(-1), device=device),
            tuple(parity))


def m2l_kernels(ndim: int, p: int, q: int, sep: int, s_cell, eps,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-parity NORMALIZED M2L conv kernels.

    Returns W [2^D, (K,)*D, NL, NM] with K = 2*(2*sep-1)+1: for target
    parity b, out_L~[t] += sum_o W[b, o+pad, :, :] @ M~[t+o], where M~
    are cell-normalized multipoles and L~_beta = L_beta s^{|beta|+1}. By
    the homogeneity T_gamma(s d) = s^{-(1+|gamma|)} T_gamma(d) (with
    eps -> eps/s), the normalized kernel is T at the INTEGER offsets with
    eps/s_cell: every entry O(1).

    The result is a view of a tensor laid out [2^D, NL, NM, (K,)*D], the
    layout the convolutions take, so `_parity_conv` copies nothing."""
    K = 2 * (2 * sep - 1) + 1
    d, gpos, coef, parity = _m2l_tables(ndim, p, q, sep, device)
    eps_n = _f64(eps, device) / _f64(s_cell, device)
    T = t_tensors(d, eps_n, ndim, p + q)                        # [NO, NG]
    NL, NM = n_coeffs(ndim, p), n_coeffs(ndim, q)
    Kmat = T[:, gpos] * coef
    Kmat = Kmat.T.to(dtype)                                     # [NL*NM, NO]
    W = torch.zeros((2 ** ndim, NL * NM, K ** ndim), dtype=dtype,
                    device=device)
    for b, (slots, sel) in enumerate(parity):
        W[b][:, slots] = Kmat[:, sel]
    W = W.reshape((2 ** ndim, NL, NM) + (K,) * ndim)
    return W.permute((0,) + tuple(range(3, 3 + ndim)) + (1, 2))


# ----------------------------------------------------- shift operators
@lru_cache(maxsize=None)
def _shift_maps(ndim: int, order: int, kind: str):
    """Static structure of the M2M / L2L shift matrices.

    M2M: A'_alpha = sum_{beta<=alpha} C(alpha,beta) t^{alpha-beta} A_beta
    L2L: A'_beta  = sum_{beta'>=beta} t^{beta'-beta}/(beta'-beta)! A_beta'
    Returns a tuple of (row, col, exponent tuple, coeff)."""
    idx, _, _ = multi_indices(ndim, order)
    out = []
    for i, a in enumerate(idx):
        for j, b in enumerate(idx):
            if kind == "m2m":
                # row i (parent alpha) from col j (child beta), beta <= alpha
                if all(b[d] <= a[d] for d in range(ndim)):
                    e = tuple(a[d] - b[d] for d in range(ndim))
                    c = math.prod(math.comb(a[d], b[d]) for d in range(ndim))
                    out.append((i, j, e, float(c)))
            else:
                # row i (new beta) from col j (old beta'), beta' >= beta
                if all(b[d] >= a[d] for d in range(ndim)):
                    e = tuple(b[d] - a[d] for d in range(ndim))
                    c = 1.0 / math.prod(math.factorial(b[d] - a[d])
                                        for d in range(ndim))
                    out.append((i, j, e, c))
    return tuple(out)


@lru_cache(maxsize=None)
def _shift_arrays(ndim: int, order: int, kind: str, halving: bool):
    """_shift_maps as arrays: flat positions [E], exponents [E, D] and
    coefficients [E] (the halving scale folded in)."""
    entries = _shift_maps(ndim, order, kind)
    NC = n_coeffs(ndim, order)
    deg = [sum(a) for a in multi_indices(ndim, order)[0]]

    def scale(i, j):
        if not halving:
            return 1.0
        return 0.5 ** deg[j] if kind == "m2m" else 0.5 ** (deg[i] + 1)

    flat = np.asarray([i * NC + j for i, j, _, _ in entries], np.int64)
    expo = np.asarray([e for _, _, e, _ in entries], np.int64).reshape(
        len(entries), ndim)
    coef = np.asarray([c * scale(i, j) for i, j, _, c in entries],
                      np.float64)
    return flat, expo, coef


def shift_matrix(t, ndim: int, order: int, kind: str,
                 halving: bool = False, dtype=None,
                 device=None) -> torch.Tensor:
    """Dense shift matrix [NC, NC] for translation t [D] (a tensor or a
    sequence of numbers), evaluated in float64 and rounded to `dtype`
    (t's own when it is a tensor, else float32).

    halving=True produces the NORMALIZED one-level pyramid shift, with
    `t` in PARENT-cell units (components +-1/4 for an octree step):
      m2m (child->parent): entry *= (1/2)^{|beta_col|}, so that parent
        M~ in parent units comes from child M~ in child units;
      l2l (parent->child): entry *= (1/2)^{|beta_row|+1}, mapping parent
        L~ to child L~. All entries stay O(1) at any depth."""
    if isinstance(t, torch.Tensor):
        dtype = dtype or t.dtype
        device = device or t.device
    dtype = dtype or torch.float32
    NC = n_coeffs(ndim, order)
    flat, expo, coef = _shift_arrays(ndim, order, kind, halving)
    pw = _powers(torch.as_tensor(t, dtype=F64, device=device), order)
    vals = torch.as_tensor(coef, device=device)
    expo_t = torch.as_tensor(expo, device=device)
    for d in range(ndim):
        vals = vals * pw[d, expo_t[:, d]]
    M = torch.zeros(NC * NC, dtype=F64, device=device)
    M[torch.as_tensor(flat, device=device)] = vals
    return M.reshape(NC, NC).to(dtype)


@device_constant
def _parity_shifts(ndim: int, order: int, kind: str, dtype, device):
    """The 2^D halving shift matrices of one pyramid step, by parity
    bidx = sum_d b_d << d: t = (b - 1/2)/2 in parent-cell units; made
    once for each argument tuple."""
    return tuple(shift_matrix([(((bidx >> d) & 1) - 0.5) * 0.5
                          for d in range(ndim)], ndim, order, kind,
                         halving=True, dtype=dtype, device=device)
                 for bidx in range(2 ** ndim))


# ------------------------------------------------------------- binning
def particle_cells(pos: torch.Tensor, box_size, depth: int,
                   L0: int) -> torch.Tensor:
    """Leaf-grid cells [N, D] int64 of positions [N, D]: the cell of each
    particle at level L0 of the depth-`depth` grid. Every coverage test
    (pyramid binning, L2P, the kernel's per-pair test, the walk's range
    test) uses this one map, so that rounding at a cell face cannot put a
    particle in one cell on one side of a test and in another on the
    other."""
    return particles.discretize(pos, box_size, depth) >> (depth - L0)


def cell_centers_of(cell: torch.Tensor, box_size, L0: int, dtype):
    s0 = box_size * (2.0 ** -L0)
    return (cell.to(dtype) + 0.5) * s0 - box_size / 2


@device_constant
def _exponents(idx, device):
    """Multi-indices idx (a tuple of NC tuples) as an [NC, D] int64
    tensor on `device`, made once."""
    return torch.as_tensor(np.asarray(idx, np.int64).reshape(len(idx), -1),
                           device=device)


def _monomials(x: torch.Tensor, idx, order: int) -> torch.Tensor:
    """x [N, D], multi-indices idx (a tuple of NC tuples) ->
    [N, NC] with prod_d x_d^{a_d}."""
    At = _exponents(idx, x.device)
    out = None
    for d in range(x.shape[1]):
        col = _powers(x[:, d], order)[:, At[:, d]]
        out = col if out is None else out * col
    return out


class Pyramid2(NamedTuple):
    """Cell-centred multipole grids, levels 0..L0 (row-major [G^D, NM])."""
    mom: tuple


def build_pyramid(td, cfg, L0: int, q: int) -> Pyramid2:
    """Bin Morton-sorted particles into leaf-cell multipoles and reduce
    upward with parity shift matrices.

    Scatter-free over particles, hence deterministic: the particles of a
    cell are contiguous in Morton order, so a float64 prefix sum read at
    the cell bounds gives each cell's moments; only the [G^D]-sized
    Morton -> row-major relayout scatters (cells, to distinct rows). The
    prefix sums run along the contiguous axis of an [NM, N] panel: a scan
    down the rows of [N, NM] leaves the card one thread per column."""
    n, ndim = td.pos.shape
    dtype = td.pos.dtype
    dev = td.pos.device
    G = 1 << L0
    ncells = G ** ndim
    alphas, _, _ = multi_indices(ndim, q)
    NM = len(alphas)

    cl0 = particle_cells(td.pos, td.box_size, cfg.max_depth, L0)
    mid = morton.encode(cl0, ndim, L0)
    cell_ids = torch.arange(ncells + 1, device=dev)
    bounds = su.searchsorted_1d(mid, cell_ids)
    # moments in cell units about the own cell's centre (|delta| <= 1/2)
    s0 = td.box_size * (2.0 ** -L0)
    delta = (td.pos - cell_centers_of(cl0, td.box_size, L0, dtype)) / s0
    vals = td.mass[:, None] * _monomials(delta, alphas, q)        # [N, NM]
    pref = F.pad(torch.cumsum(vals.T.to(F64), dim=1), (1, 0))     # [NM, N+1]
    mom_m = (pref[:, bounds[1:]] - pref[:, bounds[:-1]]).T.to(dtype)
    flat = rowmajor_cell_index(morton.decode(cell_ids[:-1], ndim, L0), ndim,
                               L0)
    mom_l0 = torch.empty((ncells, NM), dtype=dtype, device=dev)
    mom_l0[flat] = mom_m

    moms = {L0: mom_l0}
    shifts = _parity_shifts(ndim, q, "m2m", dtype, dev)
    with _full_precision():
        for lvl in range(L0 - 1, -1, -1):
            Gc = 1 << (lvl + 1)
            cview = moms[lvl + 1].reshape((Gc // 2, 2) * ndim + (NM,))
            parts = None
            for bidx, S in enumerate(shifts):
                sl = ()
                for d in range(ndim):
                    sl = sl + (slice(None), (bidx >> d) & 1)
                contrib = cview[sl] @ S.T
                parts = contrib if parts is None else parts + contrib
            moms[lvl] = parts.reshape(-1, NM)
    return Pyramid2(mom=tuple(moms[lvl] for lvl in range(L0 + 1)))


# ------------------------------------------------------------- M2L conv
def _interleave_parity(parts, ndim: int, lead: int) -> torch.Tensor:
    """Merge 2^D per-parity tensors into the full grid.

    parts[bidx] has shape lead_dims + (G/2,)*ndim + tail, with
    bidx = sum_d b_d << d; returns lead_dims + (G,)*ndim + tail where
    out[..., 2x_d + b_d, ...] = parts[bidx][..., x_d, ...]. `lead` is the
    number of leading (non-spatial) axes."""
    p0 = parts[0]
    shape = list(p0.shape)
    for d in range(ndim):
        shape[lead + d] *= 2
    out = torch.empty(shape, dtype=p0.dtype, device=p0.device)
    for bidx, part in enumerate(parts):
        sl = (slice(None),) * lead + tuple(
            slice((bidx >> d) & 1, None, 2) for d in range(ndim))
        out[sl] = part
    return out


_CONVS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _parity_conv(M: torch.Tensor, W: torch.Tensor, ndim: int, G: int,
                 cudnn: bool = False) -> torch.Tensor:
    """out[t] = sum_o W[parity(t), ..o.., :, :] @ M[t+o] via 2^D
    convolutions of stride 2. M [G^D, NM]; W [2^D, (K,)*D, NL, NM] (as
    m2l_kernels returns it); returns [G^D, NL]. `cudnn` lets the
    convolutions go through cuDNN (for comparison; the port does not)."""
    NM = M.shape[-1]
    NL = W.shape[-2]
    K = W.shape[1]
    pad = (K - 1) // 2
    lhs = M.reshape((1,) + (G,) * ndim + (NM,)).movedim(-1, 1)
    lhsp = F.pad(lhs, (pad, pad) * ndim)              # [1, NM, G + 2 pad..]
    outs = []
    with _full_precision(cudnn):
        for bidx in range(2 ** ndim):
            # out_b[x] = sum_k lhsp[2x + b_d + k] W_b[k]: valid, stride 2
            sl = (slice(None), slice(None)) + tuple(
                slice((bidx >> d) & 1, ((bidx >> d) & 1) + G - 1 + K)
                for d in range(ndim))
            rhs = W[bidx].movedim((-2, -1), (0, 1))   # [NL, NM, K...]
            outs.append(_CONVS[ndim](lhsp[sl].contiguous(),
                                     rhs.contiguous(), stride=2))
    full = _interleave_parity(outs, ndim, lead=2)     # [1, NL, G...]
    return full.movedim(1, -1).reshape(-1, NL)


def dense_far_field(pyr: Pyramid2, cfg, L0: int, box_size, eps,
                    p: int, q: int, sep: int) -> torch.Tensor:
    """M2L conv at every level + L2L chain; returns NORMALIZED leaf local
    coefficients [G^D, NL] about cell centres (L~_beta =
    L_beta s0^{|beta|+1}; l2p_particles brings the units back).

    One level's kernels W are alive at a time. They depend on the level
    through eps/s_l only, so with eps = 0 one W serves every level."""
    ndim = cfg.ndim
    dtype = pyr.mom[0].dtype
    dev = pyr.mom[0].device
    NL = n_coeffs(ndim, p)
    Lcur = W = None
    shifts = _parity_shifts(ndim, p, "l2l", dtype, dev)
    for lvl in range(2, L0 + 1):
        G = 1 << lvl
        if W is None or eps != 0:
            W = None            # free the previous level's before the next
            W = m2l_kernels(ndim, p, q, sep, box_size * (2.0 ** -lvl), eps,
                            dtype, dev)
        Ll = _parity_conv(pyr.mom[lvl], W, ndim, G)
        if Lcur is not None:
            # L2L: parent expansions recentred to the children
            Lp = Lcur.reshape((G // 2,) * ndim + (NL,))
            with _full_precision():
                cur = _interleave_parity([Lp @ S.T for S in shifts], ndim,
                                         lead=0)
            Ll = Ll + cur.reshape(-1, NL)
        Lcur = Ll
    if Lcur is None:
        Lcur = torch.zeros(((1 << L0) ** ndim, NL), dtype=dtype, device=dev)
    return Lcur


# ---------------------------------------------------------------- L2P
@device_constant
def _l2p_tables(ndim: int, p: int, dtype, device):
    """l2p_particles' constant operands on `device`, made once: 1/beta!'s
    denominators [NL] in dtype, the rows |beta| <= p - 1 and, for each
    dimension d, the rows beta + e_d that those read."""
    betas, lookup, fact = multi_indices(ndim, p)
    low = [i for i, b in enumerate(betas) if sum(b) <= p - 1]
    ups = tuple(
        torch.as_tensor([lookup[betas[i][:d] + (betas[i][d] + 1,)
                                + betas[i][d + 1:]] for i in low],
                        device=device)
        for d in range(ndim))
    return (torch.as_tensor(fact, dtype=dtype, device=device),
            torch.as_tensor(low, device=device), ups)


def l2p_particles(Lleaf, cells, pos, box_size, L0: int, G_grav, p: int):
    """Per-particle evaluation of the (normalized) leaf-cell locals.

    Lleaf [ncells, NL] row-major NORMALIZED coefficients; cells [N, D]
    each particle's leaf cell; pos [N, D]. Returns (acc [N, D], pot [N])
    scaled by G. With u = s/s0: pot = -(G/s0) sum L~_b u^b / b!,
    acc_d = (G/s0^2) sum_{|b|<=p-1} L~_{b+e_d} u^b / b!."""
    ndim = pos.shape[1]
    dtype = pos.dtype
    dev = pos.device
    betas = multi_indices(ndim, p)[0]
    fact_t, low_t, ups = _l2p_tables(ndim, p, dtype, dev)
    L = Lleaf[rowmajor_cell_index(cells, ndim, L0)]   # [N, NL] gather
    s0 = box_size * (2.0 ** -L0)
    s = (pos - cell_centers_of(cells, box_size, L0, dtype)) / s0
    w = _monomials(s, betas, p) / fact_t
    psi = (L * w).sum(1)
    wl = w[:, low_t]
    accs = []
    for up in ups:
        accs.append((L[:, up] * wl).sum(1))
    return ((G_grav / (s0 * s0)) * torch.stack(accs, dim=-1),
            -(G_grav / s0) * psi)


# ------------------------------------------------------------ top level
def effective_grid_level(cfg, n: int) -> int:
    """Leaf-grid level for grid2: occupancy-targeted, memory-capped,
    decoupled from ncrit.

    gwalk clips target tiles at leaf-grid cells (its pool-row coverage
    drop needs single-cell tiles), so there the auto level tracks the tile
    size (~n/ncrit cells) as farfield="grid" does: a deep occupancy-32
    grid would shatter every tile into ~32-particle fragments. Set
    grid_level to override."""
    if cfg.grid_level is not None:
        return cfg.grid_level
    cap = {1: 21, 2: 10, 3: 7}[cfg.ndim]   # <= ~2M cells
    if cfg.traversal_mode == "gwalk":
        if n <= cfg.ncrit:
            return 0
        l0 = int(math.floor(math.log(max(n / cfg.ncrit, 1.0),
                                     2 ** cfg.ndim)))
        return max(0, min(l0, cap, cfg.max_depth))
    if n <= max(cfg.grid_occupancy, 1):
        return 0
    l0 = int(round(math.log(n / max(cfg.grid_occupancy, 1), 2 ** cfg.ndim)))
    return max(0, min(l0, cap, cfg.max_depth))


def grid_orders(cfg):
    """(local order p, multipole order q) of the grid2 far field."""
    q = (cfg.grid_multipole_order if cfg.grid_multipole_order is not None
         else cfg.local_order)
    return cfg.local_order, q


def leaf_locals(td, cfg, eps):
    """The tree's normalized leaf locals and leaf cells: (Lleaf [G^D, NL],
    cells [N, D]), or None when the grid has no level (L0 <= 0). They
    depend on the tree and eps, not on theta or G."""
    L0 = effective_grid_level(cfg, td.pos.shape[0])
    if L0 <= 0:
        return None
    p, q = grid_orders(cfg)
    pyr = build_pyramid(td, cfg, L0, q)
    Lleaf = dense_far_field(pyr, cfg, L0, td.box_size, eps, p, q,
                            cfg.grid_sep)
    return Lleaf, particle_cells(td.pos, td.box_size, cfg.max_depth, L0)


def far_field(td, cfg, eps, G_grav, locals_=None):
    """Full grid2 far field: (acc_far [N, D], pot_far [N]) covering all
    pairs with leaf-cell separation >= cfg.grid_sep. `locals_`: what
    leaf_locals(td, cfg, eps) returned, when the caller kept it."""
    n = td.pos.shape[0]
    L0 = effective_grid_level(cfg, n)
    if L0 <= 0:
        return torch.zeros_like(td.pos), torch.zeros_like(td.pos[:, 0])
    if locals_ is None:
        locals_ = leaf_locals(td, cfg, eps)
    Lleaf, cells = locals_
    return l2p_particles(Lleaf, cells, td.pos, td.box_size, L0, G_grav,
                         cfg.local_order)
