"""Tile-local far-field expansions (M2L + L2P, L2L). Counterpart of
`rakau_tpu.expansion`; the same conventions and coefficient order.

For a source monopole (mass m at COM y) let u(x) = (|y - x|^2 + eps^2)^(-1/2).
The kernels accumulate pot(x) = -G * sum m u and acc(x) = G * grad_x sum m u,
so psi = sum m u is Taylor-expanded about the tile centre c:

    psi(c + s) ~= P0 + P1.s + 1/2 s^T H s + 1/6 P3[s,s,s]

    P0     = sum m u
    P1_a   = sum m D_a u^3                       D = y - c
    H_ab   = sum m (3 D_a D_b u^5 - delta_ab u^3)
    P3_abc = sum m (15 D_a D_b D_c u^7
                    - 3 (delta_ab D_c + delta_ac D_b + delta_bc D_a) u^5)

Symmetric tensors are stored by unique component (H: D(D+1)/2,
P3: D(D+1)(D+2)/6).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from .particles import scalar_tensor


@lru_cache(maxsize=None)
def sym_indices(ndim: int):
    """(pairs, triples) of unique symmetric index tuples with their
    permutation multiplicities."""
    pairs = []
    for a in range(ndim):
        for b in range(a, ndim):
            pairs.append(((a, b), 1 if a == b else 2))
    triples = []
    for a in range(ndim):
        for b in range(a, ndim):
            for c in range(b, ndim):
                if a == b == c:
                    mult = 1
                elif a == b or b == c or a == c:
                    mult = 3
                else:
                    mult = 6
                triples.append(((a, b, c), mult))
    return tuple(pairs), tuple(triples)


def n_coeffs(ndim: int, order: int) -> int:
    pairs, triples = sym_indices(ndim)
    n = 1 + ndim + len(pairs)
    if order >= 3:
        n += len(triples)
    return n


def m2l_terms(Dv: torch.Tensor, m: torch.Tensor, eps, order: int = 3):
    """Per-source local-expansion contributions (no reduction).

    Dv [..., D]: source position minus expansion centre; m [...]: masked
    source mass (0 = inert); eps a number or a 0-dim tensor, squared in
    Dv's dtype as the reference squares it. Returns [..., NC]."""
    ndim = Dv.shape[-1]
    pairs, triples = sym_indices(ndim)
    eps2 = scalar_tensor(eps, Dv) ** 2

    d2 = (Dv * Dv).sum(-1) + eps2
    u2 = torch.where(d2 > 0, 1.0 / d2, 0.0)
    u = torch.sqrt(u2)
    mu = m * u
    mu3 = mu * u2
    mu5 = mu3 * u2
    mu7 = mu5 * u2

    cols = [mu]                                             # P0
    for a in range(ndim):                                   # P1
        cols.append(mu3 * Dv[..., a])
    for (a, b), _ in pairs:                                 # H (unique)
        h = 3.0 * mu5 * Dv[..., a] * Dv[..., b]
        if a == b:
            h = h - mu3
        cols.append(h)
    if order >= 3:
        for (a, b, c), _ in triples:                        # P3 (unique)
            t = 15.0 * mu7 * Dv[..., a] * Dv[..., b] * Dv[..., c]
            if a == b:
                t = t - 3.0 * mu5 * Dv[..., c]
            if a == c:
                t = t - 3.0 * mu5 * Dv[..., b]
            if b == c:
                t = t - 3.0 * mu5 * Dv[..., a]
            cols.append(t)
    return torch.stack(cols, dim=-1)


def m2l(center, node_pos, node_mass, far_mask, eps, order: int = 3):
    """Accumulate far nodes into per-tile local expansions.

    center [C, D]; node_pos [U, D]; node_mass [U]; far_mask [C, U] bool;
    returns L [C, NC]."""
    Dv = node_pos[None, :, :] - center[:, None, :]          # [C, U, D]
    m = torch.where(far_mask, node_mass[None, :], 0.0)      # [C, U]
    return m2l_terms(Dv, m, eps, order).sum(1)


def l2p(L, center, tgt_pos, G, order: int = 3):
    """Evaluate local expansions at target particles.

    L [C, NC]; center [C, D]; tgt_pos [C, T, D]; returns
    (acc [C, T, D], pot [C, T]) scaled by G (a number or a 0-dim
    tensor)."""
    ndim = tgt_pos.shape[-1]
    pairs, triples = sym_indices(ndim)
    s = tgt_pos - center[:, None, :]                        # [C, T, D]

    k = 0
    P0 = L[:, k, None]
    k += 1
    P1 = [L[:, k + d, None] for d in range(ndim)]
    k += ndim
    Hu = {}
    for (a, b), _ in pairs:
        Hu[(a, b)] = L[:, k, None]
        k += 1

    def H(a, b):
        return Hu[(a, b) if a <= b else (b, a)]

    psi = P0
    acc = []
    for d in range(ndim):
        psi = psi + P1[d] * s[..., d]
        acc.append(P1[d] + sum(H(d, b) * s[..., b] for b in range(ndim)))
    for (a, b), mult in pairs:
        psi = psi + (0.5 * mult) * Hu[(a, b)] * s[..., a] * s[..., b]

    if order >= 3:
        Tu = {}
        for (a, b, c), _ in triples:
            Tu[(a, b, c)] = L[:, k, None]
            k += 1

        def T3(a, b, c):
            return Tu[tuple(sorted((a, b, c)))]

        for (a, b, c), mult in triples:
            psi = psi + (mult / 6.0) * Tu[(a, b, c)] * (
                s[..., a] * s[..., b] * s[..., c])
        for d in range(ndim):
            g = 0.0
            for (a, b), mult in pairs:
                g = g + (0.5 * mult) * T3(d, a, b) * s[..., a] * s[..., b]
            acc[d] = acc[d] + g

    G = scalar_tensor(G, L)
    return G * torch.stack(acc, dim=-1), -G * psi


def l2l(L, shift, order: int = 3):
    """Re-centre local expansions from c to c' = c + shift (exact
    polynomial recentring).

    With psi(s) = P0 + P1.s + 1/2 s^T H s + 1/6 P3[s,s,s] and s = shift + s':
      P0' = psi(shift)
      P1'_d = P1_d + (H shift)_d + 1/2 P3[d, shift, shift]
      H'_ab = H_ab + P3[a, b, shift]
      P3' = P3

    L [..., NC]; shift [..., D]; returns [..., NC]."""
    ndim = shift.shape[-1]
    pairs, triples = sym_indices(ndim)
    t = [shift[..., d] for d in range(ndim)]

    k = 0
    P0 = L[..., k]
    k += 1
    P1 = [L[..., k + d] for d in range(ndim)]
    k += ndim
    Hu = {}
    for (a, b), _ in pairs:
        Hu[(a, b)] = L[..., k]
        k += 1

    def H(a, b):
        return Hu[(a, b) if a <= b else (b, a)]

    P0n = P0 + sum(P1[d] * t[d] for d in range(ndim))
    for (a, b), mult in pairs:
        P0n = P0n + (0.5 * mult) * Hu[(a, b)] * t[a] * t[b]
    P1n = [P1[d] + sum(H(d, b) * t[b] for b in range(ndim))
           for d in range(ndim)]
    Hn = dict(Hu)

    if order >= 3:
        Tu = {}
        for (a, b, c), _ in triples:
            Tu[(a, b, c)] = L[..., k]
            k += 1

        def T3(a, b, c):
            return Tu[tuple(sorted((a, b, c)))]

        for (a, b, c), mult in triples:
            P0n = P0n + (mult / 6.0) * Tu[(a, b, c)] * t[a] * t[b] * t[c]
        for d in range(ndim):
            g = 0.0
            for (a, b), mult in pairs:
                g = g + (0.5 * mult) * T3(d, a, b) * t[a] * t[b]
            P1n[d] = P1n[d] + g
        for (a, b), _ in pairs:
            Hn[(a, b)] = Hn[(a, b)] + sum(
                T3(a, b, c) * t[c] for c in range(ndim))

    cols = [P0n] + P1n + [Hn[key] for key, _ in pairs]
    if order >= 3:
        cols += [Tu[key] for key, _ in triples]
    return torch.stack(cols, dim=-1)


def far_split(center, radius2, node_pos, node_mass, mask, gamma):
    """Gate accepted nodes between the local-expansion far path and the
    per-particle kernel path.

    center [C, D]; radius2 [C] squared tile half-diagonals; node_pos
    [U, D]; mask [C, U] (MAC-accepted). A node goes far iff
    dist(center, COM)^2 > gamma^2 * radius2 (rho <= 1/gamma). Returns
    (far_mask, near_mask)."""
    Dv = node_pos[None, :, :] - center[:, None, :]
    d2 = (Dv * Dv).sum(-1)                                  # [C, U]
    g2 = torch.full((), gamma, dtype=center.dtype,
                    device=center.device) ** 2
    far = mask & (d2 > g2 * radius2[:, None]) & (node_mass[None, :] > 0)
    return far, mask & ~far
