"""Exact O(N^2) direct-summation accelerations and potentials.

Counterpart of `rakau_tpu.direct`:

- `direct_acc_pot`: torch, chunked over targets so the [N, N] pairwise
  panel never materialises; runs on the tensors' device and dtype.
- `direct_acc_pot_np`: the float64 NumPy oracle, the same code as the
  reference's (pure NumPy, so it runs where JAX is absent).

Conventions (shared with the tree kernels):
  acc_i = G * sum_{j != i} m_j * (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}
  pot_i = -G * sum_{j != i} m_j / (|x_j - x_i|^2 + eps^2)^{1/2}
Plummer softening; the self term is excluded by index.
"""
from __future__ import annotations

import numpy as np
import torch


def direct_acc_pot(pos: torch.Tensor, mass: torch.Tensor, eps=0.0, G=1.0,
                   chunk: int = 2048):
    """Exact accelerations [N, D] and potentials [N] for all particles."""
    n = pos.shape[0]
    acc = torch.empty_like(pos)
    pot = torch.empty_like(mass)
    eps2 = float(eps) ** 2
    # keep the [chunk, N, D] panel near 2^26 entries
    chunk = max(1, min(chunk, (1 << 26) // max(n, 1)))
    src_idx = torch.arange(n, device=pos.device)
    for s in range(0, n, chunk):
        t = pos[s:s + chunk]
        d = pos[None, :, :] - t[:, None, :]               # [c, N, D]
        r2 = (d * d).sum(-1) + eps2
        inv_r = torch.rsqrt(r2)
        tid = torch.arange(s, s + t.shape[0], device=pos.device)
        inv_r = torch.where(tid[:, None] == src_idx[None, :], 0.0, inv_r)
        w = mass[None, :] * inv_r
        pot[s:s + chunk] = -G * w.sum(1)
        acc[s:s + chunk] = G * torch.einsum("tn,tnd->td",
                                            w * inv_r * inv_r, d)
    return acc, pot


def direct_acc_pot_np(pos, mass, eps=0.0, G=1.0, targets=None,
                      chunk=1024):
    """Float64 NumPy oracle. `targets`: optional index subset (for large N,
    sample-based error estimation)."""
    pos = np.asarray(pos, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    n, ndim = pos.shape
    if targets is None:
        targets = np.arange(n)
    targets = np.asarray(targets)
    acc = np.zeros((len(targets), ndim))
    pot = np.zeros(len(targets))
    e2 = float(eps) ** 2
    # cap the [chunk, N, D] pairwise panel at ~1.5 GB of float64
    # intermediates
    chunk = max(1, min(chunk, (1 << 26) // max(n, 1)))
    for s in range(0, len(targets), chunk):
        t = targets[s:s + chunk]
        d = pos[None, :, :] - pos[t][:, None, :]       # [c, N, D]
        r2 = np.einsum("cnd,cnd->cn", d, d) + e2
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_r = 1.0 / np.sqrt(r2)
        self_mask = t[:, None] == np.arange(n)[None, :]
        inv_r[self_mask] = 0.0
        w = mass[None, :] * inv_r
        pot[s:s + chunk] = -G * w.sum(axis=1)
        acc[s:s + chunk] = G * np.einsum("cn,cnd->cd", w * inv_r ** 2, d)
    return acc, pot
