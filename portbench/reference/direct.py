"""The plain reference: the float64 direct sum, and a leapfrog step of it at
sampled particles. Plain PyTorch, on whatever device the tensors lie;
it imports nothing of the program.

Softened Newtonian gravity with G = 1, as the configurations state it:
acc_i = sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^(3/2) and
pot_i = -sum_j m_j / (|x_j - x_i|^2 + eps^2)^(1/2), the term j = i left
out by index."""
from __future__ import annotations

import torch

# sources a pass, and the memory a pass may take on the card: a pass makes
# a few [targets, sources] float64 temporaries
SOURCE_BLOCK = 1 << 20
PASS_BYTES = 1 << 30


def direct_sum(src_pos, src_mass, tgt_pos, tgt_idx=None, eps: float = 0.0,
               G: float = 1.0, dtype=torch.float64):
    """(acc [k, 3], pot [k]) at the targets tgt_pos [k, 3] from every
    source (src_pos [n, 3], src_mass [n]); tgt_idx [k] names each target's
    own row among the sources, whose term is left out (None: no target is
    a source). Computed and accumulated in `dtype`: float64, or a lower
    precision for the checks' control."""
    dev = src_pos.device
    src = src_pos.to(dtype)
    m = src_mass.to(dtype)
    tgt = tgt_pos.to(device=dev, dtype=dtype)
    k, n = tgt.shape[0], src.shape[0]
    idx = (torch.full((k,), -1, dtype=torch.int64, device=dev)
           if tgt_idx is None else torch.as_tensor(tgt_idx, device=dev))
    acc = torch.zeros((k, 3), dtype=dtype, device=dev)
    pot = torch.zeros(k, dtype=dtype, device=dev)
    sb = min(SOURCE_BLOCK, n)
    tb = max(1, PASS_BYTES // (8 * 8 * sb))
    eps2 = float(eps) ** 2
    for t0 in range(0, k, tb):
        t = tgt[t0:t0 + tb]
        ti = idx[t0:t0 + tb, None]
        for s0 in range(0, n, sb):
            d = src[None, s0:s0 + sb] - t[:, None]             # [c, s, 3]
            r2 = (d * d).sum(-1) + eps2
            own = ti == torch.arange(s0, s0 + d.shape[1], device=dev)
            inv_r = torch.where(own, 0.0, r2.rsqrt())
            w = m[None, s0:s0 + sb] * inv_r
            pot[t0:t0 + tb] -= w.sum(1)
            acc[t0:t0 + tb] += torch.einsum("cs,csd->cd", w * inv_r * inv_r,
                                            d)
    return G * acc, G * pot


def kicks(pos, vel, mass, rows, dt: float, eps: float,
          dtype=torch.float64):
    """One kick-drift-kick leapfrog step of the direct sum, at the sampled
    rows of the state (pos, vel [n, 3], mass [n]). Returns (pos1 [k, 3],
    vel1 [k, 3]) of those rows, computed in `dtype` (float64, or a lower
    precision for the checks' control).

    The first half-kick and the drift are exact. The second half-kick
    takes its sources at pos + dt * vel, short by dt^2 / 2 * acc of their
    drifted places (about 5e-7 of a unit at dt = 1e-3 and |acc| <= 1),
    whose effect on a softened force is some 1e-6 of it: the reference
    would otherwise need the forces at every particle."""
    rows = torch.as_tensor(rows, device=pos.device)
    x = pos.to(dtype)
    v = vel.to(dtype)
    a0, _ = direct_sum(x, mass, x[rows], rows, eps, dtype=dtype)
    vh = v[rows] + 0.5 * dt * a0
    x1 = x[rows] + dt * vh
    a1, _ = direct_sum(x + dt * v, mass, x1, rows, eps, dtype=dtype)
    return x1, vh + 0.5 * dt * a1
