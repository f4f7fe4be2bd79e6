"""gwalk pool evaluation (K2): the plain PyTorch version and the wrapper
of the hand-written CUDA kernel (csrc/pool.cu). Counterpart of
`rakau_tpu.kernels.pallas.eval_pool` / `xla.eval_pool`.

The pool (traversal4.build_pool) is a flat row store; tile g's sources
are the contiguous rows

    [(sched[g, 0] * Wb + sched[g, 1]) * block,
     + (sched[g, 2] + sched[g, 3]) * block)          (Wb = window / block)

its sched[g, 2] node blocks, then its sched[g, 3] particle blocks. There
is no mask: padding rows carry mass 0. For target i and row j the pair
terms are those of kernels/shared.py (self-exclusion by index, r2 <= 0
dead, inv_r = 0 on dead pairs), with the quadrupole correction from
pool_quad on the node blocks only. With `compensated`, each block's
partial sum enters the running sum through TwoSum. Mode "acc" / "pot"
returns the other output as zeros. Padding tiles have m = p = 0.
"""
from __future__ import annotations

import torch

from .shared import _MODES, _check, _quad_terms, _two_sum
from . import shared

# Kernel launches per form, counted where the wrapper launches (the main
# path's proof of use).
FORMS = ("mono", "mono_comp", "quad", "quad_comp")
# and, as in kernels/shared.py, the 2-D ("d2") and float64 ("f64") launches
launches = dict.fromkeys(FORMS + shared.COUNTERS, 0)


def reset_launches():
    for k in launches:
        launches[k] = 0


def _form(quad: bool, compensated: bool) -> str:
    return ("quad" if quad else "mono") + ("_comp" if compensated else "")


def eval_pool_plain(tgt_pos, tgt_idx, pool_pos, pool_mass, pool_idx, sched,
                    window: int, eps, G, block: int,
                    compensated: bool = False, mode: str = "both",
                    pool_quad=None):
    """Plain version: one step per block position k, each tile summing its
    k-th block ([G, T, block] panels; tiles whose segment is shorter
    add exact zeros). Never gathers a tile's whole window.

    tgt_pos [G, T, D], tgt_idx [G, T], pool planes [P, D] / [P] / [P]
    (+ pool_quad [P, Q]), sched [G, 4] -> acc [G, T, D], pot [G, T]."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    Gt, T, D = tgt_pos.shape
    dev = tgt_pos.device
    eps2 = torch.full((), eps, dtype=tgt_pos.dtype, device=dev) ** 2
    acc = torch.zeros_like(tgt_pos)
    pot = torch.zeros_like(tgt_pos[..., 0])
    acc_c = torch.zeros_like(acc)
    pot_c = torch.zeros_like(pot)
    sched = sched.to(torch.int64)
    base = (sched[:, 0] * (window // block) + sched[:, 1]) * block   # [G]
    m_nb = sched[:, 2]
    nb = sched[:, 2] + sched[:, 3]
    ar = torch.arange(block, device=dev)
    for k in range(int(nb.max()) if Gt else 0):
        live = k < nb                                           # [G]
        rows = torch.where(live[:, None], base[:, None] + k * block + ar, 0)
        sp = pool_pos[rows]                                     # [G, B, D]
        sm = torch.where(live[:, None], pool_mass[rows], 0.0)[:, None, :]
        dds = [sp[:, None, :, d] - tgt_pos[:, :, None, d] for d in range(D)]
        r2 = sum(dd * dd for dd in dds) + eps2
        dead = ((pool_idx[rows][:, None, :] == tgt_idx[:, :, None])
                | (r2 <= 0))
        inv_r = torch.where(dead, 0.0, torch.rsqrt(r2))
        w = sm * inv_r
        dacc = dpot = None
        if mode in ("both", "acc"):
            w3 = w * inv_r * inv_r
            dacc = [w3 * dd for dd in dds]
        if mode in ("both", "pot"):
            dpot = -w
        if pool_quad is not None:
            # quadrupole terms on the node blocks only
            qk = (live & (k < m_nb))[:, None, None]
            q = torch.where(qk, pool_quad[rows], 0.0)[:, None]  # [G,1,B,Q]
            qa, qp = _quad_terms(dds, q, 1.0, inv_r, mode)
            if dacc is not None:
                dacc = [a + b for a, b in zip(dacc, qa)]
            if dpot is not None:
                dpot = dpot - qp
        if dacc is not None:
            dacc = torch.stack([x.sum(-1) for x in dacc], dim=-1)
            if compensated:
                acc, e = _two_sum(acc, dacc)
                acc_c += e
            else:
                acc += dacc
        if dpot is not None:
            dpot = dpot.sum(-1)
            if compensated:
                pot, e = _two_sum(pot, dpot)
                pot_c += e
            else:
                pot += dpot
    if compensated:
        acc = acc + acc_c
        pot = pot + pot_c
    return G * acc, G * pot


# ---------------------------------------------------------------- kernel
def eval_pool_fused(tgt_pos, tgt_idx, pool_pos, pool_mass, pool_idx, sched,
                    window: int, eps, G, block: int,
                    compensated: bool = False, mode: str = "both",
                    pool_quad=None):
    """The CUDA kernel (replaces `rakau_tpu.kernels.pallas.eval_pool` in
    its four forms). Same arguments and results as eval_pool_plain; 2-D
    (padded to 3-D) or 3-D float32 or float64 tensors, int64 indices, all
    on one CUDA device; sched [G, 4] of any integer type. Launches on the
    current stream."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    D, f64 = shared.check_real(tgt_pos)
    Gt, T, _ = tgt_pos.shape
    P = pool_pos.shape[0]
    if block <= 0 or window % block:
        raise ValueError(f"window {window} is not a multiple of block "
                         f"{block}")
    real = tgt_pos.dtype
    _check("tgt_pos", tgt_pos, real, (Gt, T, D))
    _check("tgt_idx", tgt_idx, torch.int64, (Gt, T))
    _check("pool_pos", pool_pos, real, (P, D))
    _check("pool_mass", pool_mass, real, (P,))
    _check("pool_idx", pool_idx, torch.int64, (P,))
    if not sched.is_cuda or tuple(sched.shape) != (Gt, 4):
        raise ValueError(f"sched must be a CUDA tensor of shape ({Gt}, 4)")
    named = [("tgt_idx", tgt_idx), ("pool_pos", pool_pos),
             ("pool_mass", pool_mass), ("pool_idx", pool_idx),
             ("sched", sched)]
    if pool_quad is not None:
        _check("pool_quad", pool_quad, real, (P, D * (D + 1) // 2))
        named.append(("pool_quad", pool_quad))
    if Gt >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError("the CUDA kernel takes fewer than 2^31 tiles")
    shared.check_devices(tgt_pos, named)
    if D == 2:
        (tgt_pos, pool_pos), pool_quad = shared.pad_to_3d(
            tgt_pos, pool_pos, quad=pool_quad)
    dev = tgt_pos.device
    acc = torch.empty((Gt, T, 3), dtype=real, device=dev)
    pot = torch.empty((Gt, T), dtype=real, device=dev)
    if Gt == 0 or T == 0:
        return G * acc[..., :D], G * pot
    sched32 = sched.to(torch.int32).contiguous()
    lib = shared._library("pool", f64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rakau_pool(
            tgt_pos.data_ptr(), tgt_idx.data_ptr(), pool_pos.data_ptr(),
            pool_mass.data_ptr(), pool_idx.data_ptr(),
            None if pool_quad is None else pool_quad.data_ptr(),
            sched32.data_ptr(), acc.data_ptr(), pot.data_ptr(),
            Gt, T, window // block, block, _MODES[mode], int(compensated),
            shared.eps2_arg(eps, real), stream)
    shared.raise_on(err, lib, "pool")
    shared.count_launch(launches, _form(pool_quad is not None, compensated),
                        D == 2, f64)
    return G * acc[..., :D], G * pot
