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
pool_quad on the node blocks only. Mode "acc" / "pot" returns the other
output as zeros. Padding tiles have m = p = 0.

The plan (kernels/rows.py): each pool block is ceil(block / GRANULE)
granules, runs of GRANULE rows (the last one ragged where GRANULE does
not divide the block); a tile's segment is its blocks' granules in row
order, cut into spans of SPAN granules (QUAD_SPAN with the quadrupole).
With `compensated`, each
granule's partial enters its span's sum through TwoSum, and the spans'
sums enter the total through TwoSum: the reference's per-block TwoSum
with the granule as the block.
"""
from __future__ import annotations

import torch

from .shared import _MODES, _check, _quad_terms
from . import rows, shared

# Kernel launches per form, counted where the wrapper launches (the main
# path's proof of use).
FORMS = ("mono", "mono_comp", "quad", "quad_comp")
# and, as in kernels/shared.py, the 2-D ("d2") and float64 ("f64") launches
launches = dict.fromkeys(FORMS + shared.COUNTERS, 0)
GRANULE = rows.GRANULE
# granules a span, handed to each launch: SPAN in the monopole forms,
# QUAD_SPAN in the quadrupole ones, whose granules cost ~3x as much
# (ab_kernels.py's span sweep on the 1M pools)
SPAN, QUAD_SPAN = 4, 2


def reset_launches():
    for k in launches:
        launches[k] = 0


def _form(quad: bool, compensated: bool) -> str:
    return ("quad" if quad else "mono") + ("_comp" if compensated else "")


def form_span(quad: bool) -> int:
    """The span of the kernel's monopole or quadrupole forms."""
    return QUAD_SPAN if quad else SPAN


def granules_per_block(block: int, granule: int = GRANULE) -> int:
    return -(-block // granule)


def pool_granules(sched, window: int, block: int, P: int,
                  granule: int = GRANULE) -> torch.Tensor:
    """[G] int64: each tile's granules, (sched[g, 2] + sched[g, 3]) *
    granules_per_block(block), or -1 where its schedule row is out of range
    (a negative count, or blocks outside the P-row pool)."""
    s = sched.to(torch.int64)
    nb = s[:, 2] + s[:, 3]
    base = s[:, 0] * (window // block) + s[:, 1]
    bad = (s[:, 2] < 0) | (s[:, 3] < 0) | (
        (nb > 0) & ((s[:, 0] < 0) | (s[:, 1] < 0)
                    | (base + nb > -(-P // block))))
    return torch.where(bad, -1, nb * granules_per_block(block, granule))


def span_capacity(G: int, P: int, window: int, block: int,
                  span: int = SPAN) -> int:
    """The spans a launch makes room for: the segments of a pool are
    disjoint and each lies in one window, so G tiles hold at most
    ceil(P / block) * granules_per_block(block) granules, each tile at most
    window / block blocks."""
    gpb = granules_per_block(block)
    per_tile = -(-(window // block) * gpb // span)
    return max(1, min(G * per_tile, -(-P // block) * gpb // span + G))


def pool_plan(sched, window: int, block: int, P: int,
              span: int = SPAN) -> rows.RowsPlan:
    """K2's plan for a pool of P rows, on sched's device, with no host
    sync (csrc/pool.cu builds the same on the card)."""
    return rows.span_plan(pool_granules(sched, window, block, P), span,
                          span_capacity(sched.shape[0], P, window, block,
                                        span))


def granule_rows(sched, window: int, block: int, k: int,
                 granule: int = GRANULE):
    """Granule k of every tile's segment: (first row [G] int64, rows in it
    (the same for every tile), of a node block [G] bool)."""
    s = sched.to(torch.int64)
    b, sub = divmod(k, granules_per_block(block, granule))
    r0 = (s[:, 0] * (window // block) + s[:, 1] + b) * block + sub * granule
    return r0, min(granule, block - sub * granule), b < s[:, 2]


def eval_pool_plain(tgt_pos, tgt_idx, pool_pos, pool_mass, pool_idx, sched,
                    window: int, eps, G, block: int,
                    compensated: bool = False, mode: str = "both",
                    pool_quad=None, granule: int = GRANULE,
                    span: int = None):
    """Plain version, in K2's plan: one step per granule position k, each
    tile summing its k-th granule ([G, T, granule] panels; tiles whose
    segment is shorter add nothing), the partials added into spans of
    `span` granules (0: one span a tile; None: the kernel's,
    form_span), the spans in order. Never gathers a tile's whole window.

    tgt_pos [G, T, D], tgt_idx [G, T], pool planes [P, D] / [P] / [P]
    (+ pool_quad [P, Q]), sched [G, 4] -> acc [G, T, D], pot [G, T]."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    if span is None:
        span = form_span(pool_quad is not None)
    if span < 0:
        raise ValueError("span must be >= 0")
    Gt, T, D = tgt_pos.shape
    dev = tgt_pos.device
    eps2 = torch.full((), eps, dtype=tgt_pos.dtype, device=dev) ** 2
    sums = {o: rows.SpanSums(like, compensated) for o, like in
            (("acc", tgt_pos), ("pot", tgt_pos[..., 0]))
            if mode in ("both", o)}
    ngran = (sched[:, 2] + sched[:, 3]).to(torch.int64) \
        * granules_per_block(block, granule)
    for k in range(int(ngran.max()) if Gt else 0):
        live = k < ngran                                        # [G]
        r0, nr, node = granule_rows(sched, window, block, k, granule)
        rws = torch.where(live[:, None],
                          r0[:, None] + torch.arange(nr, device=dev), 0)
        sp = pool_pos[rws]                                      # [G, B, D]
        sm = torch.where(live[:, None], pool_mass[rws], 0.0)[:, None, :]
        dds = [sp[:, None, :, d] - tgt_pos[:, :, None, d] for d in range(D)]
        r2 = sum(dd * dd for dd in dds) + eps2
        dead = ((pool_idx[rws][:, None, :] == tgt_idx[:, :, None])
                | (r2 <= 0))
        inv_r = torch.where(dead, 0.0, torch.rsqrt(r2))
        w = sm * inv_r
        part = {}
        if "acc" in sums:
            w3 = w * inv_r * inv_r
            part["acc"] = [w3 * dd for dd in dds]
        if "pot" in sums:
            part["pot"] = -w
        if pool_quad is not None:
            # quadrupole terms on the node blocks only
            qk = (live & node)[:, None, None]
            q = torch.where(qk, pool_quad[rws], 0.0)[:, None]  # [G,1,B,Q]
            qa, qp = _quad_terms(dds, q, 1.0, inv_r, mode)
            if "acc" in part:
                part["acc"] = [a + b for a, b in zip(part["acc"], qa)]
            if "pot" in part:
                part["pot"] = part["pot"] - qp
        end = rows.span_ends(k, ngran, span)
        if "acc" in sums:
            sums["acc"].add(torch.stack([x.sum(-1) for x in part["acc"]],
                                        dim=-1), live, end)
        if "pot" in sums:
            sums["pot"].add(part["pot"].sum(-1), live, end)
    acc = sums["acc"].total() if "acc" in sums else torch.zeros_like(tgt_pos)
    pot = sums["pot"].total() if "pot" in sums \
        else torch.zeros_like(tgt_pos[..., 0])
    return G * acc, G * pot


# ---------------------------------------------------------------- kernel
def pool_device_plan(sched, window: int, block: int, P: int,
                     span: int = SPAN) -> rows.RowsPlan:
    """K2's plan as its kernel builds it from sched [G, 4] on a CUDA
    device, which must equal pool_plan(...) in every field (a check of the
    kernels, not a step of the path)."""
    G = sched.shape[0]
    cap = span_capacity(G, P, window, block, span)
    plan = rows.plan_views(torch.empty(G + cap + 2, dtype=torch.int32,
                                       device=sched.device), G, cap)
    sched32 = sched.to(torch.int32).contiguous()
    lib = shared._library("pool")
    with torch.cuda.device(sched.device):
        err = lib.rakau_pool_plan(
            sched32.data_ptr(), *(t.data_ptr() for t in plan), G, P,
            window // block, block, span, cap,
            torch.cuda.current_stream(sched.device).cuda_stream)
    shared.raise_on(err, lib, "pool (plan)")
    return plan


def eval_pool_fused(tgt_pos, tgt_idx, pool_pos, pool_mass, pool_idx, sched,
                    window: int, eps, G, block: int,
                    compensated: bool = False, mode: str = "both",
                    pool_quad=None):
    """The CUDA kernel (replaces `rakau_tpu.kernels.pallas.eval_pool` in
    its four forms). Same arguments and results as eval_pool_plain at its
    default plan; 2-D (padded to 3-D) or 3-D float32 or float64 tensors,
    int64 indices, all on one CUDA device; sched [G, 4] of any integer
    type, its segments disjoint (as traversal4.build_pool lays them out).
    On the current stream, with no host sync: the plan, the kernel and
    its span reduction."""
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
    if max(Gt * T, P) >= 2 ** 31:
        raise ValueError("the CUDA kernel takes sizes below 2^31")
    shared.check_devices(tgt_pos, named)
    if D == 2:
        (tgt_pos, pool_pos), pool_quad = shared.pad_to_3d(
            tgt_pos, pool_pos, quad=pool_quad)
    acc, pot = shared._outputs(tgt_pos)
    if Gt == 0 or T == 0:
        return acc[..., :D], pot
    dev = tgt_pos.device
    quad = pool_quad is not None
    span = form_span(quad)
    cap = span_capacity(Gt, P, window, block, span)
    plan = rows.plan_views(torch.empty(Gt + cap + 2, dtype=torch.int32,
                                       device=dev), Gt, cap)
    sched32 = sched.to(torch.int32).contiguous()
    lib = shared._library("pool", f64)
    ws = torch.empty(lib.rakau_pool_workspace(T, cap, int(compensated)),
                     dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rakau_pool(
            tgt_pos.data_ptr(), tgt_idx.data_ptr(), pool_pos.data_ptr(),
            pool_mass.data_ptr(), pool_idx.data_ptr(),
            pool_quad.data_ptr() if quad else None, sched32.data_ptr(),
            *(t.data_ptr() for t in plan), ws.data_ptr(), acc.data_ptr(),
            pot.data_ptr(), Gt, T, P, window // block, block, span, cap,
            _MODES[mode], int(compensated), shared.multiprocessors(dev),
            shared.eps2_arg(eps, real), float(G), stream)
    shared.raise_on(err, lib, "pool")
    shared.count_launch(launches, _form(quad, compensated), D == 2, f64)
    return (acc if D == 3 else acc[..., :D].contiguous()), pot
