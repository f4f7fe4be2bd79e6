"""Per-tile list evaluation of the lists traversal: the plain PyTorch
versions and the wrappers of the hand-written CUDA kernels K3 (fused) and
K4 (split) in csrc/tiles.cu, and the ports of the reference's plain-op
route `rakau_tpu.kernels.xla.eval_m2p` / `eval_p2p`. Counterpart of
`rakau_tpu.kernels.pallas.eval_tiles` (`_fused_kernel`, `_kernel`).

Each tile c of a chunk has rows of its own: an M2P row of node COMs and
masses [C, Sm] and a P2P row of particles with indices [C, Sp], each
left-compacted with counts m2p_cnt / p2p_cnt [C] and padded (mass 0, far
away, index -1). For target i (position t_i, index ti_i) and entry j:

    d = s_j - t_i,  r2 = |d|^2 + eps^2
    inv_r = 0 if r2 <= 0, or (P2P row only) idx_j == ti_i; else r2^(-1/2)
    w = m_j * inv_r
    pot_i = -G * sum_j w,  acc_i = G * sum_j w * inv_r^2 * d

The M2P row has no self-exclusion: a node on a target at eps = 0 is dead
by r2 <= 0 alone. Entries past a count are padding and add zero.

K3's plan (kernels/rows.py): each tile's rows are cut into granules of
GRANULE entries, ceil(clip(m2p_cnt, 0, Sm) / GRANULE) of the M2P row
then ceil(clip(p2p_cnt, 0, Sp) / GRANULE) of the P2P row (tiles_granules),
the granules into spans of SPAN; each granule's partial enters its span's
sum, the spans' sums are added in order. That visits the same live
entries as the reference's plan of whole blocks of `block` up to each
count. K4 keeps the reference's visited set, one row a launch:
ceil(max(min(cnt, S), 1) / b) blocks of b = min(block, S) per tile (at
least one; tile_blocks), the last cut at S, entries past the count inside
them included; those entries are cut into granules of GRANULE and spans
of SPAN on K3's engine (pairwise_granules, pairwise_plan).

The device of the tensors decides: CUDA tensors launch the kernel (2-D
operands padded to 3-D by kernels.shared.pad_to_3d, float64 through the
float64 build), CPU tensors take the plain version.
"""
from __future__ import annotations

import torch

from . import rows, shared

# K4's block and its default (the reference's DEF_BLOCK)
BLOCK = 1024
GRANULE = rows.GRANULE
# K3 and K4: granules a span, handed to each launch
SPAN = 2
# the index of an M2P entry in K3's plain version: no target has it
_NO_IDX = torch.iinfo(torch.int64).min
# Launches, counted where the wrappers launch: "fused" is K3, "split" one
# K4 launch (one row); "xla_quad" counts the quadrupole calls of
# kernels.dispatch.eval_tiles, which take the plain-op route of the
# reference (eval_m2p + eval_p2p, no kernel); "d2" and "f64" as in
# kernels/shared.py.
FORMS = ("fused", "split", "xla_quad")
launches = dict.fromkeys(FORMS + shared.COUNTERS, 0)


def reset_launches():
    for k in launches:
        launches[k] = 0


def tile_blocks(cnt, S: int, block: int, at_least_one: bool):
    """Blocks of `block` entries that a plan visits in each tile's row
    of S entries with counts cnt [C] (None: all S):
    ceil(clip(cnt, 0, S) / block) (K3's at its granule), or with
    at_least_one K4's ceil(max(min(cnt, S), 1) / block)."""
    if cnt is None:
        return -(-S // block)
    k = torch.clamp(cnt.to(torch.int64), 0, S)
    if at_least_one:
        k = torch.clamp(k, min=1)
    return (k + block - 1) // block


def _pair_sums(tgt_pos, tgt_idx, s, m, idx, eps2):
    """Sums of one source block s [C, B, D], m [C, B] (idx [C, B] or None
    for no self-exclusion) at the targets: (acc [C, T, D], pot [C, T])."""
    D = tgt_pos.shape[-1]
    dds = [s[:, None, :, d] - tgt_pos[:, :, None, d] for d in range(D)]
    r2 = eps2 + sum(dd * dd for dd in dds)
    dead = r2 <= 0
    if idx is not None:
        dead = dead | (idx[:, None, :] == tgt_idx[:, :, None])
    inv_r = torch.where(dead, 0.0, torch.rsqrt(r2))
    w = m[:, None, :] * inv_r
    w3 = w * inv_r * inv_r
    acc = torch.stack([(w3 * dd).sum(-1) for dd in dds], dim=-1)
    return acc, -w.sum(-1)


def _blocked(src_pos, src_mass, src_idx, block: int):
    """The row padded to whole blocks as the reference pads it (1e30, mass
    0, index -1)."""
    S = src_pos.shape[1]
    pad = -(-S // block) * block - S
    if pad:
        src_pos = torch.nn.functional.pad(src_pos, (0, 0, 0, pad),
                                          value=1e30)
        src_mass = torch.nn.functional.pad(src_mass, (0, pad))
        if src_idx is not None:
            src_idx = torch.nn.functional.pad(src_idx, (0, pad), value=-1)
    return src_pos, src_mass, src_idx


def _row_plain(acc, pot, tgt_pos, tgt_idx, src_pos, src_mass, src_idx, eps2,
               nblk, block: int):
    """Adds the blocks [0, nblk[c]) of each tile's row to acc, pot, block
    by block (tiles past their count add exact zeros)."""
    if acc.shape[0] == 0:
        return
    src_pos, src_mass, src_idx = _blocked(src_pos, src_mass, src_idx, block)
    top = int(nblk.max()) if torch.is_tensor(nblk) else nblk
    for j in range(top):
        sl = slice(j * block, (j + 1) * block)
        a, p = _pair_sums(tgt_pos, tgt_idx, src_pos[:, sl], src_mass[:, sl],
                          None if src_idx is None else src_idx[:, sl], eps2)
        live = (j < nblk) if torch.is_tensor(nblk) else True
        if torch.is_tensor(live):
            a = torch.where(live[:, None, None], a, 0.0)
            p = torch.where(live[:, None], p, 0.0)
        acc += a
        pot += p


def tiles_granules(C: int, Sm: int, Sp: int, m2p_cnt=None, p2p_cnt=None,
                   granule: int = GRANULE, device=None):
    """K3's granules of each tile: (gm [C], gp [C]) int64, of the M2P row
    and of the P2P row."""
    def row(cnt, S):
        g = tile_blocks(cnt, S, granule, False)
        return g if torch.is_tensor(g) else torch.full(
            (C,), g, dtype=torch.int64, device=device)
    return row(m2p_cnt, Sm), row(p2p_cnt, Sp)


def tiles_capacity(C: int, Sm: int, Sp: int, span: int = SPAN) -> int:
    """The spans a K3 launch makes room for: every tile's whole rows."""
    ngt = -(-Sm // GRANULE) + -(-Sp // GRANULE)
    return max(1, C * -(-ngt // span))


def tiles_plan(C: int, Sm: int, Sp: int, m2p_cnt=None, p2p_cnt=None,
               span: int = SPAN, device=None) -> rows.RowsPlan:
    """K3's plan for C tiles with rows of Sm and Sp entries and counts
    [C] (None: whole rows), on the counts' device (or `device`), with no
    host sync (csrc/tiles.cu builds the same on the card)."""
    gm, gp = tiles_granules(C, Sm, Sp, m2p_cnt, p2p_cnt, device=device)
    return rows.span_plan(gm + gp, span, tiles_capacity(C, Sm, Sp, span))


def _granule_rows(pos, mass, idx, granule: int):
    """A row [C, S, ...] padded to whole granules (1e30, mass 0, index -1;
    idx None: _NO_IDX everywhere)."""
    C, S = mass.shape
    pad = -(-S // granule) * granule - S
    fpad = torch.nn.functional.pad
    if idx is None:
        idx = torch.full((C, S), _NO_IDX, dtype=torch.int64,
                         device=mass.device)
    return (fpad(pos, (0, 0, 0, pad), value=1e30), fpad(mass, (0, pad)),
            fpad(idx, (0, pad), value=-1))


def eval_tiles_plain(tgt_pos, tgt_idx, m2p_pos, m2p_mass, p2p_pos, p2p_mass,
                     p2p_idx, scal, m2p_cnt=None, p2p_cnt=None,
                     granule: int = GRANULE, span: int = SPAN):
    """Plain version of K3 (`rakau_tpu.kernels.pallas.eval_tiles_fused`),
    in K3's plan: per tile the M2P row's granules, then the P2P row's,
    each bounded by its count, one [C, T, granule] panel per granule
    position, added into spans of `span` granules (0: one span a tile),
    the spans in order; times G.

    tgt_pos [C, T, D], tgt_idx [C, T], m2p_pos [C, Sm, D], m2p_mass
    [C, Sm], p2p_pos [C, Sp, D], p2p_mass [C, Sp], p2p_idx [C, Sp],
    scal (shared.scalar_buffer), counts [C] -> acc [C, T, D],
    pot [C, T]."""
    if span < 0:
        raise ValueError("span must be >= 0")
    C, T, D = tgt_pos.shape
    Sm, Sp = m2p_pos.shape[1], p2p_pos.shape[1]
    dev = tgt_pos.device
    eps2, G = shared.check_scalars(scal, tgt_pos)
    gm, gp = tiles_granules(C, Sm, Sp, m2p_cnt, p2p_cnt, granule, dev)
    ng = gm + gp
    mrow = _granule_rows(m2p_pos, m2p_mass, None, granule)
    prow = _granule_rows(p2p_pos, p2p_mass, p2p_idx, granule)
    NGm = mrow[1].shape[1] // granule
    pos, mass, idx = (torch.cat(x, 1) for x in zip(mrow, prow))
    top = max(pos.shape[1] // granule - 1, 0)
    lane = torch.arange(granule, device=dev)
    acc = rows.SpanSums(tgt_pos, False)
    pot = rows.SpanSums(tgt_pos[..., 0], False)
    for k in range(int(ng.max()) if C else 0):
        live = k < ng
        slot = torch.where(k < gm, k, NGm + k - gm).clamp(0, top)
        ent = slot[:, None] * granule + lane                   # [C, g]
        s = torch.gather(pos, 1, ent[..., None].expand(-1, -1, D))
        m = torch.where(live[:, None], torch.gather(mass, 1, ent), 0.0)
        a, p = _pair_sums(tgt_pos, tgt_idx, s, m, torch.gather(idx, 1, ent),
                          eps2)
        end = rows.span_ends(k, ng, span)
        acc.add(a, live, end)
        pot.add(p, live, end)
    return G * acc.total(), G * pot.total()


def pairwise_entries(C: int, S: int, cnt=None, block: int = BLOCK,
                     device=None) -> torch.Tensor:
    """[C] int64: the entries of each tile's row of S that K4's plan
    visits, the reference's: whole blocks of b = min(block, S) up to
    ceil(max(min(cnt, S), 1) / b), at least one, the last cut at S (None:
    the whole row)."""
    b = max(1, min(block, S))
    nb = tile_blocks(cnt, S, b, True)
    if not torch.is_tensor(nb):
        nb = torch.full((C,), nb, dtype=torch.int64, device=device)
    return torch.clamp(nb * b, max=S)


def pairwise_granules(C: int, S: int, cnt=None, block: int = BLOCK,
                      device=None) -> torch.Tensor:
    """[C] int64: K4's granules of each tile, ceil(pairwise_entries /
    GRANULE)."""
    n = pairwise_entries(C, S, cnt, block, device)
    return (n + GRANULE - 1) // GRANULE


def pairwise_capacity(C: int, S: int, span: int = SPAN) -> int:
    """The spans a K4 launch makes room for: every tile's whole row."""
    ng = -(-S // GRANULE)
    return max(1, C * -(-ng // span))


def pairwise_plan(C: int, S: int, cnt=None, block: int = BLOCK,
                  span: int = SPAN, device=None) -> rows.RowsPlan:
    """K4's plan for C tiles with a row of S entries and counts [C]
    (None: the whole row), on the counts' device (or `device`), with no
    host sync (csrc/tiles.cu builds the same on the card)."""
    return rows.span_plan(pairwise_granules(C, S, cnt, block,
                                            device=device),
                          span, pairwise_capacity(C, S, span))


def eval_pairwise_plain(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, scal,
                        use_idx: bool, cnt=None, block: int = BLOCK,
                        granule: int = GRANULE, span: int = SPAN):
    """Plain version of one K4 launch (`rakau_tpu.kernels.pallas.
    _pairwise`), in K4's plan: one row, with the self-exclusion test if
    use_idx, each tile's visited entries (pairwise_entries: whole blocks of
    min(block, S) up to ceil(max(min(cnt, S), 1) / b), entries past the
    count inside them included) cut into granules of `granule`, one
    [C, T, granule] panel per granule position, added into spans of `span`
    granules (0: one span a tile), the spans in order. eps^2 from scal
    (shared.scalar_buffer); no G factor. Returns acc [C, T, D],
    pot [C, T]."""
    if span < 0:
        raise ValueError("span must be >= 0")
    C, T, D = tgt_pos.shape
    S = src_pos.shape[1]
    dev = tgt_pos.device
    n = pairwise_entries(C, S, cnt, block, dev)
    ng = (n + granule - 1) // granule
    pos, mass, idx = _granule_rows(src_pos, src_mass,
                                   src_idx if use_idx else None, granule)
    top = max(pos.shape[1] // granule - 1, 0)
    lane = torch.arange(granule, device=dev)
    acc = rows.SpanSums(tgt_pos, False)
    pot = rows.SpanSums(tgt_pos[..., 0], False)
    eps2, _ = shared.check_scalars(scal, tgt_pos)
    for k in range(int(ng.max()) if C and S else 0):
        live = k < ng
        ent = min(k, top) * granule + lane                  # [granule]
        s = pos[:, ent]
        m = torch.where((ent[None, :] < n[:, None]) & live[:, None],
                        mass[:, ent], 0.0)
        a, p = _pair_sums(tgt_pos, tgt_idx, s, m, idx[:, ent], eps2)
        end = rows.span_ends(k, ng, span)
        acc.add(a, live, end)
        pot.add(p, live, end)
    return acc.total(), pot.total()


# ----------------------------------------- the reference's plain-op route
def eval_p2p(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, scal,
             block: int = 512):
    """Port of `rakau_tpu.kernels.xla.eval_p2p`: the near-field row [C, S]
    with self-exclusion by index, direct per-component differences, in
    blocks of `block` (padded with 1e30, mass 0, index -1). Returns
    acc [C, T, D], pot [C, T] times G."""
    eps2, G = shared.check_scalars(scal, tgt_pos)
    acc = torch.zeros_like(tgt_pos)
    pot = torch.zeros_like(tgt_pos[..., 0])
    _row_plain(acc, pot, tgt_pos, tgt_idx, src_pos, src_mass, src_idx, eps2,
               max(1, -(-src_pos.shape[1] // block)), block)
    return G * acc, G * pot


def _quad_terms(t, s, q, inv_r):
    """Port of `rakau_tpu.kernels.xla._quad_terms` in d = t - s: the
    quadrupole correction (dacc [C, T, D], dpot [C, T]) of one block,
    psi = 1.5 dQd r^-5 - 0.5 trQ r^-3, grad psi = 3 Qd r^-5
    + 1.5 trQ d r^-5 - 7.5 dQd d r^-7. Every term multiplies q (0 on
    padding) into d before d again, so a 1e30 padding row gives 0."""
    D = t.shape[-1]
    d = [t[:, :, None, a] - s[:, None, :, a] for a in range(D)]  # [C, T, B]
    inv2 = inv_r * inv_r
    inv3 = inv2 * inv_r
    inv5 = inv3 * inv2
    inv7 = inv5 * inv2
    trq = torch.zeros_like(q[..., 0])
    dqd = torch.zeros_like(inv_r)
    qd = [torch.zeros_like(inv_r) for _ in range(D)]
    for ci, (a, b) in enumerate(shared.quad_pairs(D)):
        qc = q[:, None, :, ci]
        if a == b:
            trq = trq + q[..., ci]
            dqd = dqd + qc * d[a] * d[b]
            qd[a] = qd[a] + qc * d[b]
        else:
            dqd = dqd + 2 * qc * d[a] * d[b]
            qd[a] = qd[a] + qc * d[b]
            qd[b] = qd[b] + qc * d[a]
    half_tr = 0.5 * trq[:, None, :]
    dpot = -(1.5 * dqd * inv5 - half_tr * inv3).sum(-1)
    dacc = torch.stack([(3.0 * qd[a] * inv5 + 3.0 * half_tr * d[a] * inv5
                         - 7.5 * dqd * d[a] * inv7).sum(-1)
                        for a in range(D)], dim=-1)
    return dacc, dpot


def eval_m2p(tgt_pos, src_pos, src_mass, scal, src_quad=None,
             block: int = 1024):
    """Port of `rakau_tpu.kernels.xla.eval_m2p`: node monopoles (and with
    src_quad [C, S, Q] their quadrupoles) on a far-field row [C, S],
    r^2 by the norm expansion in the tile-local frame about the targets'
    mean (|t|^2 + |s|^2 - 2 t.s, clamped at 0), a pair dead where
    m <= 0 or r2 <= 0, in blocks of `block` (padded with 1e30 and mass
    0). The t.s and the sum over the sources are elementwise products and
    sums in the working type, as the reference's HIGHEST-precision
    einsums. Returns acc [C, T, D], pot [C, T] times G."""
    D = tgt_pos.shape[-1]
    eps2, G = shared.check_scalars(scal, tgt_pos)
    center = tgt_pos.mean(1, keepdim=True)
    t = tgt_pos - center
    t2 = (t * t).sum(-1)
    acc = torch.zeros_like(tgt_pos)
    pot = torch.zeros_like(tgt_pos[..., 0])
    pos, mass, _ = _blocked(src_pos, src_mass, None, block)
    quad = src_quad
    if quad is not None:
        quad = torch.nn.functional.pad(quad, (0, 0, 0, pos.shape[1]
                                              - quad.shape[1]))
    for j in range(0, pos.shape[1], block):
        s = pos[:, j:j + block] - center
        m = mass[:, j:j + block]
        s2 = (s * s).sum(-1)
        ts = sum(t[:, :, None, d] * s[:, None, :, d] for d in range(D))
        r2 = torch.clamp(t2[:, :, None] + s2[:, None, :] - 2 * ts,
                         min=0.0) + eps2
        inv_r = torch.where((m[:, None, :] <= 0) | (r2 <= 0), 0.0,
                            torch.rsqrt(r2))
        w = m[:, None, :] * inv_r
        w3 = w * inv_r * inv_r
        pot = pot - w.sum(-1)
        ws = torch.stack([(w3 * s[:, None, :, d]).sum(-1) for d in range(D)],
                         dim=-1)
        acc = acc + ws
        acc = acc - t * w3.sum(-1)[:, :, None]
        if quad is not None:
            da, dp = _quad_terms(t, s, quad[:, j:j + block], inv_r)
            acc = acc + da
            pot = pot + dp
    return G * acc, G * pot


# ---------------------------------------------------------------- kernels
def _check_tiles(tgt_pos, tgt_idx, rows):
    """The wrappers' checks: 2-D or 3-D float32 or float64 targets, rows
    (name, pos [C, S, D], mass [C, S], idx [C, S] int64 or None, cnt [C]
    integer or None) of the same type, contiguous, on one CUDA device,
    sizes below 2^31. Returns (C, T, D, float64?)."""
    D, f64 = shared.check_real(tgt_pos)
    C, T, _ = tgt_pos.shape
    real = tgt_pos.dtype
    shared._check("tgt_pos", tgt_pos, real, (C, T, D))
    shared._check("tgt_idx", tgt_idx, torch.int64, (C, T))
    named = [("tgt_idx", tgt_idx)]
    for name, pos, mass, idx, cnt in rows:
        S = pos.shape[1]
        shared._check(f"{name}_pos", pos, real, (C, S, D))
        shared._check(f"{name}_mass", mass, real, (C, S))
        named += [(f"{name}_pos", pos), (f"{name}_mass", mass)]
        if idx is not None:
            shared._check(f"{name}_idx", idx, torch.int64, (C, S))
            named.append((f"{name}_idx", idx))
        if cnt is not None:
            if (cnt.dtype not in (torch.int32, torch.int64)
                    or tuple(cnt.shape) != (C,) or not cnt.is_cuda):
                raise ValueError(f"{name}_cnt must be an integer CUDA "
                                 f"tensor of shape ({C},)")
            named.append((f"{name}_cnt", cnt))
        if max(C * T, C * S) >= 2 ** 31:
            raise ValueError("the CUDA kernel takes sizes below 2^31")
    shared.check_devices(tgt_pos, named)
    return C, T, D, f64


def _cnt64(cnt):
    return None if cnt is None else cnt.to(torch.int64).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def tiles_device_plan(C: int, Sm: int, Sp: int, m2p_cnt=None, p2p_cnt=None,
                      device=None) -> rows.RowsPlan:
    """K3's plan as its kernel builds it on a CUDA device from the counts
    (integer [C] CUDA tensors, or None for whole rows), which must equal
    tiles_plan(...) in every field (a check of the kernels, not a step of
    the path)."""
    m2p_cnt, p2p_cnt = _cnt64(m2p_cnt), _cnt64(p2p_cnt)
    dev = next((c.device for c in (m2p_cnt, p2p_cnt) if c is not None),
               device)
    cap = tiles_capacity(C, Sm, Sp)
    plan = rows.plan_views(torch.empty(C + cap + 2, dtype=torch.int32,
                                       device=dev), C, cap)
    lib = shared._library("tiles")
    with torch.cuda.device(dev):
        err = lib.rakau_tiles_plan(
            _ptr(m2p_cnt), _ptr(p2p_cnt), *(t.data_ptr() for t in plan), C,
            Sm, Sp, SPAN, cap, torch.cuda.current_stream(dev).cuda_stream)
    shared.raise_on(err, lib, "tiles (plan)")
    return plan


def eval_tiles_fused(tgt_pos, tgt_idx, m2p_pos, m2p_mass, p2p_pos, p2p_mass,
                     p2p_idx, scal, m2p_cnt=None, p2p_cnt=None):
    """K3, the CUDA kernel (replaces `rakau_tpu.kernels.pallas.
    eval_tiles_fused`): one launch for the chunk, both rows of each tile,
    the counts read on the device. Same arguments and results as
    eval_tiles_plain at its default plan; 2-D or 3-D float32 or float64
    tensors, int64 indices, integer counts, all on one CUDA device. On the
    current stream, with no host sync: the plan, the kernel and its span
    reduction."""
    C, T, D, f64 = _check_tiles(tgt_pos, tgt_idx, (
        ("m2p", m2p_pos, m2p_mass, None, m2p_cnt),
        ("p2p", p2p_pos, p2p_mass, p2p_idx, p2p_cnt)))
    shared.check_scalars(scal, tgt_pos)
    if D == 2:
        (tgt_pos, m2p_pos, p2p_pos), _ = shared.pad_to_3d(tgt_pos, m2p_pos,
                                                           p2p_pos)
    Sm, Sp = m2p_pos.shape[1], p2p_pos.shape[1]
    acc, pot = shared._outputs(tgt_pos)
    if C == 0 or T == 0:
        return acc[..., :D], pot
    m2p_cnt, p2p_cnt = _cnt64(m2p_cnt), _cnt64(p2p_cnt)
    dev = tgt_pos.device
    cap = tiles_capacity(C, Sm, Sp)
    plan = rows.plan_views(torch.empty(C + cap + 2, dtype=torch.int32,
                                       device=dev), C, cap)
    lib = shared._library("tiles", f64)
    ws = torch.empty(lib.rakau_tiles_workspace(T, cap), dtype=torch.uint8,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rakau_tiles(
            tgt_pos.data_ptr(), tgt_idx.data_ptr(), m2p_pos.data_ptr(),
            m2p_mass.data_ptr(), _ptr(m2p_cnt), p2p_pos.data_ptr(),
            p2p_mass.data_ptr(), p2p_idx.data_ptr(), _ptr(p2p_cnt),
            *(t.data_ptr() for t in plan), ws.data_ptr(), acc.data_ptr(),
            pot.data_ptr(), C, T, Sm, Sp, SPAN, cap,
            shared.multiprocessors(dev),
            scal.data_ptr(), stream)
    shared.raise_on(err, lib, "tiles")
    shared.count_launch(launches, "fused", D == 2, f64)
    return (acc if D == 3 else acc[..., :D].contiguous()), pot


def pairwise_device_plan(C: int, S: int, cnt=None, block: int = BLOCK,
                         device=None) -> rows.RowsPlan:
    """K4's plan as its kernel builds it on a CUDA device from the counts
    (an integer [C] CUDA tensor, or None for the whole row), which must
    equal pairwise_plan(...) in every field (a check of the kernels, not a
    step of the path)."""
    cnt = _cnt64(cnt)
    dev = cnt.device if cnt is not None else device
    cap = pairwise_capacity(C, S)
    plan = rows.plan_views(torch.empty(C + cap + 2, dtype=torch.int32,
                                       device=dev), C, cap)
    lib = shared._library("tiles")
    with torch.cuda.device(dev):
        err = lib.rakau_tiles_pairwise_plan(
            _ptr(cnt), *(t.data_ptr() for t in plan), C, S, block, SPAN, cap,
            torch.cuda.current_stream(dev).cuda_stream)
    shared.raise_on(err, lib, "tiles (K4 plan)")
    return plan


def eval_pairwise(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, scal,
                  use_idx: bool, cnt=None, block: int = BLOCK):
    """One K4 launch, the CUDA kernel (replaces `rakau_tpu.kernels.pallas.
    _pairwise`): one row on K3's engine over K4's visited set. Same
    arguments and results as eval_pairwise_plain at its default plan (no G
    factor: its launch reads scal's last two values, [eps^2, 1]), same
    tensor types as eval_tiles_fused. On the current stream, with no host
    sync: the plan, the kernel and its span reduction (two launches on
    the same inputs agree bit for bit)."""
    C, T, D, f64 = _check_tiles(tgt_pos, tgt_idx, (
        ("src", src_pos, src_mass, src_idx if use_idx else None, cnt),))
    shared.check_scalars(scal, tgt_pos)
    if block < 1:
        raise ValueError("block must be >= 1")
    if D == 2:
        (tgt_pos, src_pos), _ = shared.pad_to_3d(tgt_pos, src_pos)
    S = src_pos.shape[1]
    acc, pot = shared._outputs(tgt_pos)
    if C == 0 or T == 0:
        return acc[..., :D], pot
    cnt = _cnt64(cnt)
    dev = tgt_pos.device
    cap = pairwise_capacity(C, S)
    plan = rows.plan_views(torch.empty(C + cap + 2, dtype=torch.int32,
                                       device=dev), C, cap)
    lib = shared._library("tiles", f64)
    ws = torch.empty(lib.rakau_tiles_workspace(T, cap), dtype=torch.uint8,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rakau_tiles_pairwise(
            tgt_pos.data_ptr(), tgt_idx.data_ptr(), src_pos.data_ptr(),
            src_mass.data_ptr(), src_idx.data_ptr() if use_idx else None,
            _ptr(cnt), *(t.data_ptr() for t in plan), ws.data_ptr(),
            acc.data_ptr(), pot.data_ptr(), C, T, S, block, SPAN, cap,
            shared.multiprocessors(dev),
            scal[2:].data_ptr(), stream)
    shared.raise_on(err, lib, "tiles (K4)")
    shared.count_launch(launches, "split", D == 2, f64)
    return (acc if D == 3 else acc[..., :D].contiguous()), pot


def eval_tiles(tgt_pos, tgt_idx, m2p_pos, m2p_mass, m2p_quad, p2p_pos,
               p2p_mass, p2p_idx, scal, m2p_cnt=None, p2p_cnt=None,
               block: int = BLOCK, fused: bool = True, kernel=None):
    """Counterpart of `rakau_tpu.kernels.pallas.eval_tiles`: monopole M2P
    + P2P of each tile's rows, times G. With kernel=True K3 is launched
    (fused) or, with fused=False, K4 once per row (M2P without, P2P with
    the index test), the two sums added and multiplied by G; with
    kernel=False the plain versions of the same run. kernel=None takes
    the kernel on CUDA tensors and the plain versions on CPU tensors
    (kernels.dispatch.eval_tiles passes cfg.kernel_backend's choice).
    `block` is K4's (K3 visits granules). The quadrupole raises
    NotImplementedError, as the reference's does (kernels.dispatch
    .eval_tiles routes it to eval_m2p + eval_p2p)."""
    if m2p_quad is not None:
        raise NotImplementedError("the tile kernels are monopole-only")
    cuda = tgt_pos.is_cuda if kernel is None else kernel
    if fused:
        fn = eval_tiles_fused if cuda else eval_tiles_plain
        return fn(tgt_pos, tgt_idx, m2p_pos, m2p_mass, p2p_pos, p2p_mass,
                  p2p_idx, scal, m2p_cnt=m2p_cnt, p2p_cnt=p2p_cnt)
    fn = eval_pairwise if cuda else eval_pairwise_plain
    am, pm = fn(tgt_pos, tgt_idx, m2p_pos, m2p_mass, None, scal,
                use_idx=False, cnt=m2p_cnt, block=block)
    ap, pp = fn(tgt_pos, tgt_idx, p2p_pos, p2p_mass, p2p_idx, scal,
                use_idx=True, cnt=p2p_cnt, block=block)
    G = scal[1]
    return G * (am + ap), G * (pm + pp)
