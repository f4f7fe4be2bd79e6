"""Shared-candidate pairwise evaluation: the plain PyTorch versions and the
wrappers of the hand-written CUDA kernels (csrc/shared_fused.cu, and the
two other evaluators of the same row, csrc/shared_mma.cu and
csrc/shared_blocks.cu, described at eval_shared_mma_plain and
eval_shared_blocks_plain).

Semantics, for tile c, target i (position t_i, index ti_i) and shared
source j (position s_j, mass m_j, index si_j):

    d = s_j - t_i,  r2 = |d|^2 + eps^2
    inv_r = 0 if si_j == ti_i or r2 <= 0, else r2^(-1/2)
    w = m_j * mask[c, j] * inv_r
    pot_i = -G * sum_j w,  acc_i = G * sum_j w * inv_r^2 * d

eps^2 and G reach every kernel and plain version in one tensor, scal =
scalar_buffer(eps, G, like), which engine.scalars makes once a call.

Padding sources sit far away (1e30 or the traversal's 4*box sentinel)
with mass 0; r2 may overflow to inf there and inv_r is then 0, never NaN.
mode "acc" / "pot" skips the other sum and returns it as zeros.

Three options, as in the reference kernel:
  * compensated: each BLOCK-sized source block's partial sum enters the
    running sum through Knuth's TwoSum; the error terms are added at the
    end;
  * src_quad [S, Q] (Q = D(D+1)/2 raw second moments about each source's
    COM, multipole node rows): adds the quadrupole correction
        pot_i -= G * sum_j (1.5 dQd inv_r^5 - 0.5 tr(Q) inv_r^3)
        acc_i += G * sum_j (-3 (Qd) inv_r^5 - 1.5 tr(Q) d inv_r^5
                            + 7.5 dQd d inv_r^7)
    with mask[c, j] == 0 folded into the dead gate (inv_r = 0), so that a
    masked-out node on top of a target gives zeros, not 0 * inf = NaN;
  * src_cell [S, D], tgt_cell [C, T, D] and grid_sep > 0 (farfield
    "grid2"): leaf-grid cells of the sources and the targets. A pair
    whose Chebyshev cell separation max_d |src_cell_d - tgt_cell_d| is
    >= grid_sep belongs to the dense far field and is dead here; source
    rows with src_cell[:, 0] < 0 are exempt from the test.

The CUDA wrappers take 2-D and 3-D operands, float32 or float64 (K6 and K5
float32 only): a 2-D call is padded to 3-D by pad_to_3d, which is exact,
and a float64 call runs the same source built with -DRAKAU_REAL=double
(build_library(f64=True)).

The plans: K1 (csrc/shared_fused.cu) and K6 (csrc/shared_mma.cu) compact
each tile's mask at GRANULE sources and cut each tile's list into spans of
SPAN entries (fused_plan); K5 (csrc/shared_blocks.cu) compacts it at the
reference's whole blocks of BLOCK sources, in spans of BLOCKS_SPAN
(fused_plan(mask, BLOCKS_SPAN, BLOCK)). Each library builds its plan on
the card by the same plan kernels (csrc/shared_plan.cuh) at its own unit.
PLAN_BLOCK names each evaluator's unit; metrics.processed_pairs replays
them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from .. import scan_utils as su
from ..particles import scalar_tensor
from . import rows

_MODES = {"both": 0, "acc": 1, "pot": 2}
# The reference's source block (`pallas.eval_shared`): the unit of K5's
# per-tile active-block lists, whose kernel's kGranule must equal it
# (checked when the library loads); its lists are cut into spans of
# BLOCKS_SPAN entries, handed to each launch.
BLOCK = 1024
BLOCKS_SPAN = 1
# The plan of K1 and K6: each tile's list of active granules of GRANULE
# sources (the reference's `subblock` selection; the unit of one staging
# step), cut into spans of SPAN consecutive entries, one work item a span
# and target group. Each kernel's kGranule must equal GRANULE (checked
# when the library loads); SPAN is handed to each launch. The plain
# versions follow the same plan unless told otherwise.
GRANULE = 128
SPAN = 2
# the unit of each evaluator's plan: the sources a processed (tile, entry)
# pair of its lists computes for every target
PLAN_BLOCK = {"fused": GRANULE, "mma": GRANULE, "blocks": BLOCK}


def quad_pairs(ndim: int):
    """Index pairs (a, b), a <= b, in the order of the Q columns."""
    return [(a, b) for a in range(ndim) for b in range(a, ndim)]


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quad_terms(dds, q, mk, inv_r, mode):
    """Quadrupole correction of one source block: dds D panels [C, T, B]
    (d = s - t), q [B, Q] (or [C, 1, B, Q], per tile), mk [C, 1, B],
    inv_r [C, T, B] (0 on dead pairs). Returns (dacc list of D panels or
    None, dpot panel or None), not yet summed over the sources."""
    D = len(dds)
    qd = [None] * D                       # (Q d)_a
    trq = 0.0
    for ci, (a, b) in enumerate(quad_pairs(D)):
        qc = q[..., ci]
        qd[a] = qc * dds[b] if qd[a] is None else qd[a] + qc * dds[b]
        if a == b:
            trq = trq + qc
        else:
            qd[b] = qc * dds[a] if qd[b] is None else qd[b] + qc * dds[a]
    dqd = sum(dd * x for dd, x in zip(dds, qd))
    inv2 = inv_r * inv_r
    inv3 = inv2 * inv_r
    inv5 = inv3 * inv2
    dpot = dacc = None
    if mode in ("both", "pot"):
        dpot = mk * (1.5 * dqd * inv5 - 0.5 * trq * inv3)
    if mode in ("both", "acc"):
        f5 = mk * inv5
        f7 = mk * dqd * inv5 * inv2
        dacc = [-3.0 * qd[d] * f5 - 1.5 * trq * dds[d] * f5
                + 7.5 * dds[d] * f7 for d in range(D)]
    return dacc, dpot


def eval_shared_plain(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                      scal, mode: str = "both", block: int = GRANULE,
                      compensated: bool = False, src_quad=None,
                      src_cell=None, tgt_cell=None, grid_sep: int = 0,
                      span: int = SPAN, weight_mask: bool = False):
    """Plain version (counterpart of `rakau_tpu.kernels.xla.eval_shared`),
    in K1's structure: each tile's list of active granules of `block`
    sources (active_blocks(mask, block)) is cut into spans of `span`
    consecutive entries (0: one span, the whole list). A granule's
    [C, T, block] panel is summed over its sources and added into its
    span's sum; the spans' sums are added in span order. compensated:
    TwoSum at both levels, the error terms added at the end. weight_mask:
    the mask multiplies the masses (m_j * mask[c, j], the reference's
    `_shared_kernel`, K5) instead of entering the dead gate (monopole
    only; the same sums wherever m_j * inv_r^3 is finite).

    tgt_pos [C, T, D], tgt_idx [C, T], src_pos [S, D], src_mass [S],
    src_idx [S], mask [C, S] bool, scal (scalar_buffer) (+ src_quad
    [S, Q]; + integer src_cell [S, D], tgt_cell [C, T, D] and grid_sep)
    -> acc [C, T, D], pot [C, T]."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    if src_cell is None:
        grid_sep = 0
    elif tgt_cell is None or grid_sep < 1:
        raise ValueError("src_cell needs tgt_cell and grid_sep >= 1")
    if span < 0:
        raise ValueError("span must be >= 0")
    if weight_mask and src_quad is not None:
        raise ValueError("weight_mask is the monopole's")
    C, T, D = tgt_pos.shape
    S = src_pos.shape[0]
    dtype = tgt_pos.dtype
    dev = tgt_pos.device
    eps2, G = check_scalars(scal, tgt_pos)
    ids, cnt = active_blocks(mask, block)
    NG = ids.shape[1]
    pad = NG * block - S
    # the row padded to whole granules with masked-out entries
    fpad = torch.nn.functional.pad
    pos_p = fpad(src_pos, (0, 0, 0, pad))
    mass_p = fpad(src_mass, (0, pad))
    idx_p = fpad(src_idx, (0, pad), value=-1)
    mask_p = fpad(mask, (0, pad))
    quad_p = None if src_quad is None else fpad(src_quad, (0, 0, 0, pad))
    cell_p = fpad(src_cell, (0, 0, 0, pad), value=-1) if grid_sep else None
    outs = []                 # per output: acc [C, T, D], pot [C, T]
    if mode in ("both", "acc"):
        outs.append("acc")
    if mode in ("both", "pot"):
        outs.append("pot")
    zero = {"acc": torch.zeros_like(tgt_pos),
            "pot": torch.zeros_like(tgt_pos[..., 0])}
    tot = dict(zero)          # the spans added so far
    tot_e = dict(zero)        # their TwoSum errors
    run = dict(zero)          # the current span's sum
    run_e = dict(zero)        # its TwoSum errors
    nmax = int(cnt.max()) if C else 0
    lane = torch.arange(block, device=dev)
    for k in range(nmax):
        take = k < cnt                                     # [C]
        end = take & (k + 1 == cnt)
        if span:
            end = end | (take & ((k + 1) % span == 0))
        sl = ids[:, k].clamp(max=NG - 1).long()[:, None] * block + lane
        mkb = torch.gather(mask_p, 1, sl)[:, None, :]      # [C, 1, B]
        sp = pos_p[sl]                                     # [C, B, D]
        dds = [sp[:, None, :, d] - tgt_pos[:, :, None, d] for d in range(D)]
        r2 = eps2 + sum(dd * dd for dd in dds)
        inv_r = torch.rsqrt(r2)
        dead = (idx_p[sl][:, None, :] == tgt_idx[:, :, None]) | (r2 <= 0)
        if not weight_mask:
            dead = dead | ~mkb
        if grid_sep:
            scb = cell_p[sl]                               # [C, B, D]
            csep = None
            for d in range(D):
                cd = (scb[:, None, :, d] - tgt_cell[:, :, None, d]).abs()
                csep = cd if csep is None else torch.maximum(csep, cd)
            dead = dead | ((csep >= grid_sep) & (scb[:, None, :, 0] >= 0))
        inv_r = torch.where(dead, 0.0, inv_r)
        m = mass_p[sl][:, None, :]
        w = (m * mkb.to(dtype) if weight_mask else m) * inv_r
        part = {}
        if "acc" in outs:
            w3 = w * inv_r * inv_r
            part["acc"] = [w3 * dd for dd in dds]
        if "pot" in outs:
            part["pot"] = -w
        if quad_p is not None:
            qa, qp = _quad_terms(dds, quad_p[sl][:, None], mkb.to(dtype),
                                 inv_r, mode)
            if "acc" in part:
                part["acc"] = [a + b for a, b in zip(part["acc"], qa)]
            if "pot" in part:
                part["pot"] = part["pot"] - qp
        for o in outs:
            p = part[o]
            if o == "acc":
                p = torch.stack([x.sum(-1) for x in p], dim=-1)
                tk = take[:, None, None]
                ek = end[:, None, None]
            else:
                p = p.sum(-1)
                tk = take[:, None]
                ek = end[:, None]
            if compensated:
                s, e = _two_sum(run[o], p)
                run_e[o] = torch.where(tk, run_e[o] + e, run_e[o])
            else:
                s = run[o] + p
            run[o] = torch.where(tk, s, run[o])
            if compensated:
                s, e = _two_sum(tot[o], run[o])
                tot_e[o] = torch.where(ek, (tot_e[o] + e) + run_e[o],
                                       tot_e[o])
                run_e[o] = torch.where(ek, 0.0, run_e[o])
            else:
                s = tot[o] + run[o]
            tot[o] = torch.where(ek, s, tot[o])
            run[o] = torch.where(ek, 0.0, run[o])
    if compensated:
        tot = {o: tot[o] + tot_e[o] for o in tot}
    return G * tot["acc"], G * tot["pot"]

PRECS = {"bf16": 0, "x3": 1, "highest": 2}


def _bf16(x):
    """x rounded to bfloat16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def eval_shared_mma_plain(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                          scal, mode: str = "both", prec: str = "x3",
                          src_cell=None, tgt_cell=None, grid_sep: int = 0,
                          granule: int = GRANULE, span: int = SPAN):
    """Plain version of the tensor-core form (counterpart of
    `rakau_tpu.kernels.pallas._shared_fused_kernel_mxu`): monopole, fp32
    sums, another arithmetic than eval_shared_plain. In tile-local
    coordinates about the tile's first target p (t' = t - p, s' = s - p):

        r2n = (|t'|^2 - 2 t'.s') + |s'|^2
        dead = r2n <= 2^-21 (|t'|^2 + |s'|^2)       (or the cell test)
        inv_r = 0 if dead else rsqrt(r2n + eps^2)
        w = m mask inv_r, w3 = w inv_r^2
        Y = sum_j w3 s'_j, ysum = sum_j w3, pot = -G sum_j w
        acc = G (Y - ysum t')

    The indices are not read: the relative threshold drops a target's own
    row and any source within ~7e-4 of the pair's distance from p. Y is a
    [T, B] x [B, D] product per granule at precision `prec`: "bf16" (both
    operands rounded to bfloat16, fp32 sums), "x3" (w3 = Ah + Al and s' =
    Bh + Bl in bfloat16, the three products Ah Bl + Al Bh + Ah Bh) or
    "highest" (fp32).

    K1's plan and order of sums (eval_shared_plain): each tile's list of
    active granules of `granule` sources is cut into spans of `span`
    consecutive entries (0: one span, the whole list); a granule's
    [C, T, granule] panel is summed over its sources and added into its
    span's sums (Y, ysum, pot), the spans' sums are added in span order,
    and acc = Y - ysum t' is formed once on the totals. Arguments and
    results as eval_shared_plain."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    if prec not in PRECS:
        raise ValueError(f"prec must be one of {tuple(PRECS)}")
    if src_cell is None:
        grid_sep = 0
    elif tgt_cell is None or grid_sep < 1:
        raise ValueError("src_cell needs tgt_cell and grid_sep >= 1")
    if span < 0:
        raise ValueError("span must be >= 0")
    C, T, D = tgt_pos.shape
    S = src_pos.shape[0]
    dtype = tgt_pos.dtype
    dev = tgt_pos.device
    eps2, G = check_scalars(scal, tgt_pos)
    p = tgt_pos[:, :1, :]                               # [C, 1, D]
    tp = tgt_pos - p
    tts = None
    for d in range(D):
        sq = tp[..., d] * tp[..., d]
        tts = sq if tts is None else tts + sq           # [C, T]
    ids, cnt = active_blocks(mask, granule)
    NG = ids.shape[1]
    pad = NG * granule - S
    # the row padded to whole granules with masked-out entries
    fpad = torch.nn.functional.pad
    pos_p = fpad(src_pos, (0, 0, 0, pad))
    mass_p = fpad(src_mass, (0, pad))
    mask_p = fpad(mask, (0, pad))
    cell_p = fpad(src_cell, (0, 0, 0, pad), value=-1) if grid_sep else None
    zero = {"y": torch.zeros_like(tgt_pos), "ysum": torch.zeros_like(tts),
            "pot": torch.zeros_like(tts)}
    tot = dict(zero)          # the spans added so far
    run = dict(zero)          # the current span's sums
    nmax = int(cnt.max()) if C else 0
    lane = torch.arange(granule, device=dev)
    for k in range(nmax):
        take = k < cnt                                     # [C]
        end = take & (k + 1 == cnt)
        if span:
            end = end | (take & ((k + 1) % span == 0))
        sl = ids[:, k].clamp(max=NG - 1).long()[:, None] * granule + lane
        sp = pos_p[sl] - p                                 # [C, B, D]
        ss = dot = None
        for d in range(D):
            sq = sp[..., d] * sp[..., d]
            ss = sq if ss is None else ss + sq             # [C, B]
            pr = tp[:, :, None, d] * sp[:, None, :, d]
            dot = pr if dot is None else dot + pr          # [C, T, B]
        r2n = (tts[:, :, None] - 2.0 * dot) + ss[:, None, :]
        dead = r2n <= 2.0 ** -21 * (tts[:, :, None] + ss[:, None, :])
        if grid_sep:
            scb = cell_p[sl]                               # [C, B, D]
            csep = None
            for d in range(D):
                cd = (scb[:, None, :, d] - tgt_cell[:, :, None, d]).abs()
                csep = cd if csep is None else torch.maximum(csep, cd)
            dead = dead | ((csep >= grid_sep) & (scb[:, None, :, 0] >= 0))
        inv_r = torch.where(dead, 0.0, torch.rsqrt(r2n + eps2))
        mkb = torch.gather(mask_p, 1, sl).to(dtype)        # [C, B]
        w = (mass_p[sl] * mkb)[:, None, :] * inv_r
        part = {}
        if mode in ("both", "acc"):
            w3 = w * (inv_r * inv_r)
            part["ysum"] = w3.sum(-1)
            if prec == "highest":
                pairs = [(w3, sp)]
            else:
                ah, bh = _bf16(w3), _bf16(sp)
                pairs = [(ah, bh)]
                if prec == "x3":
                    pairs = [(ah, _bf16(sp - bh)), (_bf16(w3 - ah), bh),
                             (ah, bh)]
            ys = []
            for d in range(D):
                yd = None
                for a, b in pairs:
                    pr = a * b[:, None, :, d]
                    yd = pr if yd is None else yd + pr
                ys.append(yd.sum(-1))
            part["y"] = torch.stack(ys, dim=-1)
        if mode in ("both", "pot"):
            part["pot"] = -w.sum(-1)
        for o, v in part.items():
            sh = (C, 1, 1) if o == "y" else (C, 1)
            tk, ek = take.view(sh), end.view(sh)
            run[o] = torch.where(tk, run[o] + v, run[o])
            tot[o] = torch.where(ek, tot[o] + run[o], tot[o])
            run[o] = torch.where(ek, 0.0, run[o])
    return G * (tot["y"] - tot["ysum"][..., None] * tp), G * tot["pot"]


def eval_shared_blocks_plain(tgt_pos, tgt_idx, src_pos, src_mass, src_idx,
                             mask, scal, block: int = BLOCK,
                             span: int = BLOCKS_SPAN):
    """Plain version of the block-plan form K5 (counterpart of
    `rakau_tpu.kernels.pallas.eval_shared`): monopole, fp32, both outputs,
    in K5's plan (fused_plan(mask, span, block)): each tile's list of
    active blocks of `block` sources cut into spans of `span` entries, a
    block's [C, T, block] panel summed over its sources with every entry
    weighted by its mask (m_j * mask[c, j], the reference's multiply) and
    added into its span's sum, the spans' sums added in span order; times
    G."""
    if span < 1:
        raise ValueError("span must be >= 1")
    return eval_shared_plain(tgt_pos, tgt_idx, src_pos, src_mass, src_idx,
                             mask, scal, block=block, span=span,
                             weight_mask=True)


# ---------------------------------------------------------------- kernel
# Kernel launches per form (the main path's proof of use): "mono" is K1a,
# "mono_comp" K1b, "quad" K1d and "quad_comp" K1d with K1b's sums; the
# "_cell" forms are K1c, each of them with the cell-separation test; "mma"
# and "mma_cell" are the tensor-core form K6 (any precision) and "blocks"
# the block-plan form K5.
FORMS = ("mono", "mono_comp", "quad", "quad_comp", "mono_cell",
         "mono_comp_cell", "quad_cell", "quad_comp_cell", "mma", "mma_cell",
         "blocks")
# The kernel packs a source's D-dimensional cell into one int32 (fields of
# 30 // D bits) and takes coordinates below 2^CELL_BITS[D] (its
# cell_coord_bits, checked when the library loads) and grid_sep up to
# 2^CELL_BITS[D]. Every grid2 level that TreeConfig admits (up to 7 in
# 3-D, 10 in 2-D) lies inside; check_cell_level refuses a deeper grid.
CELL_BITS = {2: 13, 3: 8}
# Besides the forms, `launches` counts the launches made for 2-D operands
# padded to 3-D ("d2") and those of the float64 build ("f64"); each such
# launch counts under its form too.
COUNTERS = ("d2", "f64")
launches = dict.fromkeys(FORMS + COUNTERS, 0)


def form_name(quad: bool, compensated: bool, cell: bool = False) -> str:
    """The key of a kernel form in `launches`."""
    return (("quad" if quad else "mono") + ("_comp" if compensated else "")
            + ("_cell" if cell else ""))


def reset_launches():
    for k in launches:
        launches[k] = 0


def count_launch(counts: dict, form: str, d2: bool, f64: bool):
    """Add one launch of `form` to `counts` (a module's `launches`), and
    to its "d2" and "f64" counters where they apply."""
    counts[form] += 1
    counts["d2"] += int(d2)
    counts["f64"] += int(f64)


def pad_to_3d(*tensors, quad=None):
    """The operands of a 2-D kernel call as 3-D ones, for the 3-D kernels:
    each tensor [..., 2] (positions, leaf cells; None passes through) gets
    a zero z column, and the second moments quad [..., 3] (the columns of
    quad_pairs(2): xx, xy, yy) go to [..., 6] in the columns of
    quad_pairs(3), xz, yz and zz zero. Exact: every pair gains dz = 0, and
    the quadrupole terms read Q d, d.Q d and tr Q, which zeros leave as
    they were. Returns (list of the padded tensors, padded quad)."""
    out = [None if t is None
           else torch.nn.functional.pad(t, (0, 1)).contiguous()
           for t in tensors]
    if quad is not None:
        q6 = quad.new_zeros(quad.shape[:-1] + (6,))
        slots = [quad_pairs(3).index(p) for p in quad_pairs(2)]
        q6[..., slots] = quad
        quad = q6
    return out, quad


_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_libs: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def build_library(name: str = "shared_fused", f64: bool = False,
                  macros=()) -> Path:
    """Compile csrc/<name>.cu for sm_90a into _build/lib<name>_<hash>.so
    (keyed by the hash of the source, of the headers beside it and of the
    macros) unless it is there already; the ptxas report goes beside it.
    f64: the same source with -DRAKAU_REAL=double, into
    _build/lib<name>_f64_<hash>.so; `macros`: more -D flags (a build that
    the package itself never loads, such as another granule for a
    sweep). Raises on a failed build."""
    path = _CSRC / f"{name}.cu"
    macros = (["-DRAKAU_REAL=double"] if f64 else []) + list(macros)
    src = path.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh"))) \
        + " ".join(macros).encode()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD_DIR / f"lib{name}{'_f64' if f64 else ''}_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *macros, "-o", str(tmp), str(path)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    (_BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(res.stderr)
    return out


_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
# per library: its functions' argument types, and the constants it must
# report equal to this module's ("real_bytes": its scalar type's)
_LIBRARIES = {
    "shared_fused": ({"rakau_shared_fused_plan": [_VOIDP] * 6 + [_INT] * 3
                      + [_VOIDP],
                      "rakau_shared_fused_pack": [_VOIDP] * 6 + [_INT] * 6
                      + [_VOIDP],
                      "rakau_shared_fused": [_VOIDP] * 10 + [_INT] * 10
                      + [_VOIDP, _VOIDP],
                      "rakau_shared_fused_workspace": [_INT] * 7,
                      "rakau_shared_fused_grid": [_INT] * 10,
                      "rakau_shared_fused_blocks_per_sm": [_INT] * 5,
                      "rakau_shared_fused_targets_per_thread": []},
                     ("granule", "cell_bits", "real_bytes")),
    "shared_mma": ({"rakau_shared_mma_plan": [_VOIDP] * 6 + [_INT] * 3
                    + [_VOIDP],
                    "rakau_shared_mma_pack": [_VOIDP] * 4 + [_INT] * 5
                    + [_VOIDP],
                    "rakau_shared_mma": [_VOIDP] * 9 + [_INT] * 9
                    + [_VOIDP, _VOIDP],
                    "rakau_shared_mma_workspace": [_INT] * 5,
                    "rakau_shared_mma_grid": [_INT] * 9,
                    "rakau_shared_mma_blocks_per_sm": [_INT] * 4,
                    "rakau_shared_mma_targets_per_item": [],
                    "rakau_shared_mma_threads": []},
                   ("granule", "cell_bits")),
    "shared_blocks": ({"rakau_shared_blocks_plan": [_VOIDP] * 6
                       + [_INT] * 3 + [_VOIDP],
                       "rakau_shared_blocks_pack": [_VOIDP] * 4 + [_INT] * 4
                       + [_VOIDP],
                       "rakau_shared_blocks": [_VOIDP] * 9 + [_INT] * 5
                       + [_VOIDP, _VOIDP],
                       "rakau_shared_blocks_workspace": [_INT] * 4,
                       "rakau_shared_blocks_grid": [_INT] * 5,
                       "rakau_shared_blocks_blocks_per_sm": [],
                       "rakau_shared_blocks_targets_per_thread": [],
                       "rakau_shared_blocks_threads": [],
                       "rakau_shared_blocks_step": []}, ("block",)),
    "pool": ({"rakau_pool_plan": [_VOIDP] * 4 + [_INT] * 6 + [_VOIDP],
              "rakau_pool": [_VOIDP] * 13 + [_INT] * 10
              + [_VOIDP, _VOIDP],
              "rakau_pool_workspace": [_INT] * 3,
              "rakau_pool_grid": [_INT] * 6,
              "rakau_pool_blocks_per_sm": [_INT] * 3,
              "rakau_pool_targets_per_thread": []},
             ("granule", "real_bytes")),
    "tiles": ({"rakau_tiles_plan": [_VOIDP] * 5 + [_INT] * 5 + [_VOIDP],
               "rakau_tiles": [_VOIDP] * 15 + [_INT] * 7
               + [_VOIDP, _VOIDP],
               "rakau_tiles_workspace": [_INT] * 2,
               "rakau_tiles_grid": [_INT] * 3,
               "rakau_tiles_blocks_per_sm": [],
               "rakau_tiles_targets_per_thread": [],
               "rakau_tiles_pairwise_plan": [_VOIDP] * 4 + [_INT] * 5
               + [_VOIDP],
               "rakau_tiles_pairwise": [_VOIDP] * 12 + [_INT] * 7
               + [_VOIDP, _VOIDP],
               "rakau_tiles_pairwise_grid": [_INT] * 3,
               "rakau_tiles_pairwise_blocks_per_sm": []},
              ("granule", "real_bytes")),
}
# functions that return something else than an int
_RESTYPES = {"rakau_shared_fused_workspace": ctypes.c_size_t,
             "rakau_shared_mma_workspace": ctypes.c_size_t,
             "rakau_shared_blocks_workspace": ctypes.c_size_t,
             "rakau_pool_workspace": ctypes.c_size_t,
             "rakau_tiles_workspace": ctypes.c_size_t}
# the libraries that have a float64 build
F64_LIBRARIES = ("shared_fused", "pool", "tiles")


def bind_library(path, name: str = "shared_fused"):
    """Load the built library at `path` (of csrc/<name>.cu, either build)
    and declare its functions' argument and result types (the scalar
    type's values reach the kernels through device pointers)."""
    lib = ctypes.CDLL(str(path))
    for fname, argtypes in _LIBRARIES[name][0].items():
        fn = getattr(lib, fname)
        fn.restype = _RESTYPES.get(fname, _INT)
        fn.argtypes = argtypes
    lib.rakau_cuda_error_string.restype = ctypes.c_char_p
    lib.rakau_cuda_error_string.argtypes = [_INT]
    return lib


def _library(name: str = "shared_fused", f64: bool = False):
    """The built and loaded library csrc/<name>.cu (built at first use),
    in its float64 build with f64."""
    key = (name, f64)
    if key not in _libs:
        if f64 and name not in F64_LIBRARIES:
            raise ValueError(f"{name} has no float64 build")
        consts = _LIBRARIES[name][1]
        lib = bind_library(build_library(name, f64), name)
        granule = rows.GRANULE if name in ("pool", "tiles") else GRANULE
        checks = [("block", (), BLOCK), ("granule", (), granule),
                  ("real_bytes", (), 8 if f64 else 4)]
        checks += [("cell_bits", (d,), b) for d, b in CELL_BITS.items()]
        for const, args, want in checks:
            if const in consts:
                get = getattr(lib, f"rakau_{name}_{const}")
                get.restype = _INT
                get.argtypes = [_INT] * len(args)
                if get(*args) != want:
                    raise RuntimeError(f"{name}: kernel {const}{args} "
                                       f"{get(*args)} != {want}")
        _libs[key] = lib
    return _libs[key]


def scalar_buffer(eps, G, like):
    """The kernels' scalars [eps^2, G, eps^2, 1], of like's dtype on its
    device (eps and G numbers or 0-dim tensors): eps rounded to the dtype,
    then squared in it (the reference's `jnp.asarray(eps, dt) ** 2`).
    Every kernel and plain version takes this buffer in place of eps and
    G. A launch passes its address and the kernel reads eps^2 and G on the
    card, so that a graph takes them as inputs: a new eps or G replays it.
    K4, which applies no G, reads the last two. It is made once where eps
    and G enter a call (engine.scalars), or once by a caller of the
    kernels."""
    eps2 = scalar_tensor(eps, like) ** 2
    return torch.stack([eps2, scalar_tensor(G, like), eps2,
                        torch.ones_like(eps2)])


def check_scalars(scal, like):
    """(eps^2, G) of scal, raising ValueError unless it is a
    scalar_buffer for like: a contiguous [4] tensor of like's dtype on
    like's device."""
    if (not isinstance(scal, torch.Tensor) or tuple(scal.shape) != (4,)
            or scal.dtype != like.dtype or scal.device != like.device
            or not scal.is_contiguous()):
        raise ValueError(f"scal must be scalar_buffer(eps, G, like): [4] "
                         f"of {like.dtype} on {like.device}")
    return scal[0], scal[1]


def block_any(mask: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """[C, NB] bool: tile c has a live mask entry in source block j of
    `block` entries. The one place where a mask [C, S] becomes a kernel's
    plan: each form computes exactly the (tile, block) pairs that are true
    here at its own unit (PLAN_BLOCK: GRANULE for K1 and K6, BLOCK for
    K5), block x T pairs each, and metrics.processed_pairs counts them from
    here. The last block may be ragged (the kernels pad or bounds-check
    it)."""
    C, S = mask.shape
    nb = max(1, -(-S // block))
    pad = nb * block - S
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    return mask.reshape(C, nb, block).any(-1)


def active_blocks(mask: torch.Tensor, block: int = BLOCK):
    """Per-tile compacted lists of the blocks of block_any(mask, block), in
    row order: (ids [C, NB] int32, padded with NB; counts [C] int32)."""
    blk_any = block_any(mask, block)
    ids, cnt = su.compact_indices(blk_any, blk_any.shape[1])
    return ids.to(torch.int32), cnt.to(torch.int32)


class FusedPlan(NamedTuple):
    """The plan of one launch of K1 or K6. ids [C, NG] int32, cnt [C]
    int32: every tile's active granules (active_blocks(mask, GRANULE)).
    work [C * zmax] int32: the spans, tile * zmax + span index in
    tile-major order, span z of tile c the list entries [z * span,
    min((z + 1) * span, cnt[c])); n_work [1] int32 of them are live (the
    rest padding). zmax = ceil(NG / span), the most spans a tile can
    have."""
    ids: torch.Tensor
    cnt: torch.Tensor
    work: torch.Tensor
    n_work: torch.Tensor
    zmax: int


def fused_plan(mask: torch.Tensor, span: int = SPAN,
               granule: int = GRANULE) -> FusedPlan:
    """The plan of K1 and K6 for a mask [C, S], on the mask's device, with
    no host sync: each tile's active granules, cut into spans of `span`
    entries."""
    ids, cnt = active_blocks(mask, granule)
    zmax = -(-ids.shape[1] // span)
    nspan = (cnt.long() + span - 1) // span
    live = torch.arange(zmax, device=mask.device)[None, :] < nspan[:, None]
    work, n_work = su.compact_indices(live.reshape(1, -1), live.numel())
    return FusedPlan(ids, cnt, work[0].to(torch.int32),
                     n_work.to(torch.int32), zmax)


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_real(tgt_pos, f32_only: bool = False):
    """(D, float64?) of a kernel call from its targets [..., D]: the CUDA
    kernels take D = 2 (padded to 3-D) or 3, float32 or (where a float64
    build exists) float64; anything else raises."""
    D = tgt_pos.shape[-1]
    if D not in (2, 3):
        raise NotImplementedError(
            f"the CUDA kernels take 2-D or 3-D positions, got D = {D}")
    reals = (torch.float32,) if f32_only else (torch.float32, torch.float64)
    if tgt_pos.dtype not in reals:
        if f32_only and tgt_pos.dtype == torch.float64:
            raise ValueError("this kernel is float32 only (no float64 "
                             "build)")
        raise TypeError(f"tgt_pos must be one of {reals}, got "
                        f"{tgt_pos.dtype}")
    return D, tgt_pos.dtype == torch.float64


def check_devices(tgt_pos, named):
    """Raise unless every (name, tensor) of `named` lies on tgt_pos's
    device."""
    for name, t in named:
        if t.device != tgt_pos.device:
            raise ValueError(f"{name} is on {t.device}, targets on "
                             f"{tgt_pos.device}")


def check_cell_level(level: int, D: int):
    """Raise ValueError unless the packed cell test of the CUDA kernels
    takes the cells of a D-dimensional leaf grid at `level` (coordinates
    below 2^level)."""
    if D not in CELL_BITS or level > CELL_BITS[D]:
        raise ValueError(
            f"the CUDA cell test takes {D}-D leaf-grid levels up to "
            f"{CELL_BITS.get(D)}, got grid level {level}")


def _check_cells(src_cell, tgt_cell, grid_sep: int, D: int) -> int:
    """grid_sep, or 0 without cells; raises on cells without their
    partner or a separation the packed test of D-dimensional cells does
    not take (a D without kernels is left to _check_row)."""
    if src_cell is None:
        return 0
    top = 2 ** CELL_BITS.get(D, 30)
    if tgt_cell is None or not 1 <= grid_sep <= top:
        raise ValueError(f"src_cell needs tgt_cell and grid_sep in [1, {top}]")
    return grid_sep


def _check_row(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
               src_quad=None, src_cell=None, tgt_cell=None,
               f32_only: bool = False):
    """The checks every kernel form makes on its arguments: 2-D or 3-D
    float32 (or float64) tensors of one type, int64 indices, bool mask
    (and int32 or int64 cells), the stated shapes, contiguous, on one CUDA
    device, sizes below 2^31. Returns (C, T, S, D, float64?)."""
    D, f64 = check_real(tgt_pos, f32_only)
    C, T, _ = tgt_pos.shape
    S = src_pos.shape[0]
    real = tgt_pos.dtype
    _check("tgt_pos", tgt_pos, real, (C, T, D))
    _check("tgt_idx", tgt_idx, torch.int64, (C, T))
    _check("src_pos", src_pos, real, (S, D))
    _check("src_mass", src_mass, real, (S,))
    _check("src_idx", src_idx, torch.int64, (S,))
    _check("mask", mask, torch.bool, (C, S))
    named = [("tgt_idx", tgt_idx), ("src_pos", src_pos),
             ("src_mass", src_mass), ("src_idx", src_idx), ("mask", mask)]
    if src_quad is not None:
        _check("src_quad", src_quad, real, (S, D * (D + 1) // 2))
        named.append(("src_quad", src_quad))
    if src_cell is not None:
        for name, t, shape in (("src_cell", src_cell, (S, D)),
                               ("tgt_cell", tgt_cell, (C, T, D))):
            if t.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"{name} must be int32 or int64, got "
                                f"{t.dtype}")
            _check(name, t, t.dtype, shape)
            named.append((name, t))
    if max(C * T, S, C * S) >= 2 ** 31:
        raise ValueError("the CUDA kernel takes sizes below 2^31")
    check_devices(tgt_pos, named)
    return C, T, S, D, f64


def _outputs(tgt_pos):
    C, T, _ = tgt_pos.shape
    return (torch.empty((C, T, 3), dtype=tgt_pos.dtype,
                        device=tgt_pos.device),
            torch.empty((C, T), dtype=tgt_pos.dtype, device=tgt_pos.device))


def raise_on(err: int, lib, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.rakau_cuda_error_string(err).decode())


def multiprocessors(dev) -> int:
    """The streaming multiprocessors of CUDA device dev."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _device_plan(lib, mask, ws, stream, name: str = "shared_fused",
                 span: int = SPAN, granule: int = GRANULE) -> FusedPlan:
    """fused_plan(mask, span, granule) built on the card by the plan
    kernels of library `name` (shared_fused, shared_mma or shared_blocks:
    the same kernels, csrc/shared_plan.cuh, at the library's granule)
    into new tensors, the mask bits and flags into the workspace ws."""
    C, S = mask.shape
    ng = max(1, -(-S // granule))
    zmax = -(-ng // span)
    dev = mask.device
    plan = FusedPlan(torch.empty((C, ng), dtype=torch.int32, device=dev),
                     torch.empty((C,), dtype=torch.int32, device=dev),
                     torch.empty((C * zmax,), dtype=torch.int32, device=dev),
                     torch.empty((1,), dtype=torch.int32, device=dev), zmax)
    err = getattr(lib, f"rakau_{name}_plan")(
        mask.data_ptr(), ws.data_ptr(), plan.ids.data_ptr(),
        plan.cnt.data_ptr(), plan.work.data_ptr(), plan.n_work.data_ptr(),
        C, S, span, stream)
    raise_on(err, lib, f"{name} (plan)")
    return plan


def fused_device_plan(mask: torch.Tensor,
                      name: str = "shared_fused") -> FusedPlan:
    """The plan as the kernels of library `name` (K1's shared_fused or
    K6's shared_mma) build it from a bool mask [C, S] on a CUDA device,
    which must equal fused_plan(mask) in every field (a check of the
    kernels, not a step of the path)."""
    _check("mask", mask, torch.bool, mask.shape)
    lib = _library(name)
    C, S = mask.shape
    size = (lib.rakau_shared_fused_workspace(C, 1, S, SPAN, 0, 0, 0)
            if name == "shared_fused"
            else lib.rakau_shared_mma_workspace(C, 1, S, SPAN, 0))
    ws = torch.empty(size, dtype=torch.uint8, device=mask.device)
    with torch.cuda.device(mask.device):
        return _device_plan(lib, mask, ws, torch.cuda.current_stream(
            mask.device).cuda_stream, name)


def eval_shared_fused(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                      scal, mode: str = "both", compensated: bool = False,
                      src_quad=None, src_cell=None, tgt_cell=None,
                      grid_sep: int = 0):
    """The CUDA kernel (replaces `rakau_tpu.kernels.pallas.
    eval_shared_fused` in its fp32 and compensated forms, monopole or
    with src_quad [S, Q], each with or without the cell-separation test
    of src_cell [S, D] / tgt_cell [C, T, D] / grid_sep). Same arguments
    and results as eval_shared_plain at its default plan (fused_plan);
    2-D or 3-D float32 or float64 tensors, int64 indices (the cells int64
    or int32, coordinates below 2^CELL_BITS[D], see check_cell_level),
    bool mask, all on one CUDA device. On the current stream, with no
    host sync: the plan and the packed row into a workspace, then the
    kernel and its span reduction."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    grid_sep = _check_cells(src_cell, tgt_cell, grid_sep, tgt_pos.shape[-1])
    C, T, S, D, f64 = _check_row(tgt_pos, tgt_idx, src_pos, src_mass,
                                 src_idx, mask, src_quad,
                                 src_cell if grid_sep else None, tgt_cell)
    check_scalars(scal, tgt_pos)
    if D == 2:
        (tgt_pos, src_pos, src_cell, tgt_cell), src_quad = pad_to_3d(
            tgt_pos, src_pos, src_cell if grid_sep else None,
            tgt_cell if grid_sep else None, quad=src_quad)
    acc, pot = _outputs(tgt_pos)
    if C == 0 or T == 0:
        return acc[..., :D], pot
    if grid_sep:
        src_cell = src_cell.to(torch.int32)
        tgt_cell = tgt_cell.to(torch.int32)
    lib = _library("shared_fused", f64)
    dev = tgt_pos.device
    quad = src_quad is not None
    ws = torch.empty(lib.rakau_shared_fused_workspace(
        C, T, S, SPAN, int(quad), int(bool(grid_sep)), int(compensated)),
        dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        plan = _device_plan(lib, mask, ws, stream)
        err = lib.rakau_shared_fused_pack(
            src_pos.data_ptr(), src_mass.data_ptr(), src_idx.data_ptr(),
            src_quad.data_ptr() if quad else None,
            src_cell.data_ptr() if grid_sep else None, ws.data_ptr(), C, T,
            S, SPAN, int(compensated), D if grid_sep else 0, stream)
        raise_on(err, lib, "shared_fused (row packing)")
        err = lib.rakau_shared_fused(
            tgt_pos.data_ptr(), tgt_idx.data_ptr(),
            tgt_cell.data_ptr() if grid_sep else None, plan.ids.data_ptr(),
            plan.cnt.data_ptr(), plan.work.data_ptr(),
            plan.n_work.data_ptr(), ws.data_ptr(), acc.data_ptr(),
            pot.data_ptr(),
            C, T, S, SPAN, _MODES[mode], int(compensated), int(quad),
            int(grid_sep), D, multiprocessors(dev),
            scal.data_ptr(), stream)
    raise_on(err, lib, "shared_fused")
    count_launch(launches, form_name(quad, compensated, bool(grid_sep)),
                 D == 2, f64)
    return (acc if D == 3 else acc[..., :D].contiguous()), pot


def eval_shared_mma(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                    scal, mode: str = "both", prec: str = "x3",
                    src_cell=None, tgt_cell=None, grid_sep: int = 0):
    """The tensor-core CUDA kernel csrc/shared_mma.cu (replaces
    `rakau_tpu.kernels.pallas._shared_fused_kernel_mxu`): monopole, fp32
    sums, with or without the cell-separation test, at precision `prec`
    ("bf16" | "x3" | "highest"). Same arguments and results as
    eval_shared_mma_plain at its default plan (fused_plan), same tensor
    types as eval_shared_fused but float32 only (float64 raises
    ValueError); the indices are checked and not read. On the current
    stream, with no host sync: K1's plan and the packed row into a
    workspace (K1's own plan and packing kernels), then the kernel and its
    span reduction."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    if prec not in PRECS:
        raise ValueError(f"prec must be one of {tuple(PRECS)}")
    grid_sep = _check_cells(src_cell, tgt_cell, grid_sep, tgt_pos.shape[-1])
    C, T, S, D, _ = _check_row(tgt_pos, tgt_idx, src_pos, src_mass, src_idx,
                               mask, None, src_cell if grid_sep else None,
                               tgt_cell, f32_only=True)
    check_scalars(scal, tgt_pos)
    if D == 2:
        (tgt_pos, src_pos, src_cell, tgt_cell), _ = pad_to_3d(
            tgt_pos, src_pos, src_cell if grid_sep else None,
            tgt_cell if grid_sep else None)
    acc, pot = _outputs(tgt_pos)
    if C == 0 or T == 0:
        return acc[..., :D], pot
    if grid_sep:
        src_cell = src_cell.to(torch.int32)
        tgt_cell = tgt_cell.to(torch.int32)
    lib = _library("shared_mma")
    dev = tgt_pos.device
    ws = torch.empty(lib.rakau_shared_mma_workspace(C, T, S, SPAN,
                                                    int(bool(grid_sep))),
                     dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        plan = _device_plan(lib, mask, ws, stream, "shared_mma")
        err = lib.rakau_shared_mma_pack(
            src_pos.data_ptr(), src_mass.data_ptr(),
            src_cell.data_ptr() if grid_sep else None, ws.data_ptr(), C, T,
            S, SPAN, D if grid_sep else 0, stream)
        raise_on(err, lib, "shared_mma (row packing)")
        err = lib.rakau_shared_mma(
            tgt_pos.data_ptr(), tgt_cell.data_ptr() if grid_sep else None,
            plan.ids.data_ptr(), plan.cnt.data_ptr(), plan.work.data_ptr(),
            plan.n_work.data_ptr(), ws.data_ptr(), acc.data_ptr(),
            pot.data_ptr(), C, T, S, SPAN, _MODES[mode], PRECS[prec],
            int(grid_sep), D, multiprocessors(dev),
            scal.data_ptr(), stream)
    raise_on(err, lib, "shared_mma")
    count_launch(launches, "mma_cell" if grid_sep else "mma", D == 2, False)
    return (acc if D == 3 else acc[..., :D].contiguous()), pot


def blocks_device_plan(mask: torch.Tensor,
                       span: int = BLOCKS_SPAN) -> FusedPlan:
    """K5's plan as its kernels build it from a bool mask [C, S] on a CUDA
    device, which must equal fused_plan(mask, span, BLOCK) in every field
    (a check of the kernels, not a step of the path)."""
    _check("mask", mask, torch.bool, mask.shape)
    lib = _library("shared_blocks")
    C, S = mask.shape
    ws = torch.empty(lib.rakau_shared_blocks_workspace(C, 1, S, span),
                     dtype=torch.uint8, device=mask.device)
    with torch.cuda.device(mask.device):
        return _device_plan(lib, mask, ws, torch.cuda.current_stream(
            mask.device).cuda_stream, "shared_blocks", span, BLOCK)


def eval_shared_blocks(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                       scal, span: int = BLOCKS_SPAN):
    """The block-plan CUDA kernel csrc/shared_blocks.cu, K5 (replaces
    `rakau_tpu.kernels.pallas.eval_shared`): monopole, fp32 sums, both
    outputs. Same arguments and results as eval_shared_blocks_plain at the
    same `span` (its plan fused_plan(mask, span, BLOCK)), same tensor
    types as eval_shared_fused but float32 only (float64 raises
    ValueError). On the current stream, with no host sync: the plan and
    the packed row into a workspace (K1's plan and packing kernels at
    blocks of BLOCK), then the kernel and its span reduction, which
    applies G; two launches on the same inputs agree bit for bit."""
    if span < 1:
        raise ValueError("span must be >= 1")
    C, T, S, D, _ = _check_row(tgt_pos, tgt_idx, src_pos, src_mass,
                               src_idx, mask, f32_only=True)
    check_scalars(scal, tgt_pos)
    if D == 2:
        (tgt_pos, src_pos), _ = pad_to_3d(tgt_pos, src_pos)
    acc, pot = _outputs(tgt_pos)
    if C == 0 or T == 0:
        return acc[..., :D], pot
    lib = _library("shared_blocks")
    dev = tgt_pos.device
    ws = torch.empty(lib.rakau_shared_blocks_workspace(C, T, S, span),
                     dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        plan = _device_plan(lib, mask, ws, stream, "shared_blocks", span,
                            BLOCK)
        err = lib.rakau_shared_blocks_pack(
            src_pos.data_ptr(), src_mass.data_ptr(), src_idx.data_ptr(),
            ws.data_ptr(), C, T, S, span, stream)
        raise_on(err, lib, "shared_blocks (row packing)")
        err = lib.rakau_shared_blocks(
            tgt_pos.data_ptr(), tgt_idx.data_ptr(), plan.ids.data_ptr(),
            plan.cnt.data_ptr(), plan.work.data_ptr(),
            plan.n_work.data_ptr(), ws.data_ptr(), acc.data_ptr(),
            pot.data_ptr(), C, T, S, span, multiprocessors(dev),
            scal.data_ptr(), stream)
    raise_on(err, lib, "shared_blocks")
    count_launch(launches, "blocks", D == 2, False)
    return (acc if D == 3 else acc[..., :D].contiguous()), pot
