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
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .. import scan_utils as su

_MODES = {"both": 0, "acc": 1, "pot": 2}
# Source-block granularity of the kernel's active-block lists: each CUDA
# block stages this many sources in shared memory per step (x, y, z,
# m*mask as float4 + idx as int32: 20 KB at 1024; the quadrupole form
# adds its 6 second-moment planes, 24 KB, the cell forms one packed int32
# cell, 4 KB: 48 KB with both). This is the single source of
# the block plan for every form; the kernel's kBlock must equal it
# (checked when the library loads). The plain version sums by the same
# blocks unless told otherwise.
BLOCK = 1024


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
                      eps, G, mode: str = "both", block: int = BLOCK,
                      compensated: bool = False, src_quad=None,
                      src_cell=None, tgt_cell=None, grid_sep: int = 0):
    """Plain version (counterpart of `rakau_tpu.kernels.xla.eval_shared`):
    loops over source blocks with [C, T, B] panels.

    tgt_pos [C, T, D], tgt_idx [C, T], src_pos [S, D], src_mass [S],
    src_idx [S], mask [C, S] bool (+ src_quad [S, Q]; + integer
    src_cell [S, D], tgt_cell [C, T, D] and grid_sep) -> acc [C, T, D],
    pot [C, T]."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    if src_cell is None:
        grid_sep = 0
    elif tgt_cell is None or grid_sep < 1:
        raise ValueError("src_cell needs tgt_cell and grid_sep >= 1")
    C, T, D = tgt_pos.shape
    S = src_pos.shape[0]
    dtype = tgt_pos.dtype
    eps2 = torch.full((), eps, dtype=dtype, device=tgt_pos.device) ** 2
    acc = torch.zeros_like(tgt_pos)
    pot = torch.zeros_like(tgt_pos[..., 0])
    acc_c = torch.zeros_like(acc)
    pot_c = torch.zeros_like(pot)
    mk = mask.to(dtype)
    for s in range(0, S, block):
        if not bool(mask[:, s:s + block].any()):
            continue    # no tile takes this block: it adds exact zeros
        sp = src_pos[s:s + block]
        mkb = mk[:, None, s:s + block]
        m = src_mass[s:s + block][None, None, :] * mkb
        dds = [sp[None, None, :, d] - tgt_pos[:, :, None, d]
               for d in range(D)]
        r2 = eps2 + sum(dd * dd for dd in dds)
        inv_r = torch.rsqrt(r2)
        dead = (src_idx[s:s + block][None, None, :] == tgt_idx[:, :, None]) \
            | (r2 <= 0)
        if grid_sep:
            scb = src_cell[s:s + block]
            csep = None
            for d in range(D):
                cd = (scb[None, None, :, d] - tgt_cell[:, :, None, d]).abs()
                csep = cd if csep is None else torch.maximum(csep, cd)
            dead = dead | ((csep >= grid_sep) & (scb[None, None, :, 0] >= 0))
        if src_quad is not None:
            dead = dead | (mkb <= 0)
        inv_r = torch.where(dead, 0.0, inv_r)
        w = m * inv_r
        dacc = dpot = None
        if mode in ("both", "acc"):
            w3 = w * inv_r * inv_r
            dacc = [w3 * dd for dd in dds]
        if mode in ("both", "pot"):
            dpot = -w
        if src_quad is not None:
            qa, qp = _quad_terms(dds, src_quad[s:s + block], mkb, inv_r,
                                 mode)
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

PRECS = {"bf16": 0, "x3": 1, "highest": 2}


def _bf16(x):
    """x rounded to bfloat16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def eval_shared_mma_plain(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                          eps, G, mode: str = "both", prec: str = "x3",
                          block: int = BLOCK, src_cell=None, tgt_cell=None,
                          grid_sep: int = 0):
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
    [T, B] x [B, D] product per source block at precision `prec`: "bf16"
    (both operands rounded to bfloat16, fp32 sums), "x3" (w3 = Ah + Al and
    s' = Bh + Bl in bfloat16, the three products Ah Bl + Al Bh + Ah Bh) or
    "highest" (fp32). Arguments and results as eval_shared_plain."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    if prec not in PRECS:
        raise ValueError(f"prec must be one of {tuple(PRECS)}")
    if src_cell is None:
        grid_sep = 0
    elif tgt_cell is None or grid_sep < 1:
        raise ValueError("src_cell needs tgt_cell and grid_sep >= 1")
    C, T, D = tgt_pos.shape
    S = src_pos.shape[0]
    dtype = tgt_pos.dtype
    eps2 = torch.full((), eps, dtype=dtype, device=tgt_pos.device) ** 2
    p = tgt_pos[:, :1, :]                               # [C, 1, D]
    tp = tgt_pos - p
    tts = None
    for d in range(D):
        sq = tp[..., d] * tp[..., d]
        tts = sq if tts is None else tts + sq           # [C, T]
    y = torch.zeros_like(tgt_pos)
    ysum = torch.zeros_like(tts)
    pot = torch.zeros_like(tts)
    mk = mask.to(dtype)
    for s in range(0, S, block):
        if not bool(mask[:, s:s + block].any()):
            continue    # no tile takes this block: it adds exact zeros
        sp = src_pos[None, s:s + block] - p             # [C, B, D]
        ss = dot = None
        for d in range(D):
            sq = sp[..., d] * sp[..., d]
            ss = sq if ss is None else ss + sq          # [C, B]
            pr = tp[:, :, None, d] * sp[:, None, :, d]
            dot = pr if dot is None else dot + pr       # [C, T, B]
        r2n = (tts[:, :, None] - 2.0 * dot) + ss[:, None, :]
        dead = r2n <= 2.0 ** -21 * (tts[:, :, None] + ss[:, None, :])
        if grid_sep:
            scb = src_cell[s:s + block]
            csep = None
            for d in range(D):
                cd = (scb[None, None, :, d] - tgt_cell[:, :, None, d]).abs()
                csep = cd if csep is None else torch.maximum(csep, cd)
            dead = dead | ((csep >= grid_sep) & (scb[None, None, :, 0] >= 0))
        inv_r = torch.where(dead, 0.0, torch.rsqrt(r2n + eps2))
        w = (src_mass[s:s + block][None, None, :]
             * mk[:, None, s:s + block]) * inv_r
        if mode in ("both", "acc"):
            w3 = w * (inv_r * inv_r)
            ysum += w3.sum(-1)
            if prec == "highest":
                parts = [(w3, sp)]
            else:
                ah, bh = _bf16(w3), _bf16(sp)
                parts = [(ah, bh)]
                if prec == "x3":
                    parts = [(ah, _bf16(sp - bh)), (_bf16(w3 - ah), bh),
                             (ah, bh)]
            for d in range(D):
                yd = None
                for a, b in parts:
                    pr = a * b[:, None, :, d]
                    yd = pr if yd is None else yd + pr
                y[..., d] += yd.sum(-1)
        if mode in ("both", "pot"):
            pot -= w.sum(-1)
    return G * (y - ysum[..., None] * tp), G * pot


def eval_shared_blocks_plain(tgt_pos, tgt_idx, src_pos, src_mass, src_idx,
                             mask, eps, G, block: int = BLOCK,
                             nsplit: int = 1):
    """Plain version of the split-source form (counterpart of
    `rakau_tpu.kernels.pallas.eval_shared`): the monopole sums of
    eval_shared_plain, fp32, both outputs, as per-block sums: the row's
    blocks are cut into `nsplit` contiguous spans, each span adds its
    blocks' sums in block order ((tile, block) pairs with an empty mask
    add exact zeros), and the spans' sums are added in order."""
    C, T, D = tgt_pos.shape
    S = src_pos.shape[0]
    nb = max(1, -(-S // block))
    if not 1 <= nsplit <= nb:
        raise ValueError(f"nsplit must be in [1, {nb}]")
    per = -(-nb // nsplit)
    acc = torch.zeros_like(tgt_pos)
    pot = torch.zeros_like(tgt_pos[..., 0])
    for z in range(nsplit):
        a, p = eval_shared_plain(
            tgt_pos, tgt_idx, src_pos[z * per * block:(z + 1) * per * block],
            src_mass[z * per * block:(z + 1) * per * block],
            src_idx[z * per * block:(z + 1) * per * block],
            mask[:, z * per * block:(z + 1) * per * block], eps, 1.0,
            block=block)
        acc += a
        pot += p
    return G * acc, G * pot


# ---------------------------------------------------------------- kernel
# Kernel launches per form (the main path's proof of use): "mono" is K1a,
# "mono_comp" K1b, "quad" K1d and "quad_comp" K1d with K1b's sums; the
# "_cell" forms are K1c, each of them with the cell-separation test; "mma"
# and "mma_cell" are the tensor-core form K6 (any precision) and "blocks"
# the split-source form K5.
FORMS = ("mono", "mono_comp", "quad", "quad_comp", "mono_cell",
         "mono_comp_cell", "quad_cell", "quad_comp_cell", "mma", "mma_cell",
         "blocks")
# The kernel packs a source's cell into one int32 and takes coordinates
# below 2^CELL_BITS (its kCellBits, checked when the library loads), which
# grid2's level cap of 7 in 3-D guarantees, and grid_sep up to 2^CELL_BITS.
CELL_BITS = 7
launches = dict.fromkeys(FORMS, 0)


def form_name(quad: bool, compensated: bool, cell: bool = False) -> str:
    """The key of a kernel form in `launches`."""
    return (("quad" if quad else "mono") + ("_comp" if compensated else "")
            + ("_cell" if cell else ""))


def reset_launches():
    for k in FORMS:
        launches[k] = 0


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


def build_library(name: str = "shared_fused") -> Path:
    """Compile csrc/<name>.cu for sm_90a into _build/lib<name>_<hash>.so
    (keyed by the hash of the source and of the headers beside it) unless
    it is there already; the ptxas report goes beside it. Raises on a
    failed build."""
    path = _CSRC / f"{name}.cu"
    src = path.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(path)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    (_BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(res.stderr)
    return out


_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
# per library: the launch function's argument types, and the constants it
# must report equal to this module's
_LIBRARIES = {
    "shared_fused": ([_VOIDP] * 13 + [_INT] * 7 + [ctypes.c_float, _VOIDP],
                     ("block", "cell_bits")),
    "shared_mma": ([_VOIDP] * 10 + [_INT] * 7 + [ctypes.c_float, _VOIDP],
                   ("block", "cell_bits")),
    "shared_blocks": ([_VOIDP] * 10 + [_INT] * 5 + [ctypes.c_float, _VOIDP],
                      ("block",)),
}


def _library(name: str = "shared_fused"):
    """The built and loaded library csrc/<name>.cu (built at first use)."""
    if name not in _libs:
        argtypes, consts = _LIBRARIES[name]
        lib = ctypes.CDLL(str(build_library(name)))
        fn = getattr(lib, f"rakau_{name}")
        fn.restype = _INT
        fn.argtypes = argtypes
        for const, want in (("block", BLOCK), ("cell_bits", CELL_BITS)):
            if const in consts:
                get = getattr(lib, f"rakau_{name}_{const}")
                get.restype = _INT
                if get() != want:
                    raise RuntimeError(f"{name}: kernel {const} {get()} != "
                                       f"{want}")
        lib.rakau_cuda_error_string.restype = ctypes.c_char_p
        lib.rakau_cuda_error_string.argtypes = [_INT]
        _libs[name] = lib
    return _libs[name]


def block_any(mask: torch.Tensor) -> torch.Tensor:
    """[C, NB] bool: tile c has a live mask entry in source block j of
    BLOCK entries. The one place where a mask [C, S] becomes the kernels'
    block plan: every form computes exactly the (tile, block) pairs that
    are true here, BLOCK x T pairs each, and metrics.collect_shared_density
    counts them from here. The last block may be ragged (the kernels
    bounds-check it)."""
    C, S = mask.shape
    nb = max(1, -(-S // BLOCK))
    pad = nb * BLOCK - S
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    return mask.reshape(C, nb, BLOCK).any(-1)


def active_blocks(mask: torch.Tensor):
    """Per-tile compacted lists of the blocks of block_any(mask):
    (ids [C, NB] int32, padded with NB; counts [C] int32)."""
    blk_any = block_any(mask)
    ids, cnt = su.compact_indices(blk_any, blk_any.shape[1])
    return ids.to(torch.int32), cnt.to(torch.int32)


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


def _check_cells(src_cell, tgt_cell, grid_sep: int) -> int:
    """grid_sep, or 0 without cells; raises on cells without their
    partner or a separation the packed test does not take."""
    if src_cell is None:
        return 0
    if tgt_cell is None or not 1 <= grid_sep <= 2 ** CELL_BITS:
        raise ValueError("src_cell needs tgt_cell and grid_sep in "
                         f"[1, {2 ** CELL_BITS}]")
    return grid_sep


def _check_row(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
               src_quad=None, src_cell=None, tgt_cell=None):
    """The checks every kernel form makes on its arguments: float32
    tensors, int64 indices, bool mask (and int32 or int64 cells), the
    stated shapes, contiguous, on one CUDA device, 3-D, sizes below 2^31.
    Returns (C, T, S)."""
    C, T, D = tgt_pos.shape
    S = src_pos.shape[0]
    if D != 3:
        raise NotImplementedError("the CUDA kernel is 3-D only")
    _check("tgt_pos", tgt_pos, torch.float32, (C, T, 3))
    _check("tgt_idx", tgt_idx, torch.int64, (C, T))
    _check("src_pos", src_pos, torch.float32, (S, 3))
    _check("src_mass", src_mass, torch.float32, (S,))
    _check("src_idx", src_idx, torch.int64, (S,))
    _check("mask", mask, torch.bool, (C, S))
    named = [("tgt_idx", tgt_idx), ("src_pos", src_pos),
             ("src_mass", src_mass), ("src_idx", src_idx), ("mask", mask)]
    if src_quad is not None:
        _check("src_quad", src_quad, torch.float32, (S, 6))
        named.append(("src_quad", src_quad))
    if src_cell is not None:
        for name, t, shape in (("src_cell", src_cell, (S, 3)),
                               ("tgt_cell", tgt_cell, (C, T, 3))):
            if t.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"{name} must be int32 or int64, got "
                                f"{t.dtype}")
            _check(name, t, t.dtype, shape)
            named.append((name, t))
    if max(C * T, S, C * S) >= 2 ** 31:
        raise ValueError("the CUDA kernel takes sizes below 2^31")
    for name, t in named:
        if t.device != tgt_pos.device:
            raise ValueError(f"{name} is on {t.device}, targets on "
                             f"{tgt_pos.device}")
    return C, T, S


def _outputs(tgt_pos):
    C, T, _ = tgt_pos.shape
    return (torch.empty((C, T, 3), dtype=torch.float32,
                        device=tgt_pos.device),
            torch.empty((C, T), dtype=torch.float32, device=tgt_pos.device))


def _raise_on(err: int, lib, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.rakau_cuda_error_string(err).decode())


def eval_shared_fused(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                      eps, G, mode: str = "both", compensated: bool = False,
                      src_quad=None, src_cell=None, tgt_cell=None,
                      grid_sep: int = 0):
    """The CUDA kernel (replaces `rakau_tpu.kernels.pallas.
    eval_shared_fused` in its fp32 and compensated forms, monopole or
    with src_quad [S, 6], each with or without the cell-separation test
    of src_cell [S, 3] / tgt_cell [C, T, 3] / grid_sep). Same arguments
    and results as eval_shared_plain; float32 tensors, int64 indices
    (the cells int64 or int32, coordinates below 2^CELL_BITS: the grid2
    levels end at 7), bool mask, all on one CUDA device. Launches on the
    current stream."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    grid_sep = _check_cells(src_cell, tgt_cell, grid_sep)
    C, T, S = _check_row(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                         src_quad, src_cell if grid_sep else None, tgt_cell)
    acc, pot = _outputs(tgt_pos)
    if C == 0 or T == 0:
        return acc, pot
    ids, cnt = active_blocks(mask)
    if grid_sep:
        src_cell = src_cell.to(torch.int32)
        tgt_cell = tgt_cell.to(torch.int32)
    lib = _library("shared_fused")
    dev = tgt_pos.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    eps2 = float(torch.tensor(eps, dtype=torch.float32) ** 2)
    with torch.cuda.device(dev):
        err = lib.rakau_shared_fused(
            tgt_pos.data_ptr(), tgt_idx.data_ptr(), src_pos.data_ptr(),
            src_mass.data_ptr(), src_idx.data_ptr(), mask.data_ptr(),
            None if src_quad is None else src_quad.data_ptr(),
            src_cell.data_ptr() if grid_sep else None,
            tgt_cell.data_ptr() if grid_sep else None,
            ids.data_ptr(), cnt.data_ptr(), acc.data_ptr(), pot.data_ptr(),
            C, T, S, ids.shape[1], _MODES[mode], int(compensated),
            int(grid_sep), eps2, stream)
    _raise_on(err, lib, "shared_fused")
    launches[form_name(src_quad is not None, compensated,
                       bool(grid_sep))] += 1
    return G * acc, G * pot


def eval_shared_mma(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                    eps, G, mode: str = "both", prec: str = "x3",
                    src_cell=None, tgt_cell=None, grid_sep: int = 0):
    """The tensor-core CUDA kernel csrc/shared_mma.cu (replaces
    `rakau_tpu.kernels.pallas._shared_fused_kernel_mxu`): monopole, fp32
    sums, with or without the cell-separation test, at precision `prec`
    ("bf16" | "x3" | "highest"). Same arguments and results as
    eval_shared_mma_plain, same tensor types as eval_shared_fused; the
    indices are checked and not read. Launches on the current stream."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    if prec not in PRECS:
        raise ValueError(f"prec must be one of {tuple(PRECS)}")
    grid_sep = _check_cells(src_cell, tgt_cell, grid_sep)
    C, T, S = _check_row(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                         None, src_cell if grid_sep else None, tgt_cell)
    acc, pot = _outputs(tgt_pos)
    if C == 0 or T == 0:
        return acc, pot
    ids, cnt = active_blocks(mask)
    if grid_sep:
        src_cell = src_cell.to(torch.int32)
        tgt_cell = tgt_cell.to(torch.int32)
    lib = _library("shared_mma")
    dev = tgt_pos.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    eps2 = float(torch.tensor(eps, dtype=torch.float32) ** 2)
    with torch.cuda.device(dev):
        err = lib.rakau_shared_mma(
            tgt_pos.data_ptr(), src_pos.data_ptr(), src_mass.data_ptr(),
            mask.data_ptr(), src_cell.data_ptr() if grid_sep else None,
            tgt_cell.data_ptr() if grid_sep else None, ids.data_ptr(),
            cnt.data_ptr(), acc.data_ptr(), pot.data_ptr(), C, T, S,
            ids.shape[1], _MODES[mode], PRECS[prec], int(grid_sep), eps2,
            stream)
    _raise_on(err, lib, "shared_mma")
    launches["mma_cell" if grid_sep else "mma"] += 1
    return G * acc, G * pot


# CUDA blocks per SM that eval_shared_blocks aims at when it splits the row
BLOCKS_PER_SM = 8
_KERNEL_THREADS = 128       # targets per CUDA block of every form


def blocks_nsplit(C: int, T: int, nb: int, sms: int) -> int:
    """Spans into which eval_shared_blocks cuts a row of nb source blocks:
    as many as bring the launch to BLOCKS_PER_SM CUDA blocks per SM, given
    the C * ceil(T / 128) that the targets alone give, at least 1 and at
    most one span a block."""
    base = C * -(-T // _KERNEL_THREADS)
    return max(1, min(nb, -(-BLOCKS_PER_SM * sms // base)))


def eval_shared_blocks(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                       eps, G, nsplit: int = None):
    """The split-source CUDA kernel csrc/shared_blocks.cu (replaces
    `rakau_tpu.kernels.pallas.eval_shared`): monopole, fp32 sums, both
    outputs. CUDA block (tile, 128 targets, span) sums the span's blocks
    that block_any(mask) marks for the tile into a scratch
    [nsplit, C, T, 4]; a second kernel adds the spans in order, so two
    launches on the same inputs agree bit for bit. nsplit defaults to
    blocks_nsplit for the tensors' device. Same arguments and results as
    eval_shared_blocks_plain, same tensor types as eval_shared_fused.
    Launches on the current stream."""
    C, T, S = _check_row(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask)
    acc, pot = _outputs(tgt_pos)
    if C == 0 or T == 0:
        return acc, pot
    dev = tgt_pos.device
    blk = block_any(mask).to(torch.uint8).contiguous()
    nb = blk.shape[1]
    if nsplit is None:
        nsplit = blocks_nsplit(
            C, T, nb, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
    if not 1 <= nsplit <= nb:
        raise ValueError(f"nsplit must be in [1, {nb}]")
    scratch = torch.empty((nsplit, C, T, 4), dtype=torch.float32, device=dev)
    lib = _library("shared_blocks")
    stream = torch.cuda.current_stream(dev).cuda_stream
    eps2 = float(torch.tensor(eps, dtype=torch.float32) ** 2)
    with torch.cuda.device(dev):
        err = lib.rakau_shared_blocks(
            tgt_pos.data_ptr(), tgt_idx.data_ptr(), src_pos.data_ptr(),
            src_mass.data_ptr(), src_idx.data_ptr(), mask.data_ptr(),
            blk.data_ptr(), scratch.data_ptr(), acc.data_ptr(),
            pot.data_ptr(), C, T, S, nb, nsplit, eps2, stream)
    _raise_on(err, lib, "shared_blocks")
    launches["blocks"] += 1
    return G * acc, G * pot
