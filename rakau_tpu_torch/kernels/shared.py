"""Shared-candidate pairwise evaluation: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel (csrc/shared_fused.cu).

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


# ---------------------------------------------------------------- kernel
# Kernel launches per form (the main path's proof of use): "mono" is K1a,
# "mono_comp" K1b, "quad" K1d and "quad_comp" K1d with K1b's sums; the
# "_cell" forms are K1c, each of them with the cell-separation test.
FORMS = ("mono", "mono_comp", "quad", "quad_comp", "mono_cell",
         "mono_comp_cell", "quad_cell", "quad_comp_cell")
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
_lib = None


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
    (keyed by the source's hash) unless it is there already; the ptxas
    report goes beside it. Raises on a failed build."""
    path = _CSRC / f"{name}.cu"
    src = path.read_bytes()
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


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.rakau_shared_fused
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        lib.rakau_shared_fused_block.restype = ctypes.c_int
        if lib.rakau_shared_fused_block() != BLOCK:
            raise RuntimeError(
                f"kernel block {lib.rakau_shared_fused_block()} != "
                f"BLOCK {BLOCK}")
        lib.rakau_shared_fused_cell_bits.restype = ctypes.c_int
        if lib.rakau_shared_fused_cell_bits() != CELL_BITS:
            raise RuntimeError(
                f"kernel cell bits {lib.rakau_shared_fused_cell_bits()} != "
                f"CELL_BITS {CELL_BITS}")
        lib.rakau_cuda_error_string.restype = ctypes.c_char_p
        lib.rakau_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def active_blocks(mask: torch.Tensor):
    """Per-tile compacted lists of the BLOCK-sized source blocks with any
    live mask entry: (ids [C, NB] int32, padded with NB; counts [C]
    int32). The last block may be ragged (the kernel bounds-checks it)."""
    C, S = mask.shape
    nb = max(1, -(-S // BLOCK))
    pad = nb * BLOCK - S
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    blk_any = mask.reshape(C, nb, BLOCK).any(-1)
    ids, cnt = su.compact_indices(blk_any, nb)
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
    if src_cell is None:
        grid_sep = 0
    elif tgt_cell is None or not 1 <= grid_sep <= 2 ** CELL_BITS:
        raise ValueError("src_cell needs tgt_cell and grid_sep in "
                         f"[1, {2 ** CELL_BITS}]")
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
    if grid_sep:
        for name, t, shape in (("src_cell", src_cell, (S, 3)),
                               ("tgt_cell", tgt_cell, (C, T, 3))):
            if t.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"{name} must be int32 or int64, got "
                                f"{t.dtype}")
            _check(name, t, t.dtype, shape)
            named.append((name, t))
    if max(C * T, S, C * S) >= 2 ** 31:
        raise ValueError("the CUDA kernel takes sizes below 2^31")
    dev = tgt_pos.device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, targets on {dev}")
    acc = torch.empty((C, T, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((C, T), dtype=torch.float32, device=dev)
    if C == 0 or T == 0:
        return acc, pot
    ids, cnt = active_blocks(mask)
    if grid_sep:
        src_cell = src_cell.to(torch.int32)
        tgt_cell = tgt_cell.to(torch.int32)
    lib = _library()
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
    if err != 0:
        raise RuntimeError("shared_fused kernel launch failed: "
                           + lib.rakau_cuda_error_string(err).decode())
    launches[form_name(src_quad is not None, compensated,
                       bool(grid_sep))] += 1
    return G * acc, G * pot
