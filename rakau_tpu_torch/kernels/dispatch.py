"""Kernel dispatch for the shared-candidate, the gwalk pool and the
per-tile list evaluations. Counterpart of
`rakau_tpu.kernels.dispatch.eval_shared`, `eval_pool` and `eval_tiles`.

`cfg.kernel_backend` decides, as the reference's field does (`_kernel`):
"auto" sends CUDA tensors to the hand-written kernel in the asked form (or
raises) and CPU tensors to the plain PyTorch version; "xla" takes the plain
version on either device; "pallas" takes the kernel and raises ValueError
on CPU tensors. Nothing falls back from one to the other.

The shared row has three evaluators. The default is the fused kernel
(kernels.shared.eval_shared_fused, every form). `shared_variant` selects,
for the calls made inside it, the tensor-core form ("mma", at a precision)
or the split-source form ("blocks"); it is a diagnostic switch, read at
call time, and no TreeConfig field. (The reference reaches its matrix-unit
kernel by two environment variables read at trace time, and its
split-source kernel by no engine route.) The per-tile lists have two:
the fused kernel K3 (the default) and, inside `tiles_variant("split")`,
the split form K4 (the reference's `pallas.eval_tiles(fused=False)`).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ..config import TreeConfig
from . import pool, shared, tiles


VARIANTS = ("fused", "mma", "blocks")
# the selected evaluator of the shared row and the "mma" precision
_variant = ("fused", "x3")


@contextmanager
def shared_variant(name: str, prec: str = "x3"):
    """Inside the block, eval_shared evaluates the shared row by `name`:
    "fused" (the default), "mma" (the tensor-core form at precision
    `prec`, "bf16" | "x3" | "highest"; a compensated or a quadrupole
    launch still goes to the fused kernel, which alone has those forms) or
    "blocks" (the split-source form: monopole fp32, mode "both", no cells;
    anything else raises ValueError at the call)."""
    global _variant
    if name not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    if prec not in shared.PRECS:
        raise ValueError(f"prec must be one of {tuple(shared.PRECS)}")
    saved = _variant
    _variant = (name, prec)
    try:
        yield
    finally:
        _variant = saved


TILE_VARIANTS = ("fused", "split")
_tiles_fused = True


@contextmanager
def tiles_variant(name: str):
    """Inside the block, eval_tiles evaluates the monopole tile lists by
    `name`: "fused" (K3, the default) or "split" (K4, one launch a row,
    as `rakau_tpu.kernels.pallas.eval_tiles(fused=False)`); a diagnostic
    switch read at call time."""
    global _tiles_fused
    if name not in TILE_VARIANTS:
        raise ValueError(f"variant must be one of {TILE_VARIANTS}")
    saved = _tiles_fused
    _tiles_fused = name == "fused"
    try:
        yield
    finally:
        _tiles_fused = saved


def capture_key() -> tuple:
    """The global switches a captured query reads, for its CUDA graph's key
    (engine._run): the two variants above and torch's TF32 switches, which
    the plain matmuls and convolutions of the far fields read. A switch
    added here reaches the key with nothing else to change."""
    return (_variant, _tiles_fused, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _on_card(t) -> bool:
    return t.is_cuda


def _kernel(cfg: TreeConfig, t) -> bool:
    """Whether a call on tensor `t` goes to the hand-written kernel (True)
    or to its plain PyTorch version (False), by cfg.kernel_backend: "auto"
    by the tensor's device, "xla" never, "pallas" always (ValueError on a
    CPU tensor, which has no kernel)."""
    backend = cfg.kernel_backend
    if backend == "xla":
        return False
    if backend == "pallas" and not _on_card(t):
        raise ValueError("kernel_backend='pallas' needs CUDA tensors; the "
                         "CPU has only the plain versions (use 'auto' or "
                         "'xla')")
    return _on_card(t)


def _eval(kernel, tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask, eps, G,
          mode, compensated, src_quad=None, src_cell=None, tgt_cell=None,
          grid_sep=0):
    name, prec = _variant
    row = (tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask, eps, G)
    if name == "blocks":
        if (compensated or src_quad is not None or src_cell is not None
                or mode != "both"):
            raise ValueError(
                "shared_variant('blocks') evaluates the monopole in fp32 "
                "sums, mode 'both', without cells only")
        fn = shared.eval_shared_blocks if kernel \
            else shared.eval_shared_blocks_plain
        return fn(*row)
    if name == "mma" and not compensated and src_quad is None:
        fn = shared.eval_shared_mma if kernel else shared.eval_shared_mma_plain
        return fn(*row, mode=mode, prec=prec, src_cell=src_cell,
                  tgt_cell=tgt_cell, grid_sep=grid_sep)
    fn = shared.eval_shared_fused if kernel else shared.eval_shared_plain
    return fn(*row, mode=mode, compensated=compensated, src_quad=src_quad,
              src_cell=src_cell, tgt_cell=tgt_cell, grid_sep=grid_sep)


def eval_shared(cfg: TreeConfig, tgt_pos, tgt_idx, src_pos, src_mass,
                src_idx, mask, eps, G, mode: str = "both", src_quad=None,
                src_cell=None, tgt_cell=None):
    """Shared-candidate evaluation: sources [S, ...] common to the chunk's
    C tiles, per-tile mask [C, S]. mode: "both" | "acc" | "pot" (the
    skipped output is returned as zeros); cfg.accum == "compensated"
    selects the TwoSum block sums. Returns acc [C, T, D], pot [C, T].

    src_cell [S, D] / tgt_cell [C, T, D] (farfield "grid2"): the per-pair
    leaf-grid coverage test at separation cfg.grid_sep.

    src_quad [U, Q] (multipole_order=2): second moments of the FIRST U
    source rows (the traversal's M2P node rows). Two launches, the
    quadrupole form on rows [0, U) and the monopole form on rows [U, S),
    so the quadrupole's ~3x work per pair is paid on the node rows only;
    their results are summed. The cells are split with the rows."""
    kernel = _kernel(cfg, tgt_pos)
    comp = cfg.accum == "compensated"
    sep = cfg.grid_sep if src_cell is not None else 0
    if src_pos.shape[0] == 0:
        C, T, D = tgt_pos.shape
        return (torch.zeros_like(tgt_pos),
                torch.zeros((C, T), dtype=tgt_pos.dtype,
                            device=tgt_pos.device))
    if src_quad is None:
        return _eval(kernel, tgt_pos, tgt_idx, src_pos, src_mass, src_idx,
                     mask, eps, G, mode, comp, None, src_cell, tgt_cell,
                     sep)
    U = src_quad.shape[0]
    cell_n = cell_p = None
    if src_cell is not None:
        cell_n, cell_p = src_cell[:U], src_cell[U:]
    a1, p1 = eval_shared(cfg, tgt_pos, tgt_idx, src_pos[U:], src_mass[U:],
                         src_idx[U:], mask[:, U:].contiguous(), eps, G,
                         mode=mode, src_cell=cell_p, tgt_cell=tgt_cell)
    a2, p2 = _eval(kernel, tgt_pos, tgt_idx, src_pos[:U], src_mass[:U],
                   src_idx[:U], mask[:, :U].contiguous(), eps, G, mode,
                   comp, src_quad, cell_n, tgt_cell, sep)
    return a1 + a2, p1 + p2


def eval_pool(cfg: TreeConfig, tgt_pos, tgt_idx, pool_pos, pool_mass,
              pool_idx, sched, window: int, block: int, eps, G,
              mode: str = "both", pool_quad=None):
    """gwalk pool evaluation (kernels/pool.py): tile g of tgt_pos
    [G, T, D] sums its scheduled pool segment (sched [G, 4]); one launch
    for the whole query. cfg.accum == "compensated" selects the TwoSum
    block sums, in the monopole form too. Returns acc [G, T, D],
    pot [G, T]."""
    fn = pool.eval_pool_fused if _kernel(cfg, tgt_pos) \
        else pool.eval_pool_plain
    return fn(tgt_pos, tgt_idx, pool_pos, pool_mass, pool_idx, sched,
              window, eps, G, block,
              compensated=cfg.accum == "compensated", mode=mode,
              pool_quad=pool_quad)


def eval_tiles(cfg: TreeConfig, tgt_pos, tgt_idx, m2p_pos, m2p_mass,
               m2p_quad, p2p_pos, p2p_mass, p2p_idx, eps, G, m2p_cnt=None,
               p2p_cnt=None):
    """Far-field (M2P) plus near-field (P2P) sums of the per-tile lists
    (rows [C, Sm] and [C, Sp], counts [C]). Returns acc [C, T, D],
    pot [C, T].

    The monopole goes to kernels.tiles.eval_tiles: CUDA tensors to K3 (K4
    under tiles_variant("split")), CPU tensors to their plain versions.
    With m2p_quad [C, Sm, Q] the reference has no kernel (its Pallas tile
    kernels are monopole-only, `pallas.eval_tiles` raises) and takes its
    plain-op route, `xla.eval_m2p` + `xla.eval_p2p`, on whatever device
    the tensors lie on; so does the port (tiles.eval_m2p + eval_p2p),
    counted in tiles.launches["xla_quad"]. Of cfg only kernel_backend is
    read: the lists kernels have no modes, compensated sums or cells."""
    kernel = _kernel(cfg, tgt_pos)
    if m2p_quad is not None:
        tiles.launches["xla_quad"] += 1
        am, pm = tiles.eval_m2p(tgt_pos, m2p_pos, m2p_mass, eps, G,
                                src_quad=m2p_quad)
        ap, pp = tiles.eval_p2p(tgt_pos, tgt_idx, p2p_pos, p2p_mass,
                                p2p_idx, eps, G)
        return am + ap, pm + pp
    return tiles.eval_tiles(tgt_pos, tgt_idx, m2p_pos, m2p_mass, None,
                            p2p_pos, p2p_mass, p2p_idx, eps, G,
                            m2p_cnt=m2p_cnt, p2p_cnt=p2p_cnt,
                            fused=_tiles_fused, kernel=kernel)
