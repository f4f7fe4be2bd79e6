"""Kernel dispatch for the shared-candidate and the gwalk pool
evaluations. Counterpart of `rakau_tpu.kernels.dispatch.eval_shared` and
`eval_pool`.

The device of the tensors decides: CUDA tensors go to the hand-written
kernel in the asked form (or raise), CPU tensors to the plain PyTorch
version. Nothing falls back from one to the other.

The shared row has three evaluators. The default is the fused kernel
(kernels.shared.eval_shared_fused, every form). `shared_variant` selects,
for the calls made inside it, the tensor-core form ("mma", at a precision)
or the split-source form ("blocks"); it is a diagnostic switch, read at
call time, and no TreeConfig field. (The reference reaches its matrix-unit
kernel by two environment variables read at trace time, and its
split-source kernel by no engine route.)
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ..config import TreeConfig
from . import pool, shared


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


def _eval(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask, eps, G,
          mode, compensated, src_quad=None, src_cell=None, tgt_cell=None,
          grid_sep=0):
    name, prec = _variant
    cuda = tgt_pos.is_cuda
    row = (tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask, eps, G)
    if name == "blocks":
        if (compensated or src_quad is not None or src_cell is not None
                or mode != "both"):
            raise ValueError(
                "shared_variant('blocks') evaluates the monopole in fp32 "
                "sums, mode 'both', without cells only")
        fn = shared.eval_shared_blocks if cuda \
            else shared.eval_shared_blocks_plain
        return fn(*row)
    if name == "mma" and not compensated and src_quad is None:
        fn = shared.eval_shared_mma if cuda else shared.eval_shared_mma_plain
        return fn(*row, mode=mode, prec=prec, src_cell=src_cell,
                  tgt_cell=tgt_cell, grid_sep=grid_sep)
    fn = shared.eval_shared_fused if cuda else shared.eval_shared_plain
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
    comp = cfg.accum == "compensated"
    sep = cfg.grid_sep if src_cell is not None else 0
    if src_pos.shape[0] == 0:
        C, T, D = tgt_pos.shape
        return (torch.zeros_like(tgt_pos),
                torch.zeros((C, T), dtype=tgt_pos.dtype,
                            device=tgt_pos.device))
    if src_quad is None:
        return _eval(tgt_pos, tgt_idx, src_pos, src_mass, src_idx, mask,
                     eps, G, mode, comp, None, src_cell, tgt_cell, sep)
    U = src_quad.shape[0]
    cell_n = cell_p = None
    if src_cell is not None:
        cell_n, cell_p = src_cell[:U], src_cell[U:]
    a1, p1 = eval_shared(cfg, tgt_pos, tgt_idx, src_pos[U:], src_mass[U:],
                         src_idx[U:], mask[:, U:].contiguous(), eps, G,
                         mode=mode, src_cell=cell_p, tgt_cell=tgt_cell)
    a2, p2 = _eval(tgt_pos, tgt_idx, src_pos[:U], src_mass[:U],
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
    fn = pool.eval_pool_fused if tgt_pos.is_cuda else pool.eval_pool_plain
    return fn(tgt_pos, tgt_idx, pool_pos, pool_mass, pool_idx, sched,
              window, eps, G, block,
              compensated=cfg.accum == "compensated", mode=mode,
              pool_quad=pool_quad)
