"""Kernel dispatch for the shared-candidate evaluation. Counterpart of
`rakau_tpu.kernels.dispatch.eval_shared`.

The device of the tensors decides: CUDA tensors go to the hand-written
kernel (or raise), CPU tensors to the plain PyTorch version. Nothing
falls back from one to the other.
"""
from __future__ import annotations

from ..config import TreeConfig
from . import shared


def eval_shared(cfg: TreeConfig, tgt_pos, tgt_idx, src_pos, src_mass,
                src_idx, mask, eps, G, mode: str = "both"):
    """Shared-candidate evaluation: sources [S, ...] common to the chunk's
    C tiles, per-tile mask [C, S]. mode: "both" | "acc" | "pot" (the
    skipped output is returned as zeros). Returns acc [C, T, D],
    pot [C, T]."""
    if cfg.accum != "fp32":
        raise NotImplementedError("accum='compensated' is not ported")
    if tgt_pos.is_cuda:
        return shared.eval_shared_fused(tgt_pos, tgt_idx, src_pos, src_mass,
                                        src_idx, mask, eps, G, mode=mode)
    return shared.eval_shared_plain(tgt_pos, tgt_idx, src_pos, src_mass,
                                    src_idx, mask, eps, G, mode=mode)
