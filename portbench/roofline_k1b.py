"""The operation and byte count of K1b, the compensated monopole form of
csrc/shared_fused.cu, frozen here so that a change to the program cannot
move it: a copy of chip_smoke.py's `bound` for this form (comp=True).

Beside K1a's count (portbench/roofline.py, whose peaks and 20 operations
a live pair this takes): TwoSum's FLOPS_TWOSUM fp32 operations a real
target for each staged granule and for each span of the tile's plan. The
plan's granules are the GRANULE-source blocks of a tile's mask row that
hold a true entry, cut into spans of SPAN of them (the values of
rakau_tpu_torch.kernels.shared's GRANULE and SPAN, counted here from the
mask, not read from the program)."""
from __future__ import annotations

import torch

from portbench.roofline import FLOPS_MONO, PEAK_BYTES, PEAK_FP32

FLOPS_TWOSUM = 24          # fp32 operations a TwoSum, a real target
GRANULE = 128              # sources a granule of the plan
SPAN = 2                   # granules a span of the plan


def granules(mask: torch.Tensor) -> torch.Tensor:
    """[C] int64: the granules of each tile's mask row [C, S] that hold a
    true entry (the last one padded with false)."""
    C, S = mask.shape
    nb = max(1, -(-S // GRANULE))
    mask = torch.nn.functional.pad(mask, (0, nb * GRANULE - S))
    return mask.reshape(C, nb, GRANULE).any(-1).sum(1)


def k1b_bound(inputs, n: int) -> tuple:
    """(seconds, "bytes" | "operations") of one K1b call on `inputs` =
    (tgt_pos [C, T, D], tgt_idx [C, T], src_pos [S, D], src_mass [S],
    src_idx [S], mask [C, S]), padding targets carrying the index n: the
    larger of the bytes (each operand read once, acc and pot written
    once) over the bandwidth and the operations (live pairs x FLOPS_MONO,
    and TwoSum's per granule and span) over the fp32 peak."""
    tpos, tidx, spos, smass, sidx, mask = inputs[:6]
    C, T, _ = tpos.shape
    nbytes = sum(t.numel() * t.element_size() for t in inputs[:6])
    nbytes += C * T * 4 * tpos.element_size()                # acc, pot
    ntgt = (tidx < n).sum(1).double()
    pairs = float((mask.sum(1).double() * ntgt).sum())
    cnt = granules(mask).double()
    staged = float(((cnt + (cnt / SPAN).ceil()) * ntgt).sum())
    t_bytes = nbytes / PEAK_BYTES
    t_ops = (pairs * FLOPS_MONO + staged * FLOPS_TWOSUM) / PEAK_FP32
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")
