"""The yardstick's table of peaks and the operation and byte counts of the
port's kernels, frozen here so that a change to the program cannot move
them.

Peaks: one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense
rates): fp32 outside the tensor cores and HBM bandwidth.

K1a (csrc/shared_fused.cu, monopole fp32): one call reads its six
operands once and writes acc and pot once; each live pair (a mask-true
source row times a real target of the n-particle tree) costs 20 fp32
operations, counted from the kernel's inner loop. The least time of a call
is the larger of bytes over the bandwidth and operations over the fp32
peak. A copy of chip_smoke.py's `bound` for this form."""
from __future__ import annotations

PEAK_FP32 = 67e12          # operations/s
PEAK_BYTES = 3.35e12       # bytes/s
FLOPS_MONO = 20            # fp32 operations a live monopole pair


def k1a_bound(inputs, n: int) -> tuple:
    """(seconds, "bytes" | "operations") of one K1a call on `inputs` =
    (tgt_pos [C, T, D], tgt_idx [C, T], src_pos [S, D], src_mass [S],
    src_idx [S], mask [C, S]), padding targets carrying the index n."""
    tpos, tidx, spos, smass, sidx, mask = inputs[:6]
    C, T, _ = tpos.shape
    nbytes = sum(t.numel() * t.element_size() for t in inputs[:6])
    nbytes += C * T * 4 * tpos.element_size()                # acc, pot
    ntgt = (tidx < n).sum(1).double()
    pairs = float((mask.sum(1).double() * ntgt).sum())
    t_bytes = nbytes / PEAK_BYTES
    t_ops = pairs * FLOPS_MONO / PEAK_FP32
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")
