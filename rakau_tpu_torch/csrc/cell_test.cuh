// The packed-word leaf-cell separation test of the grid2 forms, shared by
// the kernels of the shared row (shared_fused.cu, shared_mma.cu).
//
// A source's three cell coordinates sit in one int32, in fields of
// kFieldBits = 10 bits (-1 for a row exempt from the test). The target
// thread adds its own constant, per field 512 + sep - 1 - tc_d, so that
// each field holds
//     v_d = sc_d - tc_d + sep - 1 + 512  in (0, 1024): no carry crosses,
// and the pair is near in dimension d iff 512 <= v_d <= 512 + 2 sep - 2:
// the field's top bit is set, and its low 9 bits plus 513 - 2 sep do not
// reach the top bit. One add, one and, one add, one three-input logic
// operation and two compares a pair, where the test per coordinate
// (3 extractions, 3 differences, 3 absolute values, 2 maxima) measured 3x
// the monopole kernel's time: integer operations run at half the fp32 rate
// on this card.
#pragma once

#include <stdint.h>

// Cell coordinates lie below 2^kCellBits (kernels/shared.py:CELL_BITS:
// grid2's leaf grids end at level 7), and sep at or below it. A packed cell
// holds them in three fields of kFieldBits bits; kTopMask has each field's
// top bit, kLowMask the bits below it.
constexpr int kCellBits = 7;
constexpr int kFieldBits = 10;
constexpr int kFieldTop = 1 << (kFieldBits - 1);

__host__ __device__ constexpr int pack3(int a, int b, int c)
{
    return (a << (2 * kFieldBits)) | (b << kFieldBits) | c;
}

constexpr int kTopMask = pack3(kFieldTop, kFieldTop, kFieldTop);
constexpr int kLowMask = pack3(kFieldTop - 1, kFieldTop - 1, kFieldTop - 1);
static_assert((1 << kCellBits) + (1 << kCellBits) + kFieldTop
                  <= (1 << kFieldBits),
              "a field must hold coordinate + sep + 512 without a carry");

// A target's constant: per field 512 + sep - 1 - its coordinate.
__device__ __forceinline__ int cell_target_word(const int32_t* tc, int sep)
{
    const int bias = kFieldTop + sep - 1;
    return pack3(bias - tc[0], bias - tc[1], bias - tc[2]);
}

// Per field 511 - (2 sep - 2): carries a field's low bits into its top bit
// exactly when they exceed 2 sep - 2.
__device__ __forceinline__ int cell_over_word(int sep)
{
    const int over = kFieldTop + 1 - 2 * sep;
    return pack3(over, over, over);
}

// A source's packed cell from its three coordinates; -1 when the first is
// negative (a row exempt from the test).
__device__ __forceinline__ int cell_source_word(const int32_t* sc)
{
    return sc[0] >= 0 ? pack3(sc[0], sc[1], sc[2]) : -1;
}

// The pair (source word pc, target word tk) belongs to the dense far field:
// separated by sep cells or more in some dimension, and not exempt.
__device__ __forceinline__ bool cell_far(int pc, int tk, int cb)
{
    const int v = pc + tk;
    const int x = (v & kLowMask) + cb;
    return pc >= 0 && ((~v | x) & kTopMask) != 0;
}
