// The packed-word leaf-cell separation test of the grid2 forms, shared by
// the kernels of the shared row (shared_fused.cu, shared_mma.cu).
//
// A source's cell coordinates sit in one int32, in `dims` fields of
// 30 / dims bits each (-1 for a row exempt from the test): three fields of
// 10 bits for 3-D cells, two of 15 bits for 2-D ones (a 2-D call arrives
// padded to 3-D, and its zero z coordinate is not packed; the launch's
// cell_dims selects the kernel of its packing). With
// top = 2^(bits - 1), the target thread adds its own constant, per field
// top + sep - 1 - tc_d, so that each field holds
//     v_d = sc_d - tc_d + sep - 1 + top  in (0, 2^bits): no carry crosses,
// and the pair is near in dimension d iff top <= v_d <= top + 2 sep - 2:
// the field's top bit is set, and its low bits plus top + 1 - 2 sep do not
// reach the top bit. One add, one and, one add, one three-input logic
// operation and two compares a pair, where the test per coordinate
// (3 extractions, 3 differences, 3 absolute values, 2 maxima) measured 3x
// the monopole kernel's time: integer operations run at half the fp32 rate
// on this card.
//
// The fields hold it when the coordinates lie below 2^(bits - 2) and sep
// is at most that: cell_coord_bits(dims), 8 in 3-D and 13 in 2-D
// (kernels/shared.py:CELL_BITS, checked when the library loads). The grid2
// levels that the configuration admits end at 7 in 3-D and 10 in 2-D.
#pragma once

#include <stdint.h>

__host__ __device__ constexpr int cell_field_bits(int dims)
{
    return 30 / dims;
}

__host__ __device__ constexpr int cell_coord_bits(int dims)
{
    return cell_field_bits(dims) - 2;
}

static_assert((1 << cell_coord_bits(3)) * 2 + (1 << (cell_field_bits(3) - 1))
                  <= (1 << cell_field_bits(3)),
              "a field must hold coordinate + sep + top without a carry");
static_assert((1 << cell_coord_bits(2)) * 2 + (1 << (cell_field_bits(2) - 1))
                  <= (1 << cell_field_bits(2)),
              "a field must hold coordinate + sep + top without a carry");

// The packing of DIMS-dimensional cells, at compile time: the kernels
// take it as a template parameter (their CELL: 0 for no test, 2 or 3), so
// the masks are immediates, as in a kernel written for one packing.
template <int DIMS>
struct CellPack {
    static_assert(DIMS == 2 || DIMS == 3, "cells are 2-D or 3-D");
    static constexpr int kBits = cell_field_bits(DIMS);   // bits a field
    static constexpr int kTop = 1 << (kBits - 1);          // a field's top bit

    // the fields (a, b[, c]) in one word; c is not packed in 2-D
    __host__ __device__ static constexpr int pack(int a, int b, int c)
    {
        return DIMS == 3 ? (((a << kBits) | b) << kBits) | c
                         : (a << kBits) | b;
    }

    static constexpr int kTopMask = pack(kTop, kTop, kTop);
    static constexpr int kLowMask = pack(kTop - 1, kTop - 1, kTop - 1);
};

// A target's constant: per field top + sep - 1 - its coordinate.
template <int DIMS>
__device__ __forceinline__ int cell_target_word(const int32_t* tc, int sep)
{
    const int bias = CellPack<DIMS>::kTop + sep - 1;
    return CellPack<DIMS>::pack(bias - tc[0], bias - tc[1], bias - tc[2]);
}

// Per field top + 1 - 2 sep: carries a field's low bits into its top bit
// exactly when they exceed 2 sep - 2.
template <int DIMS>
__device__ __forceinline__ int cell_over_word(int sep)
{
    const int over = CellPack<DIMS>::kTop + 1 - 2 * sep;
    return CellPack<DIMS>::pack(over, over, over);
}

// A source's packed cell from its coordinates; -1 when the first is
// negative (a row exempt from the test).
template <int DIMS>
__device__ __forceinline__ int cell_source_word(const int32_t* sc)
{
    return sc[0] >= 0 ? CellPack<DIMS>::pack(sc[0], sc[1], sc[2]) : -1;
}

// The pair (source word pc, target word tk) belongs to the dense far field:
// separated by sep cells or more in some dimension, and not exempt.
template <int DIMS>
__device__ __forceinline__ bool cell_far(int pc, int tk, int cb)
{
    const int v = pc + tk;
    const int x = (v & CellPack<DIMS>::kLowMask) + cb;
    return pc >= 0 && ((~v | x) & CellPack<DIMS>::kTopMask) != 0;
}
