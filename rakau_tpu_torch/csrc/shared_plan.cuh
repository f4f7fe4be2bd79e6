// The plan and the packed row of the kernels of the shared row: K1
// (shared_fused.cu) and K6 (shared_mma.cu) at granules of 128 sources, K5
// (shared_blocks.cu) at the reference's blocks of 1024. Each library
// includes this header once, so each has its own copy of these kernels at
// its own granule.
//
// The plan of a launch over a mask [C, S] (kernels/shared.py:fused_plan
// builds the same in PyTorch), three kernels, none waiting on the host:
//  1. shared_fused_mask_kernel turns the mask into bits [C, Sp / 32] (a
//     warp ballot a word) and one flag a (tile, granule of kGranule
//     sources): does the tile take any of its sources?
//  2. shared_fused_plan_kernel, one CUDA block a tile, compacts the tile's
//     flagged granules into its list ids [C, NG] and count cnt [C];
//  3. shared_fused_work_kernel, one CUDA block, cuts every list into spans
//     of `span` consecutive entries and writes them tile after tile.
// shared_fused_pack_kernel packs the row once: (x, y, z, m) as one real4 a
// source, int32 indices, the packed cells and the second moments, each
// optional but the first, all padded to whole granules (far at 1e30,
// massless, index -1, exempt, zero moments).
//
// Scalar type: `real` is RAKAU_REAL, float unless the library is built
// with -DRAKAU_REAL=double. RAKAU_GRANULE sets the granule at build time
// (128, kernels/shared.py:GRANULE; shared_blocks.cu defines 1024,
// kernels/shared.py:BLOCK; each checked at load). Nothing here depends on
// the granule beyond kGranule: the mask kernel's ballots run over its
// words, the other kernels over whole granules.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "per_device.cuh"

#include "cell_test.cuh"

#ifndef RAKAU_REAL
#define RAKAU_REAL float
#endif
#ifndef RAKAU_GRANULE
#define RAKAU_GRANULE 128
#endif

namespace {

using real = RAKAU_REAL;
struct alignas(32) double4a { double x, y, z, w; };
using real4 = std::conditional_t<sizeof(real) == 4, float4, double4a>;

// Sources a granule: the unit of the per-tile active lists and of one
// staging step. Must equal kernels/shared.py:GRANULE (checked at load).
constexpr int kGranule = RAKAU_GRANULE;
constexpr int kQuad = 6;                 // second moments a source
constexpr int kPackThreads = 256;
constexpr int kWorkThreads = 1024;       // the one CUDA block of the work list
static_assert(kGranule % 32 == 0, "a granule is whole mask words");

// The mask as bits and granule flags: warp w = c * NG + g reads tile c's
// mask over granule g (a ballot a 32-entry word) and writes its words and
// whether any entry is on.
__global__ void __launch_bounds__(kPackThreads)
shared_fused_mask_kernel(const uint8_t* __restrict__ mask,    // [C, S]
                         unsigned* __restrict__ bits,         // [C, words]
                         uint8_t* __restrict__ flags,         // [C, NG]
                         int C, int S, int NG)
{
    const long long w = (static_cast<long long>(blockIdx.x) * kPackThreads
                         + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (w >= static_cast<long long>(C) * NG) return;    // the whole warp
    const int c = static_cast<int>(w / NG);
    const int g = static_cast<int>(w - static_cast<long long>(c) * NG);
    const uint8_t* row = mask + static_cast<size_t>(c) * S;
    unsigned any = 0;
#pragma unroll
    for (int k = 0; k < kGranule / 32; ++k) {
        const int s = g * kGranule + 32 * k + lane;
        const unsigned b = __ballot_sync(0xffffffffu, s < S && row[s] != 0);
        if (lane == 0) bits[w * (kGranule / 32) + k] = b;
        any |= b;
    }
    if (lane == 0) flags[w] = any != 0;
}

// Tile blockIdx.x's list: its flagged granules in row order into ids[c, :],
// their count into cnt[c], the rest of the row padded with NG
// (kernels/shared.py:fused_plan, whose ids and counts these equal).
__global__ void __launch_bounds__(kPackThreads)
shared_fused_plan_kernel(const uint8_t* __restrict__ flags,   // [C, NG]
                         int32_t* __restrict__ ids,           // [C, NG]
                         int32_t* __restrict__ cnt,           // [C]
                         int NG)
{
    __shared__ int warp_on[kPackThreads / 32];
    const int c = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const uint8_t* f = flags + static_cast<size_t>(c) * NG;
    int32_t* out = ids + static_cast<size_t>(c) * NG;
    int running = 0;    // the same in every thread
    for (int base = 0; base < NG; base += kPackThreads) {
        const int g = base + threadIdx.x;
        const bool on = g < NG && f[g] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, on);
        if (lane == 0) warp_on[wid] = __popc(bal);
        __syncthreads();
        int before = running, total = 0;
        for (int w = 0; w < kPackThreads / 32; ++w) {
            before += w < wid ? warp_on[w] : 0;
            total += warp_on[w];
        }
        if (on) out[before + __popc(bal & ((1u << lane) - 1u))] = g;
        running += total;
        __syncthreads();    // warp_on is read before the next round
    }
    for (int g = running + threadIdx.x; g < NG; g += kPackThreads)
        out[g] = NG;
    if (threadIdx.x == 0) cnt[c] = running;
}

// Pack the row: entries [0, Sp) of pm, idx, quad, cell, padding past S
// (idx, q6 and cellw may each be null: not packed).
__global__ void __launch_bounds__(kPackThreads)
shared_fused_pack_kernel(const real* __restrict__ src,         // [S, 3]
                         const real* __restrict__ mass,        // [S]
                         const int64_t* __restrict__ src_idx,  // [S]
                         const real* __restrict__ quad,        // [S, 6]
                         const int32_t* __restrict__ src_cell, // [S, 3]
                         real4* __restrict__ pm, int* __restrict__ idx,
                         real* __restrict__ q6, int* __restrict__ cellw,
                         int S, int Sp, int cell_dims)
{
    const long long i = static_cast<long long>(blockIdx.x) * kPackThreads
        + threadIdx.x;
    if (i >= Sp) return;
    const int s = static_cast<int>(i);
    const bool in = s < S;
    const size_t s3 = 3 * static_cast<size_t>(s);
    real4 v{real(1e30f), real(1e30f), real(1e30f), real(0)};
    if (in) {
        v.x = src[s3];
        v.y = src[s3 + 1];
        v.z = src[s3 + 2];
        v.w = mass[s];
    }
    pm[s] = v;
    if (idx != nullptr) idx[s] = in ? static_cast<int>(src_idx[s]) : -1;
    if (q6 != nullptr) {
        const size_t s6 = kQuad * static_cast<size_t>(s);
        for (int q = 0; q < kQuad; ++q)
            q6[s6 + q] = in ? quad[s6 + q] : real(0);
    }
    if (cellw != nullptr) {
        // padding past S: exempt, and massless
        cellw[s] = !in ? -1
            : cell_dims == 2 ? cell_source_word<2>(src_cell + s3)
                             : cell_source_word<3>(src_cell + s3);
    }
}

// The work list, by one CUDA block: tile c's spans z < ceil(cnt[c] / span)
// as c * zmax + z, tile after tile (fused_plan's work list), padded with
// C * zmax, and their number into n_work[0].
__global__ void __launch_bounds__(kWorkThreads)
shared_fused_work_kernel(const int32_t* __restrict__ cnt,     // [C]
                         int32_t* __restrict__ work,          // [C * zmax]
                         int32_t* __restrict__ n_work,        // [1]
                         int C, int zmax, int span)
{
    __shared__ int first[kWorkThreads + 1];  // spans before each tile
    __shared__ int warp_sum[kWorkThreads / 32];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    int base = 0;   // spans of the tiles before this round's
    for (int c0 = 0; c0 < C; c0 += kWorkThreads) {
        const int c = c0 + threadIdx.x;
        const int ns = c < C ? (cnt[c] + span - 1) / span : 0;
        int incl = ns;  // inclusive scan in the warp, then across warps
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int up = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += up;
        }
        if (lane == 31) warp_sum[wid] = incl;
        __syncthreads();
        int before = base;
        for (int w = 0; w < wid; ++w) before += warp_sum[w];
        first[threadIdx.x] = before + incl - ns;
        if (threadIdx.x == kWorkThreads - 1)
            first[kWorkThreads] = before + incl;
        __syncthreads();
        const int tiles = min(kWorkThreads, C - c0);
        for (int k = 0; k < tiles; ++k) {
            const int at = first[k];
            const int n = first[k + 1] - at;
            for (int z = threadIdx.x; z < n; z += kWorkThreads)
                work[at + z] = (c0 + k) * zmax + z;
        }
        base = first[kWorkThreads];
        __syncthreads();    // first, warp_sum read before the next round
    }
    for (int k = base + threadIdx.x; k < C * zmax; k += kWorkThreads)
        work[k] = C * zmax;
    if (threadIdx.x == 0) n_work[0] = base;
}

// The plan's three kernels on `stream`: the mask [C, S] into bits and
// flags (workspace parts of C * Sp / 32 words and C * NG bytes), every
// tile's list into ids [C, NG] and cnt [C], the spans of `span` entries
// into work [C * zmax] and their number into n_work [1]. Returns
// cudaGetLastError() of the launches.
inline cudaError_t launch_plan(const uint8_t* mask, unsigned* bits,
                               uint8_t* flags, int32_t* ids, int32_t* cnt,
                               int32_t* work, int32_t* n_work, int C, int S,
                               int NG, int zmax, int span, cudaStream_t st)
{
    const long long threads = static_cast<long long>(C) * NG * 32;
    shared_fused_mask_kernel<<<static_cast<unsigned>(
        (threads + kPackThreads - 1) / kPackThreads), kPackThreads, 0, st>>>(
        mask, bits, flags, C, S, NG);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    shared_fused_plan_kernel<<<C, kPackThreads, 0, st>>>(flags, ids, cnt,
                                                         NG);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    shared_fused_work_kernel<<<1, kWorkThreads, 0, st>>>(cnt, work, n_work,
                                                         C, zmax, span);
    return cudaGetLastError();
}

}  // namespace
