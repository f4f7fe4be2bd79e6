// Per-tile list kernels of the lists traversal for NVIDIA Hopper: the fused
// form K3 and the split form K4 (fp32, or fp64 in the float64 build).
//
// K3 replaces the TPU kernel rakau_tpu/kernels/pallas.py:_fused_kernel
// (eval_tiles_fused), K4 replaces pallas.py:_kernel (_pairwise, reached
// through eval_tiles(fused=False)). Each tile c of a chunk has two rows of
// its own, not shared with the other tiles: a dense M2P row of node COMs
// and masses [Sm] and a P2P row of particles with their indices [Sp],
// each left-compacted by the traversal and followed by padding (mass 0,
// at the traversal's 4*box sentinel or at 1e30, index -1). For target i
// (position t_i, index ti_i) and row entry j:
//
//     d = s_j - t_i, r2 = |d|^2 + eps^2
//     inv_r = 0 if r2 <= 0, or (P2P row only) idx_j == ti_i; else rsqrt(r2)
//     w = m_j * inv_r
//     pot_i -= w, acc_i += w * inv_r^2 * d          (G applied by the caller)
//
// The M2P row has no indices: a node exactly on a target at eps = 0 is
// dead by r2 <= 0 alone. Padding adds exact zeros: at 1e30 r2 overflows to
// inf (float) and rsqrt gives 0, at 4*box the mass is 0.
//
// The block plan is the TPU kernels': a row is visited in whole blocks of
// `block` entries (a runtime argument) up to its count, read on the device
// from cnt[c] with no host sync:
//   K3: ceil(clip(cnt, 0, S) / block) blocks, so a count of 0 visits none;
//   K4: ceil(max(min(cnt, S), 1) / block) blocks, at least one,
// the last one cut at S. Entries past the count inside a visited block are
// padding and add zero, as on the TPU.
//
// What bounds them on this card: arithmetic. A pair costs ~20 operations
// and one rsqrt against 16 (32 in double) bytes of row, read from device
// memory by one tile only and reused from shared memory by its 128
// targets. A chunk of 32 tiles of 512 targets is 128 CUDA blocks of 4
// warps for 132 SMs: the card is about one block an SM, so the warps in
// flight, not the issue rate, are the first limit (as in K1).
//
// K3 design: grid (C, ceil(T/128)), one thread per target, its position
// and index in registers. The block streams its tile's M2P row and then
// its P2P row through shared memory, kStage entries at a time (real4 x, y,
// z, m and the int32 index), every thread reading the same entry at a
// time (a broadcast), each stage summed into partials that are then added
// to the running sums.
//
// K4 design: the TPU form's (C, blocks) grid runs a tile's blocks in order
// into one output; CUDA blocks run in no order and share nothing, so the
// sequential axis becomes a split of the row (as K5, shared_blocks.cu):
// grid (C, ceil(T/128), nsplit), CUDA block (c, y, z) sums the blocks
// [z * per, (z + 1) * per) that tile c visits for 128 targets, and writes
// one partial (ax, ay, az, pot) a target into scratch[z, c, t]; a second
// kernel adds the nsplit partials in the order z = 0, 1, ... (no atomics,
// so two launches agree bit for bit). One launch evaluates one row,
// with (P2P) or without (M2P) the index test.
//
// Scalar type: `real` is RAKAU_REAL, float unless the library is built
// with -DRAKAU_REAL=double. Indices are compared as int32 (particle counts
// stay below 2^31). Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RAKAU_REAL
#define RAKAU_REAL float
#endif

namespace {

using real = RAKAU_REAL;
struct alignas(4 * sizeof(real)) real4 { real x, y, z, w; };
__device__ __forceinline__ float rsqrt_r(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_r(double x) { return rsqrt(x); }

constexpr int kThreads = 128;   // targets per CUDA block, one per thread
constexpr int kStage = 512;     // row entries staged per step
// entries unrolled in the inner loop (fewer in double, as in pool.cu)
constexpr int kUnroll = sizeof(real) == 8 ? 2 : 4;
static_assert(kStage * (sizeof(real4) + sizeof(int)) <= 48 * 1024,
              "the staged entries must fit in static shared memory");

// Entries of tile c's row that the block plan visits: whole blocks up to
// the count (all S without counts), the last block cut at S.
__device__ __forceinline__ int row_entries(const int64_t* __restrict__ cnt,
                                           int c, int S, int block,
                                           bool at_least_one)
{
    int64_t k = cnt == nullptr ? S : cnt[c];
    k = k < 0 ? 0 : (k > S ? S : k);
    if (at_least_one && k < 1) k = 1;
    const int64_t n = (k + block - 1) / block * block;
    return static_cast<int>(n < S ? n : S);
}

// Stages entries [s0, s0 + nj) of the row that starts at row0.
template <bool USE_IDX>
__device__ __forceinline__ void stage(const real* __restrict__ pos,
                                      const real* __restrict__ mass,
                                      const int64_t* __restrict__ idx,
                                      size_t row0, int s0, int nj,
                                      real4* s_pm, int* s_idx)
{
    for (int j = threadIdx.x; j < nj; j += kThreads) {
        const size_t s = row0 + s0 + j;
        s_pm[j] = real4{pos[3 * s], pos[3 * s + 1], pos[3 * s + 2], mass[s]};
        if (USE_IDX) s_idx[j] = static_cast<int>(idx[s]);
    }
}

// Adds the staged entries [0, nj) to one target's partials.
template <bool USE_IDX>
__device__ __forceinline__ void accumulate(
    const real4* __restrict__ s_pm, const int* __restrict__ s_idx, int nj,
    real tx, real ty, real tz, int ti, real eps2, real& bx, real& by,
    real& bz, real& bp)
{
#pragma unroll (kUnroll)
    for (int j = 0; j < nj; ++j) {
        const real4 v = s_pm[j];
        const real dx = v.x - tx;
        const real dy = v.y - ty;
        const real dz = v.z - tz;
        const real r2 = dx * dx + dy * dy + dz * dz + eps2;
        real inv_r = rsqrt_r(r2);
        bool dead = r2 <= real(0);
        if (USE_IDX) dead = dead || s_idx[j] == ti;
        if (dead) inv_r = 0;
        const real w = v.w * inv_r;
        const real g = w * (inv_r * inv_r);
        bx += g * dx;
        by += g * dy;
        bz += g * dz;
        bp -= w;
    }
}

// Streams row entries [b0, b1) of the row at row0 into the running sums,
// one stage's partials at a time.
template <bool USE_IDX>
__device__ __forceinline__ void stream_row(
    const real* __restrict__ pos, const real* __restrict__ mass,
    const int64_t* __restrict__ idx, size_t row0, int b0, int b1,
    real4* s_pm, int* s_idx, real tx, real ty, real tz, int ti, real eps2,
    real& ax, real& ay, real& az, real& pp)
{
    for (int s0 = b0; s0 < b1; s0 += kStage) {
        const int nj = min(kStage, b1 - s0);
        __syncthreads();            // the previous stage is consumed
        stage<USE_IDX>(pos, mass, idx, row0, s0, nj, s_pm, s_idx);
        __syncthreads();
        real bx = 0, by = 0, bz = 0, bp = 0;
        accumulate<USE_IDX>(s_pm, s_idx, nj, tx, ty, tz, ti, eps2, bx, by,
                            bz, bp);
        ax += bx;
        ay += by;
        az += bz;
        pp += bp;
    }
}

__global__ void __launch_bounds__(kThreads)
tiles_fused_kernel(const real* __restrict__ tgt,          // [C, T, 3]
                   const int64_t* __restrict__ tgt_idx,   // [C, T]
                   const real* __restrict__ m_pos,        // [C, Sm, 3]
                   const real* __restrict__ m_mass,       // [C, Sm]
                   const int64_t* __restrict__ m_cnt,     // [C] or null
                   const real* __restrict__ p_pos,        // [C, Sp, 3]
                   const real* __restrict__ p_mass,       // [C, Sp]
                   const int64_t* __restrict__ p_idx,     // [C, Sp]
                   const int64_t* __restrict__ p_cnt,     // [C] or null
                   real* __restrict__ acc,                // [C, T, 3]
                   real* __restrict__ pot,                // [C, T]
                   int T, int Sm, int Sp, int block, real eps2)
{
    __shared__ real4 s_pm[kStage];
    __shared__ int s_idx[kStage];

    const int c = blockIdx.x;
    const int t = blockIdx.y * kThreads + threadIdx.x;
    const bool live = t < T;
    const size_t tc = static_cast<size_t>(c) * T + t;
    real tx = 0, ty = 0, tz = 0;
    int ti = -2;   // matches no source index (padding carries -1)
    if (live) {
        tx = tgt[3 * tc];
        ty = tgt[3 * tc + 1];
        tz = tgt[3 * tc + 2];
        ti = static_cast<int>(tgt_idx[tc]);
    }
    real ax = 0, ay = 0, az = 0, pp = 0;
    stream_row<false>(m_pos, m_mass, nullptr, static_cast<size_t>(c) * Sm, 0,
                      row_entries(m_cnt, c, Sm, block, false), s_pm, s_idx,
                      tx, ty, tz, ti, eps2, ax, ay, az, pp);
    stream_row<true>(p_pos, p_mass, p_idx, static_cast<size_t>(c) * Sp, 0,
                     row_entries(p_cnt, c, Sp, block, false), s_pm, s_idx,
                     tx, ty, tz, ti, eps2, ax, ay, az, pp);
    if (live) {
        acc[3 * tc] = ax;
        acc[3 * tc + 1] = ay;
        acc[3 * tc + 2] = az;
        pot[tc] = pp;
    }
}

template <bool USE_IDX>
__global__ void __launch_bounds__(kThreads)
tiles_split_kernel(const real* __restrict__ tgt,          // [C, T, 3]
                   const int64_t* __restrict__ tgt_idx,   // [C, T]
                   const real* __restrict__ pos,          // [C, S, 3]
                   const real* __restrict__ mass,         // [C, S]
                   const int64_t* __restrict__ idx,       // [C, S] (USE_IDX)
                   const int64_t* __restrict__ cnt,       // [C] or null
                   real4* __restrict__ scratch,           // [nsplit, C, T]
                   int C, int T, int S, int block, int per, real eps2)
{
    __shared__ real4 s_pm[kStage];
    __shared__ int s_idx[USE_IDX ? kStage : 1];

    const int c = blockIdx.x;
    const int t = blockIdx.y * kThreads + threadIdx.x;
    const int z = blockIdx.z;
    const bool live = t < T;
    const size_t tc = static_cast<size_t>(c) * T + t;
    real tx = 0, ty = 0, tz = 0;
    int ti = -2;
    if (live) {
        tx = tgt[3 * tc];
        ty = tgt[3 * tc + 1];
        tz = tgt[3 * tc + 2];
        ti = static_cast<int>(tgt_idx[tc]);
    }
    const int n = row_entries(cnt, c, S, block, true);
    const int jb_end = min((n + block - 1) / block, (z + 1) * per);
    real ax = 0, ay = 0, az = 0, pp = 0;
    for (int jb = z * per; jb < jb_end; ++jb) {
        // one TPU grid step: this block's sums, added to the span's
        real bx = 0, by = 0, bz = 0, bp = 0;
        stream_row<USE_IDX>(pos, mass, idx, static_cast<size_t>(c) * S,
                            jb * block, min((jb + 1) * block, n), s_pm,
                            s_idx, tx, ty, tz, ti, eps2, bx, by, bz, bp);
        ax += bx;
        ay += by;
        az += bz;
        pp += bp;
    }
    if (live)
        scratch[(static_cast<size_t>(z) * C + c) * T + t]
            = real4{ax, ay, az, pp};
}

// acc[i], pot[i] = the nsplit partials of target i, added in order (read
// as four reals: a 32-byte real4 local went through local memory in
// double).
__global__ void __launch_bounds__(kThreads)
tiles_split_reduce(const real* __restrict__ scratch,    // [nsplit, CT, 4]
                   real* __restrict__ acc,              // [CT, 3]
                   real* __restrict__ pot,              // [CT]
                   int CT, int nsplit)
{
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= CT) return;
    const real* p = scratch + 4 * static_cast<size_t>(i);
    real sx = p[0], sy = p[1], sz = p[2], sp = p[3];
    for (int z = 1; z < nsplit; ++z) {
        p += 4 * static_cast<size_t>(CT);
        sx += p[0];
        sy += p[1];
        sz += p[2];
        sp += p[3];
    }
    acc[3 * static_cast<size_t>(i)] = sx;
    acc[3 * static_cast<size_t>(i) + 1] = sy;
    acc[3 * static_cast<size_t>(i) + 2] = sz;
    pot[i] = sp;
}

}  // namespace

// Bytes of the scalar type the library was built for (4 or 8).
extern "C" int rakau_tiles_real_bytes() { return static_cast<int>(sizeof(real)); }

// K3: launches on `stream` and returns cudaGetLastError() of the launch
// (0 = accepted). m_cnt / p_cnt: per-tile counts [C] (int64), or null for
// whole rows. block: entries per block of the plan (>= 1). Every real
// pointer and eps2 are of the library's scalar type.
extern "C" int rakau_tiles(const real* tgt, const int64_t* tgt_idx,
                           const real* m_pos, const real* m_mass,
                           const int64_t* m_cnt, const real* p_pos,
                           const real* p_mass, const int64_t* p_idx,
                           const int64_t* p_cnt, real* acc, real* pot, int C,
                           int T, int Sm, int Sp, int block, real eps2,
                           void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (Sm < 0 || Sp < 0 || block < 1 || (T + kThreads - 1) / kThreads > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(C, (T + kThreads - 1) / kThreads);
    tiles_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tgt, tgt_idx, m_pos, m_mass, m_cnt, p_pos, p_mass, p_idx, p_cnt, acc,
        pot, T, Sm, Sp, block, eps2);
    return static_cast<int>(cudaGetLastError());
}

// K4: one row, both kernels launched on `stream`; returns
// cudaGetLastError() of the launches (0 = accepted). idx: the row's
// indices [C, S] for the self-exclusion test (P2P), or null (M2P, no
// test). cnt: counts [C] or null. scratch: nsplit * C * T * 4 reals,
// written and read here. nsplit in [1, ceil(S / block)].
extern "C" int rakau_tiles_split(const real* tgt, const int64_t* tgt_idx,
                                 const real* pos, const real* mass,
                                 const int64_t* idx, const int64_t* cnt,
                                 real* scratch, real* acc, real* pot, int C,
                                 int T, int S, int block, int nsplit,
                                 real eps2, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    const int nb = S > 0 && block > 0 ? (S + block - 1) / block : 0;
    if (S < 1 || block < 1 || nsplit < 1 || nsplit > nb || nsplit > 65535
        || (T + kThreads - 1) / kThreads > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int per = (nb + nsplit - 1) / nsplit;
    const dim3 grid(C, (T + kThreads - 1) / kThreads, nsplit);
    real4* sc = reinterpret_cast<real4*>(scratch);
    if (idx != nullptr)
        tiles_split_kernel<true><<<grid, kThreads, 0, st>>>(
            tgt, tgt_idx, pos, mass, idx, cnt, sc, C, T, S, block, per, eps2);
    else
        tiles_split_kernel<false><<<grid, kThreads, 0, st>>>(
            tgt, tgt_idx, pos, mass, idx, cnt, sc, C, T, S, block, per, eps2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int CT = C * T;
    tiles_split_reduce<<<(CT + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        scratch, acc, pot, CT, nsplit);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
