// Shared-candidate pairwise kernel (monopole, fp32) for NVIDIA Hopper.
//
// Replaces the TPU kernel rakau_tpu/kernels/pallas.py:_shared_fused_kernel
// in its monopole fp32 form (no compensation, no cell test, no quadrupole,
// no subblock selection). All C tiles of a chunk share one source row of S
// entries; a per-tile mask [C, S] selects which sources act on which tile.
// For tile c, target i and source j:
//
//     d = s_j - t_i, r2 = |d|^2 + eps^2
//     inv_r = 0 if idx_j == idx_i or r2 <= 0, else rsqrt(r2)
//     w = m_j * mask[c, j] * inv_r
//     pot_i -= w, acc_i += w * inv_r^2 * d          (G applied by the caller)
//
// What bounds it on this card: arithmetic. Each pair costs ~20 fp32
// operations and one MUFU rsqrt against 20 bytes of source data that every
// target of the tile reuses, so device memory is not the limit; the rsqrt
// rate and the number of warps in flight are.
//
// Design: grid (C, ceil(T/128)), one thread per target, its position and
// index in registers. Each CUDA block walks its tile's compacted list of
// active source blocks (built by the wrapper from the mask, as the TPU
// kernel's scalar-prefetched ids), so dead blocks cost nothing. Per block
// the threads stage x, y, z, m*mask (float4) and idx (int32) in shared
// memory; every thread then reads the same entry at a time (a broadcast,
// no bank conflicts) and accumulates in fp32 registers. The last block of
// the row may be ragged: entries past S are staged as far, massless
// padding and not visited. The TPU kernel held the whole row in VMEM and
// had to segment rows past its VMEM budget; this one streams blocks and
// takes any S. With 32 tiles of 512 targets a chunk fills 128 CUDA blocks
// of 4 warps, about one per SM: occupancy, not the rsqrt rate, is the
// first limit, and splitting the source loop across blocks is later work.
//
// Padding sources sit at 1e30 (or the traversal's 4*box) with mass 0:
// r2 overflows to inf, rsqrtf(inf) = 0, and w = 0, never NaN. Built
// without --use_fast_math to keep that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // targets per CUDA block, one per thread
// Sources staged per step: float4 (x, y, z, m*mask) + int32 idx, 20 KB.
// Must equal kernels/shared.py:BLOCK, which the wrapper checks at load.
constexpr int kBlock = 1024;
static_assert(kBlock * (sizeof(float4) + sizeof(int)) <= 48 * 1024,
              "the source panel must fit in static shared memory");
enum Mode { kBoth = 0, kAcc = 1, kPot = 2 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
shared_fused_kernel(const float* __restrict__ tgt,        // [C, T, 3]
                    const int64_t* __restrict__ tgt_idx,  // [C, T]
                    const float* __restrict__ src,        // [S, 3]
                    const float* __restrict__ mass,       // [S]
                    const int64_t* __restrict__ src_idx,  // [S]
                    const uint8_t* __restrict__ mask,     // [C, S]
                    const int32_t* __restrict__ ids,      // [C, NB]
                    const int32_t* __restrict__ cnt,      // [C]
                    float* __restrict__ acc,              // [C, T, 3]
                    float* __restrict__ pot,              // [C, T]
                    int T, int S, int NB, float eps2)
{
    __shared__ float4 s_pm[kBlock];
    __shared__ int s_idx[kBlock];

    const int c = blockIdx.x;
    const int t = blockIdx.y * kThreads + threadIdx.x;
    const bool live = t < T;
    const size_t tc = static_cast<size_t>(c) * T + t;
    float tx = 0.f, ty = 0.f, tz = 0.f;
    int ti = -2;   // matches no source index (nodes carry -1)
    if (live) {
        tx = tgt[3 * tc];
        ty = tgt[3 * tc + 1];
        tz = tgt[3 * tc + 2];
        ti = static_cast<int>(tgt_idx[tc]);
    }
    const int32_t* my_ids = ids + static_cast<size_t>(c) * NB;
    const uint8_t* my_mask = mask + static_cast<size_t>(c) * S;
    const int nblk = cnt[c];

    float ax = 0.f, ay = 0.f, az = 0.f, pp = 0.f;
    for (int k = 0; k < nblk; ++k) {
        const int base = my_ids[k] * kBlock;
        __syncthreads();            // the previous panel is consumed
        for (int j = threadIdx.x; j < kBlock; j += kThreads) {
            const int s = base + j;
            float4 v = make_float4(1e30f, 1e30f, 1e30f, 0.f);
            int id = -1;
            if (s < S) {
                const size_t s3 = 3 * static_cast<size_t>(s);
                v.x = src[s3];
                v.y = src[s3 + 1];
                v.z = src[s3 + 2];
                v.w = my_mask[s] ? mass[s] : 0.f;
                id = static_cast<int>(src_idx[s]);
            }
            s_pm[j] = v;
            s_idx[j] = id;
        }
        __syncthreads();
        const int nj = min(kBlock, S - base);
#pragma unroll 4
        for (int j = 0; j < nj; ++j) {
            const float4 v = s_pm[j];
            const float dx = v.x - tx;
            const float dy = v.y - ty;
            const float dz = v.z - tz;
            const float r2 = dx * dx + dy * dy + dz * dz + eps2;
            float inv_r = rsqrtf(r2);
            if (s_idx[j] == ti || r2 <= 0.f) inv_r = 0.f;
            const float w = v.w * inv_r;
            if (MODE != kPot) {
                const float w3 = w * inv_r * inv_r;
                ax += w3 * dx;
                ay += w3 * dy;
                az += w3 * dz;
            }
            if (MODE != kAcc) pp -= w;
        }
    }
    if (live) {
        acc[3 * tc] = ax;
        acc[3 * tc + 1] = ay;
        acc[3 * tc + 2] = az;
        pot[tc] = pp;
    }
}

template <int MODE>
cudaError_t launch(const float* tgt, const int64_t* tgt_idx, const float* src,
                   const float* mass, const int64_t* src_idx,
                   const uint8_t* mask, const int32_t* ids,
                   const int32_t* cnt, float* acc, float* pot, int C, int T,
                   int S, int NB, float eps2, cudaStream_t stream)
{
    const dim3 grid(C, (T + kThreads - 1) / kThreads);
    shared_fused_kernel<MODE><<<grid, kThreads, 0, stream>>>(
        tgt, tgt_idx, src, mass, src_idx, mask, ids, cnt, acc, pot,
        T, S, NB, eps2);
    return cudaGetLastError();
}

}  // namespace

// Source entries per block of the active-block lists (ids index blocks
// of this size).
extern "C" int rakau_shared_fused_block() { return kBlock; }

// Launches on `stream` and returns cudaGetLastError() of the launch
// (0 = accepted). mode: 0 both, 1 acc only (pot written as 0), 2 pot only
// (acc written as 0).
extern "C" int rakau_shared_fused(const float* tgt, const int64_t* tgt_idx,
                                  const float* src, const float* mass,
                                  const int64_t* src_idx, const uint8_t* mask,
                                  const int32_t* ids, const int32_t* cnt,
                                  float* acc, float* pot, int C, int T, int S,
                                  int NB, int mode, float eps2,
                                  void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (S < 0 || NB <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mode) {
    case kBoth:
        return static_cast<int>(launch<kBoth>(tgt, tgt_idx, src, mass, src_idx, mask, ids,
                                              cnt, acc, pot, C, T, S, NB, eps2, st));
    case kAcc:
        return static_cast<int>(launch<kAcc>(tgt, tgt_idx, src, mass, src_idx, mask, ids,
                                             cnt, acc, pot, C, T, S, NB, eps2, st));
    case kPot:
        return static_cast<int>(launch<kPot>(tgt, tgt_idx, src, mass, src_idx, mask, ids,
                                             cnt, acc, pot, C, T, S, NB, eps2, st));
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
