// Split-source form of the shared-candidate pairwise kernel (K5) for NVIDIA
// Hopper: monopole, fp32 sums, both outputs, no cell test.
//
// Replaces the TPU kernel rakau_tpu/kernels/pallas.py:_shared_kernel, whose
// grid is (C, NB): tile c meets source block j in grid step (c, j), steps
// with an all-zero mask block are skipped, and the steps of one tile run in
// order and add into the tile's output block. CUDA blocks run in no order
// and share nothing, so that sequential axis becomes what it implies, a
// split of the source row: grid (C, ceil(T / 128), nsplit). CUDA block
// (c, y, z) sums the contiguous span [z * per, (z + 1) * per) of the row's
// source blocks for 128 targets of tile c, skipping every block whose
// blk_active[c, j] is 0, and writes one partial (ax, ay, az, pot) a target
// into scratch[z, c, t]. A second kernel adds the nsplit partials of every
// target in the order z = 0, 1, ...: no float atomics, so the result
// repeats bit for bit. The pair arithmetic is shared_fused.cu's monopole:
//
//     d = s_j - t_i, r2 = |d|^2 + eps^2
//     inv_r = 0 if idx_j == idx_i or r2 <= 0, else rsqrt(r2)
//     w = m_j * mask[c, j] * inv_r
//     pot_i -= w, acc_i += w * inv_r^2 * d          (G applied by the caller)
//
// What bounds it on this card: arithmetic (~20 fp32 operations and one MUFU
// rsqrt a pair against 20 bytes a source reused by 128 targets), and the
// warps in flight. A chunk of 32 tiles of 512 targets gives shared_fused.cu
// 128 CUDA blocks of 4 warps for 132 SMs; this form puts nsplit times as
// many on the card (the wrapper aims at 8 a SM: nsplit 9, 1152 CUDA
// blocks), at the price of the scratch round trip (nsplit * C * T * 16
// bytes written and read) and of spans that hold unequal numbers of active
// blocks, since a tile's active blocks cluster along the row.
// Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // targets per CUDA block, one per thread
// Sources staged per step: float4 (x, y, z, m*mask) + int32 idx, 20 KB.
// Must equal kernels/shared.py:BLOCK, which the wrapper checks at load.
constexpr int kBlock = 1024;

__global__ void __launch_bounds__(kThreads)
shared_blocks_kernel(const float* __restrict__ tgt,         // [C, T, 3]
                     const int64_t* __restrict__ tgt_idx,   // [C, T]
                     const float* __restrict__ src,         // [S, 3]
                     const float* __restrict__ mass,        // [S]
                     const int64_t* __restrict__ src_idx,   // [S]
                     const uint8_t* __restrict__ mask,      // [C, S]
                     const uint8_t* __restrict__ blk_active,// [C, NB]
                     float4* __restrict__ scratch,          // [nsplit, C, T]
                     int C, int T, int S, int NB, int per, float eps2)
{
    __shared__ float4 s_pm[kBlock];
    __shared__ int s_idx[kBlock];

    const int c = blockIdx.x;
    const int t = blockIdx.y * kThreads + threadIdx.x;
    const int z = blockIdx.z;
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
    const uint8_t* my_active = blk_active + static_cast<size_t>(c) * NB;
    const uint8_t* my_mask = mask + static_cast<size_t>(c) * S;
    const int jb_end = min(NB, (z + 1) * per);

    float ax = 0.f, ay = 0.f, az = 0.f, pp = 0.f;
    for (int jb = z * per; jb < jb_end; ++jb) {
        if (my_active[jb] == 0) continue;     // the same for every thread
        const int base = jb * kBlock;
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
                v.w = my_mask[s] != 0 ? mass[s] : 0.f;
                id = static_cast<int>(src_idx[s]);
            }
            s_pm[j] = v;
            s_idx[j] = id;
        }
        __syncthreads();
        const int nj = min(kBlock, S - base);
        float bx = 0.f, by = 0.f, bz = 0.f, bp = 0.f;   // this block's sums
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
            const float g = w * (inv_r * inv_r);
            bx += g * dx;
            by += g * dy;
            bz += g * dz;
            bp -= w;
        }
        ax += bx;
        ay += by;
        az += bz;
        pp += bp;
    }
    if (live)
        scratch[(static_cast<size_t>(z) * C + c) * T + t]
            = make_float4(ax, ay, az, pp);
}

// acc[i], pot[i] = the nsplit partials of target i, added in order.
__global__ void __launch_bounds__(kThreads)
shared_blocks_reduce(const float4* __restrict__ scratch,   // [nsplit, CT]
                     float* __restrict__ acc,              // [CT, 3]
                     float* __restrict__ pot,              // [CT]
                     int CT, int nsplit)
{
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= CT) return;
    float4 sum = scratch[i];
    for (int z = 1; z < nsplit; ++z) {
        const float4 v = scratch[static_cast<size_t>(z) * CT + i];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
    }
    acc[3 * static_cast<size_t>(i)] = sum.x;
    acc[3 * static_cast<size_t>(i) + 1] = sum.y;
    acc[3 * static_cast<size_t>(i) + 2] = sum.z;
    pot[i] = sum.w;
}

}  // namespace

// Source entries per block of blk_active.
extern "C" int rakau_shared_blocks_block() { return kBlock; }

// Launches both kernels on `stream` and returns cudaGetLastError() of the
// launches (0 = accepted). blk_active [C, NB]: nonzero where tile c has a
// mask-true source in block j. scratch: nsplit * C * T float4, written and
// read here. nsplit in [1, NB].
extern "C" int rakau_shared_blocks(const float* tgt, const int64_t* tgt_idx,
                                   const float* src, const float* mass,
                                   const int64_t* src_idx,
                                   const uint8_t* mask,
                                   const uint8_t* blk_active, float* scratch,
                                   float* acc, float* pot, int C, int T,
                                   int S, int NB, int nsplit, float eps2,
                                   void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (S < 0 || NB <= 0 || nsplit < 1 || nsplit > NB || nsplit > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int per = (NB + nsplit - 1) / nsplit;
    const dim3 grid(C, (T + kThreads - 1) / kThreads, nsplit);
    shared_blocks_kernel<<<grid, kThreads, 0, st>>>(
        tgt, tgt_idx, src, mass, src_idx, mask, blk_active,
        reinterpret_cast<float4*>(scratch), C, T, S, NB, per, eps2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int CT = C * T;
    shared_blocks_reduce<<<(CT + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(scratch), acc, pot, CT, nsplit);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
