// Shared-candidate pairwise kernel (fp32) for NVIDIA Hopper, in eight forms.
//
// Replaces the TPU kernel rakau_tpu/kernels/pallas.py:_shared_fused_kernel
// with the options the shared path uses: monopole fp32 (K1a),
// `compensated=True` (K1b), `quad=6` (K1d) and both together, and each of
// the four with the grid2 cell test `grid_sep > 0` (K1c). Not here:
// subblock selection. All C tiles of
// a chunk share one source row of S entries; a per-tile mask [C, S]
// selects which sources act on which tile. For tile c, target i and
// source j:
//
//     d = s_j - t_i, r2 = |d|^2 + eps^2
//     inv_r = 0 if idx_j == idx_i or r2 <= 0, else rsqrt(r2)
//     w = m_j * mask[c, j] * inv_r
//     pot_i -= w, acc_i += w * inv_r^2 * d          (G applied by the caller)
//
// QUAD (node rows with raw second moments Q_j, 6 planes xx xy xz yy yz zz):
// a masked-out pair is dead too (inv_r = 0), so that a masked-out node on
// top of a target starts every power chain from an exact zero instead of
// giving mask * inv_r^7 = 0 * inf = NaN (pallas.py:686-694). With
// Qd = Q_j d, dQd = d.Qd, tr = tr Q_j:
//
//     pot_i -= 1.5 dQd inv_r^5 - 0.5 tr inv_r^3
//     acc_i += -3 Qd inv_r^5 + (7.5 dQd inv_r^7 - 1.5 tr inv_r^5) d
//
// (d = s - t, the negative of the t - s frame of the derivation, so the
// odd-order terms carry the signs of pallas.py:733-746.)
//
// CELL (farfield "grid2", tiles spanning several leaf-grid cells): every
// source row and every target carries its leaf-grid cell, and a pair whose
// Chebyshev cell separation max_d |sc_d - tc_d| is >= sep belongs to the
// dense far field: it is dead here, through the same gate as the self
// pair, so every power of inv_r starts from an exact zero
// (pallas.py:676-695). Source rows whose first cell coordinate is negative
// are exempt from the test. The TPU kernel packs the D coordinates of
// either side into one f32 plane to keep its resident row small; here the
// cells arrive as int32 triples, and a source's cell is packed at staging
// into one int32 (-1 for an exempt row), because three more ints per
// source would take the QUAD panel past the 48 KB of static shared memory.
// The test runs on the packed word at once (cell_test.cuh).
//
// COMP: each thread sums one staged source block into fp32 partials, then
// adds each partial into its running sum with Knuth's TwoSum and keeps the
// error terms, written as sum + err at the end: the TPU kernel's per-block
// structure (pallas.py:751-773). A skipped dead block adds nothing, as a
// zero partial would. TwoSum has no products, so nvcc's FMA contraction
// cannot change it; built without fast math, nothing reassociates it.
//
// What bounds it on this card: arithmetic. A monopole pair costs ~20 fp32
// operations and one MUFU rsqrt, a quadrupole pair ~60, against 20 (44)
// bytes of source data that every target of the tile reuses from shared
// memory, so device memory is not the limit; the issue rate and the warps
// in flight are. TwoSum adds ~24 operations per source block, not per
// pair, so the compensated forms cost what the fp32 ones do.
//
// Design: grid (C, ceil(T/128)), one thread per target, its position and
// index in registers. Each CUDA block walks its tile's compacted list of
// active source blocks (built by the wrapper from the mask, as the TPU
// kernel's scalar-prefetched ids), so dead blocks cost nothing. Per block
// the threads stage x, y, z, m*mask (float4) and idx (int32) in shared
// memory, and in the QUAD form the 6 second-moment planes; a masked-out
// source's staged idx is kMaskedIdx, which no target carries, so the QUAD
// dead gate needs no extra plane. Every thread then reads the same entry
// at a time (a broadcast, no bank conflicts) and accumulates in fp32
// registers. The last block of the row may be ragged: entries past S are
// staged as far, massless padding and not visited. The TPU kernel held the
// whole row in VMEM and had to segment rows past its VMEM budget; this one
// streams blocks and takes any S. With 32 tiles of 512 targets a chunk
// fills 128 CUDA blocks of 4 warps, about one per SM: occupancy, not the
// issue rate, is the first limit, and splitting the source loop across
// blocks is later work.
//
// Padding sources sit at 1e30 (or the traversal's 4*box) with mass 0:
// r2 overflows to inf, rsqrtf(inf) = 0, and w = 0, never NaN. The QUAD
// terms multiply Q (0 on padding) into d before d again (Qd, then d.Qd),
// so no 1e30 * 1e30 = inf meets a zero. Built without --use_fast_math to
// keep that.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_test.cuh"

namespace {

constexpr int kThreads = 128;   // targets per CUDA block, one per thread
// Sources staged per step: float4 (x, y, z, m*mask) + int32 idx, 20 KB,
// plus 6 float planes (24 KB) in the QUAD form and one packed int32 cell
// (4 KB) in the CELL form: 48 KB with both. Must equal
// kernels/shared.py:BLOCK, which the wrapper checks at load.
constexpr int kBlock = 1024;
constexpr int kQuad = 6;
static_assert(kBlock * (sizeof(float4) + sizeof(int) + kQuad * sizeof(float)
                        + sizeof(int))
                  <= 48 * 1024,
              "the largest source panel must fit in static shared memory");
constexpr int kMaskedIdx = INT32_MIN;   // staged idx of a masked-out source
enum Mode { kBoth = 0, kAcc = 1, kPot = 2 };

// Knuth TwoSum: s + e == a + b exactly; a becomes s, e is added to err.
__device__ __forceinline__ void two_sum_into(float& a, float b, float& err)
{
    const float s = a + b;
    const float bb = s - a;
    err += (a - (s - bb)) + (b - bb);
    a = s;
}

template <int MODE, bool COMP, bool QUAD, bool CELL>
__global__ void __launch_bounds__(kThreads)
shared_fused_kernel(const float* __restrict__ tgt,        // [C, T, 3]
                    const int64_t* __restrict__ tgt_idx,  // [C, T]
                    const float* __restrict__ src,        // [S, 3]
                    const float* __restrict__ mass,       // [S]
                    const int64_t* __restrict__ src_idx,  // [S]
                    const uint8_t* __restrict__ mask,     // [C, S]
                    const float* __restrict__ quad,       // [S, 6] (QUAD)
                    const int32_t* __restrict__ src_cell, // [S, 3] (CELL)
                    const int32_t* __restrict__ tgt_cell, // [C, T, 3] (CELL)
                    const int32_t* __restrict__ ids,      // [C, NB]
                    const int32_t* __restrict__ cnt,      // [C]
                    float* __restrict__ acc,              // [C, T, 3]
                    float* __restrict__ pot,              // [C, T]
                    int T, int S, int NB, int sep, float eps2)
{
    __shared__ float4 s_pm[kBlock];
    __shared__ int s_idx[kBlock];
    __shared__ float s_q[QUAD ? kQuad : 1][QUAD ? kBlock : 1];
    __shared__ int s_cell[CELL ? kBlock : 1];

    const int c = blockIdx.x;
    const int t = blockIdx.y * kThreads + threadIdx.x;
    const bool live = t < T;
    const size_t tc = static_cast<size_t>(c) * T + t;
    float tx = 0.f, ty = 0.f, tz = 0.f;
    int ti = -2;   // matches no source index (nodes carry -1)
    int tk = 0;    // per field 512 + sep - 1 - the target's coordinate (CELL)
    if (live) {
        tx = tgt[3 * tc];
        ty = tgt[3 * tc + 1];
        tz = tgt[3 * tc + 2];
        ti = static_cast<int>(tgt_idx[tc]);
        if (CELL) tk = cell_target_word(tgt_cell + 3 * tc, sep);
    }
    const int cb = CELL ? cell_over_word(sep) : 0;
    const int32_t* my_ids = ids + static_cast<size_t>(c) * NB;
    const uint8_t* my_mask = mask + static_cast<size_t>(c) * S;
    const int nblk = cnt[c];

    float ax = 0.f, ay = 0.f, az = 0.f, pp = 0.f;   // running sums
    float ex = 0.f, ey = 0.f, ez = 0.f, ep = 0.f;   // TwoSum errors (COMP)
    for (int k = 0; k < nblk; ++k) {
        const int base = my_ids[k] * kBlock;
        __syncthreads();            // the previous panel is consumed
        for (int j = threadIdx.x; j < kBlock; j += kThreads) {
            const int s = base + j;
            float4 v = make_float4(1e30f, 1e30f, 1e30f, 0.f);
            int id = -1;
            if (s < S) {
                const size_t s3 = 3 * static_cast<size_t>(s);
                const bool on = my_mask[s] != 0;
                v.x = src[s3];
                v.y = src[s3 + 1];
                v.z = src[s3 + 2];
                v.w = on ? mass[s] : 0.f;
                id = static_cast<int>(src_idx[s]);
                if (QUAD && !on) id = kMaskedIdx;
            }
            s_pm[j] = v;
            s_idx[j] = id;
            if (CELL) {
                // padding past S: exempt, and massless
                s_cell[j] = s < S ? cell_source_word(
                    src_cell + 3 * static_cast<size_t>(s)) : -1;
            }
            if (QUAD) {
                const size_t s6 = kQuad * static_cast<size_t>(s);
#pragma unroll
                for (int q = 0; q < kQuad; ++q)
                    s_q[q][j] = s < S ? quad[s6 + q] : 0.f;
            }
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
            const int sid = s_idx[j];
            bool dead = sid == ti || r2 <= 0.f;
            if (QUAD) dead = dead || sid == kMaskedIdx;
            if (CELL) {
                dead = dead || cell_far(s_cell[j], tk, cb);
            }
            if (dead) inv_r = 0.f;
            const float w = v.w * inv_r;
            const float inv2 = inv_r * inv_r;
            float g = w * inv2;            // the factor of d in acc
            float qx = 0.f, qy = 0.f, qz = 0.f;
            if (QUAD) {
                const float qxx = s_q[0][j], qxy = s_q[1][j], qxz = s_q[2][j];
                const float qyy = s_q[3][j], qyz = s_q[4][j], qzz = s_q[5][j];
                qx = qxx * dx + qxy * dy + qxz * dz;      // Qd
                qy = qxy * dx + qyy * dy + qyz * dz;
                qz = qxz * dx + qyz * dy + qzz * dz;
                const float dqd = dx * qx + dy * qy + dz * qz;
                const float tr = qxx + qyy + qzz;
                const float inv3 = inv2 * inv_r;
                const float inv5 = inv3 * inv2;
                if (MODE != kPot) {
                    g += 7.5f * dqd * (inv5 * inv2) - 1.5f * tr * inv5;
                    qx *= -3.f * inv5;
                    qy *= -3.f * inv5;
                    qz *= -3.f * inv5;
                }
                if (MODE != kAcc) bp -= 1.5f * dqd * inv5 - 0.5f * tr * inv3;
            }
            if (MODE != kPot) {
                bx += g * dx + qx;
                by += g * dy + qy;
                bz += g * dz + qz;
            }
            if (MODE != kAcc) bp -= w;
        }
        if (COMP) {
            if (MODE != kPot) {
                two_sum_into(ax, bx, ex);
                two_sum_into(ay, by, ey);
                two_sum_into(az, bz, ez);
            }
            if (MODE != kAcc) two_sum_into(pp, bp, ep);
        } else {
            ax += bx;
            ay += by;
            az += bz;
            pp += bp;
        }
    }
    if (live) {
        acc[3 * tc] = ax + ex;
        acc[3 * tc + 1] = ay + ey;
        acc[3 * tc + 2] = az + ez;
        pot[tc] = pp + ep;
    }
}

struct Args {
    const float* tgt; const int64_t* tgt_idx; const float* src;
    const float* mass; const int64_t* src_idx; const uint8_t* mask;
    const float* quad; const int32_t* src_cell; const int32_t* tgt_cell;
    const int32_t* ids; const int32_t* cnt;
    float* acc; float* pot; int C, T, S, NB, sep; float eps2;
};

template <int MODE, bool COMP, bool QUAD, bool CELL>
cudaError_t launch(const Args& a, cudaStream_t stream)
{
    const dim3 grid(a.C, (a.T + kThreads - 1) / kThreads);
    shared_fused_kernel<MODE, COMP, QUAD, CELL>
        <<<grid, kThreads, 0, stream>>>(
            a.tgt, a.tgt_idx, a.src, a.mass, a.src_idx, a.mask, a.quad,
            a.src_cell, a.tgt_cell, a.ids, a.cnt, a.acc, a.pot, a.T, a.S,
            a.NB, a.sep, a.eps2);
    return cudaGetLastError();
}

template <int MODE, bool COMP>
cudaError_t launch_opts(const Args& a, cudaStream_t stream)
{
    const bool quad = a.quad != nullptr;
    if (a.sep > 0)
        return quad ? launch<MODE, COMP, true, true>(a, stream)
                    : launch<MODE, COMP, false, true>(a, stream);
    return quad ? launch<MODE, COMP, true, false>(a, stream)
                : launch<MODE, COMP, false, false>(a, stream);
}

template <int MODE>
cudaError_t launch_form(const Args& a, bool comp, cudaStream_t stream)
{
    return comp ? launch_opts<MODE, true>(a, stream)
                : launch_opts<MODE, false>(a, stream);
}

}  // namespace

// Source entries per block of the active-block lists (ids index blocks
// of this size).
extern "C" int rakau_shared_fused_block() { return kBlock; }

// Bits per coordinate of a packed source cell: the cells handed to the
// cell forms must lie below 2^this.
extern "C" int rakau_shared_fused_cell_bits() { return kCellBits; }

// Launches on `stream` and returns cudaGetLastError() of the launch
// (0 = accepted). mode: 0 both, 1 acc only (pot written as 0), 2 pot only
// (acc written as 0). quad: [S, 6] second moments, or null for the
// monopole forms. comp: nonzero for the compensated (TwoSum) sums. sep > 0
// with src_cell [S, 3] and tgt_cell [C, T, 3] (coordinates below
// 2^kCellBits, sep at most 2^kCellBits; a negative first source coordinate
// exempts the row) selects the cell-separation forms; sep = 0 ignores the
// cells.
extern "C" int rakau_shared_fused(const float* tgt, const int64_t* tgt_idx,
                                  const float* src, const float* mass,
                                  const int64_t* src_idx, const uint8_t* mask,
                                  const float* quad, const int32_t* src_cell,
                                  const int32_t* tgt_cell, const int32_t* ids,
                                  const int32_t* cnt, float* acc, float* pot,
                                  int C, int T, int S, int NB, int mode,
                                  int comp, int sep, float eps2, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (S < 0 || NB <= 0 || sep < 0 || sep > (1 << kCellBits)
        || (sep > 0 && (src_cell == nullptr || tgt_cell == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{tgt, tgt_idx, src, mass, src_idx, mask, quad, src_cell,
                 tgt_cell, ids, cnt, acc, pot, C, T, S, NB, sep, eps2};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mode) {
    case kBoth: return static_cast<int>(launch_form<kBoth>(a, comp != 0, st));
    case kAcc:  return static_cast<int>(launch_form<kAcc>(a, comp != 0, st));
    case kPot:  return static_cast<int>(launch_form<kPot>(a, comp != 0, st));
    default:    return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
