// Tensor-core form of the shared-candidate pairwise kernel (K6) for NVIDIA
// Hopper: monopole, fp32 sums, with or without the grid2 cell test.
//
// Replaces the TPU kernel rakau_tpu/kernels/pallas.py:
// _shared_fused_kernel_mxu. Same contract as shared_fused.cu (all C tiles
// of a chunk share one source row of S entries, a per-tile mask [C, S], the
// tile's compacted list of active source blocks), another arithmetic. For
// tile c with first target p, in tile-local coordinates t' = t - p and
// s' = s - p:
//
//     r2n   = (|t'|^2 - 2 t'.s') + |s'|^2            (the norm trick)
//     dead  = r2n <= 2^-21 (|t'|^2 + |s'|^2)         (or the cell test)
//     inv_r = dead ? 0 : rsqrt(r2n + eps^2)
//     w = m_j * mask[c, j] * inv_r,  w3 = w * inv_r^2
//     Y_i += sum_j w3_ij s'_j,  ysum_i += sum_j w3_ij,  pot_i -= sum_j w_ij
//     acc_i = Y_i - ysum_i t'_i                       (G applied by the caller)
//
// The relative threshold stands in for the index comparison: the norm
// trick's rounding noise, about 2^-24 (|t'|^2 + |s'|^2), swallows an exact
// zero, so a target's own row and any source closer than ~7e-4 of the
// pair's distance from p is dropped, and rsqrt never sees a negative
// rounding residue. The indices are not read. Tile-local coordinates keep
// that noise at the scale of the tile, not of the box.
//
// What goes where. The cross term t'.s' has depth 3: five fp32 operations
// a pair (the TPU kernel asks its matrix unit for full precision there).
// Only the accumulation Y += W3 X runs on the tensor cores, by warp-level
// mma.sync m16n8k16 in bf16 with fp32 accumulators: rows = 16 targets,
// depth = 16 staged sources, width 8 = the 3 coordinates of s' and 5 zero
// columns. Each lane computes the w3 of its 8 pairs (2 targets x 4
// sources) directly in the A fragment's layout, so W3 never passes through
// shared memory; the B fragments (s' in bf16, and its bf16 residue) are
// made once per staged block and read by every warp. ysum and pot are fp32
// sums in registers, as in the TPU kernel.
//
// Precisions (PREC), the TPU kernel's y_prec:
//   bf16:    one pass, bf16(w3) x bf16(s');
//   x3:      the TPU kernel's own split, w3 = Ah + Al and s' = Bh + Bl in
//            bf16, three passes Ah Bl + Al Bh + Ah Bh (the Al Bl term, 2^-18
//            relative, is dropped). Taken instead of a 3xTF32 split because
//            it is the reference's arithmetic term for term, so the plain
//            version (kernels/shared.py: eval_shared_mma_plain) checks both;
//   highest: no tensor core, Y by three fp32 FMAs a pair.
//
// What bounds it on this card: arithmetic, on the fp32 pipe. A pair costs
// ~16 fp32 operations and one MUFU rsqrt here against ~20 in shared_fused.cu
// (no dx, dy, dz, no three w3 * d products), plus in x3 about 3 operations
// of bf16 conversion and residue a pair; the tensor-core product itself is
// 3 x 16 x 8 x 2 operations for 16 pairs a row, a few percent of the card's
// bf16 rate. The 20 bytes a source are reused by every target of the tile
// from shared memory, so device memory is not the limit.
//
// Design: grid (C, ceil(T / 64)), 4 warps, each warp one slab of 16 targets
// (a lane holds 2 targets, rows g and g + 8; with two slabs a warp ptxas
// spilled registers in half of the forms). Per active
// block the threads stage s' and m * mask (float4), |s'|^2, the packed cell
// (CELL) and the bf16 planes of s'; entries past S are staged as massless
// points at p. Then every warp walks the block 16 sources at a time.
// Built without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_test.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlabs = 1;                      // 16-target slabs per warp
constexpr int kTargets = kWarps * kSlabs * 16; // targets per CUDA block
constexpr int kStep = 16;                      // sources per mma (its depth)
// Sources staged per step of the active-block list. Must equal
// kernels/shared.py:BLOCK, which the wrapper checks at load.
constexpr int kBlock = 1024;
// bf16 elements per coordinate plane of s': 16 more than kBlock, so that
// the three planes a warp reads at once start 8 banks apart
constexpr int kPlane = kBlock + 16;
enum Mode { kBoth = 0, kAcc = 1, kPot = 2 };
enum Prec { kBf16 = 0, kX3 = 1, kHighest = 2 };

// x a + y b + z c, every product and sum rounded on its own, left to right.
// The norm trick cancels: its rounding residue, not its value, decides a
// close pair's r2n, so the three norms and the cross term are written with
// intrinsics that nvcc never contracts into FMAs. The plain version then
// computes the same r2n bit for bit, and the two can be held together at
// rounding level instead of at the trick's own noise (~1e-3 of a close
// pair's force). FMAs would save two operations a pair.
__device__ __forceinline__ float dot3(float x, float y, float z, float a,
                                      float b, float c)
{
    return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)),
                     __fmul_rn(z, c));
}

__device__ __forceinline__ float norm2(float x, float y, float z)
{
    return dot3(x, y, z, x, y, z);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) -> the bf16 pair of their residues after pack_bf16(a, b)
__device__ __forceinline__ uint32_t pack_bf16_residue(float a, float b,
                                                      uint32_t packed)
{
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&packed));
    return pack_bf16(a - f.x, b - f.y);
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_sum(float v)
{
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

template <int MODE, int CELL, int PREC>
__global__ void __launch_bounds__(kThreads)
shared_mma_kernel(const float* __restrict__ tgt,        // [C, T, 3]
                  const float* __restrict__ src,        // [S, 3]
                  const float* __restrict__ mass,       // [S]
                  const uint8_t* __restrict__ mask,     // [C, S]
                  const int32_t* __restrict__ src_cell, // [S, 3] (CELL)
                  const int32_t* __restrict__ tgt_cell, // [C, T, 3] (CELL)
                  const int32_t* __restrict__ ids,      // [C, NB]
                  const int32_t* __restrict__ cnt,      // [C]
                  float* __restrict__ acc,              // [C, T, 3]
                  float* __restrict__ pot,              // [C, T]
                  int T, int S, int NB, int sep, float eps2)
{
    constexpr int DIMS = CELL ? CELL : 3;   // the cell packing (CELL)
    constexpr bool kMma = PREC != kHighest && MODE != kPot;
    __shared__ float4 s_pm[kBlock];                     // s', m * mask
    __shared__ float s_ss[kBlock];                      // |s'|^2
    __shared__ int s_cell[CELL ? kBlock : 1];
    __shared__ __align__(4) __nv_bfloat16 s_bh[kMma ? 3 : 1][kMma ? kPlane : 2];
    __shared__ __align__(4) __nv_bfloat16
        s_bl[kMma && PREC == kX3 ? 3 : 1][kMma && PREC == kX3 ? kPlane : 2];

    const int c = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;      // row of the fragments (and B's column)
    const int q = lane & 3;       // position in the group of four lanes
    const size_t c0 = static_cast<size_t>(c) * T;
    // the tile's first target: the origin of the local coordinates
    const float px = tgt[3 * c0], py = tgt[3 * c0 + 1], pz = tgt[3 * c0 + 2];

    // this lane's targets: slab m, rows g and g + 8
    float tx[kSlabs][2], ty[kSlabs][2], tz[kSlabs][2], tts[kSlabs][2];
    int tk[kSlabs][2];
#pragma unroll
    for (int m = 0; m < kSlabs; ++m)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int t = blockIdx.y * kTargets + (warp * kSlabs + m) * 16
                + g + 8 * r;
            tx[m][r] = ty[m][r] = tz[m][r] = 0.f;
            tk[m][r] = 0;
            if (t < T) {
                tx[m][r] = tgt[3 * (c0 + t)] - px;
                ty[m][r] = tgt[3 * (c0 + t) + 1] - py;
                tz[m][r] = tgt[3 * (c0 + t) + 2] - pz;
                if (CELL)
                    tk[m][r] = cell_target_word<DIMS>(
                        tgt_cell + 3 * (c0 + t), sep);
            }
            tts[m][r] = norm2(tx[m][r], ty[m][r], tz[m][r]);
        }
    const int cb = CELL ? cell_over_word<DIMS>(sep) : 0;
    const int32_t* my_ids = ids + static_cast<size_t>(c) * NB;
    const uint8_t* my_mask = mask + static_cast<size_t>(c) * S;
    const int nblk = cnt[c];

    float y[kSlabs][4];            // sums of the mma results: (row g |
    //                                g + 8) x columns 2q, 2q + 1 of Y (kMma)
    float yf[kSlabs][2][3];        // Y by fp32 FMAs (highest)
    float ysum[kSlabs][2], pp[kSlabs][2];
#pragma unroll
    for (int m = 0; m < kSlabs; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) y[m][i] = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            ysum[m][r] = pp[m][r] = 0.f;
            yf[m][r][0] = yf[m][r][1] = yf[m][r][2] = 0.f;
        }
    }

    for (int k = 0; k < nblk; ++k) {
        const int base = my_ids[k] * kBlock;
        __syncthreads();            // the previous panel is consumed
        for (int j = threadIdx.x; j < kBlock; j += kThreads) {
            const int s = base + j;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            int pc = -1;
            if (s < S) {
                const size_t s3 = 3 * static_cast<size_t>(s);
                v.x = src[s3] - px;
                v.y = src[s3 + 1] - py;
                v.z = src[s3 + 2] - pz;
                v.w = my_mask[s] != 0 ? mass[s] : 0.f;
                if (CELL) pc = cell_source_word<DIMS>(src_cell + s3);
            }
            s_pm[j] = v;
            s_ss[j] = norm2(v.x, v.y, v.z);
            if (CELL) s_cell[j] = pc;
            if (kMma) {
                const float xs[3] = {v.x, v.y, v.z};
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                    const __nv_bfloat16 h = __float2bfloat16_rn(xs[d]);
                    s_bh[d][j] = h;
                    if (PREC == kX3)
                        s_bl[d][j] = __float2bfloat16_rn(
                            xs[d] - __bfloat162float(h));
                }
            }
        }
        __syncthreads();
        const int nj = min(kBlock, S - base);
        for (int j0 = 0; j0 < nj; j0 += kStep) {
            // this lane's four sources: the A fragment's columns
            const int js[4] = {j0 + 2 * q, j0 + 2 * q + 1, j0 + 2 * q + 8,
                               j0 + 2 * q + 9};
            float4 sv[4];
            float ss[4];
            int pc[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                sv[i] = s_pm[js[i]];
                ss[i] = s_ss[js[i]];
                pc[i] = CELL ? s_cell[js[i]] : 0;
            }
            // B fragments: column g of X = coordinate g of s' (zero past 2)
            uint32_t bh0 = 0, bh1 = 0, bl0 = 0, bl1 = 0;
            if (kMma && g < 3) {
                bh0 = *reinterpret_cast<const uint32_t*>(&s_bh[g][js[0]]);
                bh1 = *reinterpret_cast<const uint32_t*>(&s_bh[g][js[2]]);
                if (PREC == kX3) {
                    bl0 = *reinterpret_cast<const uint32_t*>(&s_bl[g][js[0]]);
                    bl1 = *reinterpret_cast<const uint32_t*>(&s_bl[g][js[2]]);
                }
            }
#pragma unroll
            for (int m = 0; m < kSlabs; ++m) {
                float w3[2][4];
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float dot = dot3(tx[m][r], ty[m][r], tz[m][r],
                                               sv[i].x, sv[i].y, sv[i].z);
                        const float r2n = __fadd_rn(
                            __fsub_rn(tts[m][r], __fmul_rn(2.f, dot)), ss[i]);
                        bool dead = r2n <= 0x1p-21f * (tts[m][r] + ss[i]);
                        if (CELL)
                            dead = dead || cell_far<DIMS>(pc[i], tk[m][r], cb);
                        const float inv_r = dead ? 0.f : rsqrtf(r2n + eps2);
                        const float w = sv[i].w * inv_r;
                        if (MODE != kAcc) pp[m][r] -= w;
                        if (MODE != kPot) {
                            const float v3 = w * (inv_r * inv_r);
                            ysum[m][r] += v3;
                            if (PREC == kHighest) {
                                yf[m][r][0] = fmaf(v3, sv[i].x, yf[m][r][0]);
                                yf[m][r][1] = fmaf(v3, sv[i].y, yf[m][r][1]);
                                yf[m][r][2] = fmaf(v3, sv[i].z, yf[m][r][2]);
                            }
                            w3[r][i] = v3;
                        }
                    }
                if (kMma) {
                    // A fragment: (row g, k 0-1), (row g+8, k 0-1),
                    // (row g, k 8-9), (row g+8, k 8-9) of this lane's pairs
                    const uint32_t ah[4] = {
                        pack_bf16(w3[0][0], w3[0][1]),
                        pack_bf16(w3[1][0], w3[1][1]),
                        pack_bf16(w3[0][2], w3[0][3]),
                        pack_bf16(w3[1][2], w3[1][3])};
                    // The tensor core adds into its fp32 accumulator by
                    // truncation, so a sum chained through it over
                    // thousands of steps drifts by a part in 1e3 of Y, and
                    // Y - ysum t' cancels. Each step's product starts from
                    // zero and enters the running sum by a rounded add.
                    float c[4] = {0.f, 0.f, 0.f, 0.f};
                    if (PREC == kX3) {
                        const uint32_t al[4] = {
                            pack_bf16_residue(w3[0][0], w3[0][1], ah[0]),
                            pack_bf16_residue(w3[1][0], w3[1][1], ah[1]),
                            pack_bf16_residue(w3[0][2], w3[0][3], ah[2]),
                            pack_bf16_residue(w3[1][2], w3[1][3], ah[3])};
                        mma_bf16(c, ah, bl0, bl1);
                        mma_bf16(c, al, bh0, bh1);
                    }
                    mma_bf16(c, ah, bh0, bh1);
#pragma unroll
                    for (int i = 0; i < 4; ++i) y[m][i] += c[i];
                }
            }
        }
    }

    // a target's sums lie in the four lanes of its group: ysum and pot (and
    // highest's Y) as partial sums, the mma's Y as columns (x, y in lane
    // q = 0, z in lane q = 1)
    const int lead = lane & ~3;
#pragma unroll
    for (int m = 0; m < kSlabs; ++m)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float yx, yy, yz;
            if (kMma) {
                yx = __shfl_sync(0xffffffffu, y[m][2 * r], lead);
                yy = __shfl_sync(0xffffffffu, y[m][2 * r + 1], lead);
                yz = __shfl_sync(0xffffffffu, y[m][2 * r], lead + 1);
            } else {
                yx = quad_sum(yf[m][r][0]);
                yy = quad_sum(yf[m][r][1]);
                yz = quad_sum(yf[m][r][2]);
            }
            const float ys = quad_sum(ysum[m][r]);
            const float p = quad_sum(pp[m][r]);
            const int t = blockIdx.y * kTargets + (warp * kSlabs + m) * 16
                + g + 8 * r;
            if (q == 0 && t < T) {
                acc[3 * (c0 + t)] = yx - ys * tx[m][r];
                acc[3 * (c0 + t) + 1] = yy - ys * ty[m][r];
                acc[3 * (c0 + t) + 2] = yz - ys * tz[m][r];
                pot[c0 + t] = p;
            }
        }
}

struct Args {
    const float* tgt; const float* src; const float* mass;
    const uint8_t* mask; const int32_t* src_cell; const int32_t* tgt_cell;
    const int32_t* ids; const int32_t* cnt;
    float* acc; float* pot; int C, T, S, NB, sep, cell_dims; float eps2;
};

template <int MODE, int CELL, int PREC>
cudaError_t launch(const Args& a, cudaStream_t stream)
{
    const dim3 grid(a.C, (a.T + kTargets - 1) / kTargets);
    shared_mma_kernel<MODE, CELL, PREC><<<grid, kThreads, 0, stream>>>(
        a.tgt, a.src, a.mass, a.mask, a.src_cell, a.tgt_cell, a.ids, a.cnt,
        a.acc, a.pot, a.T, a.S, a.NB, a.sep, a.eps2);
    return cudaGetLastError();
}

template <int MODE, int CELL>
cudaError_t launch_prec(const Args& a, int prec, cudaStream_t stream)
{
    switch (prec) {
    case kBf16:    return launch<MODE, CELL, kBf16>(a, stream);
    case kX3:      return launch<MODE, CELL, kX3>(a, stream);
    case kHighest: return launch<MODE, CELL, kHighest>(a, stream);
    default:       return cudaErrorInvalidValue;
    }
}

template <int MODE>
cudaError_t launch_form(const Args& a, int prec, cudaStream_t stream)
{
    if (a.sep > 0)
        return a.cell_dims == 2 ? launch_prec<MODE, 2>(a, prec, stream)
                                : launch_prec<MODE, 3>(a, prec, stream);
    return launch_prec<MODE, 0>(a, prec, stream);
}

}  // namespace

// Source entries per block of the active-block lists.
extern "C" int rakau_shared_mma_block() { return kBlock; }

// Bits per coordinate of a packed source cell of `dims` dimensions.
extern "C" int rakau_shared_mma_cell_bits(int dims)
{
    return cell_coord_bits(dims);
}

// Launches on `stream` and returns cudaGetLastError() of the launch
// (0 = accepted). mode: 0 both, 1 acc only (pot written as 0), 2 pot only
// (acc written as 0). prec: 0 bf16, 1 x3, 2 highest. sep > 0 with src_cell
// [S, 3] and tgt_cell [C, T, 3] of cell_dims (2 or 3) dimensions (as in
// rakau_shared_fused) selects the cell-separation form; sep = 0 ignores the
// cells.
extern "C" int rakau_shared_mma(const float* tgt, const float* src,
                                const float* mass, const uint8_t* mask,
                                const int32_t* src_cell,
                                const int32_t* tgt_cell, const int32_t* ids,
                                const int32_t* cnt, float* acc, float* pot,
                                int C, int T, int S, int NB, int mode,
                                int prec, int sep, int cell_dims, float eps2,
                                void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (S < 0 || NB <= 0 || sep < 0
        || (sep > 0 && (src_cell == nullptr || tgt_cell == nullptr
                        || (cell_dims != 2 && cell_dims != 3)
                        || sep > (1 << cell_coord_bits(cell_dims)))))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{tgt, src, mass, mask, src_cell, tgt_cell, ids, cnt,
                 acc, pot, C, T, S, NB, sep, cell_dims, eps2};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mode) {
    case kBoth: return static_cast<int>(launch_form<kBoth>(a, prec, st));
    case kAcc:  return static_cast<int>(launch_form<kAcc>(a, prec, st));
    case kPot:  return static_cast<int>(launch_form<kPot>(a, prec, st));
    default:    return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
