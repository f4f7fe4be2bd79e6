// Tensor-core form of the shared-candidate pairwise kernel (K6) for NVIDIA
// Hopper: monopole, fp32 sums, with or without the grid2 cell test.
//
// Replaces the TPU kernel rakau_tpu/kernels/pallas.py:
// _shared_fused_kernel_mxu. Same contract as shared_fused.cu (all C tiles
// of a chunk share one source row of S entries, a per-tile mask [C, S]),
// the same plan (each tile's list of active granules, cut into spans),
// another arithmetic. For tile c with first target p, in tile-local
// coordinates t' = t - p and s' = s - p:
//
//     r2n   = (|t'|^2 - 2 t'.s') + |s'|^2            (the norm trick)
//     dead  = r2n <= 2^-21 (|t'|^2 + |s'|^2)         (or the cell test)
//     inv_r = dead ? 0 : rsqrt(r2n + eps^2)
//     w = m_j * mask[c, j] * inv_r,  w3 = w * inv_r^2
//     Y_i += sum_j w3_ij s'_j,  ysum_i += sum_j w3_ij,  pot_i -= sum_j w_ij
//     acc_i = G (Y_i - ysum_i t'_i),  pot_i = G pot_i
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
// columns. Each lane computes the w3 of its 8 pairs a slab (2 targets x 4
// sources) directly in the A fragment's layout, so W3 never passes through
// shared memory; the B fragments (s' in bf16, and its bf16 residue) are
// formed once per staged granule and read by every warp. ysum and pot are
// fp32 sums in registers, as in the TPU kernel.
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
// What bounds it on this card: the issue rate of the fp32 pipe. A pair
// costs ~16 fp32 operations and one MUFU rsqrt here against ~20 in
// shared_fused.cu (no dx, dy, dz, no three w3 * d products), plus in x3
// about 3 operations of bf16 conversion and residue a pair; the
// tensor-core product itself is 3 x 16 x 8 x 2 operations for 16 pairs a
// row, a few percent of the card's bf16 rate. The 16 bytes a source are
// reused by every target of the work item from shared memory, so device
// memory is not the limit. Two savings keep the plain version's bits:
// r2n's 2 t'.s' and the threshold's 2^-21 scaling are exact, so each
// folds into one FMA; and rsqrt runs on the MUFU alone (rsqrt_normal),
// without rsqrtf's rescaling of subnormal inputs.
//
// Design, K1's plan and structure (shared_fused.cu), six kernels a launch,
// none waiting on the host:
//  1-3. The plan and the packed row of shared_plan.cuh, K1's own kernels:
//     each tile's list of active granules of kGranule sources, cut into
//     spans of `span` entries, one work item a (span, group of kTargets
//     targets); the row packed once as (x, y, z, m) and the cell words.
//  4. shared_mma_kernel: a persistent grid of at most as many CUDA blocks
//     as fit on the card walks the items in a fixed order. kWarps warps a
//     block, kSlabs slabs of 16 targets a warp (a lane holds rows g and
//     g + 8 of each slab). Granules stream through a ring of kStages
//     buffers by 16-byte cp.async copies, the next in flight while the
//     current one is summed. The thread that copied a source forms its
//     staged entry itself before the granule's one barrier: s' = s - p,
//     the mass times the tile's mask bit, |s'|^2, and the bf16 planes of
//     s' (and of its residue in x3). A work item writes its span's partial
//     sums (Y, ysum, pot: five floats a target) into a scratch
//     [C, zmax, T].
//  5. shared_mma_reduce_kernel adds each target's spans in span order,
//     forms acc = Y - ysum t' once on the sums (it cancels: |Y| is 10-100x
//     |acc|) and applies G. No float atomics: two launches on the same
//     inputs give the same bits.
//
// Padding past S sits at 1e30 with mass 0: |s'|^2 overflows to inf, the
// dead rule holds (inf <= inf), inv_r = 0 and w3 = 0, so the tensor-core
// product multiplies that source's bf16 coordinates by zeros only. Built
// without --use_fast_math.
//
// CELL is the packing of the cell test (cell_test.cuh): 0 (none), 3 (3-D
// cells) or 2 (2-D cells, padded to 3-D by the wrapper): 27
// instantiations of the main kernel (mode x cell x precision), one of the
// reduction and the four plan and packing kernels of shared_plan.cuh.
// Float32 only. RAKAU_MMA_WARPS (4) and RAKAU_MMA_SLABS (2) set the warps
// a block and the slabs a warp at build time, for ab_kernels.py's sweeps;
// the defaults were chosen there on the card (PERF.md, PR 9), as were the
// unrolling of a granule's steps (none) and the launch bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_test.cuh"
#include "shared_plan.cuh"

#ifndef RAKAU_MMA_WARPS
#define RAKAU_MMA_WARPS 4
#endif
#ifndef RAKAU_MMA_SLABS
#define RAKAU_MMA_SLABS 2
#endif

namespace {

static_assert(sizeof(real) == 4, "K6 is float32 only");
constexpr int kWarps = RAKAU_MMA_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlabs = RAKAU_MMA_SLABS;        // 16-target slabs a warp
constexpr int kTargets = kWarps * kSlabs * 16; // targets a work item
constexpr int kStep = 16;                      // sources a mma (its depth)
constexpr int kStages = 3;                     // ring of staged granules
// bf16 elements a coordinate plane of s': 16 more than a granule, so that
// the three planes a warp reads at once start 8 banks apart
constexpr int kPlane = kGranule + 16;
static_assert(kGranule <= kThreads,
              "each staged source is copied and formed by one thread");
static_assert(kGranule % kStep == 0, "a granule is whole mma steps");
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

// rsqrt(x) on the MUFU unit alone. rsqrtf without --use_fast_math wraps
// the same MUFU.RSQ in a rescaling of subnormal inputs (five more
// instructions a pair, a fifth of a pair's issue slots); here x is raised
// to the smallest normal number first (one instruction), so every x >=
// 2^-126 gets rsqrtf's bits and a smaller one (a pair closer than 1e-19
// at eps = 0, which the dead rule does not resolve) a finite 2^63.
__device__ __forceinline__ float rsqrt_normal(float x)
{
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaxf(x, 0x1p-126f)));
    return y;
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

// *p, by a load that the compiler can neither move nor merge with another
__device__ __forceinline__ int load_again(const int32_t* p)
{
    int v;
    asm volatile("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

// ---- 16-byte asynchronous copies global -> shared (sm_80 and later) ----
__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One staged granule: s' and m * mask, |s'|^2, in CELL the packed source
// cells, in the tensor-core forms the bf16 planes of s' (PLANES) and of
// its residue (RESIDUE, x3).
template <int CELL, bool PLANES, bool RESIDUE>
struct alignas(16) Stage {
    float4 pm[kGranule];
    alignas(16) float ss[kGranule];
    alignas(16) int cell[CELL ? kGranule : 4];
    alignas(4) __nv_bfloat16 bh[PLANES ? 3 : 1][PLANES ? kPlane : 2];
    alignas(4) __nv_bfloat16 bl[RESIDUE ? 3 : 1][RESIDUE ? kPlane : 2];
};

// The packed row in the workspace.
struct Row {
    const float4* pm;         // [Sp] x, y, z, m
    const int* cell;          // [Sp] packed source cells (CELL)
    const unsigned* bits;     // [C, Sp / 32] mask bits
};

// Issue the copies of granule gid into `st`: thread j < kGranule copies
// source j, thread j < kGranule / 4 the cell words 4j .. 4j + 3.
template <int CELL, class St>
__device__ __forceinline__ void issue(St& st, const Row& row, int gid)
{
    const size_t base = static_cast<size_t>(gid) * kGranule;
    const int j = threadIdx.x;
    if (j < kGranule) cp_async16(&st.pm[j], row.pm + base + j);
    if (CELL && j < kGranule / 4)
        cp_async16(&st.cell[4 * j], row.cell + base + 4 * j);
}

// Thread j < kGranule forms staged entry j, which it copied itself: s'
// about p, the mass times the tile's mask bit (from `word`, the mask word
// that holds it), |s'|^2 and the bf16 planes.
template <int CELL, bool PLANES, bool RESIDUE>
__device__ __forceinline__ void form(Stage<CELL, PLANES, RESIDUE>& st,
                                     unsigned word, float px, float py,
                                     float pz)
{
    const int j = threadIdx.x;
    if (j >= kGranule) return;
    float4 v = st.pm[j];
    v.x = __fsub_rn(v.x, px);
    v.y = __fsub_rn(v.y, py);
    v.z = __fsub_rn(v.z, pz);
    if (!((word >> (j & 31)) & 1u)) v.w = 0.f;
    st.pm[j] = v;
    st.ss[j] = norm2(v.x, v.y, v.z);
    if constexpr (PLANES) {
        const float xs[3] = {v.x, v.y, v.z};
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            const __nv_bfloat16 h = __float2bfloat16_rn(xs[d]);
            st.bh[d][j] = h;
            if constexpr (RESIDUE)
                st.bl[d][j] = __float2bfloat16_rn(
                    __fsub_rn(xs[d], __bfloat162float(h)));
        }
    }
}

template <int MODE, int CELL, int PREC>
__global__ void __launch_bounds__(kThreads)
shared_mma_kernel(Row row,
                  const float* __restrict__ tgt,        // [C, T, 3]
                  const int32_t* __restrict__ tgt_cell, // [C, T, 3] (CELL)
                  const int32_t* __restrict__ ids,      // [C, NG]
                  const int32_t* __restrict__ cnt,      // [C]
                  const int32_t* __restrict__ work,     // [C * zmax]
                  const int32_t* __restrict__ n_work,   // [1]
                  float4* __restrict__ sums,            // [C, zmax, T]
                  float* __restrict__ pots,             // [C, zmax, T]
                  int T, int NG, int words, int zmax, int span, int sep,
                  const float* __restrict__ scal)       // [eps^2, G]
{
    constexpr int DIMS = CELL ? CELL : 3;   // the cell packing (CELL)
    constexpr bool kMma = PREC != kHighest && MODE != kPot;
    using St = Stage<CELL, kMma, kMma && PREC == kX3>;
    __shared__ St ring[kStages];
    // eps^2 in a register from entry, but for the acc-only x3 cell forms:
    // they sit at the register limit, where one more live value spills
    // (4-8 bytes), and read it at each use instead
    constexpr bool kHoldEps2 = !(MODE == kAcc && CELL && PREC == kX3);
    const float eps2_held = kHoldEps2 ? __ldg(scal) : 0.f;

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;      // row of the fragments (and B's column)
    const int q = lane & 3;       // position in the group of four lanes
    const int groups = (T + kTargets - 1) / kTargets;
    const int items = n_work[0] * groups;
    const int cb = CELL ? cell_over_word<DIMS>(sep) : 0;
    const bool copies = threadIdx.x < kGranule;
    unsigned n = 0;   // granules this block has staged and summed

    for (int u = blockIdx.x; u < items; u += gridDim.x) {
        const int pr = u / groups;
        const int grp = u - pr * groups;
        const int entry = work[pr];
        const int c = entry / zmax;
        const int z = entry - c * zmax;
        const int k0 = z * span;
        const int k1 = min(k0 + span, cnt[c]);
        const int32_t* my_ids = ids + static_cast<size_t>(c) * NG;
        // the mask word of this thread's staged source within a granule's
        const unsigned* my_bits = row.bits + static_cast<size_t>(c) * words
            + (threadIdx.x >> 5);
        const size_t c0 = static_cast<size_t>(c) * T;
        // the tile's first target: the origin of the local coordinates
        const float px = tgt[3 * c0], py = tgt[3 * c0 + 1],
                    pz = tgt[3 * c0 + 2];

        // this lane's targets: slab m, rows g and g + 8; th = 2^-21 |t'|^2,
        // the target's part of the dead rule's threshold
        float tx[kSlabs][2], ty[kSlabs][2], tz[kSlabs][2], tts[kSlabs][2];
        float th[kSlabs][2];
        int tk[kSlabs][2];
#pragma unroll
        for (int m = 0; m < kSlabs; ++m)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int t = grp * kTargets + (warp * kSlabs + m) * 16 + g
                    + 8 * r;
                tx[m][r] = ty[m][r] = tz[m][r] = 0.f;
                tk[m][r] = 0;
                if (t < T) {
                    tx[m][r] = __fsub_rn(tgt[3 * (c0 + t)], px);
                    ty[m][r] = __fsub_rn(tgt[3 * (c0 + t) + 1], py);
                    tz[m][r] = __fsub_rn(tgt[3 * (c0 + t) + 2], pz);
                    if (CELL)
                        tk[m][r] = cell_target_word<DIMS>(
                            tgt_cell + 3 * (c0 + t), sep);
                }
                tts[m][r] = norm2(tx[m][r], ty[m][r], tz[m][r]);
                th[m][r] = 0x1p-21f * tts[m][r];
            }

        float y[kSlabs][4];        // sums of the mma results: (row g |
        //                            g + 8) x columns 2q, 2q + 1 of Y (kMma)
        float yf[kSlabs][2][3];    // Y by fp32 FMAs (highest)
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

        // prologue: the first granule in flight, the id after it read
        int gid = my_ids[k0];
        issue<CELL>(ring[n % kStages], row, gid);
        cp_async_commit();
        unsigned word = copies ? __ldg(my_bits + gid * (kGranule / 32)) : 0u;
        int gid_next = k0 + 1 < k1 ? my_ids[k0 + 1] : 0;
        for (int k = k0; k < k1; ++k, ++n) {
            St& cur = ring[n % kStages];
            unsigned word_next = 0;
            if (k + 1 < k1) {
                // the buffer written here was summed two granules ago, and
                // the barrier of the last granule is behind every thread
                issue<CELL>(ring[(n + 1) % kStages], row, gid_next);
                if (copies)
                    word_next = __ldg(my_bits + gid_next * (kGranule / 32));
                gid_next = k + 2 < k1 ? my_ids[k + 2] : 0;
            }
            cp_async_commit();          // an empty group past the last
            cp_async_wait<1>();         // this thread's copies of `cur`
            form(cur, word, px, py, pz);
            word = word_next;
            __syncthreads();            // every thread's entries of `cur`

#pragma unroll 1
            for (int j0 = 0; j0 < kGranule; j0 += kStep) {
                // this lane's four sources: the A fragment's columns, and
                // the B fragment's rows
                const int jb = j0 + 2 * q;
                const float4 sv[4] = {cur.pm[jb], cur.pm[jb + 1],
                                      cur.pm[jb + 8], cur.pm[jb + 9]};
                const float2 sa = *reinterpret_cast<const float2*>(
                    &cur.ss[jb]);
                const float2 sb = *reinterpret_cast<const float2*>(
                    &cur.ss[jb + 8]);
                const float ss[4] = {sa.x, sa.y, sb.x, sb.y};
                int pc[4] = {0, 0, 0, 0};
                if (CELL) {
                    const int2 ca = *reinterpret_cast<const int2*>(
                        &cur.cell[jb]);
                    const int2 cb2 = *reinterpret_cast<const int2*>(
                        &cur.cell[jb + 8]);
                    pc[0] = ca.x; pc[1] = ca.y; pc[2] = cb2.x; pc[3] = cb2.y;
                }
                // B fragments: column g of X = coordinate g of s' (zero
                // past 2)
                uint32_t bh0 = 0, bh1 = 0, bl0 = 0, bl1 = 0;
                if constexpr (kMma) {
                    if (g < 3) {
                        bh0 = *reinterpret_cast<const uint32_t*>(
                            &cur.bh[g][jb]);
                        bh1 = *reinterpret_cast<const uint32_t*>(
                            &cur.bh[g][jb + 8]);
                        if constexpr (PREC == kX3) {
                            bl0 = *reinterpret_cast<const uint32_t*>(
                                &cur.bl[g][jb]);
                            bl1 = *reinterpret_cast<const uint32_t*>(
                                &cur.bl[g][jb + 8]);
                        }
                    }
                }
#pragma unroll
                for (int m = 0; m < kSlabs; ++m) {
                    float w3[2][4];
#pragma unroll
                    for (int r = 0; r < 2; ++r)
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const float dot = dot3(tx[m][r], ty[m][r],
                                                   tz[m][r], sv[i].x,
                                                   sv[i].y, sv[i].z);
                            // (|t'|^2 - 2 dot) + |s'|^2 and the threshold
                            // 2^-21 (|t'|^2 + |s'|^2), each as one FMA and
                            // with the plain version's bits: 2 dot and the
                            // scaling by 2^-21 are exact, so each FMA
                            // rounds where the separate operations round
                            const float r2n = __fadd_rn(
                                __fmaf_rn(-2.f, dot, tts[m][r]), ss[i]);
                            bool dead = r2n <= __fmaf_rn(0x1p-21f, ss[i],
                                                         th[m][r]);
                            if (CELL)
                                dead = dead | cell_far<DIMS>(pc[i], tk[m][r],
                                                             cb);
                            // the load, where there is one, on live pairs
                            // only: made for every pair it spilled too
                            const float inv_r =
                                dead ? 0.f
                                     : rsqrt_normal(r2n + (kHoldEps2
                                                           ? eps2_held
                                                           : __ldg(scal)));
                            const float w = sv[i].w * inv_r;
                            if (MODE != kAcc) pp[m][r] -= w;
                            const float v3 = w * (inv_r * inv_r);
                            if (MODE != kPot) {
                                ysum[m][r] += v3;
                                if (PREC == kHighest) {
                                    yf[m][r][0] = fmaf(v3, sv[i].x,
                                                       yf[m][r][0]);
                                    yf[m][r][1] = fmaf(v3, sv[i].y,
                                                       yf[m][r][1]);
                                    yf[m][r][2] = fmaf(v3, sv[i].z,
                                                       yf[m][r][2]);
                                }
                            }
                            w3[r][i] = v3;
                        }
                    if (kMma) {
                        // A fragment: (row g, k 0-1), (row g+8, k 0-1),
                        // (row g, k 8-9), (row g+8, k 8-9) of this lane's
                        // pairs
                        const uint32_t ah[4] = {
                            pack_bf16(w3[0][0], w3[0][1]),
                            pack_bf16(w3[1][0], w3[1][1]),
                            pack_bf16(w3[0][2], w3[0][3]),
                            pack_bf16(w3[1][2], w3[1][3])};
                        // The tensor core adds into its fp32 accumulator by
                        // truncation, so a sum chained through it over
                        // thousands of steps drifts by a part in 1e3 of Y,
                        // and Y - ysum t' cancels. Each step's product
                        // starts from zero and enters the running sum by a
                        // rounded add.
                        float cc[4] = {0.f, 0.f, 0.f, 0.f};
                        if (PREC == kX3) {
                            const uint32_t al[4] = {
                                pack_bf16_residue(w3[0][0], w3[0][1], ah[0]),
                                pack_bf16_residue(w3[1][0], w3[1][1], ah[1]),
                                pack_bf16_residue(w3[0][2], w3[0][3], ah[2]),
                                pack_bf16_residue(w3[1][2], w3[1][3], ah[3])};
                            mma_bf16(cc, ah, bl0, bl1);
                            mma_bf16(cc, al, bh0, bh1);
                        }
                        mma_bf16(cc, ah, bh0, bh1);
#pragma unroll
                        for (int i = 0; i < 4; ++i) y[m][i] += cc[i];
                    }
                }
            }
        }

        // a target's sums lie in the four lanes of its group: ysum and pot
        // (and highest's Y) as partial sums, the mma's Y as columns (x, y
        // in lane q = 0, z in lane q = 1). The span's partial goes to the
        // scratch, at the item's place read again here: held across the
        // granules, it was what ptxas spilled.
        const int e_end = load_again(work + pr);
        const int c_end = e_end / zmax;
        const size_t at0 = (static_cast<size_t>(c_end) * zmax
                            + (e_end - c_end * zmax)) * T;
        const int t0 = (u - pr * groups) * kTargets;
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
                const int t = t0 + (warp * kSlabs + m) * 16 + g + 8 * r;
                if (q == 0 && t < T) {
                    sums[at0 + t] = make_float4(yx, yy, yz, ys);
                    pots[at0 + t] = p;
                }
            }
    }
    cp_async_wait<0>();
}

// acc, pot of target (c, t): its tile's spans added in span order, then
// acc = Y - ysum t' about the tile's first target, both times G =
// scal[1] (read after the sums: held from entry, it spilled).
__global__ void __launch_bounds__(kPackThreads)
shared_mma_reduce_kernel(const float4* __restrict__ sums,  // [C, zmax, T]
                         const float* __restrict__ pots,   // [C, zmax, T]
                         const int32_t* __restrict__ cnt,  // [C]
                         const float* __restrict__ tgt,    // [C, T, 3]
                         float* __restrict__ acc,          // [C, T, 3]
                         float* __restrict__ pot,          // [C, T]
                         int C, int T, int zmax, int span,
                         const float* __restrict__ scal)   // [eps^2, G]
{
    const long long i = static_cast<long long>(blockIdx.x) * kPackThreads
        + threadIdx.x;
    if (i >= static_cast<long long>(C) * T) return;
    const int c = static_cast<int>(i / T);
    const int t = static_cast<int>(i - static_cast<long long>(c) * T);
    const int nz = (cnt[c] + span - 1) / span;
    const size_t base = static_cast<size_t>(c) * zmax * T + t;
    float yx = 0.f, yy = 0.f, yz = 0.f, ys = 0.f, p = 0.f;
    for (int z = 0; z < nz; ++z) {
        const float4 v = sums[base + static_cast<size_t>(z) * T];
        yx += v.x;
        yy += v.y;
        yz += v.z;
        ys += v.w;
        p += pots[base + static_cast<size_t>(z) * T];
    }
    const float* p0 = tgt + 3 * static_cast<size_t>(c) * T;
    const float tv[3] = {__fsub_rn(tgt[3 * i], p0[0]),
                         __fsub_rn(tgt[3 * i + 1], p0[1]),
                         __fsub_rn(tgt[3 * i + 2], p0[2])};
    const float yv[3] = {yx, yy, yz};
    const float G = __ldg(scal + 1);
#pragma unroll
    for (int d = 0; d < 3; ++d)
        acc[3 * i + d] = G * __fsub_rn(yv[d], __fmul_rn(ys, tv[d]));
    pot[i] = G * p;
}

// Byte offsets of the workspace's parts, 256-aligned: the mask bits and
// the granule flags (all the plan needs), the packed row, the spans'
// scratch.
struct Layout {
    int NG, Sp, words, zmax;
    size_t bits, flags, pm, cell, sums, pots, total;
};

Layout layout(int C, int T, int S, int span, bool cell)
{
    Layout L{};
    L.NG = S > 0 ? (S + kGranule - 1) / kGranule : 1;
    L.Sp = L.NG * kGranule;
    L.words = L.Sp / 32;
    L.zmax = (L.NG + span - 1) / span;
    size_t off = 0;
    auto take = [&off](size_t bytes) {
        const size_t at = off;
        off += (bytes + 255) / 256 * 256;
        return at;
    };
    const size_t Sp = static_cast<size_t>(L.Sp);
    const size_t parts = static_cast<size_t>(C) * L.zmax * T;
    L.bits = take(static_cast<size_t>(C) * L.words * sizeof(unsigned));
    L.flags = take(static_cast<size_t>(C) * L.NG);
    L.pm = take(Sp * sizeof(float4));
    L.cell = take(cell ? Sp * sizeof(int) : 0);
    L.sums = take(parts * sizeof(float4));
    L.pots = take(parts * sizeof(float));
    L.total = off;
    return L;
}

struct Args {
    const float* tgt; const int32_t* tgt_cell; const int32_t* ids;
    const int32_t* cnt; const int32_t* work; const int32_t* n_work;
    unsigned char* ws; float* acc; float* pot;
    int C, T, S, span, sep, sms; const float* scal;
};

// CUDA blocks of one form that fit on an SM at once (at least 1).
template <int MODE, int CELL, int PREC>
int blocks_per_sm()
{
    static int cache[kMaxDevices] = {};
    int& occ = device_slot(cache);
    if (occ == 0) {
        int got = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &got, shared_mma_kernel<MODE, CELL, PREC>, kThreads, 0)
            != cudaSuccess)
            got = 1;
        occ = got > 0 ? got : 1;
    }
    return occ;
}

// The persistent grid: at most one CUDA block a work item that could
// exist (C * zmax spans x target groups), at most what fits on the card.
template <int MODE, int CELL, int PREC>
int grid_blocks(int C, int T, const Layout& L, int sms)
{
    const long long items = static_cast<long long>(C) * L.zmax
        * ((T + kTargets - 1) / kTargets);
    const long long fit = static_cast<long long>(
        blocks_per_sm<MODE, CELL, PREC>()) * (sms > 0 ? sms : 1);
    const long long g = items < fit ? items : fit;
    return static_cast<int>(g > 0 ? g : 1);
}

template <int MODE, int CELL, int PREC>
cudaError_t launch(const Args& a, const Layout& L, cudaStream_t stream)
{
    const int grid = grid_blocks<MODE, CELL, PREC>(a.C, a.T, L, a.sms);
    const Row row{reinterpret_cast<const float4*>(a.ws + L.pm),
                  reinterpret_cast<const int*>(a.ws + L.cell),
                  reinterpret_cast<const unsigned*>(a.ws + L.bits)};
    float4* sums = reinterpret_cast<float4*>(a.ws + L.sums);
    float* pots = reinterpret_cast<float*>(a.ws + L.pots);
    shared_mma_kernel<MODE, CELL, PREC><<<grid, kThreads, 0, stream>>>(
        row, a.tgt, a.tgt_cell, a.ids, a.cnt, a.work, a.n_work, sums, pots,
        a.T, L.NG, L.words, L.zmax, a.span, a.sep, a.scal);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long CT = static_cast<long long>(a.C) * a.T;
    shared_mma_reduce_kernel
        <<<static_cast<unsigned>((CT + kPackThreads - 1) / kPackThreads),
           kPackThreads, 0, stream>>>(sums, pots, a.cnt, a.tgt, a.acc,
                                      a.pot, a.C, a.T, L.zmax, a.span,
                                      a.scal);
    return cudaGetLastError();
}

// The form's instantiation called with F<MODE, CELL, PREC>::run, or `bad`
// for a mode or precision out of range.
template <template <int, int, int> class F, int MODE, int CELL, typename R,
          typename... A>
R by_prec(int prec, R bad, A&&... args)
{
    switch (prec) {
    case kBf16:    return F<MODE, CELL, kBf16>::run(args...);
    case kX3:      return F<MODE, CELL, kX3>::run(args...);
    case kHighest: return F<MODE, CELL, kHighest>::run(args...);
    default:       return bad;
    }
}

template <template <int, int, int> class F, int MODE, typename R,
          typename... A>
R by_cell(int sep, int cell_dims, int prec, R bad, A&&... args)
{
    if (sep > 0)
        return cell_dims == 2 ? by_prec<F, MODE, 2>(prec, bad, args...)
                              : by_prec<F, MODE, 3>(prec, bad, args...);
    return by_prec<F, MODE, 0>(prec, bad, args...);
}

template <template <int, int, int> class F, typename R, typename... A>
R by_form(int mode, int sep, int cell_dims, int prec, R bad, A&&... args)
{
    switch (mode) {
    case kBoth: return by_cell<F, kBoth>(sep, cell_dims, prec, bad, args...);
    case kAcc:  return by_cell<F, kAcc>(sep, cell_dims, prec, bad, args...);
    case kPot:  return by_cell<F, kPot>(sep, cell_dims, prec, bad, args...);
    default:    return bad;
    }
}

template <int MODE, int CELL, int PREC>
struct Launch {
    static cudaError_t run(const Args& a, const Layout& L, cudaStream_t st)
    {
        return launch<MODE, CELL, PREC>(a, L, st);
    }
};

template <int MODE, int CELL, int PREC>
struct Grid {
    static int run(int C, int T, const Layout& L, int sms)
    {
        return grid_blocks<MODE, CELL, PREC>(C, T, L, sms);
    }
};

template <int MODE, int CELL, int PREC>
struct Occupancy {
    static int run() { return blocks_per_sm<MODE, CELL, PREC>(); }
};

bool bad_cells(int sep, int cell_dims)
{
    if (sep == 0) return false;
    return sep < 0 || (cell_dims != 2 && cell_dims != 3)
        || sep > (1 << cell_coord_bits(cell_dims));
}

}  // namespace

// Sources a granule: the unit of the per-tile active lists (ids index
// granules of this size).
extern "C" int rakau_shared_mma_granule() { return kGranule; }

// Targets a work item (the CUDA block's warps x slabs x 16).
extern "C" int rakau_shared_mma_targets_per_item() { return kTargets; }

// Threads of a CUDA block of the main kernel.
extern "C" int rakau_shared_mma_threads() { return kThreads; }

// Bits per coordinate of a packed source cell of `dims` dimensions.
extern "C" int rakau_shared_mma_cell_bits(int dims)
{
    return cell_coord_bits(dims);
}

// Bytes of the workspace a launch of these sizes needs (the plan's mask
// bits and granule flags, the packed row and its cells with `cell`, the
// spans' scratch), or 0 for bad sizes. The plan alone needs the first
// part, which depends on C and S only.
extern "C" size_t rakau_shared_mma_workspace(int C, int T, int S, int span,
                                             int cell)
{
    if (C <= 0 || T <= 0 || S < 0 || span < 1) return 0;
    return layout(C, T, S, span, cell != 0).total;
}

// K6's plan on `stream`, K1's (rakau_shared_fused_plan, the same kernels):
// mask [C, S] into bits and granule flags in the workspace ws (256-byte
// aligned), every tile's active granules into ids [C, NG] and their count
// into cnt [C], the spans of `span` entries into work [C * zmax] and their
// number into n_work [1]: kernels/shared.py:fused_plan on the card.
// Returns cudaGetLastError() of the launches (0 = accepted).
extern "C" int rakau_shared_mma_plan(const uint8_t* mask, void* ws,
                                     int32_t* ids, int32_t* cnt,
                                     int32_t* work, int32_t* n_work, int C,
                                     int S, int span, void* stream)
{
    if (C <= 0) return 0;
    if (S < 0 || span < 1 || ws == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(C, 1, S, span, false);
    unsigned char* base = static_cast<unsigned char*>(ws);
    return static_cast<int>(launch_plan(
        mask, reinterpret_cast<unsigned*>(base + L.bits),
        reinterpret_cast<uint8_t*>(base + L.flags), ids, cnt, work, n_work,
        C, S, L.NG, L.zmax, span, static_cast<cudaStream_t>(stream)));
}

// Packs the row into the workspace ws (256-byte aligned, at least
// rakau_shared_mma_workspace(C, T, S, span, cell_dims > 0) bytes) on
// `stream` by K1's packing kernel: src [S, 3], mass [S], src_cell [S, 3]
// of cell_dims (2 or 3) dimensions or null with cell_dims = 0. Returns
// cudaGetLastError() of the launch (0 = accepted).
extern "C" int rakau_shared_mma_pack(const float* src, const float* mass,
                                     const int32_t* src_cell, void* ws,
                                     int C, int T, int S, int span,
                                     int cell_dims, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (S < 0 || span < 1 || ws == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0
        || (cell_dims != 0) != (src_cell != nullptr)
        || (cell_dims != 0 && cell_dims != 2 && cell_dims != 3))
        return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(C, T, S, span, cell_dims != 0);
    unsigned char* base = static_cast<unsigned char*>(ws);
    shared_fused_pack_kernel<<<static_cast<unsigned>(
        (L.Sp + kPackThreads - 1) / kPackThreads), kPackThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(
        src, mass, nullptr, nullptr, src_cell,
        reinterpret_cast<float4*>(base + L.pm), nullptr, nullptr,
        cell_dims != 0 ? reinterpret_cast<int*>(base + L.cell) : nullptr, S,
        L.Sp, cell_dims);
    return static_cast<int>(cudaGetLastError());
}

// Launches the main kernel and the span reduction on `stream` over the
// plan (ids, cnt, work, n_work from rakau_shared_mma_plan) and the row
// packed into ws by rakau_shared_mma_pack with the same sizes, and returns
// cudaGetLastError() of the launches (0 = accepted). mode: 0 both, 1 acc
// only (pot written as 0), 2 pot only (acc written as 0). prec: 0 bf16, 1
// x3, 2 highest. sep > 0 with tgt_cell [C, T, 3] of cell_dims (2 or 3)
// dimensions (as in rakau_shared_fused) selects the cell-separation form;
// sep = 0 ignores the cells. sms: the card's multiprocessors. acc
// [C, T, 3] and pot [C, T] are the sums times G. scal [2] on the card holds
// eps^2 and G, read by the kernels.
extern "C" int rakau_shared_mma(const float* tgt, const int32_t* tgt_cell,
                                const int32_t* ids, const int32_t* cnt,
                                const int32_t* work, const int32_t* n_work,
                                void* ws, float* acc, float* pot, int C,
                                int T, int S, int span, int mode, int prec,
                                int sep, int cell_dims, int sms,
                                const float* scal, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (S < 0 || span < 1 || ws == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0
        || bad_cells(sep, cell_dims) || (sep > 0 && tgt_cell == nullptr)
        || scal == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(C, T, S, span, sep > 0);
    const Args a{tgt, tgt_cell, ids, cnt, work, n_work,
                 static_cast<unsigned char*>(ws), acc, pot, C, T, S, span,
                 sep, sms, scal};
    return static_cast<int>(by_form<Launch>(
        mode, sep, cell_dims, prec, cudaErrorInvalidValue, a, L,
        static_cast<cudaStream_t>(stream)));
}

// CUDA blocks a launch of these sizes and options runs (its persistent
// grid), or -1 for a bad mode, precision or cell option.
extern "C" int rakau_shared_mma_grid(int C, int T, int S, int span,
                                     int mode, int prec, int sep,
                                     int cell_dims, int sms)
{
    if (C <= 0 || T <= 0 || S < 0 || span < 1 || bad_cells(sep, cell_dims))
        return -1;
    const Layout L = layout(C, T, S, span, sep > 0);
    return by_form<Grid>(mode, sep, cell_dims, prec, -1, C, T, L, sms);
}

// CUDA blocks of a form that fit on one SM at once.
extern "C" int rakau_shared_mma_blocks_per_sm(int mode, int prec, int sep,
                                              int cell_dims)
{
    if (bad_cells(sep, cell_dims)) return -1;
    return by_form<Occupancy>(mode, sep, cell_dims, prec, -1);
}

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
