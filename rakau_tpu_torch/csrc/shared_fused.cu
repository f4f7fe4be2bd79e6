// Shared-candidate pairwise kernel for NVIDIA Hopper, in eight forms (fp32,
// or fp64 in the float64 build).
//
// Replaces the TPU kernel rakau_tpu/kernels/pallas.py:_shared_fused_kernel
// with the options the shared path uses: monopole fp32 (K1a),
// `compensated=True` (K1b), `quad=6` (K1d) and both together, and each of
// the four with the grid2 cell test `grid_sep > 0` (K1c). All C tiles of
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
// odd-order terms carry the signs of pallas.py:733-746.) Here the masked-out
// pair is dead in every form: its term is m * 0 = 0 where the TPU kernel's
// monopole multiplies m * 0 * inv_r, the same zero.
//
// CELL (farfield "grid2", tiles spanning several leaf-grid cells): every
// source row and every target carries its leaf-grid cell, and a pair whose
// Chebyshev cell separation max_d |sc_d - tc_d| is >= sep belongs to the
// dense far field: it is dead here, through the same gate as the self
// pair, so every power of inv_r starts from an exact zero
// (pallas.py:676-695). Source rows whose first cell coordinate is negative
// are exempt from the test. A source's cell is packed once per launch into
// one int32 (-1 for an exempt row) and the test runs on the packed word
// (cell_test.cuh).
//
// COMP: each thread sums one staged granule into partials, adds each
// partial into its span's running sum with Knuth's TwoSum and keeps the
// error terms; the second kernel adds the spans' sums by TwoSum in span
// order and their error terms, and writes sum + err: the TPU kernel's
// per-block structure (pallas.py:751-773) with the granule as the block. A
// skipped granule adds nothing, as a zero partial would. TwoSum has no
// products, so nvcc's FMA contraction cannot change it; built without fast
// math, nothing reassociates it.
//
// What bounds it on this card: arithmetic. A monopole pair costs ~20 fp32
// operations and one MUFU rsqrt, a quadrupole pair ~60, against 20 (44)
// bytes of source data that every target of the work item reuses from
// shared memory, so device memory is not the limit; the issue rate and the
// warps in flight are.
//
// Design, six kernels a launch, none waiting on the host:
//  1-3. The plan and the packed row (shared_plan.cuh, shared with K6):
//     the mask into bits and granule flags, each tile's list of active
//     granules of kGranule sources, the spans of `span` list entries
//     (kernels/shared.py:fused_plan is the same plan in PyTorch); the row
//     packed once: (x, y, z, m) as one real4 a source, int32 indices, the
//     packed cells and the second moments, all padded to whole granules
//     (far, massless, index -1, exempt, zero moments).
//  4. shared_fused_kernel: the work is cut by each tile's own list; a
//     work item is (span, group of targets), in the work list's order. A
//     persistent grid of at most as many CUDA blocks as fit on the card
//     walks the items in a fixed order (item blockIdx.x, then +
//     gridDim.x, ...), so no block waits on the tile with the longest
//     list and none is launched only to exit. Each thread holds kTpt
//     targets in registers (2 in the float build, so that every staged
//     entry read from shared memory serves two pairs; 1 in the float64
//     build), its span sums in its own column of shared
//     memory. Granules stream through a ring of kStages buffers by
//     16-byte cp.async.cg copies, the next one in flight while the current
//     one is summed; the thread that copied four staged indices folds the
//     tile's mask bits into them (kMaskedIdx for a masked-out source,
//     which the dead gate kills), so one barrier a granule suffices. A
//     span writes its partial (and in COMP its error terms) per target
//     into a scratch [C, zmax, T].
//  5. shared_fused_reduce_kernel adds each target's spans in span order
//     and applies G. No float atomics: two launches on the same inputs
//     give the same bits.
//
// Padding sources sit at 1e30 (or the traversal's 4*box) with mass 0:
// r2 overflows to inf, rsqrtf(inf) = 0, and w = 0, never NaN. The QUAD
// terms multiply Q (0 on padding) into d before d again (Qd, then d.Qd),
// so no 1e30 * 1e30 = inf meets a zero. Built without --use_fast_math to
// keep that.
//
// Scalar type: `real` is RAKAU_REAL, float unless the library is built
// with -DRAKAU_REAL=double (kernels/shared.py:build_library(f64=True)),
// which gives the same kernels in float64 for float64 trees. A ring that
// fits in the 48 KB of static shared memory is declared static; a larger
// one (the double QUAD forms at a granule of 256) takes dynamic shared
// memory and raises its kernel's limit first. The plan (kGranule) is the
// same in both types. RAKAU_GRANULE, RAKAU_TPT and RAKAU_UNROLL set the
// granule, the targets a thread of the float build and the unrolling at
// build time (128, 2 and 8, chosen by ab_k1.py's sweep on the card;
// kernels/shared.py:GRANULE must equal the granule, checked at load).
//
// CELL is the packing of the cell test: 0 (none), 3 (3-D cells) or 2 (2-D
// cells, padded to 3-D by the wrapper): 36 instantiations of the main
// kernel, two of the reduction and the four plan and packing kernels of
// shared_plan.cuh.

#ifdef RAKAU_REAL
// The float64 build: at least four resident blocks a SM (at most 128
// registers a thread). Under the thread bound alone ptxas held the double
// forms at 56-96 registers and spilled 8-24 bytes in most of them.
#ifndef RAKAU_MIN_BLOCKS
#define RAKAU_MIN_BLOCKS 4
#endif
#else
#define RAKAU_REAL float
#endif
#ifndef RAKAU_MIN_BLOCKS
#define RAKAU_MIN_BLOCKS 0
#endif
#if RAKAU_MIN_BLOCKS > 0
#define RAKAU_K1_BOUNDS __launch_bounds__(kThreads, RAKAU_MIN_BLOCKS)
#else
#define RAKAU_K1_BOUNDS __launch_bounds__(kThreads)
#endif
#ifndef RAKAU_TPT
#define RAKAU_TPT 2
#endif
#ifndef RAKAU_UNROLL
#define RAKAU_UNROLL 8
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_test.cuh"
#include "shared_plan.cuh"

namespace {

__device__ __forceinline__ float rsqrt_r(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_r(double x) { return rsqrt(x); }

constexpr int kThreads = 128;            // threads of a work item's block
// Targets a thread (every staged entry read from shared memory serves
// that many pairs): RAKAU_TPT in the float build, one in the float64
// build, whose registers are twice as wide.
constexpr int kTpt = sizeof(real) == 8 ? 1 : RAKAU_TPT;
constexpr int kTargets = kThreads * kTpt;    // targets a work item
constexpr int kUnroll = RAKAU_UNROLL;    // unrolling of the source loop
constexpr int kStages = 3;               // ring of staged granules
constexpr size_t kStaticSmem = 48 * 1024;
constexpr int kMaskedIdx = INT32_MIN;    // staged idx of a masked-out source
static_assert(kGranule / 4 <= kThreads,
              "one thread folds each 16-byte chunk of a granule's indices");
static_assert(kTpt >= 1, "a thread holds at least one target");
enum Mode { kBoth = 0, kAcc = 1, kPot = 2 };

// One staged granule of a form: real4 (x, y, z, m), int32 idx, in QUAD the
// 6 second moments of each source, in CELL its packed cell word.
template <bool QUAD, bool CELL>
struct alignas(32) Stage {
    real4 pm[kGranule];
    alignas(16) int idx[kGranule];
    alignas(16) real q[QUAD ? kGranule * kQuad : 4];
    alignas(16) int cell[CELL ? kGranule : 4];
};

// A block's shared memory: the ring of staged granules, and each
// thread's span sums (and TwoSum errors) of its targets, one column a
// thread: they change once a granule, so they wait there and not in the
// registers that the source loop needs.
template <bool QUAD, bool CELL>
struct Ring {
    Stage<QUAD, CELL> st[kStages];
    real sum[8 * kTpt][kThreads];
};
static_assert(sizeof(Ring<true, true>) <= 227 * 1024,
              "the largest ring must fit in a block's shared memory");

// Dynamic shared memory a form's launch asks for: 0 where its ring is
// static.
template <bool QUAD, bool CELL>
__host__ __device__ constexpr size_t dynamic_smem()
{
    return sizeof(Ring<QUAD, CELL>) <= kStaticSmem
        ? 0 : sizeof(Ring<QUAD, CELL>);
}

// The block's ring: static where it fits, else at the start of dynamic
// shared memory.
template <bool QUAD, bool CELL>
__device__ __forceinline__ Ring<QUAD, CELL>& ring_smem()
{
    if constexpr (dynamic_smem<QUAD, CELL>() == 0) {
        __shared__ Ring<QUAD, CELL> r;
        return r;
    } else {
        extern __shared__ __align__(32) unsigned char smem[];
        return *reinterpret_cast<Ring<QUAD, CELL>*>(smem);
    }
}

// Knuth TwoSum: s + e == a + b exactly; a becomes s, e is added to err.
__device__ __forceinline__ void two_sum_into(real& a, real b, real& err)
{
    const real s = a + b;
    const real bb = s - a;
    err += (a - (s - bb)) + (b - bb);
    a = s;
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

// The block copies `bytes` (a multiple of 16) from src to dst; chunk q
// goes to thread q % kThreads.
template <size_t BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src)
{
    static_assert(BYTES % 16 == 0, "16-byte chunks");
    char* d = static_cast<char*>(dst);
    const char* s = static_cast<const char*>(src);
    for (int q = threadIdx.x; q < static_cast<int>(BYTES / 16); q += kThreads)
        cp_async16(d + 16 * q, s + 16 * q);
}

// The packed row in the workspace.
struct Row {
    const real4* pm;          // [Sp] x, y, z, m
    const int* idx;           // [Sp]
    const real* quad;         // [Sp, 6] (QUAD)
    const int* cell;          // [Sp] packed source cells (CELL)
    const unsigned* bits;     // [C, Sp / 32] mask bits
};

// Issue the copies of granule gid into stage st.
template <bool QUAD, bool CELL>
__device__ __forceinline__ void issue(Stage<QUAD, CELL>& st, const Row& row,
                                      int gid)
{
    const size_t base = static_cast<size_t>(gid) * kGranule;
    copy_async<kGranule * sizeof(real4)>(st.pm, row.pm + base);
    copy_async<kGranule * sizeof(int)>(st.idx, row.idx + base);
    if constexpr (QUAD)
        copy_async<kGranule * kQuad * sizeof(real)>(st.q,
                                                    row.quad + base * kQuad);
    if constexpr (CELL)
        copy_async<kGranule * sizeof(int)>(st.cell, row.cell + base);
}

// Thread q < kGranule / 4 copied idx chunk q (entries 4q .. 4q + 3) itself;
// `word` is the tile's mask word that holds their bits. A masked-out entry
// gets kMaskedIdx.
__device__ __forceinline__ void fold(int* s_idx, unsigned word)
{
    if (threadIdx.x < kGranule / 4) {
        const unsigned b = word >> ((threadIdx.x * 4) & 31);
        int4* p = reinterpret_cast<int4*>(s_idx) + threadIdx.x;
        int4 v = *p;
        if (!(b & 1u)) v.x = kMaskedIdx;
        if (!(b & 2u)) v.y = kMaskedIdx;
        if (!(b & 4u)) v.z = kMaskedIdx;
        if (!(b & 8u)) v.w = kMaskedIdx;
        *p = v;
    }
}

template <int MODE, bool COMP, bool QUAD, int CELL>
__global__ void RAKAU_K1_BOUNDS
shared_fused_kernel(Row row,
                    const real* __restrict__ tgt,         // [C, T, 3]
                    const int64_t* __restrict__ tgt_idx,  // [C, T]
                    const int32_t* __restrict__ tgt_cell, // [C, T, 3] (CELL)
                    const int32_t* __restrict__ ids,      // [C, NG]
                    const int32_t* __restrict__ cnt,      // [C]
                    const int32_t* __restrict__ work,     // [C * zmax]
                    const int32_t* __restrict__ n_work,   // [1]
                    real4* __restrict__ sums,             // [C, zmax, T]
                    real4* __restrict__ errs,             // [C, zmax, T]
                    int T, int NG, int words, int zmax, int span, int sep,
                    const real* __restrict__ scal)        // [eps^2, G]
{
    constexpr int DIMS = CELL ? CELL : 3;
    const real eps2 = scal[0];
    using St = Stage<QUAD, CELL != 0>;
    Ring<QUAD, CELL != 0>& ring = ring_smem<QUAD, CELL != 0>();
    const int groups = (T + kTargets - 1) / kTargets;
    const int items = n_work[0] * groups;
    const int cb = CELL ? cell_over_word<DIMS>(sep) : 0;
    const bool folds = threadIdx.x < kGranule / 4;
    unsigned n = 0;   // granules this block has staged and summed

    for (int u = blockIdx.x; u < items; u += gridDim.x) {
        const int pr = u / groups;
        const int g = u - pr * groups;
        const int entry = work[pr];
        const int c = entry / zmax;
        const int z = entry - c * zmax;
        const int k0 = z * span;
        const int k1 = min(k0 + span, cnt[c]);
        const int32_t* my_ids = ids + static_cast<size_t>(c) * NG;
        // the word of this thread's folded chunk within a granule's words
        const unsigned* my_bits = row.bits + static_cast<size_t>(c) * words
            + (threadIdx.x >> 3);

        real tx[kTpt], ty[kTpt], tz[kTpt];
        int ti[kTpt], tk[kTpt];
#pragma unroll
        for (int i = 0; i < kTpt; ++i) {
            const int t = g * kTargets + i * kThreads + threadIdx.x;
            const size_t tc = static_cast<size_t>(c) * T + t;
            tx[i] = ty[i] = tz[i] = 0;
            ti[i] = -2;   // matches no source index (nodes carry -1)
            tk[i] = 0;    // per field top + sep - 1 - the coordinate (CELL)
            if (t < T) {
                tx[i] = tgt[3 * tc];
                ty[i] = tgt[3 * tc + 1];
                tz[i] = tgt[3 * tc + 2];
                ti[i] = static_cast<int>(tgt_idx[tc]);
                if (CELL) tk[i] = cell_target_word<DIMS>(tgt_cell + 3 * tc,
                                                          sep);
            }
        }
        // target i's span sums at rows 8 i .. 8 i + 3 of span_sum (acc x,
        // y, z, pot), their TwoSum errors at rows 8 i + 4 .. 8 i + 7 (COMP)
        real* span_sum = &ring.sum[0][threadIdx.x];
#pragma unroll
        for (int q = 0; q < 8 * kTpt; ++q) span_sum[q * kThreads] = 0;

        // prologue: the first granule in flight, the id after it read
        int gid = my_ids[k0];
        issue(ring.st[n % kStages], row, gid);
        cp_async_commit();
        unsigned word = folds ? __ldg(my_bits + gid * (kGranule / 32)) : 0u;
        int gid_next = k0 + 1 < k1 ? my_ids[k0 + 1] : 0;
        for (int k = k0; k < k1; ++k, ++n) {
            St& cur = ring.st[n % kStages];
            unsigned word_next = 0;
            if (k + 1 < k1) {
                // the buffer written here was summed two granules ago, and
                // the barrier of the last granule is behind every thread
                issue(ring.st[(n + 1) % kStages], row, gid_next);
                if (folds)
                    word_next = __ldg(my_bits + gid_next * (kGranule / 32));
                gid_next = k + 2 < k1 ? my_ids[k + 2] : 0;
            }
            cp_async_commit();          // an empty group past the last
            cp_async_wait<1>();         // this thread's copies of `cur`
            fold(cur.idx, word);
            word = word_next;
            __syncthreads();            // every thread's copies of `cur`

            real bx[kTpt], by[kTpt], bz[kTpt], bp[kTpt];   // the granule's
#pragma unroll
            for (int i = 0; i < kTpt; ++i) bx[i] = by[i] = bz[i] = bp[i] = 0;
#pragma unroll (kUnroll)
            for (int j = 0; j < kGranule; ++j) {
                const real4 sv = cur.pm[j];
                const int sid = cur.idx[j];
                const bool off = sid == kMaskedIdx;
                int pc = 0;
                if (CELL) pc = cur.cell[j];
                real qxx = 0, qxy = 0, qxz = 0, qyy = 0, qyz = 0, qzz = 0;
                if (QUAD) {
                    const real* qj = cur.q + kQuad * j;
                    qxx = qj[0]; qxy = qj[1]; qxz = qj[2];
                    qyy = qj[3]; qyz = qj[4]; qzz = qj[5];
                }
#pragma unroll
                for (int i = 0; i < kTpt; ++i) {
                    const real dx = sv.x - tx[i];
                    const real dy = sv.y - ty[i];
                    const real dz = sv.z - tz[i];
                    const real r2 = dx * dx + dy * dy + dz * dz + eps2;
                    real inv_r = rsqrt_r(r2);
                    bool dead = off || sid == ti[i] || r2 <= real(0);
                    if (CELL) dead = dead || cell_far<DIMS>(pc, tk[i], cb);
                    if (dead) inv_r = 0;
                    const real w = sv.w * inv_r;
                    const real inv2 = inv_r * inv_r;
                    real gf = w * inv2;            // the factor of d in acc
                    real qx = 0, qy = 0, qz = 0;
                    if (QUAD) {
                        qx = qxx * dx + qxy * dy + qxz * dz;      // Qd
                        qy = qxy * dx + qyy * dy + qyz * dz;
                        qz = qxz * dx + qyz * dy + qzz * dz;
                        const real dqd = dx * qx + dy * qy + dz * qz;
                        const real tr = qxx + qyy + qzz;
                        const real inv3 = inv2 * inv_r;
                        const real inv5 = inv3 * inv2;
                        if (MODE != kPot) {
                            gf += real(7.5) * dqd * (inv5 * inv2)
                                - real(1.5) * tr * inv5;
                            qx *= real(-3) * inv5;
                            qy *= real(-3) * inv5;
                            qz *= real(-3) * inv5;
                        }
                        if (MODE != kAcc)
                            bp[i] -= real(1.5) * dqd * inv5
                                - real(0.5) * tr * inv3;
                    }
                    if (MODE != kPot) {
                        bx[i] += gf * dx + qx;
                        by[i] += gf * dy + qy;
                        bz[i] += gf * dz + qz;
                    }
                    if (MODE != kAcc) bp[i] -= w;
                }
            }
#pragma unroll
            for (int i = 0; i < kTpt; ++i) {
                const real part[4] = {bx[i], by[i], bz[i], bp[i]};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (q < 3 ? MODE == kPot : MODE == kAcc) continue;
                    real& a = span_sum[(8 * i + q) * kThreads];
                    if (COMP) {
                        real a_ = a;
                        real& e = span_sum[(8 * i + 4 + q) * kThreads];
                        real e_ = e;
                        two_sum_into(a_, part[q], e_);
                        a = a_;
                        e = e_;
                    } else {
                        a += part[q];
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kTpt; ++i) {
            const int t = g * kTargets + i * kThreads + threadIdx.x;
            if (t < T) {
                const size_t at = (static_cast<size_t>(c) * zmax + z) * T + t;
                const real* v = span_sum + 8 * i * kThreads;
                sums[at] = real4{v[0], v[kThreads], v[2 * kThreads],
                                 v[3 * kThreads]};
                if (COMP)
                    errs[at] = real4{v[4 * kThreads], v[5 * kThreads],
                                     v[6 * kThreads], v[7 * kThreads]};
            }
        }
    }
    cp_async_wait<0>();
}

// acc, pot of target (c, t): its tile's spans added in span order (COMP:
// TwoSum of the sums, then the error terms; sum + err at the end), times
// G = scal[1].
template <bool COMP>
__global__ void __launch_bounds__(kPackThreads)
shared_fused_reduce_kernel(const real4* __restrict__ sums,   // [C, zmax, T]
                           const real4* __restrict__ errs,   // [C, zmax, T]
                           const int32_t* __restrict__ cnt,  // [C]
                           real* __restrict__ acc,           // [C, T, 3]
                           real* __restrict__ pot,           // [C, T]
                           int C, int T, int zmax, int span,
                           const real* __restrict__ scal)  // [eps^2, G]
{
    const real G = scal[1];
    const long long i = static_cast<long long>(blockIdx.x) * kPackThreads
        + threadIdx.x;
    if (i >= static_cast<long long>(C) * T) return;
    const int c = static_cast<int>(i / T);
    const int t = static_cast<int>(i - static_cast<long long>(c) * T);
    const int nz = (cnt[c] + span - 1) / span;
    const size_t base = static_cast<size_t>(c) * zmax * T + t;
    real sx = 0, sy = 0, sz = 0, sp = 0;
    real ex = 0, ey = 0, ez = 0, ep = 0;
    for (int z = 0; z < nz; ++z) {
        const real4 v = sums[base + static_cast<size_t>(z) * T];
        if (COMP) {
            const real4 e = errs[base + static_cast<size_t>(z) * T];
            two_sum_into(sx, v.x, ex);
            ex += e.x;
            two_sum_into(sy, v.y, ey);
            ey += e.y;
            two_sum_into(sz, v.z, ez);
            ez += e.z;
            two_sum_into(sp, v.w, ep);
            ep += e.w;
        } else {
            sx += v.x;
            sy += v.y;
            sz += v.z;
            sp += v.w;
        }
    }
    acc[3 * i] = G * (sx + ex);
    acc[3 * i + 1] = G * (sy + ey);
    acc[3 * i + 2] = G * (sz + ez);
    pot[i] = G * (sp + ep);
}

// Byte offsets of the workspace's parts, 256-aligned: the mask bits and
// the granule flags (all the plan needs), the packed row, the spans'
// scratch.
struct Layout {
    int NG, Sp, words, zmax;
    size_t bits, flags, pm, idx, quad, cell, sums, errs, total;
};

Layout layout(int C, int T, int S, int span, bool quad, bool cell, bool comp)
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
    L.bits = take(static_cast<size_t>(C) * L.words * sizeof(unsigned));
    L.flags = take(static_cast<size_t>(C) * L.NG);
    L.pm = take(Sp * sizeof(real4));
    L.idx = take(Sp * sizeof(int));
    L.quad = take(quad ? Sp * kQuad * sizeof(real) : 0);
    L.cell = take(cell ? Sp * sizeof(int) : 0);
    const size_t part = static_cast<size_t>(C) * L.zmax * T * sizeof(real4);
    L.sums = take(part);
    L.errs = take(comp ? part : 0);
    L.total = off;
    return L;
}

struct Args {
    const real* tgt; const int64_t* tgt_idx; const int32_t* tgt_cell;
    const int32_t* ids; const int32_t* cnt; const int32_t* work;
    const int32_t* n_work; unsigned char* ws; real* acc; real* pot;
    int C, T, S, span, sep, sms; bool quad; const real* scal;
};

// CUDA blocks of one form that fit on an SM at once (at least 1); sets
// the form's dynamic shared memory limit first where it needs one, once
// on each device (per_device.cuh).
template <int MODE, bool COMP, bool QUAD, int CELL>
int blocks_per_sm()
{
    static int cache[kMaxDevices] = {};
    int& occ = device_slot(cache);
    if (occ == 0) {
        constexpr size_t smem = dynamic_smem<QUAD, CELL != 0>();
        auto kernel = shared_fused_kernel<MODE, COMP, QUAD, CELL>;
        if (smem > 0)
            cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        int got = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &got, kernel, kThreads, smem) != cudaSuccess)
            got = 1;
        occ = got > 0 ? got : 1;
    }
    return occ;
}

// The persistent grid: at most one CUDA block a work item that could
// exist (C * zmax spans x target groups), at most what fits on the card.
template <int MODE, bool COMP, bool QUAD, int CELL>
int grid_blocks(int C, int T, const Layout& L, int sms)
{
    const long long items = static_cast<long long>(C) * L.zmax
        * ((T + kTargets - 1) / kTargets);
    const long long fit = static_cast<long long>(
        blocks_per_sm<MODE, COMP, QUAD, CELL>()) * (sms > 0 ? sms : 1);
    const long long g = items < fit ? items : fit;
    return static_cast<int>(g > 0 ? g : 1);
}

template <int MODE, bool COMP, bool QUAD, int CELL>
cudaError_t launch(const Args& a, const Layout& L, cudaStream_t stream)
{
    constexpr size_t smem = dynamic_smem<QUAD, CELL != 0>();
    const int grid = grid_blocks<MODE, COMP, QUAD, CELL>(a.C, a.T, L, a.sms);
    const Row row{reinterpret_cast<const real4*>(a.ws + L.pm),
                  reinterpret_cast<const int*>(a.ws + L.idx),
                  reinterpret_cast<const real*>(a.ws + L.quad),
                  reinterpret_cast<const int*>(a.ws + L.cell),
                  reinterpret_cast<const unsigned*>(a.ws + L.bits)};
    real4* sums = reinterpret_cast<real4*>(a.ws + L.sums);
    real4* errs = reinterpret_cast<real4*>(a.ws + L.errs);
    shared_fused_kernel<MODE, COMP, QUAD, CELL>
        <<<grid, kThreads, smem, stream>>>(
            row, a.tgt, a.tgt_idx, a.tgt_cell, a.ids, a.cnt, a.work,
            a.n_work, sums, errs, a.T, L.NG, L.words, L.zmax, a.span, a.sep,
            a.scal);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long CT = static_cast<long long>(a.C) * a.T;
    shared_fused_reduce_kernel<COMP>
        <<<static_cast<unsigned>((CT + kPackThreads - 1) / kPackThreads),
           kPackThreads, 0, stream>>>(sums, errs, a.cnt, a.acc, a.pot, a.C,
                                      a.T, L.zmax, a.span, a.scal);
    return cudaGetLastError();
}

// The form's instantiation called with F<MODE, COMP, QUAD, CELL>::run.
template <template <int, bool, bool, int> class F, int MODE, bool COMP,
          typename... A>
auto by_opts(bool quad, int sep, int cell_dims, A&&... args)
{
    if (sep > 0 && cell_dims == 2)
        return quad ? F<MODE, COMP, true, 2>::run(args...)
                    : F<MODE, COMP, false, 2>::run(args...);
    if (sep > 0)
        return quad ? F<MODE, COMP, true, 3>::run(args...)
                    : F<MODE, COMP, false, 3>::run(args...);
    return quad ? F<MODE, COMP, true, 0>::run(args...)
                : F<MODE, COMP, false, 0>::run(args...);
}

template <template <int, bool, bool, int> class F, typename R, typename... A>
R by_form(int mode, bool comp, bool quad, int sep, int cell_dims, R bad,
          A&&... args)
{
    switch (mode) {
    case kBoth:
        return comp ? by_opts<F, kBoth, true>(quad, sep, cell_dims, args...)
                    : by_opts<F, kBoth, false>(quad, sep, cell_dims, args...);
    case kAcc:
        return comp ? by_opts<F, kAcc, true>(quad, sep, cell_dims, args...)
                    : by_opts<F, kAcc, false>(quad, sep, cell_dims, args...);
    case kPot:
        return comp ? by_opts<F, kPot, true>(quad, sep, cell_dims, args...)
                    : by_opts<F, kPot, false>(quad, sep, cell_dims, args...);
    default:
        return bad;
    }
}

template <int MODE, bool COMP, bool QUAD, int CELL>
struct Launch {
    static cudaError_t run(const Args& a, const Layout& L, cudaStream_t st)
    {
        return launch<MODE, COMP, QUAD, CELL>(a, L, st);
    }
};

template <int MODE, bool COMP, bool QUAD, int CELL>
struct Grid {
    static int run(int C, int T, const Layout& L, int sms)
    {
        return grid_blocks<MODE, COMP, QUAD, CELL>(C, T, L, sms);
    }
};

template <int MODE, bool COMP, bool QUAD, int CELL>
struct Occupancy {
    static int run() { return blocks_per_sm<MODE, COMP, QUAD, CELL>(); }
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
extern "C" int rakau_shared_fused_granule() { return kGranule; }

// Targets a thread holds.
extern "C" int rakau_shared_fused_targets_per_thread() { return kTpt; }

// Bits per coordinate of a packed source cell of `dims` dimensions: the
// cells handed to the cell forms must lie below 2^this.
extern "C" int rakau_shared_fused_cell_bits(int dims)
{
    return cell_coord_bits(dims);
}

// Bytes of the scalar type the library was built for (4 or 8).
extern "C" int rakau_shared_fused_real_bytes()
{
    return static_cast<int>(sizeof(real));
}

// Bytes of the workspace a launch of these sizes and options needs (the
// plan's mask bits and granule flags, the packed row and the spans'
// scratch), or 0 for bad sizes. The plan alone needs the first part,
// which depends on C and S only.
extern "C" size_t rakau_shared_fused_workspace(int C, int T, int S, int span,
                                               int quad, int cell, int comp)
{
    if (C <= 0 || T <= 0 || S < 0 || span < 1) return 0;
    return layout(C, T, S, span, quad != 0, cell != 0, comp != 0).total;
}

// K1's plan on `stream`: mask [C, S] (bytes, nonzero = on) into bits and
// granule flags in the workspace ws (256-byte aligned), every tile's
// active granules into ids [C, NG] (row order, padded with NG) and their
// count into cnt [C], NG = ceil(S / granule), at least 1, and the spans
// of `span` entries into work [C * zmax] (tile * zmax + span index, tile
// after tile, padded with C * zmax; zmax = ceil(NG / span)) and their
// number into n_work [1]: kernels/shared.py:fused_plan on the card.
// Returns cudaGetLastError() of the launches (0 = accepted).
extern "C" int rakau_shared_fused_plan(const uint8_t* mask, void* ws,
                                       int32_t* ids, int32_t* cnt,
                                       int32_t* work, int32_t* n_work, int C,
                                       int S, int span, void* stream)
{
    if (C <= 0) return 0;
    if (S < 0 || span < 1 || ws == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(C, 1, S, span, false, false, false);
    unsigned char* base = static_cast<unsigned char*>(ws);
    return static_cast<int>(launch_plan(
        mask, reinterpret_cast<unsigned*>(base + L.bits),
        reinterpret_cast<uint8_t*>(base + L.flags), ids, cnt, work, n_work,
        C, S, L.NG, L.zmax, span, static_cast<cudaStream_t>(stream)));
}

// Packs the row into the workspace ws (256-byte aligned, at least
// rakau_shared_fused_workspace(C, T, S, span, quad != null,
// cell_dims > 0, comp) bytes) on `stream`; returns cudaGetLastError() of
// the launch (0 = accepted). src [S, 3], mass [S], src_idx [S], quad
// [S, 6] or null, src_cell [S, 3] of cell_dims (2 or 3) dimensions or
// null with cell_dims = 0.
extern "C" int rakau_shared_fused_pack(const real* src, const real* mass,
                                       const int64_t* src_idx,
                                       const real* quad,
                                       const int32_t* src_cell, void* ws,
                                       int C, int T, int S, int span,
                                       int comp, int cell_dims, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (S < 0 || span < 1 || ws == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0
        || (cell_dims != 0) != (src_cell != nullptr)
        || (cell_dims != 0 && cell_dims != 2 && cell_dims != 3))
        return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(C, T, S, span, quad != nullptr, cell_dims != 0,
                            comp != 0);
    unsigned char* base = static_cast<unsigned char*>(ws);
    shared_fused_pack_kernel<<<static_cast<unsigned>(
        (L.Sp + kPackThreads - 1) / kPackThreads), kPackThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(
        src, mass, src_idx, quad, src_cell,
        reinterpret_cast<real4*>(base + L.pm),
        reinterpret_cast<int*>(base + L.idx),
        quad != nullptr ? reinterpret_cast<real*>(base + L.quad) : nullptr,
        cell_dims != 0 ? reinterpret_cast<int*>(base + L.cell) : nullptr, S,
        L.Sp, cell_dims);
    return static_cast<int>(cudaGetLastError());
}

// Launches the main kernel and the span reduction on `stream` over the
// plan (ids, cnt, work, n_work from rakau_shared_fused_plan) and the row
// packed into ws by rakau_shared_fused_pack with the same sizes and
// options, and returns cudaGetLastError() of the launches (0 = accepted).
// Work item: span z of tile c, the list entries [z * span, min((z + 1) *
// span, cnt[c])), and a group of targets, in the order of the work list.
// mode: 0 both, 1 acc only (pot written as 0), 2 pot only (acc written as
// 0). quad: nonzero for the quadrupole forms. comp: nonzero for the
// compensated (TwoSum) sums. sep > 0 with tgt_cell [C, T, 3] of cell_dims
// (2 or 3) dimensions (coordinates below 2^cell_coord_bits(cell_dims), sep
// at most that) selects the cell forms. sms: the card's multiprocessors.
// acc [C, T, 3] and pot [C, T] are the sums times G. scal [2] on the card
// holds eps^2 and G, read by the kernels (so a CUDA graph takes new values
// as inputs). Every real pointer is of the library's scalar type.
extern "C" int rakau_shared_fused(const real* tgt, const int64_t* tgt_idx,
                                  const int32_t* tgt_cell,
                                  const int32_t* ids, const int32_t* cnt,
                                  const int32_t* work, const int32_t* n_work,
                                  void* ws, real* acc, real* pot, int C,
                                  int T, int S, int span, int mode, int comp,
                                  int quad, int sep, int cell_dims, int sms,
                                  const real* scal, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (S < 0 || span < 1 || ws == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0
        || bad_cells(sep, cell_dims) || (sep > 0 && tgt_cell == nullptr)
        || scal == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(C, T, S, span, quad != 0, sep > 0, comp != 0);
    const Args a{tgt, tgt_idx, tgt_cell, ids, cnt, work, n_work,
                 static_cast<unsigned char*>(ws), acc, pot, C, T, S, span,
                 sep, sms, quad != 0, scal};
    return static_cast<int>(by_form<Launch>(
        mode, comp != 0, quad != 0, sep, cell_dims, cudaErrorInvalidValue,
        a, L, static_cast<cudaStream_t>(stream)));
}

// CUDA blocks a launch of these sizes and options runs (its persistent
// grid), or -1 for a bad mode or cell option.
extern "C" int rakau_shared_fused_grid(int C, int T, int S, int span,
                                       int mode, int comp, int quad, int sep,
                                       int cell_dims, int sms)
{
    if (C <= 0 || T <= 0 || S < 0 || span < 1 || bad_cells(sep, cell_dims))
        return -1;
    const Layout L = layout(C, T, S, span, quad != 0, sep > 0, comp != 0);
    return by_form<Grid>(mode, comp != 0, quad != 0, sep, cell_dims, -1, C,
                         T, L, sms);
}

// CUDA blocks of a form that fit on one SM at once.
extern "C" int rakau_shared_fused_blocks_per_sm(int mode, int comp, int quad,
                                                int sep, int cell_dims)
{
    if (bad_cells(sep, cell_dims)) return -1;
    return by_form<Occupancy>(mode, comp != 0, quad != 0, sep, cell_dims, -1);
}

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
