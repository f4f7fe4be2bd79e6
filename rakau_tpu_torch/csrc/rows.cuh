// Device code shared by the kernels whose tiles own private, contiguous
// source rows: K2 (csrc/pool.cu, the gwalk pool), K3 and K4 (csrc/tiles.cu,
// the lists path's rows: both in one launch, or one row a launch). Each
// tile's rows are cut into granules of kGranule packed entries; the work
// is cut into spans of consecutive granules of one tile; a persistent grid
// walks (span, group of targets) items; a second kernel adds each target's
// spans in span order.
//
// What this header holds:
//  * the scalar type (RAKAU_REAL, float unless the library is built with
//    -DRAKAU_REAL=double) and the launch shape: kThreads threads a CUDA
//    block, kTpt targets a thread (RAKAU_TPT, 2 in the float build, so
//    that every staged entry read from shared memory serves two pairs; 1
//    in the float64 build, whose registers are twice as wide), the
//    granule, the ring of kStages staged granules;
//  * cp.async copies of the rows' planes as they are into the ring (one
//    barrier a granule, the next granule in flight while the current one
//    is summed);
//  * the pair loop over one staged granule (monopole, and the quadrupole
//    correction from raw second moments);
//  * rows_work_kernel: the work list from each tile's granule count, by
//    one CUDA block, with no host sync;
//  * walk_items: the persistent main loop over the work list, which each
//    library's kernel calls with its own source of granules;
//  * rows_reduce_kernel: each target's span sums added in span order
//    (TwoSum at this level too in the compensated forms), times G. No
//    float atomics: two launches on the same inputs give the same bits.
//
// A granule is up to kGranule consecutive rows of the sources' planes:
// positions [n, 3], masses [n], int64 indices [n] (none where no
// self-exclusion applies) and, for the quadrupole, 6 second moments xx xy
// xz yy yz zz a row. A stage's entries past n are far (1e30), massless,
// with zero moments: they add exact zeros. For target i (position t,
// index ti) and entry j (its index compared as int32):
//
//     d = s_j - t, r2 = |d|^2 + eps^2
//     inv_r = 0 if idx_j == ti or r2 <= 0, else rsqrt(r2)
//     w = m_j * inv_r
//     pot_i -= w, acc_i += w * inv_r^2 * d          (G applied at the end)
//
// and with the second moments Q_j (Qd = Q_j d, dQd = d.Qd, tr = tr Q_j):
//
//     pot_i -= 1.5 dQd inv_r^5 - 0.5 tr inv_r^3
//     acc_i += -3 Qd inv_r^5 + (7.5 dQd inv_r^7 - 1.5 tr inv_r^5) d
//
// the signs of rakau_tpu/kernels/pallas.py:1041-1090. The dead gate zeroes
// inv_r before any power of it is formed, so an entry exactly on a target
// at eps = 0 adds 0, not 0 * inf = NaN; padding at 1e30 overflows r2 to
// inf in float and rsqrt gives 0. The moments multiply into d before d
// again, so no 1e30 * 1e30 = inf meets a zero. Built without fast math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "per_device.cuh"

#ifdef RAKAU_REAL
// The float64 build: at least four resident blocks a SM (at most 128
// registers a thread), as K1's float64 build, against spills.
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
#define RAKAU_ROWS_BOUNDS __launch_bounds__(kThreads, RAKAU_MIN_BLOCKS)
#else
#define RAKAU_ROWS_BOUNDS __launch_bounds__(kThreads)
#endif
#ifndef RAKAU_TPT
#define RAKAU_TPT 2
#endif
#ifndef RAKAU_UNROLL
#define RAKAU_UNROLL 8
#endif

namespace {

using real = RAKAU_REAL;
struct alignas(32) double4a { double x, y, z, w; };
using real4 = std::conditional_t<sizeof(real) == 4, float4, double4a>;
// rsqrtf, not K6's MUFU-only form (shared_mma.cu:rsqrt_normal): measured
// on the card with both, the same bits, K2 6.5 % faster but K3 6.6 %
// slower on the MUFU alone (PERF.md, K2 and K3).
__device__ __forceinline__ float rsqrt_r(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_r(double x) { return rsqrt(x); }

constexpr int kThreads = 128;            // threads of a work item's block
constexpr int kTpt = sizeof(real) == 8 ? 1 : RAKAU_TPT;
constexpr int kTargets = kThreads * kTpt;    // targets a work item
constexpr int kUnroll = RAKAU_UNROLL;    // unrolling of the entry loop
// Entries a granule: the unit of a tile's rows and of one staging step.
// Must equal kernels/rows.py:GRANULE (checked when a library loads).
constexpr int kGranule = 128;
constexpr int kStages = 3;               // ring of staged granules
constexpr int kQuad = 6;
constexpr int kPackThreads = 256;        // the packing and reduction kernels
constexpr int kWorkThreads = 1024;       // the one CUDA block of the work list
constexpr int kNoIdx = INT32_MIN;        // staged index of an entry without
                                         // self-exclusion
static_assert(kTpt >= 1, "a thread holds at least one target");
enum Mode { kBoth = 0, kAcc = 1, kPot = 2 };

// One staged granule: kGranule rows of the source planes as they are,
// (x, y, z) and m in two arrays, the int64 index (kNoIdx where no
// self-exclusion applies), in QUAD the 6 second moments of each row. The
// pair loop reads a stage through entry(j), id(j) and moments(j).
template <bool QUAD>
struct alignas(32) Stage {
    real pos[3 * kGranule];
    alignas(16) real mass[kGranule];
    alignas(16) int64_t idx[kGranule];
    alignas(16) real q[QUAD ? kGranule * kQuad : 4];
    __device__ __forceinline__ real4 entry(int j) const
    {
        return real4{pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], mass[j]};
    }
    __device__ __forceinline__ int id(int j) const
    {
        return static_cast<int>(idx[j]);
    }
    __device__ __forceinline__ const real* moments(int j) const
    {
        return q + kQuad * j;
    }
};

// A block's shared memory: the ring of stages, and each thread's span
// sums (and TwoSum errors) of its targets, one column a thread: they
// change once a granule, so they wait there and not in the registers that
// the entry loop needs.
template <bool QUAD>
struct Ring {
    Stage<QUAD> st[kStages];
    real sum[8 * kTpt][kThreads];
};
static_assert(sizeof(Ring<true>) <= 48 * 1024,
              "the ring must fit in static shared memory");

template <bool QUAD>
__device__ __forceinline__ Ring<QUAD>& ring_smem()
{
    __shared__ Ring<QUAD> r;
    return r;
}

__device__ __forceinline__ real quiet_nan()
{
    if constexpr (sizeof(real) == 8)
        return __longlong_as_double(0x7ff8000000000000LL);
    else
        return __int_as_float(0x7fc00000);
}

// Knuth TwoSum: s + e == a + b exactly; a becomes s, e is added to err.
__device__ __forceinline__ void two_sum_into(real& a, real b, real& err)
{
    const real s = a + b;
    const real bb = s - a;
    err += (a - (s - bb)) + (b - bb);
    a = s;
}

// ---- asynchronous copies global -> shared (sm_80 and later) ----
// One element of 4 or 8 bytes: the planes' rows start anywhere, so their
// granules need no alignment beyond the element's.
template <class E>
__device__ __forceinline__ void cp_async(E* dst, const E* src)
{
    static_assert(sizeof(E) == 4 || sizeof(E) == 8, "4- or 8-byte elements");
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(src), "n"(sizeof(E)) : "memory");
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

// The block copies n elements from src to dst; element q goes to thread
// q % kThreads.
template <class E>
__device__ __forceinline__ void copy_async(E* dst, const E* src, int n)
{
    for (int q = threadIdx.x; q < n; q += kThreads) cp_async(dst + q, src + q);
}

// A granule's rows in device memory: n <= kGranule consecutive rows of the
// planes.
struct Granule {
    const real* pos;          // [n, 3]
    const real* mass;         // [n]
    const int64_t* idx;       // [n], or null: no self-exclusion
    const real* quad;         // [n, 6] second moments, or null
    int n;
};

// Issue the copies of granule g into stage st, and fill what it does not
// copy with entries that add exact zeros: rows n .. kGranule - 1 far and
// massless (their moments zero where g has moments), and kNoIdx as every
// index where g has none. The plain stores land in a stage that no thread
// reads until the barrier of its granule.
template <bool QUAD>
__device__ __forceinline__ void issue(Stage<QUAD>& st, const Granule& g)
{
    copy_async(st.pos, g.pos, 3 * g.n);
    copy_async(st.mass, g.mass, g.n);
    if (g.idx != nullptr) copy_async(st.idx, g.idx, g.n);
    if constexpr (QUAD) {
        if (g.quad != nullptr) copy_async(st.q, g.quad, kQuad * g.n);
    }
    for (int j = threadIdx.x; j < kGranule; j += kThreads) {
        if (g.idx == nullptr) st.idx[j] = kNoIdx;
        if (j < g.n) continue;
        st.pos[3 * j] = st.pos[3 * j + 1] = st.pos[3 * j + 2] = real(1e30f);
        st.mass[j] = 0;
        st.idx[j] = kNoIdx;
        if constexpr (QUAD) {
            if (g.quad != nullptr)
                for (int k = 0; k < kQuad; ++k) st.q[kQuad * j + k] = 0;
        }
    }
}

// The targets of a thread, in registers.
struct Targets {
    real x[kTpt], y[kTpt], z[kTpt];
    int idx[kTpt];
};

// Adds a staged granule to each target's granule partials (bx, by, bz,
// bp), with the quadrupole correction where QUAD.
template <int MODE, bool QUAD, class St>
__device__ __forceinline__ void sum_granule(const St& st, const Targets& t,
                                            real eps2, real* bx, real* by,
                                            real* bz, real* bp)
{
#pragma unroll (kUnroll)
    for (int j = 0; j < kGranule; ++j) {
        const real4 sv = st.entry(j);
        const int sid = st.id(j);
        real qxx = 0, qxy = 0, qxz = 0, qyy = 0, qyz = 0, qzz = 0;
        if constexpr (QUAD) {
            const real* qj = st.moments(j);
            qxx = qj[0]; qxy = qj[1]; qxz = qj[2];
            qyy = qj[3]; qyz = qj[4]; qzz = qj[5];
        }
#pragma unroll
        for (int i = 0; i < kTpt; ++i) {
            const real dx = sv.x - t.x[i];
            const real dy = sv.y - t.y[i];
            const real dz = sv.z - t.z[i];
            const real r2 = dx * dx + dy * dy + dz * dz + eps2;
            real inv_r = rsqrt_r(r2);
            if (sid == t.idx[i] || r2 <= real(0)) inv_r = 0;
            const real w = sv.w * inv_r;
            const real inv2 = inv_r * inv_r;
            real gf = w * inv2;            // the factor of d in acc
            real qx = 0, qy = 0, qz = 0;
            if constexpr (QUAD) {
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
                    bp[i] -= real(1.5) * dqd * inv5 - real(0.5) * tr * inv3;
            }
            if (MODE != kPot) {
                bx[i] += gf * dx + qx;
                by[i] += gf * dy + qy;
                bz[i] += gf * dz + qz;
            }
            if (MODE != kAcc) bp[i] -= w;
        }
    }
}

// The work list, by one CUDA block, a thread a tile (each writes its own
// tile's spans). count(g) is tile g's granules (-1: a tile whose rows are
// out of range). Spans z < ceil(count(g) / span) of tile g get the ids
// first[g] + z, tile after tile: work[first[g] + z] = g,
// first[G] = the spans in all; work is padded with G up to cap, and
// n_work[0] is first[G], or -1 if a tile was out of range or the spans
// exceed cap (the reduction then writes NaN: a visible fault, not a
// silent one).
template <class Count>
__global__ void __launch_bounds__(kWorkThreads)
rows_work_kernel(Count count, int G, int span, int cap,
                 int32_t* __restrict__ first,       // [G + 1]
                 int32_t* __restrict__ work,        // [cap]
                 int32_t* __restrict__ n_work)      // [1]
{
    __shared__ int warp_sum[kWorkThreads / 32];
    __shared__ int bad;
    __shared__ int round_total;
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    if (threadIdx.x == 0) bad = 0;
    __syncthreads();
    int base = 0;   // spans of the tiles before this round's
    for (int c0 = 0; c0 < G; c0 += kWorkThreads) {
        const int c = c0 + threadIdx.x;
        int ns = 0;
        if (c < G) {
            const int k = count(c);
            if (k < 0) bad = 1;
            ns = k > 0 ? (k + span - 1) / span : 0;
        }
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
        const int at = before + incl - ns;    // tile c's first span
        if (c < G) {
            first[c] = at;
            for (int z = 0; z < min(ns, cap - at); ++z) work[at + z] = c;
        }
        if (threadIdx.x == kWorkThreads - 1) round_total = before + incl;
        __syncthreads();
        base = round_total;
        __syncthreads();    // warp_sum, round_total read before the next round
    }
    for (int k = max(base, 0) + threadIdx.x; k < cap; k += kWorkThreads)
        work[k] = G;
    if (threadIdx.x == 0) {
        first[G] = base;
        n_work[0] = (bad || base > cap) ? -1 : base;
    }
}

// The persistent main loop. Work item u = span s (u / groups) of tile
// work[s] and group of targets u % groups; a block takes items blockIdx.x,
// + gridDim.x, ... The source `src` gives a tile's descriptor
// (src.tile(g)), its granule count (.granules), and the rows of its k-th
// granule (src.granule(tile, k) -> Granule; with moments: the quadrupole
// terms). Span s writes its per-target partial (and in COMP its error
// terms) into sums[s * T + t] (errs).
template <int MODE, bool COMP, bool QUAD, class Src>
__device__ __forceinline__ void walk_items(
    const Src& src, const real* __restrict__ tgt,     // [G, T, 3]
    const int64_t* __restrict__ tgt_idx,              // [G, T]
    const int32_t* __restrict__ first, const int32_t* __restrict__ work,
    const int32_t* __restrict__ n_work, real4* __restrict__ sums,
    real4* __restrict__ errs, int T, int span, real eps2)
{
    using St = Stage<QUAD>;
    Ring<QUAD>& ring = ring_smem<QUAD>();
    const int groups = (T + kTargets - 1) / kTargets;
    const int nw = n_work[0];
    const int items = (nw > 0 ? nw : 0) * groups;
    unsigned n = 0;   // granules this block has staged and summed

    for (int u = blockIdx.x; u < items; u += gridDim.x) {
        const int s = u / groups;
        const int grp = u - s * groups;
        const int g = work[s];
        const int z = s - first[g];
        const auto tile = src.tile(g);
        const int k0 = z * span;
        const int k1 = min(k0 + span, tile.granules);

        Targets tg;
#pragma unroll
        for (int i = 0; i < kTpt; ++i) {
            const int t = grp * kTargets + i * kThreads + threadIdx.x;
            const size_t tc = static_cast<size_t>(g) * T + t;
            tg.x[i] = tg.y[i] = tg.z[i] = 0;
            tg.idx[i] = -2;   // matches no entry index (nodes carry -1)
            if (t < T) {
                tg.x[i] = tgt[3 * tc];
                tg.y[i] = tgt[3 * tc + 1];
                tg.z[i] = tgt[3 * tc + 2];
                tg.idx[i] = static_cast<int>(tgt_idx[tc]);
            }
        }
        // target i's span sums at rows 8 i .. 8 i + 3 of span_sum (acc x,
        // y, z, pot), their TwoSum errors at rows 8 i + 4 .. 8 i + 7 (COMP)
        real* span_sum = &ring.sum[0][threadIdx.x];
#pragma unroll
        for (int q = 0; q < 8 * kTpt; ++q) span_sum[q * kThreads] = 0;

        // prologue: the first granule in flight
        Granule gr = src.granule(tile, k0);
        issue<QUAD>(ring.st[n % kStages], gr);
        cp_async_commit();
        for (int k = k0; k < k1; ++k, ++n) {
            St& cur = ring.st[n % kStages];
            const bool quad = gr.quad != nullptr;
            if (k + 1 < k1) {
                // the buffer written here was summed two granules ago, and
                // the barrier of the last granule is behind every thread
                gr = src.granule(tile, k + 1);
                issue<QUAD>(ring.st[(n + 1) % kStages], gr);
            }
            cp_async_commit();          // an empty group past the last
            cp_async_wait<1>();         // this thread's copies of `cur`
            __syncthreads();            // every thread's copies of `cur`

            real bx[kTpt], by[kTpt], bz[kTpt], bp[kTpt];   // the granule's
#pragma unroll
            for (int i = 0; i < kTpt; ++i) bx[i] = by[i] = bz[i] = bp[i] = 0;
            if (QUAD && quad)
                sum_granule<MODE, QUAD>(cur, tg, eps2, bx, by, bz, bp);
            else
                sum_granule<MODE, false>(cur, tg, eps2, bx, by, bz, bp);
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
            const int t = grp * kTargets + i * kThreads + threadIdx.x;
            if (t < T) {
                const size_t at = static_cast<size_t>(s) * T + t;
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

// acc, pot of target (g, t): tile g's spans [first[g], first[g + 1]) added
// in span order (COMP: TwoSum of the sums, then the error terms; sum + err
// at the end), times Gc. A tile without spans gets zeros; with n_work[0]
// < 0 (a fault of the plan) every output is NaN.
template <bool COMP>
__global__ void __launch_bounds__(kPackThreads)
rows_reduce_kernel(const real4* __restrict__ sums,    // [spans, T]
                   const real4* __restrict__ errs,    // [spans, T]
                   const int32_t* __restrict__ first, // [G + 1]
                   const int32_t* __restrict__ n_work,
                   real* __restrict__ acc,            // [G, T, 3]
                   real* __restrict__ pot,            // [G, T]
                   int G, int T, real Gc)
{
    const long long i = static_cast<long long>(blockIdx.x) * kPackThreads
        + threadIdx.x;
    if (i >= static_cast<long long>(G) * T) return;
    if (n_work[0] < 0) {
        const real nan = quiet_nan();
        acc[3 * i] = acc[3 * i + 1] = acc[3 * i + 2] = pot[i] = nan;
        return;
    }
    const int g = static_cast<int>(i / T);
    const int t = static_cast<int>(i - static_cast<long long>(g) * T);
    real sx = 0, sy = 0, sz = 0, sp = 0;
    real ex = 0, ey = 0, ez = 0, ep = 0;
    for (int s = first[g]; s < first[g + 1]; ++s) {
        const size_t at = static_cast<size_t>(s) * T + t;
        const real4 v = sums[at];
        if (COMP) {
            const real4 e = errs[at];
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
    acc[3 * i] = Gc * (sx + ex);
    acc[3 * i + 1] = Gc * (sy + ey);
    acc[3 * i + 2] = Gc * (sz + ez);
    pot[i] = Gc * (sp + ep);
}

// Byte offset `at` rounded up to 256.
inline size_t align256(size_t at) { return (at + 255) / 256 * 256; }

// CUDA blocks of `kernel` (kThreads threads, static shared memory) that
// fit on an SM at once, at least 1; `cache` keeps it per device
// (per_device.cuh).
template <class K>
int fit_per_sm(K kernel, int* cache)
{
    int& occ = device_slot(cache);
    if (occ == 0) {
        int got = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &got, kernel, kThreads, 0) != cudaSuccess)
            got = 1;
        occ = got > 0 ? got : 1;
    }
    return occ;
}

// The persistent grid: at most one CUDA block an item that could exist
// (cap spans x target groups), at most what fits on the card.
inline int persistent_grid(int cap, int T, int per_sm, int sms)
{
    const long long items = static_cast<long long>(cap)
        * ((T + kTargets - 1) / kTargets);
    const long long fit = static_cast<long long>(per_sm) * (sms > 0 ? sms : 1);
    const long long g = items < fit ? items : fit;
    return static_cast<int>(g > 0 ? g : 1);
}

}  // namespace
