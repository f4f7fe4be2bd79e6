// Block-plan form of the shared-candidate pairwise kernel (K5) for NVIDIA
// Hopper: monopole, fp32 sums, both outputs, no cell test.
//
// Replaces the TPU kernel rakau_tpu/kernels/pallas.py:_shared_kernel. All C
// tiles of a chunk share one source row of S entries; a per-tile mask
// [C, S] weights which sources act on which tile. The reference's plan
// unit is the whole block of 1024 sources: grid step (c, j) is skipped
// only when tile c's mask is empty over block j (blk_active,
// pallas.py:353-354), and every entry of an active block is weighted by
// its mask (pallas.py:327). For tile c, target i and source j:
//
//     d = s_j - t_i, r2 = |d|^2 + eps^2
//     inv_r = 0 if idx_j == idx_i or r2 <= 0, else rsqrt(r2)
//     w = (m_j * mask[c, j]) * inv_r
//     pot_i -= w, acc_i += w * inv_r^2 * d          (times G at the end)
//
// K5 keeps that plan: the coarse skip of whole 1024-blocks, where K1 and K6
// (shared_fused.cu, shared_mma.cu) compact each tile's mask at granules of
// 128 (the reference's `subblock`). Everything around the plan is K1's
// engine, so that K5 against K1a on the same rows measures what the coarse
// skip costs.
//
// What bounds it on this card: arithmetic (~20 fp32 operations and one
// MUFU rsqrt a pair against 20 bytes a source that every target of the
// work item reuses from shared memory), and keeping the SMs busy with
// each tile's active blocks, which cluster along the row.
//
// Design, six kernels a launch, none waiting on the host:
//  1-3. The plan (shared_plan.cuh, K1's kernels at this library's granule
//     RAKAU_GRANULE = 1024 = kernels/shared.py:BLOCK): the mask into bits
//     and one flag a (tile, 1024-block), each tile's active blocks
//     compacted in row order, the spans of `span` list entries
//     (kernels/shared.py:BLOCKS_SPAN); the row packed once as (x, y, z, m)
//     and int32 indices, padded to whole blocks (far, massless, index -1).
//     kernels/shared.py:fused_plan(mask, BLOCKS_SPAN, BLOCK) is the same
//     plan in PyTorch.
//  4. shared_blocks_kernel: a persistent grid of at most as many CUDA
//     blocks as fit on the card walks the work items (span, group of
//     kTargets targets) in a fixed order. Each active block streams
//     through a ring of kStages buffers in steps of kStep sources by
//     16-byte cp.async copies, the next step in flight while the current
//     one is summed; the thread that copied a source multiplies its mass
//     by the tile's mask bit before the step's one barrier. Each thread
//     holds kTpt targets; a block's partial sums stay in registers over
//     its steps and enter the span's sums at the block's end. A span writes
//     its partial per target into a scratch [C, zmax, T].
//  5. shared_blocks_reduce adds each target's spans in span order and
//     applies G. No float atomics: two launches on the same inputs give
//     the same bits. A tile with no active block gets exact zeros; a count
//     past the plan's bound (a corrupt plan) gives NaN.
//
// rsqrt runs on the MUFU alone (rsqrt_normal, as shared_mma.cu): the same
// bits as rsqrtf for every normal input. Padding at 1e30 overflows r2 to
// inf and rsqrt gives 0, never NaN. Built without --use_fast_math.
// RAKAU_STEP (sources a staging step), RAKAU_TPT (targets a thread),
// RAKAU_THREADS (threads a CUDA block) and RAKAU_UNROLL set the launch
// shape at build time, for ab_kernels.py's sweeps; the defaults were
// chosen there on the card (PERF.md, K5).

#ifndef RAKAU_GRANULE
#define RAKAU_GRANULE 1024
#endif
#ifndef RAKAU_STEP
#define RAKAU_STEP 512
#endif
#ifndef RAKAU_TPT
#define RAKAU_TPT 1
#endif
#ifndef RAKAU_UNROLL
#define RAKAU_UNROLL 16
#endif
#ifndef RAKAU_THREADS
#define RAKAU_THREADS 128
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#include "shared_plan.cuh"

namespace {

static_assert(sizeof(real) == 4, "K5 is float32 only");
constexpr int kThreads = RAKAU_THREADS;  // threads of a work item's block
constexpr int kTpt = RAKAU_TPT;          // targets a thread
constexpr int kTargets = kThreads * kTpt;    // targets a work item
constexpr int kStep = RAKAU_STEP;        // sources a staging step
constexpr int kSteps = kGranule / kStep; // steps a block
constexpr int kOwn = kStep / kThreads;   // sources a thread copies a step
constexpr int kUnroll = RAKAU_UNROLL;    // unrolling of the source loop
constexpr int kStages = 3;               // ring of staged steps
constexpr size_t kStaticSmem = 48 * 1024;
static_assert(kGranule % kStep == 0, "a block is whole steps");
static_assert(kStep % kThreads == 0, "each thread copies whole sources");
static_assert(kTpt >= 1, "a thread holds at least one target");
static_assert(kThreads % 32 == 0, "whole warps");

// One staged step: (x, y, z, m * mask bit) and the int32 index of kStep
// sources.
struct alignas(16) Stage {
    float4 pm[kStep];
    int idx[kStep];
};

// A block's shared memory: the ring of staged steps, and each thread's
// span sums of its targets (acc x, y, z, pot), one column a thread: they
// change once a block, so they wait there and not in the registers that
// the source loop needs.
struct Ring {
    Stage st[kStages];
    float sum[4 * kTpt][kThreads];
};
static_assert(sizeof(Ring) <= 227 * 1024,
              "the ring must fit in a block's shared memory");

// Dynamic shared memory a launch asks for: 0 where the ring is static.
constexpr size_t kDynamicSmem = sizeof(Ring) <= kStaticSmem ? 0
                                                            : sizeof(Ring);

template <size_t DYNAMIC>
__device__ __forceinline__ Ring& ring_smem()
{
    if constexpr (DYNAMIC == 0) {
        __shared__ Ring r;
        return r;
    } else {
        extern __shared__ __align__(16) unsigned char smem[];
        return *reinterpret_cast<Ring*>(smem);
    }
}

// rsqrt(x) on the MUFU unit alone (shared_mma.cu:rsqrt_normal): x raised to
// the smallest normal number first, so every x >= 2^-126 gets rsqrtf's
// bits, a smaller one a finite 2^63, and inf gives 0.
__device__ __forceinline__ float rsqrt_normal(float x)
{
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaxf(x, 0x1p-126f)));
    return y;
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

// The packed row and the mask bits in the workspace.
struct Row {
    const float4* pm;         // [Sp] x, y, z, m
    const int* idx;           // [Sp]
    const unsigned* bits;     // [C, Sp / 32] mask bits
};

// Issue the copies of the kStep sources at `off` into stage st: source j
// (its 16-byte entry) by thread j % kThreads, its index in 16-byte chunks
// of four. `word` gets the tile's mask words of this thread's sources
// off + threadIdx.x + k kThreads (my_bits: the tile's words, shifted by
// this thread's warp).
__device__ __forceinline__ void issue(Stage& st, const Row& row, int off,
                                      const unsigned* my_bits,
                                      unsigned (&word)[kOwn])
{
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
        const int j = threadIdx.x + k * kThreads;
        cp_async16(st.pm + j, row.pm + off + j);
        word[k] = __ldg(my_bits + (off + k * kThreads) / 32);
    }
    for (int q = threadIdx.x; q < kStep / 4; q += kThreads)
        cp_async16(st.idx + 4 * q, row.idx + off + 4 * q);
}

__global__ void __launch_bounds__(kThreads)
shared_blocks_kernel(Row row,
                     const float* __restrict__ tgt,         // [C, T, 3]
                     const int64_t* __restrict__ tgt_idx,   // [C, T]
                     const int32_t* __restrict__ ids,       // [C, NG]
                     const int32_t* __restrict__ cnt,       // [C]
                     const int32_t* __restrict__ work,      // [C * zmax]
                     const int32_t* __restrict__ n_work,    // [1]
                     float4* __restrict__ sums,             // [C, zmax, T]
                     int T, int NG, int words, int zmax, int span,
                     const float* __restrict__ scal)        // [eps^2, G]
{
    const float eps2 = scal[0];
    Ring& ring = ring_smem<kDynamicSmem>();
    const int groups = (T + kTargets - 1) / kTargets;
    const int items = n_work[0] * groups;
    const unsigned lane_bit = 1u << (threadIdx.x & 31);
    unsigned n = 0;   // steps this block has staged and summed

    for (int u = blockIdx.x; u < items; u += gridDim.x) {
        const int pr = u / groups;
        const int g = u - pr * groups;
        const int entry = work[pr];
        const int c = entry / zmax;
        const int z = entry - c * zmax;
        const int k0 = z * span;
        const int nsteps = (min(k0 + span, cnt[c]) - k0) * kSteps;
        const int32_t* my_ids = ids + static_cast<size_t>(c) * NG + k0;
        const unsigned* my_bits = row.bits + static_cast<size_t>(c) * words
            + (threadIdx.x >> 5);

        float tx[kTpt], ty[kTpt], tz[kTpt];
        int ti[kTpt];
#pragma unroll
        for (int i = 0; i < kTpt; ++i) {
            const int t = g * kTargets + i * kThreads + threadIdx.x;
            const size_t tc = static_cast<size_t>(c) * T + t;
            tx[i] = ty[i] = tz[i] = 0.f;
            ti[i] = -2;   // matches no source index (nodes carry -1)
            if (t < T) {
                tx[i] = tgt[3 * tc];
                ty[i] = tgt[3 * tc + 1];
                tz[i] = tgt[3 * tc + 2];
                ti[i] = static_cast<int>(tgt_idx[tc]);
            }
        }
        // target i's span sums at rows 4 i .. 4 i + 3 of span_sum
        float* span_sum = &ring.sum[0][threadIdx.x];
#pragma unroll
        for (int q = 0; q < 4 * kTpt; ++q) span_sum[q * kThreads] = 0.f;

        // prologue: the first step in flight, the next block's id read
        unsigned word[kOwn];
        issue(ring.st[n % kStages], row, my_ids[0] * kGranule, my_bits,
              word);
        cp_async_commit();
        int id_next = nsteps > kSteps ? my_ids[1] : 0;
        int id_issue = my_ids[0];   // the block of the last issued step

        float bx[kTpt], by[kTpt], bz[kTpt], bp[kTpt];   // the block's sums
#pragma unroll
        for (int i = 0; i < kTpt; ++i) bx[i] = by[i] = bz[i] = bp[i] = 0.f;
        for (int q = 0; q < nsteps; ++q, ++n) {
            Stage& cur = ring.st[n % kStages];
            unsigned word_next[kOwn] = {};
            if (q + 1 < nsteps) {
                // the buffer written here was summed two steps ago, and
                // the barrier of the last step is behind every thread
                const int sub = (q + 1) % kSteps;
                if (sub == 0) {
                    const int kb = (q + 1) / kSteps;
                    id_issue = id_next;
                    id_next = (kb + 1) * kSteps < nsteps ? my_ids[kb + 1]
                                                         : 0;
                }
                issue(ring.st[(n + 1) % kStages], row,
                      id_issue * kGranule + sub * kStep, my_bits,
                      word_next);
            }
            cp_async_commit();          // an empty group past the last
            cp_async_wait<1>();         // this thread's copies of `cur`
#pragma unroll
            for (int k = 0; k < kOwn; ++k) {   // m times the mask bit
                float& m = cur.pm[threadIdx.x + k * kThreads].w;
                m = m * ((word[k] & lane_bit) ? 1.f : 0.f);
                word[k] = word_next[k];
            }
            __syncthreads();            // every thread's copies of `cur`

#pragma unroll (kUnroll)
            for (int j = 0; j < kStep; ++j) {
                const float4 sv = cur.pm[j];
                const int sid = cur.idx[j];
#pragma unroll
                for (int i = 0; i < kTpt; ++i) {
                    const float dx = sv.x - tx[i];
                    const float dy = sv.y - ty[i];
                    const float dz = sv.z - tz[i];
                    const float r2 = dx * dx + dy * dy + dz * dz + eps2;
                    float inv_r = rsqrt_normal(r2);
                    if (sid == ti[i] || r2 <= 0.f) inv_r = 0.f;
                    const float w = sv.w * inv_r;
                    const float gf = w * (inv_r * inv_r);
                    bx[i] += gf * dx;
                    by[i] += gf * dy;
                    bz[i] += gf * dz;
                    bp[i] -= w;
                }
            }
            if ((q + 1) % kSteps == 0) {    // the block's end
#pragma unroll
                for (int i = 0; i < kTpt; ++i) {
                    span_sum[(4 * i) * kThreads] += bx[i];
                    span_sum[(4 * i + 1) * kThreads] += by[i];
                    span_sum[(4 * i + 2) * kThreads] += bz[i];
                    span_sum[(4 * i + 3) * kThreads] += bp[i];
                    bx[i] = by[i] = bz[i] = bp[i] = 0.f;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kTpt; ++i) {
            const int t = g * kTargets + i * kThreads + threadIdx.x;
            if (t < T) {
                const float* v = span_sum + 4 * i * kThreads;
                sums[(static_cast<size_t>(c) * zmax + z) * T + t]
                    = make_float4(v[0], v[kThreads], v[2 * kThreads],
                                  v[3 * kThreads]);
            }
        }
    }
    cp_async_wait<0>();
}

// acc, pot of target (c, t): its tile's spans added in span order, times
// G = scal[1]. A tile without spans gets zeros; a count whose spans exceed the
// plan's bound zmax (a fault of the plan) gets NaN.
__global__ void __launch_bounds__(kPackThreads)
shared_blocks_reduce(const float4* __restrict__ sums,   // [C, zmax, T]
                     const int32_t* __restrict__ cnt,   // [C]
                     float* __restrict__ acc,           // [C, T, 3]
                     float* __restrict__ pot,           // [C, T]
                     int C, int T, int zmax, int span,
                     const float* __restrict__ scal)    // [eps^2, G]
{
    const float G = scal[1];
    const long long i = static_cast<long long>(blockIdx.x) * kPackThreads
        + threadIdx.x;
    if (i >= static_cast<long long>(C) * T) return;
    const int c = static_cast<int>(i / T);
    const int t = static_cast<int>(i - static_cast<long long>(c) * T);
    const int nz = (cnt[c] + span - 1) / span;
    if (nz > zmax || nz < 0) {
        const float nan = __int_as_float(0x7fc00000);
        acc[3 * i] = acc[3 * i + 1] = acc[3 * i + 2] = pot[i] = nan;
        return;
    }
    const size_t base = static_cast<size_t>(c) * zmax * T + t;
    float sx = 0.f, sy = 0.f, sz = 0.f, sp = 0.f;
    for (int z = 0; z < nz; ++z) {
        const float4 v = sums[base + static_cast<size_t>(z) * T];
        sx += v.x;
        sy += v.y;
        sz += v.z;
        sp += v.w;
    }
    acc[3 * i] = G * sx;
    acc[3 * i + 1] = G * sy;
    acc[3 * i + 2] = G * sz;
    pot[i] = G * sp;
}

// Byte offsets of the workspace's parts, 256-aligned: the mask bits and
// the block flags (all the plan needs), the packed row, the spans'
// scratch.
struct Layout {
    int NG, Sp, words, zmax;
    size_t bits, flags, pm, idx, sums, total;
};

Layout layout(int C, int T, int S, int span)
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
    L.pm = take(Sp * sizeof(float4));
    L.idx = take(Sp * sizeof(int));
    L.sums = take(static_cast<size_t>(C) * L.zmax * T * sizeof(float4));
    L.total = off;
    return L;
}

// CUDA blocks of the main kernel that fit on an SM at once (at least 1);
// sets its dynamic shared memory limit first where it needs one, once on
// each device (per_device.cuh).
int blocks_per_sm()
{
    static int cache[kMaxDevices] = {};
    int& occ = device_slot(cache);
    if (occ == 0) {
        if (kDynamicSmem > 0)
            cudaFuncSetAttribute(shared_blocks_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kDynamicSmem));
        int got = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &got, shared_blocks_kernel, kThreads, kDynamicSmem)
            != cudaSuccess)
            got = 1;
        occ = got > 0 ? got : 1;
    }
    return occ;
}

// The persistent grid: at most one CUDA block a work item that could
// exist (C * zmax spans x target groups), at most what fits on the card.
int grid_blocks(int C, int T, const Layout& L, int sms)
{
    const long long items = static_cast<long long>(C) * L.zmax
        * ((T + kTargets - 1) / kTargets);
    const long long fit = static_cast<long long>(blocks_per_sm())
        * (sms > 0 ? sms : 1);
    const long long g = items < fit ? items : fit;
    return static_cast<int>(g > 0 ? g : 1);
}

bool bad_args(int S, int span, const void* ws)
{
    return S < 0 || span < 1 || ws == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0;
}

}  // namespace

// Sources a block of the plan (kernels/shared.py:BLOCK, checked at load).
extern "C" int rakau_shared_blocks_block() { return kGranule; }

// Sources a staging step, targets a thread and threads a CUDA block.
extern "C" int rakau_shared_blocks_step() { return kStep; }
extern "C" int rakau_shared_blocks_targets_per_thread() { return kTpt; }
extern "C" int rakau_shared_blocks_threads() { return kThreads; }

// Bytes of the workspace a launch of these sizes needs (the plan's mask
// bits and block flags, the packed row and the spans' scratch), or 0 for
// bad sizes. The plan alone needs the first part, which depends on C and
// S only.
extern "C" size_t rakau_shared_blocks_workspace(int C, int T, int S,
                                                int span)
{
    if (C <= 0 || T <= 0 || S < 0 || span < 1) return 0;
    return layout(C, T, S, span).total;
}

// K5's plan on `stream`: mask [C, S] (bytes, nonzero = on) into bits and
// block flags in the workspace ws (256-byte aligned), every tile's active
// blocks into ids [C, NG] (row order, padded with NG) and their count into
// cnt [C], NG = ceil(S / 1024), at least 1, and the spans of `span`
// entries into work [C * zmax] (tile * zmax + span index, tile after tile,
// padded with C * zmax; zmax = ceil(NG / span)) and their number into
// n_work [1]: kernels/shared.py:fused_plan(mask, span, BLOCK) on the
// card. Returns cudaGetLastError() of the launches (0 = accepted).
extern "C" int rakau_shared_blocks_plan(const uint8_t* mask, void* ws,
                                        int32_t* ids, int32_t* cnt,
                                        int32_t* work, int32_t* n_work,
                                        int C, int S, int span, void* stream)
{
    if (C <= 0) return 0;
    if (bad_args(S, span, ws)) return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(C, 1, S, span);
    unsigned char* base = static_cast<unsigned char*>(ws);
    return static_cast<int>(launch_plan(
        mask, reinterpret_cast<unsigned*>(base + L.bits),
        reinterpret_cast<uint8_t*>(base + L.flags), ids, cnt, work, n_work,
        C, S, L.NG, L.zmax, span, static_cast<cudaStream_t>(stream)));
}

// Packs the row into the workspace ws (256-byte aligned, at least
// rakau_shared_blocks_workspace(C, T, S, span) bytes) on `stream` by K1's
// packing kernel: src [S, 3], mass [S], src_idx [S]. Returns
// cudaGetLastError() of the launch (0 = accepted).
extern "C" int rakau_shared_blocks_pack(const float* src, const float* mass,
                                        const int64_t* src_idx, void* ws,
                                        int C, int T, int S, int span,
                                        void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (bad_args(S, span, ws)) return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(C, T, S, span);
    unsigned char* base = static_cast<unsigned char*>(ws);
    shared_fused_pack_kernel<<<static_cast<unsigned>(
        (L.Sp + kPackThreads - 1) / kPackThreads), kPackThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(
        src, mass, src_idx, nullptr, nullptr,
        reinterpret_cast<float4*>(base + L.pm),
        reinterpret_cast<int*>(base + L.idx), nullptr, nullptr, S, L.Sp, 0);
    return static_cast<int>(cudaGetLastError());
}

// Launches the main kernel and the span reduction on `stream` over the
// plan (ids, cnt, work, n_work from rakau_shared_blocks_plan) and the row
// packed into ws by rakau_shared_blocks_pack with the same sizes, and
// returns cudaGetLastError() of the launches (0 = accepted). Work item:
// span z of tile c, the list entries [z * span, min((z + 1) * span,
// cnt[c])), and a group of targets, in the order of the work list. sms:
// the card's multiprocessors. acc [C, T, 3] and pot [C, T] are the sums
// times G. scal [2] on the card holds eps^2 and G, read by the kernels.
extern "C" int rakau_shared_blocks(const float* tgt, const int64_t* tgt_idx,
                                   const int32_t* ids, const int32_t* cnt,
                                   const int32_t* work,
                                   const int32_t* n_work, void* ws,
                                   float* acc, float* pot, int C, int T,
                                   int S, int span, int sms,
                                   const float* scal, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (bad_args(S, span, ws) || scal == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(C, T, S, span);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    unsigned char* base = static_cast<unsigned char*>(ws);
    const Row row{reinterpret_cast<const float4*>(base + L.pm),
                  reinterpret_cast<const int*>(base + L.idx),
                  reinterpret_cast<const unsigned*>(base + L.bits)};
    float4* sums = reinterpret_cast<float4*>(base + L.sums);
    shared_blocks_kernel<<<grid_blocks(C, T, L, sms), kThreads, kDynamicSmem,
                           st>>>(row, tgt, tgt_idx, ids, cnt, work, n_work,
                                 sums, T, L.NG, L.words, L.zmax, span, scal);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long CT = static_cast<long long>(C) * T;
    shared_blocks_reduce<<<static_cast<unsigned>(
        (CT + kPackThreads - 1) / kPackThreads), kPackThreads, 0, st>>>(
        sums, cnt, acc, pot, C, T, L.zmax, span, scal);
    return static_cast<int>(cudaGetLastError());
}

// CUDA blocks a launch of these sizes runs (its persistent grid), or -1
// for bad sizes.
extern "C" int rakau_shared_blocks_grid(int C, int T, int S, int span,
                                        int sms)
{
    if (C <= 0 || T <= 0 || S < 0 || span < 1) return -1;
    return grid_blocks(C, T, layout(C, T, S, span), sms);
}

// CUDA blocks of the main kernel that fit on one SM at once.
extern "C" int rakau_shared_blocks_blocks_per_sm() { return blocks_per_sm(); }

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
