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
// What bounds them on this card: arithmetic. A pair costs ~20 operations
// and one rsqrt against 16 (32 in double) bytes of row, read from device
// memory by one tile only and reused from shared memory by every target of
// the tile.
//
// K3 design (csrc/rows.cuh): tile c's rows are cut into granules of 128
// entries: ceil(clip(m2p_cnt, 0, Sm) / 128) of the M2P row, then
// ceil(clip(p2p_cnt, 0, Sp) / 128) of the P2P row, counts read on the
// device (a count of 0 gives none; entries past a count inside a granule
// are the caller's padding and add zeros, as in the reference's block
// plan). Three kernels a launch, none waiting on the host:
//  1. rows_work_kernel, one CUDA block: the granules cut into spans of
//     `span`, the spans tile after tile (kernels/tiles.py:tiles_plan is the
//     same plan in PyTorch);
//  2. tiles_fused_kernel: a persistent grid of at most as many CUDA blocks
//     as fit on the card walks the (span, group of targets) items in a
//     fixed order, so no block waits on the tile with the longest lists;
//     granules stream from the rows as they are through a ring of three by
//     cp.async copies, one barrier a granule (kNoIdx as the index of every
//     M2P entry, which has no self-exclusion); two targets a thread in the
//     float build, one in the float64 build; each span writes its
//     per-target partial into a scratch;
//  3. rows_reduce_kernel adds each target's spans in order and applies G:
//     two launches on the same inputs give the same bits.
//
// K4 design: the TPU form's (C, blocks) grid runs a tile's blocks in order
// into one output; CUDA blocks run in no order and share nothing, so the
// sequential axis becomes a split of the row (as K5, shared_blocks.cu):
// grid (C, ceil(T/128), nsplit), CUDA block (c, y, z) sums the blocks
// [z * per, (z + 1) * per) that tile c visits for 128 targets, and writes
// one partial (ax, ay, az, pot) a target into scratch[z, c, t]; a second
// kernel adds the nsplit partials in the order z = 0, 1, ... (no atomics,
// so two launches agree bit for bit). One launch evaluates one row,
// with (P2P) or without (M2P) the index test. Its row is visited in whole
// blocks of `block` entries (a runtime argument) up to
// ceil(max(min(cnt, S), 1) / block) blocks, at least one, the last one cut
// at S, as the TPU kernel's plan.
//
// Scalar type: `real` is RAKAU_REAL, float unless the library is built
// with -DRAKAU_REAL=double. Indices are compared as int32 (particle counts
// stay below 2^31). Built without --use_fast_math. Kernels: K3's three, K4's
// two forms and its reduction.

#include "rows.cuh"

namespace {

constexpr int kStage = 512;     // K4: row entries staged per step
// K4: entries unrolled in its inner loop (fewer in double)
constexpr int kSplitUnroll = sizeof(real) == 8 ? 2 : 4;
static_assert(kStage * (sizeof(real4) + sizeof(int)) <= 48 * 1024,
              "the staged entries must fit in static shared memory");

// ---------------------------------------------------------------- K3
// Granules of tile c's row of S entries with counts cnt (null: all S).
__device__ __forceinline__ int row_granules(const int64_t* __restrict__ cnt,
                                            int c, int S)
{
    int64_t k = cnt == nullptr ? S : cnt[c];
    k = k < 0 ? 0 : (k > S ? S : k);
    return static_cast<int>((k + kGranule - 1) / kGranule);
}

struct TilesTile {
    int c;          // the tile
    int gm;         // its M2P granules
    int granules;   // M2P and P2P
};

// Both rows' granules of each tile, for the work list.
struct TilesCount {
    const int64_t* m_cnt;
    const int64_t* p_cnt;
    int Sm, Sp;
    __device__ int operator()(int c) const
    {
        return row_granules(m_cnt, c, Sm) + row_granules(p_cnt, c, Sp);
    }
};

// The rows for walk_items: tile c's granule k is the M2P row's granule k
// for k < gm, else the P2P row's granule k - gm, each cut at its row's
// end.
struct TilesSrc {
    const real* m_pos;        // [C, Sm, 3]
    const real* m_mass;       // [C, Sm]
    const real* p_pos;        // [C, Sp, 3]
    const real* p_mass;       // [C, Sp]
    const int64_t* p_idx;     // [C, Sp]
    TilesCount count;
    __device__ TilesTile tile(int c) const
    {
        const int gm = row_granules(count.m_cnt, c, count.Sm);
        return {c, gm, gm + row_granules(count.p_cnt, c, count.Sp)};
    }
    __device__ Granule granule(const TilesTile& t, int k) const
    {
        const bool m2p = k < t.gm;
        const int S = m2p ? count.Sm : count.Sp;
        const int e = (m2p ? k : k - t.gm) * kGranule;
        const size_t r = static_cast<size_t>(t.c) * S + e;
        return {(m2p ? m_pos : p_pos) + 3 * r, (m2p ? m_mass : p_mass) + r,
                m2p ? nullptr : p_idx + r, nullptr, min(kGranule, S - e)};
    }
};

__global__ void RAKAU_ROWS_BOUNDS
tiles_fused_kernel(TilesSrc src, const real* __restrict__ tgt,
                   const int64_t* __restrict__ tgt_idx,
                   const int32_t* __restrict__ first,
                   const int32_t* __restrict__ work,
                   const int32_t* __restrict__ n_work,
                   real4* __restrict__ sums, int T, int span, real eps2)
{
    walk_items<kBoth, false, false>(src, tgt, tgt_idx, first, work, n_work,
                                    sums, nullptr, T, span, eps2);
}

// Bytes of K3's workspace: the spans' scratch.
size_t workspace(int T, int cap)
{
    return align256(static_cast<size_t>(cap) * T * sizeof(real4));
}

int k3_blocks_per_sm()
{
    static int occ = 0;
    return fit_per_sm(tiles_fused_kernel, occ);
}

// ---------------------------------------------------------------- K4
// Entries of tile c's row that K4's block plan visits: whole blocks up to
// the count (all S without counts), at least one, the last block cut at S.
__device__ __forceinline__ int row_entries(const int64_t* __restrict__ cnt,
                                           int c, int S, int block)
{
    int64_t k = cnt == nullptr ? S : cnt[c];
    k = k < 0 ? 0 : (k > S ? S : k);
    if (k < 1) k = 1;
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
#pragma unroll (kSplitUnroll)
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
    const int n = row_entries(cnt, c, S, block);
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

// Entries a granule of K3 (kernels/rows.py:GRANULE).
extern "C" int rakau_tiles_granule() { return kGranule; }

// Targets a thread of K3 holds.
extern "C" int rakau_tiles_targets_per_thread() { return kTpt; }

// Bytes of K3's workspace for T targets and cap spans, or 0 for bad sizes.
extern "C" size_t rakau_tiles_workspace(int T, int cap)
{
    if (T <= 0 || cap < 1) return 0;
    return workspace(T, cap);
}

// K3's plan on `stream`: tile c's granules ceil(clip(m_cnt[c], 0, Sm) / 128)
// + ceil(clip(p_cnt[c], 0, Sp) / 128) (null counts: whole rows), cut into
// spans of `span`; first [C + 1], work [cap] (padded with C), n_work [1]
// (-1 if the spans exceed cap): kernels/tiles.py:tiles_plan on the card.
// Returns cudaGetLastError() of the launch (0 = accepted).
extern "C" int rakau_tiles_plan(const int64_t* m_cnt, const int64_t* p_cnt,
                                int32_t* first, int32_t* work,
                                int32_t* n_work, int C, int Sm, int Sp,
                                int span, int cap, void* stream)
{
    if (C < 0 || Sm < 0 || Sp < 0 || span < 1 || cap < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    rows_work_kernel<<<1, kWorkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        TilesCount{m_cnt, p_cnt, Sm, Sp}, C, span, cap, first, work, n_work);
    return static_cast<int>(cudaGetLastError());
}

// K3: launches the plan (into first, work, n_work), the main kernel and
// the span reduction on `stream` (ws: 256-byte aligned,
// rakau_tiles_workspace(T, cap) bytes), and returns cudaGetLastError() of
// the launches (0 = accepted). m_cnt / p_cnt: per-tile counts [C] (int64),
// or null for whole rows. sms: the card's multiprocessors. acc [C, T, 3],
// pot [C, T]: the sums times G. Every real pointer, eps2 and G are of the
// library's scalar type.
extern "C" int rakau_tiles(const real* tgt, const int64_t* tgt_idx,
                           const real* m_pos, const real* m_mass,
                           const int64_t* m_cnt, const real* p_pos,
                           const real* p_mass, const int64_t* p_idx,
                           const int64_t* p_cnt, int32_t* first,
                           int32_t* work, int32_t* n_work, void* ws,
                           real* acc, real* pot, int C, int T, int Sm,
                           int Sp, int span, int cap, int sms, real eps2,
                           real G, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (Sm < 0 || Sp < 0 || span < 1 || cap < 1 || ws == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = rakau_tiles_plan(m_cnt, p_cnt, first, work, n_work, C,
                                     Sm, Sp, span, cap, stream);
    if (err != 0) return err;
    real4* sums = static_cast<real4*>(ws);
    const int grid = persistent_grid(cap, T, k3_blocks_per_sm(), sms);
    tiles_fused_kernel<<<grid, kThreads, 0, st>>>(
        TilesSrc{m_pos, m_mass, p_pos, p_mass, p_idx,
                 TilesCount{m_cnt, p_cnt, Sm, Sp}},
        tgt, tgt_idx, first, work, n_work, sums, T, span, eps2);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long CT = static_cast<long long>(C) * T;
    rows_reduce_kernel<false>
        <<<static_cast<unsigned>((CT + kPackThreads - 1) / kPackThreads),
           kPackThreads, 0, st>>>(sums, nullptr, first, n_work, acc, pot, C,
                                  T, G);
    return static_cast<int>(cudaGetLastError());
}

// CUDA blocks of K3 that fit on one SM at once.
extern "C" int rakau_tiles_blocks_per_sm() { return k3_blocks_per_sm(); }

// CUDA blocks a K3 launch of cap spans and T targets runs (its persistent
// grid).
extern "C" int rakau_tiles_grid(int cap, int T, int sms)
{
    return persistent_grid(cap, T, k3_blocks_per_sm(), sms);
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
