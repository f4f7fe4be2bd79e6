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
// K4 design: K3's engine (csrc/rows.cuh) on one row a launch, with K4's
// own visited set. The TPU kernel visits each tile's row in whole blocks
// of `block` entries (a runtime argument, cut to S) up to
// ceil(max(min(cnt, S), 1) / block) blocks, at least one, the last one cut
// at S (pallas.py:_pairwise): the entries past the count inside a visited
// block are read, as the reference reads them. Here those entries are cut
// into granules of 128, ceil(visited / 128) a tile, the last one ragged
// where `block` or S is not a multiple of 128. Three kernels a launch,
// none waiting on the host: rows_work_kernel (the spans of `span`
// granules, tile after tile; kernels/tiles.py:pairwise_plan is the same
// plan in PyTorch), tiles_pairwise_kernel (walk_items over the row, two
// targets a thread in the float build, one in the float64 build; the M2P
// launch passes no indices, so every entry carries kNoIdx and only
// r2 <= 0 kills a pair) and rows_reduce_kernel (the spans added in order,
// no G: the reference's _pairwise returns sums without it, and
// eval_tiles(fused=False) applies G to the two launches' sum). Two
// launches on the same inputs give the same bits.
//
// Scalar type: `real` is RAKAU_REAL, float unless the library is built
// with -DRAKAU_REAL=double. Indices are compared as int32 (particle counts
// stay below 2^31). Built without --use_fast_math. Kernels: the work list
// of each (rows_work_kernel over K3's and over K4's counts), their main
// kernels and the span reduction.

#include "rows.cuh"

namespace {

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
                   real4* __restrict__ sums, int T, int span,
                   const real* __restrict__ scal)        // [eps^2, ...]
{
    walk_items<kBoth, false, false>(src, tgt, tgt_idx, first, work, n_work,
                                    sums, nullptr, T, span, scal[0]);
}

// Bytes of K3's workspace: the spans' scratch.
size_t workspace(int T, int cap)
{
    return align256(static_cast<size_t>(cap) * T * sizeof(real4));
}

int k3_blocks_per_sm()
{
    static int occ[kMaxDevices] = {};
    return fit_per_sm(tiles_fused_kernel, occ);
}

// ---------------------------------------------------------------- K4
// Entries of tile c's row that K4's block plan visits: whole blocks up to
// the count (all S without counts), at least one, the last block cut at S
// (block: the caller's, already cut to S).
__device__ __forceinline__ int row_entries(const int64_t* __restrict__ cnt,
                                           int c, int S, int block)
{
    int64_t k = cnt == nullptr ? S : cnt[c];
    k = k < 0 ? 0 : (k > S ? S : k);
    if (k < 1) k = 1;
    const int64_t n = (k + block - 1) / block * block;
    return static_cast<int>(n < S ? n : S);
}

struct PairTile {
    int c;          // the tile
    int n;          // its visited entries
    int granules;   // ceil(n / kGranule)
};

// The visited entries' granules of each tile, for the work list.
struct PairCount {
    const int64_t* cnt;
    int S, block;
    __device__ int operator()(int c) const
    {
        return (row_entries(cnt, c, S, block) + kGranule - 1) / kGranule;
    }
};

// The row for walk_items: tile c's granule k is its visited entries
// [k kGranule, min((k + 1) kGranule, n)).
struct PairSrc {
    const real* pos;          // [C, S, 3]
    const real* mass;         // [C, S]
    const int64_t* idx;       // [C, S], or null (M2P: no index test)
    PairCount count;
    __device__ PairTile tile(int c) const
    {
        const int n = row_entries(count.cnt, c, count.S, count.block);
        return {c, n, (n + kGranule - 1) / kGranule};
    }
    __device__ Granule granule(const PairTile& t, int k) const
    {
        const int e = k * kGranule;
        const size_t r = static_cast<size_t>(t.c) * count.S + e;
        return {pos + 3 * r, mass + r, idx == nullptr ? nullptr : idx + r,
                nullptr, min(kGranule, t.n - e)};
    }
};

__global__ void RAKAU_ROWS_BOUNDS
tiles_pairwise_kernel(PairSrc src, const real* __restrict__ tgt,
                      const int64_t* __restrict__ tgt_idx,
                      const int32_t* __restrict__ first,
                      const int32_t* __restrict__ work,
                      const int32_t* __restrict__ n_work,
                      real4* __restrict__ sums, int T, int span,
                      const real* __restrict__ scal)     // [eps^2, ...]
{
    walk_items<kBoth, false, false>(src, tgt, tgt_idx, first, work, n_work,
                                    sums, nullptr, T, span, scal[0]);
}

int k4_blocks_per_sm()
{
    static int occ[kMaxDevices] = {};
    return fit_per_sm(tiles_pairwise_kernel, occ);
}

bool bad_pairwise(int S, int block, int span, int cap)
{
    return S < 0 || block < 1 || span < 1 || cap < 1;
}

// The reference's block, min(block, S) (1 for an empty row).
int row_block(int S, int block)
{
    return S < 1 ? 1 : (block < S ? block : S);
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
// pot [C, T]: the sums times G. scal [2] on the card holds eps^2 and G,
// read by the kernels. Every real pointer is of the library's scalar type.
extern "C" int rakau_tiles(const real* tgt, const int64_t* tgt_idx,
                           const real* m_pos, const real* m_mass,
                           const int64_t* m_cnt, const real* p_pos,
                           const real* p_mass, const int64_t* p_idx,
                           const int64_t* p_cnt, int32_t* first,
                           int32_t* work, int32_t* n_work, void* ws,
                           real* acc, real* pot, int C, int T, int Sm,
                           int Sp, int span, int cap, int sms,
                           const real* scal, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (Sm < 0 || Sp < 0 || span < 1 || cap < 1 || ws == nullptr
        || scal == nullptr
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
        tgt, tgt_idx, first, work, n_work, sums, T, span, scal);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long CT = static_cast<long long>(C) * T;
    rows_reduce_kernel<false>
        <<<static_cast<unsigned>((CT + kPackThreads - 1) / kPackThreads),
           kPackThreads, 0, st>>>(sums, nullptr, first, n_work, acc, pot, C,
                                  T, scal);
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

// K4's plan on `stream`: tile c's granules ceil(n_c / 128), n_c its
// visited entries (whole blocks of min(block, S) up to max(min(cnt[c], S),
// 1), the last cut at S; null counts: the whole row), cut into spans of
// `span`; first [C + 1], work [cap] (padded with C), n_work [1] (-1 if the
// spans exceed cap): kernels/tiles.py:pairwise_plan on the card. Returns
// cudaGetLastError() of the launch (0 = accepted).
extern "C" int rakau_tiles_pairwise_plan(const int64_t* cnt, int32_t* first,
                                         int32_t* work, int32_t* n_work,
                                         int C, int S, int block, int span,
                                         int cap, void* stream)
{
    if (C < 0 || bad_pairwise(S, block, span, cap))
        return static_cast<int>(cudaErrorInvalidValue);
    rows_work_kernel<<<1, kWorkThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        PairCount{cnt, S, row_block(S, block)}, C, span, cap, first, work,
        n_work);
    return static_cast<int>(cudaGetLastError());
}

// K4, one row: launches the plan (into first, work, n_work), the main
// kernel and the span reduction on `stream` (ws: 256-byte aligned,
// rakau_tiles_workspace(T, cap) bytes), and returns cudaGetLastError() of
// the launches (0 = accepted). idx: the row's indices [C, S] for the
// self-exclusion test (P2P), or null (M2P, no test). cnt: counts [C]
// (int64) or null. acc [C, T, 3], pot [C, T]: the sums, without G. sms:
// the card's multiprocessors. scal on the card holds eps^2 first (the
// kernel reads nothing else of it). Every real pointer is of the
// library's scalar type.
extern "C" int rakau_tiles_pairwise(const real* tgt, const int64_t* tgt_idx,
                                    const real* pos, const real* mass,
                                    const int64_t* idx, const int64_t* cnt,
                                    int32_t* first, int32_t* work,
                                    int32_t* n_work, void* ws, real* acc,
                                    real* pot, int C, int T, int S,
                                    int block, int span, int cap, int sms,
                                    const real* scal, void* stream)
{
    if (C <= 0 || T <= 0) return 0;
    if (bad_pairwise(S, block, span, cap) || ws == nullptr
        || scal == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = rakau_tiles_pairwise_plan(cnt, first, work, n_work, C, S,
                                              block, span, cap, stream);
    if (err != 0) return err;
    real4* sums = static_cast<real4*>(ws);
    const int grid = persistent_grid(cap, T, k4_blocks_per_sm(), sms);
    tiles_pairwise_kernel<<<grid, kThreads, 0, st>>>(
        PairSrc{pos, mass, idx, PairCount{cnt, S, row_block(S, block)}},
        tgt, tgt_idx, first, work, n_work, sums, T, span, scal);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long CT = static_cast<long long>(C) * T;
    rows_reduce_kernel<false>
        <<<static_cast<unsigned>((CT + kPackThreads - 1) / kPackThreads),
           kPackThreads, 0, st>>>(sums, nullptr, first, n_work, acc, pot, C,
                                  T, nullptr);
    return static_cast<int>(cudaGetLastError());
}

// CUDA blocks of K4 that fit on one SM at once.
extern "C" int rakau_tiles_pairwise_blocks_per_sm()
{
    return k4_blocks_per_sm();
}

// CUDA blocks a K4 launch of cap spans and T targets runs (its persistent
// grid).
extern "C" int rakau_tiles_pairwise_grid(int cap, int T, int sms)
{
    return persistent_grid(cap, T, k4_blocks_per_sm(), sms);
}

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
