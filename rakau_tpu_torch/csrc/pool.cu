// gwalk pool kernel (K2; fp32, or fp64 in the float64 build) for NVIDIA
// Hopper, in four forms.
//
// Replaces the TPU kernel rakau_tpu/kernels/pallas.py:_pool_kernel in its
// forms: monopole, compensated, quadrupole, and both (modes both/acc/pot).
// The pool (traversal4.build_pool) is a flat row store; tile g's sources
// are the contiguous rows
//
//     [(sched[g,0] * Wb + sched[g,1]) * block, + (sched[g,2] + sched[g,3]) * block)
//
// its sched[g,2] node blocks, then its sched[g,3] particle blocks; the
// segments of different tiles are disjoint. No mask: padding rows carry
// mass 0 (at the traversal's 4 * box sentinel) and zero second moments.
// The pair terms, the quadrupole correction on the node blocks only and the
// dead gate are those of csrc/rows.cuh. Padding tiles have m = p = 0 and
// get zeros.
//
// What bounds it on this card: arithmetic. A monopole pair costs ~20 fp32
// operations and one MUFU rsqrt, a quadrupole pair ~64, against 24 bytes
// of row (48 with the second moments) that every target of a work item
// reuses from shared memory; each row is read by one tile only. So the
// issue rate and the warps in flight are the limit, and the tiles' segment
// lengths, which differ by an order of magnitude, decide the load balance.
//
// Design (csrc/rows.cuh), three kernels a launch, none waiting on the
// host:
//  1. rows_work_kernel, one CUDA block: tile g has (sched[g,2] +
//     sched[g,3]) * gpb granules (gpb = ceil(block / 128): a pool block of
//     any length is whole granules, the last one ragged), cut into spans of
//     `span` granules; the work list holds the spans tile after tile
//     (kernels/pool.py:pool_plan is the same plan in PyTorch);
//  2. pool_kernel: a persistent grid of at most as many CUDA blocks as fit
//     on the card walks the (span, group of targets) items in a fixed
//     order; granules stream from the pool's planes as they are through a
//     ring of three by cp.async copies, one barrier a granule; two targets
//     a thread in the float build, one in the float64 build; a granule of
//     a node block takes the quadrupole terms (uniform per granule). Each
//     span writes its per-target partial into a scratch;
//  3. rows_reduce_kernel adds each target's spans in order and applies G.
// Staging the planes as they are measured 1-2 % faster a launch on the 1M
// pools than packing the visited blocks once a launch into (x, y, z, m) +
// int32 indices (PERF.md): the packing pass cost more than the three more
// shared loads a row it saves.
// COMP keeps Knuth's TwoSum at both levels: granule partials into the
// span's sum, span sums in the reduction, the error terms added at the end:
// the reference's per-block TwoSum (pallas.py:1092-1101) with the granule
// as the block. Two launches on the same inputs give the same bits.
//
// Scalar type: `real` is RAKAU_REAL, float unless the library is built
// with -DRAKAU_REAL=double (kernels/shared.py:build_library(f64=True)).
// Pool rows are addressed in 64 bits (at 8M the pool holds 16n = 134M
// rows); indices are compared as int32 (particle counts stay below 2^31).
// 12 instantiations of pool_kernel (mode x compensated x quadrupole), the
// work list and the reduction in two forms: 15 kernels.

#include "rows.cuh"

namespace {

// Tile g's descriptor: its first pool row, node blocks and granules.
struct PoolTile {
    long long row0;
    int m_nb;
    int granules;
};

// Tile g's pool blocks [base, base + m + p), or m + p = -1 where the
// schedule row is out of range (negative counts, or blocks past the pool).
__device__ __forceinline__ int pool_blocks(const int32_t* __restrict__ s,
                                           int Wb, long long NB,
                                           long long& base)
{
    const int m = s[2], p = s[3];
    base = static_cast<long long>(s[0]) * Wb + s[1];
    if (m < 0 || p < 0) return -1;
    if (m + p == 0) return 0;
    if (s[0] < 0 || s[1] < 0 || base + m + p > NB) return -1;
    return m + p;
}

// The granules of each tile, for the work list.
struct PoolCount {
    const int32_t* sched;
    int Wb, gpb;
    long long NB;
    __device__ int operator()(int g) const
    {
        long long base;
        const int nb = pool_blocks(sched + 4 * g, Wb, NB, base);
        return nb < 0 ? -1 : nb * gpb;
    }
};

// The pool's planes and schedule, for walk_items: granule k of tile g is
// the run sub = k % gpb of its block b = k / gpb, rows [row0 + b * block +
// sub * kGranule, + min(kGranule, block - sub * kGranule)), cut at P.
struct PoolSrc {
    const real* pos;          // [P, 3]
    const real* mass;         // [P]
    const int64_t* idx;       // [P]
    const real* quad;         // [P, 6] or null
    const int32_t* sched;     // [G, 4]
    long long P;
    int Wb, block, gpb;
    __device__ PoolTile tile(int g) const
    {
        const int32_t* s = sched + 4 * g;
        return {(static_cast<long long>(s[0]) * Wb + s[1]) * block, s[2],
                (s[2] + s[3]) * gpb};
    }
    __device__ Granule granule(const PoolTile& t, int k) const
    {
        const int b = k / gpb;
        const int sub = k - b * gpb;
        const long long r = t.row0 + static_cast<long long>(b) * block
            + sub * kGranule;
        const long long n = min(static_cast<long long>(
                                    min(kGranule, block - sub * kGranule)),
                                P - r);
        return {pos + 3 * r, mass + r, idx + r,
                quad != nullptr && b < t.m_nb ? quad + kQuad * r : nullptr,
                static_cast<int>(n > 0 ? n : 0)};
    }
};

template <int MODE, bool COMP, bool QUAD>
__global__ void RAKAU_ROWS_BOUNDS
pool_kernel(PoolSrc src, const real* __restrict__ tgt,
            const int64_t* __restrict__ tgt_idx,
            const int32_t* __restrict__ first,
            const int32_t* __restrict__ work,
            const int32_t* __restrict__ n_work, real4* __restrict__ sums,
            real4* __restrict__ errs, int T, int span,
            const real* __restrict__ scal)                 // [eps^2, G]
{
    walk_items<MODE, COMP, QUAD>(src, tgt, tgt_idx, first, work, n_work,
                                 sums, errs, T, span, scal[0]);
}

// Byte offsets of the workspace's parts, 256-aligned: the spans' scratch
// (sums, and their TwoSum errors in COMP).
struct Layout {
    size_t sums, errs, total;
};

Layout layout(int T, int cap, bool comp)
{
    Layout L{};
    const size_t part = align256(static_cast<size_t>(cap) * T
                                 * sizeof(real4));
    L.sums = 0;
    L.errs = part;
    L.total = comp ? 2 * part : part;
    return L;
}

struct Args {
    const real* tgt; const int64_t* tgt_idx; PoolSrc src;
    const int32_t* first; const int32_t* work; const int32_t* n_work;
    unsigned char* ws; real* acc; real* pot;
    int G, T, span, cap, sms; const real* scal;
};

template <int MODE, bool COMP, bool QUAD>
int blocks_per_sm()
{
    static int occ[kMaxDevices] = {};
    return fit_per_sm(pool_kernel<MODE, COMP, QUAD>, occ);
}

template <int MODE, bool COMP, bool QUAD>
cudaError_t launch(const Args& a, const Layout& L, cudaStream_t stream)
{
    const int grid = persistent_grid(a.cap, a.T,
                                     blocks_per_sm<MODE, COMP, QUAD>(), a.sms);
    real4* sums = reinterpret_cast<real4*>(a.ws + L.sums);
    real4* errs = reinterpret_cast<real4*>(a.ws + L.errs);
    pool_kernel<MODE, COMP, QUAD><<<grid, kThreads, 0, stream>>>(
        a.src, a.tgt, a.tgt_idx, a.first, a.work, a.n_work, sums, errs,
        a.T, a.span, a.scal);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long GT = static_cast<long long>(a.G) * a.T;
    rows_reduce_kernel<COMP>
        <<<static_cast<unsigned>((GT + kPackThreads - 1) / kPackThreads),
           kPackThreads, 0, stream>>>(sums, errs, a.first, a.n_work, a.acc,
                                      a.pot, a.G, a.T, a.scal);
    return cudaGetLastError();
}

template <int MODE, bool COMP, bool QUAD>
struct Launch {
    static cudaError_t run(const Args& a, const Layout& L, cudaStream_t st)
    {
        return launch<MODE, COMP, QUAD>(a, L, st);
    }
};

template <int MODE, bool COMP, bool QUAD>
struct Occupancy {
    static int run() { return blocks_per_sm<MODE, COMP, QUAD>(); }
};

// The form's instantiation called with F<MODE, COMP, QUAD>::run.
template <template <int, bool, bool> class F, typename R, typename... A>
R by_form(int mode, bool comp, bool quad, R bad, A&&... args)
{
#define RAKAU_POOL_FORM(M)                                                  \
    return comp ? (quad ? F<M, true, true>::run(args...)                    \
                        : F<M, true, false>::run(args...))                  \
                : (quad ? F<M, false, true>::run(args...)                   \
                        : F<M, false, false>::run(args...))
    switch (mode) {
    case kBoth: RAKAU_POOL_FORM(kBoth);
    case kAcc: RAKAU_POOL_FORM(kAcc);
    case kPot: RAKAU_POOL_FORM(kPot);
    default: return bad;
    }
#undef RAKAU_POOL_FORM
}

cudaError_t plan(const int32_t* sched, int32_t* first, int32_t* work,
                 int32_t* n_work, int G, long long NB, int Wb, int gpb,
                 int span, int cap, cudaStream_t st)
{
    rows_work_kernel<<<1, kWorkThreads, 0, st>>>(
        PoolCount{sched, Wb, gpb, NB}, G, span, cap, first, work, n_work);
    return cudaGetLastError();
}

bool bad_sizes(int G, int T, int P, int Wb, int block, int span, int cap)
{
    return G < 0 || T < 0 || P < 0 || Wb <= 0 || block <= 0 || span < 1
        || cap < 1;
}

}  // namespace

// Entries a granule (kernels/rows.py:GRANULE).
extern "C" int rakau_pool_granule() { return kGranule; }

// Targets a thread holds.
extern "C" int rakau_pool_targets_per_thread() { return kTpt; }

// Bytes of the scalar type the library was built for (4 or 8).
extern "C" int rakau_pool_real_bytes() { return static_cast<int>(sizeof(real)); }

// Bytes of the workspace a launch needs (the scratch of cap spans of T
// targets, twice with comp), or 0 for bad sizes.
extern "C" size_t rakau_pool_workspace(int T, int cap, int comp)
{
    if (T <= 0 || cap < 1) return 0;
    return layout(T, cap, comp != 0).total;
}

// K2's plan on `stream`: tile g's granules (sched[g,2] + sched[g,3]) *
// ceil(block / 128) cut into spans of `span`; first [G + 1] the spans
// before each tile, work [cap] the tile of each span (padded with G),
// n_work [1] the spans, or -1 if a schedule row lies outside the P-row pool
// or the spans exceed cap: kernels/pool.py:pool_plan on the card. Returns
// cudaGetLastError() of the launch (0 = accepted).
extern "C" int rakau_pool_plan(const int32_t* sched, int32_t* first,
                               int32_t* work, int32_t* n_work, int G, int P,
                               int Wb, int block, int span, int cap,
                               void* stream)
{
    if (bad_sizes(G, 1, P, Wb, block, span, cap))
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(plan(sched, first, work, n_work, G,
                                 (static_cast<long long>(P) + block - 1)
                                     / block,
                                 Wb, (block + kGranule - 1) / kGranule, span,
                                 cap, static_cast<cudaStream_t>(stream)));
}

// Launches the whole of K2 on `stream` (the plan into first/work/n_work,
// the main kernel and the span reduction) and returns cudaGetLastError()
// of the launches (0 = accepted). ws: 256-byte aligned,
// rakau_pool_workspace(T, cap, comp) bytes. mode: 0 both, 1 acc only (pot
// written as 0), 2 pot only (acc written as 0). quad: [P, 6] second
// moments, or null for the monopole forms. comp: nonzero for the
// compensated (TwoSum) sums. Wb: blocks per window. sms: the card's
// multiprocessors. acc [G, T, 3] and pot [G, T] are the sums times G.
// scal [2] on the card holds eps^2 and G, read by the kernels (so a CUDA
// graph takes new values as inputs). Every real pointer is of the
// library's scalar type.
extern "C" int rakau_pool(const real* tgt, const int64_t* tgt_idx,
                          const real* pos, const real* mass,
                          const int64_t* idx, const real* quad,
                          const int32_t* sched, int32_t* first,
                          int32_t* work, int32_t* n_work, void* ws,
                          real* acc, real* pot, int G, int T, int P, int Wb,
                          int block, int span, int cap, int mode, int comp,
                          int sms, const real* scal, void* stream)
{
    if (G == 0 || T == 0) return 0;
    if (bad_sizes(G, T, P, Wb, block, span, cap) || ws == nullptr
        || scal == nullptr
        || reinterpret_cast<uintptr_t>(ws) % 256 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(T, cap, comp != 0);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int gpb = (block + kGranule - 1) / kGranule;
    const cudaError_t err = plan(sched, first, work, n_work, G,
                                 (static_cast<long long>(P) + block - 1)
                                     / block,
                                 Wb, gpb, span, cap, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Args a{tgt, tgt_idx, {pos, mass, idx, quad, sched, P, Wb, block,
                                gpb}, first, work, n_work,
                 static_cast<unsigned char*>(ws), acc, pot, G, T, span, cap,
                 sms, scal};
    return static_cast<int>(by_form<Launch>(mode, comp != 0, quad != nullptr,
                                            cudaErrorInvalidValue, a, L,
                                            st));
}

// CUDA blocks of a form that fit on one SM at once, or -1 for a bad mode.
extern "C" int rakau_pool_blocks_per_sm(int mode, int comp, int quad)
{
    return by_form<Occupancy>(mode, comp != 0, quad != 0, -1);
}

// CUDA blocks a launch of cap spans and T targets runs (its persistent
// grid), or -1 for a bad mode.
extern "C" int rakau_pool_grid(int cap, int T, int mode, int comp, int quad,
                               int sms)
{
    const int per_sm = rakau_pool_blocks_per_sm(mode, comp, quad);
    return per_sm < 0 ? -1 : persistent_grid(cap, T, per_sm, sms);
}

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
