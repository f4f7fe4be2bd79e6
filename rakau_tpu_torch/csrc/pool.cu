// gwalk pool kernel (K2; fp32, or fp64 in the float64 build) for NVIDIA Hopper, in four forms.
//
// Replaces the TPU kernel rakau_tpu/kernels/pallas.py:_pool_kernel in its
// forms: monopole, compensated, quadrupole, and both (modes both/acc/pot).
// The pool (traversal4.build_pool) is a flat row store; tile g's sources
// are the contiguous rows
//
//     [(sched[g,0] * Wb + sched[g,1]) * block, + (sched[g,2] + sched[g,3]) * block)
//
// its sched[g,2] node blocks, then its sched[g,3] particle blocks. No mask:
// padding rows carry mass 0. For target i and row j:
//
//     d = s_j - t_i, r2 = |d|^2 + eps^2
//     inv_r = 0 if idx_j == idx_i or r2 <= 0, else rsqrt(r2)
//     w = m_j * inv_r
//     pot_i -= w, acc_i += w * inv_r^2 * d          (G applied by the caller)
//
// QUAD, on the node blocks only (raw second moments Q_j, 6 planes xx xy xz
// yy yz zz), with Qd = Q_j d, dQd = d.Qd, tr = tr Q_j:
//
//     pot_i -= 1.5 dQd inv_r^5 - 0.5 tr inv_r^3
//     acc_i += -3 Qd inv_r^5 + (7.5 dQd inv_r^7 - 1.5 tr inv_r^5) d
//
// the signs of pallas.py:1041-1090 and of K1d (csrc/shared_fused.cu). The
// dead gate zeroes inv_r before any power of it is formed, so a node row
// exactly on a target at eps = 0 adds 0, not 0 * inf = NaN.
//
// COMP: each thread sums one pool block (`block` rows) into partials
// and adds each partial into its running sum with Knuth's TwoSum, keeping
// the error terms, written as sum + err at the end (the TPU kernel's
// per-block structure, pallas.py:1092-1101). TwoSum has no products, so
// nvcc's FMA contraction cannot change it; no fast math.
//
// Padding rows sit at the traversal's 4 * box_size sentinel (not at 1e30)
// with mass 0 and zero second moments: r2 stays finite and they add 0.
// Padding tiles have m = p = 0 and write zeros.
//
// What bounds it on this card: arithmetic. A monopole pair costs ~20 fp32
// operations and one MUFU rsqrt, a quadrupole pair ~64, against 24 bytes
// of row (48 with the second moments) that every target of the tile
// reuses from shared memory; each row is read from device memory by one
// tile only (segments are disjoint). So the instruction rate and the
// warps in flight are the limit, and the tiles' segment lengths, which
// differ by an order of magnitude, decide the load balance across SMs.
//
// Design: one CUDA block per tile, kThreads threads, one thread per target
// (a tile of more than kThreads targets is done in passes of kThreads,
// each streaming the segment again). The segment is streamed through
// shared memory kStage rows at a time: pos + mass as real4 and idx as
// int32, and the 6 second-moment planes while in the node blocks. Every
// thread then reads the same staged row at a time (a broadcast) and
// accumulates in registers. A pool block may hold any number of rows (a
// runtime argument, 512 by default): its last stage may be ragged. Row
// offsets are int64 (at 8M the pool holds 16n = 134M rows, and row * 6
// planes passes 2^31). Indices are compared as int32 (particle counts
// stay below 2^31).
//
// Scalar type: `real` is RAKAU_REAL, float unless the library is built
// with -DRAKAU_REAL=double (kernels/shared.py:build_library(f64=True)),
// which gives the same kernels in float64 for float64 trees (the staged
// rows then take 21 KB of shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef RAKAU_REAL
// The float64 build: at most two resident blocks a SM bound the registers.
// Under the thread bound alone ptxas held the double forms near 64
// registers and spilled in four of them; with this bound they take 78-96
// and none spills.
#define RAKAU_POOL_BOUNDS __launch_bounds__(kThreads, 2)
#else
#define RAKAU_REAL float
#define RAKAU_POOL_BOUNDS __launch_bounds__(kThreads)
#endif

namespace {

using real = RAKAU_REAL;
struct alignas(4 * sizeof(real)) real4 { real x, y, z, w; };
__device__ __forceinline__ float rsqrt_r(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_r(double x) { return rsqrt(x); }

constexpr int kThreads = 256;   // targets per pass, one per thread
constexpr int kStage = 256;     // pool rows staged per step
constexpr int kQuad = 6;
// rows unrolled in the inner loop
constexpr int kUnroll = sizeof(real) == 8 ? 2 : 4;
static_assert(kStage * (sizeof(real4) + sizeof(int) + kQuad * sizeof(real))
                  <= 48 * 1024,
              "the staged rows must fit in static shared memory");
enum Mode { kBoth = 0, kAcc = 1, kPot = 2 };

// Knuth TwoSum: s + e == a + b exactly; a becomes s, e is added to err.
__device__ __forceinline__ void two_sum_into(real& a, real b, real& err)
{
    const real s = a + b;
    const real bb = s - a;
    err += (a - (s - bb)) + (b - bb);
    a = s;
}

// Adds the staged rows [0, nj) to one target's block partials.
template <int MODE, bool QUAD>
__device__ __forceinline__ void accumulate(
    const real4* __restrict__ s_pm, const int* __restrict__ s_idx,
    const real* __restrict__ s_q, int nj, real tx, real ty, real tz,
    int ti, real eps2, real& bx, real& by, real& bz, real& bp)
{
#pragma unroll (kUnroll)
    for (int j = 0; j < nj; ++j) {
        const real4 v = s_pm[j];
        const real dx = v.x - tx;
        const real dy = v.y - ty;
        const real dz = v.z - tz;
        const real r2 = dx * dx + dy * dy + dz * dz + eps2;
        real inv_r = rsqrt_r(r2);
        if (s_idx[j] == ti || r2 <= real(0)) inv_r = 0;
        const real w = v.w * inv_r;
        const real inv2 = inv_r * inv_r;
        real g = w * inv2;                 // the factor of d in acc
        real qx = 0, qy = 0, qz = 0;
        if (QUAD) {
            const real qxx = s_q[0 * kStage + j], qxy = s_q[1 * kStage + j];
            const real qxz = s_q[2 * kStage + j], qyy = s_q[3 * kStage + j];
            const real qyz = s_q[4 * kStage + j], qzz = s_q[5 * kStage + j];
            qx = qxx * dx + qxy * dy + qxz * dz;          // Qd
            qy = qxy * dx + qyy * dy + qyz * dz;
            qz = qxz * dx + qyz * dy + qzz * dz;
            const real dqd = dx * qx + dy * qy + dz * qz;
            const real tr = qxx + qyy + qzz;
            const real inv3 = inv2 * inv_r;
            const real inv5 = inv3 * inv2;
            if (MODE != kPot) {
                g += real(7.5) * dqd * (inv5 * inv2) - real(1.5) * tr * inv5;
                qx *= real(-3) * inv5;
                qy *= real(-3) * inv5;
                qz *= real(-3) * inv5;
            }
            if (MODE != kAcc)
                bp -= real(1.5) * dqd * inv5 - real(0.5) * tr * inv3;
        }
        if (MODE != kPot) {
            bx += g * dx + qx;
            by += g * dy + qy;
            bz += g * dz + qz;
        }
        if (MODE != kAcc) bp -= w;
    }
}

template <int MODE, bool COMP, bool QUAD>
__global__ void RAKAU_POOL_BOUNDS
pool_kernel(const real* __restrict__ tgt,          // [G, T, 3]
            const int64_t* __restrict__ tgt_idx,   // [G, T]
            const real* __restrict__ pos,          // [P, 3]
            const real* __restrict__ mass,         // [P]
            const int64_t* __restrict__ idx,       // [P]
            const real* __restrict__ quad,         // [P, 6] (QUAD)
            const int32_t* __restrict__ sched,     // [G, 4]
            real* __restrict__ acc,                // [G, T, 3]
            real* __restrict__ pot,                // [G, T]
            int T, int Wb, int block, real eps2)
{
    __shared__ real4 s_pm[kStage];
    __shared__ int s_idx[kStage];
    __shared__ real s_q[QUAD ? kQuad * kStage : 1];

    const int64_t g = blockIdx.x;
    const int32_t* sg = sched + 4 * g;
    const int64_t row0 = (static_cast<int64_t>(sg[0]) * Wb + sg[1]) * block;
    const int m_nb = sg[2];
    const int nblk = sg[2] + sg[3];

    for (int t0 = 0; t0 < T; t0 += kThreads) {
        const int t = t0 + static_cast<int>(threadIdx.x);
        const bool live = t < T;
        const int64_t tg = g * T + t;
        real tx = 0, ty = 0, tz = 0;
        int ti = -2;   // matches no row index (nodes and padding carry -1)
        if (live) {
            tx = tgt[3 * tg];
            ty = tgt[3 * tg + 1];
            tz = tgt[3 * tg + 2];
            ti = static_cast<int>(tgt_idx[tg]);
        }
        real ax = 0, ay = 0, az = 0, pp = 0;   // running sums
        real ex = 0, ey = 0, ez = 0, ep = 0;   // TwoSum errors
        for (int b = 0; b < nblk; ++b) {
            const bool with_quad = QUAD && b < m_nb;    // uniform per block
            const int64_t brow = row0 + static_cast<int64_t>(b) * block;
            real bx = 0, by = 0, bz = 0, bp = 0;   // block partials
            for (int s0 = 0; s0 < block; s0 += kStage) {
                const int nj = min(kStage, block - s0);
                __syncthreads();        // the previous stage is consumed
                for (int j = threadIdx.x; j < nj; j += kThreads) {
                    const int64_t r = brow + s0 + j;
                    s_pm[j] = real4{pos[3 * r], pos[3 * r + 1],
                                    pos[3 * r + 2], mass[r]};
                    s_idx[j] = static_cast<int>(idx[r]);
                    if constexpr (QUAD) {
                        if (with_quad) {
#pragma unroll
                            for (int q = 0; q < kQuad; ++q)
                                s_q[q * kStage + j] = quad[kQuad * r + q];
                        }
                    }
                }
                __syncthreads();
                if constexpr (QUAD) {
                    if (with_quad) {
                        accumulate<MODE, true>(s_pm, s_idx, s_q, nj, tx, ty,
                                               tz, ti, eps2, bx, by, bz, bp);
                        continue;
                    }
                }
                accumulate<MODE, false>(s_pm, s_idx, s_q, nj, tx, ty, tz,
                                        ti, eps2, bx, by, bz, bp);
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
            acc[3 * tg] = ax + ex;
            acc[3 * tg + 1] = ay + ey;
            acc[3 * tg + 2] = az + ez;
            pot[tg] = pp + ep;
        }
    }
}

struct Args {
    const real* tgt; const int64_t* tgt_idx; const real* pos;
    const real* mass; const int64_t* idx; const real* quad;
    const int32_t* sched; real* acc; real* pot;
    int G, T, Wb, block; real eps2;
};

template <int MODE, bool COMP, bool QUAD>
cudaError_t launch(const Args& a, cudaStream_t stream)
{
    pool_kernel<MODE, COMP, QUAD><<<a.G, kThreads, 0, stream>>>(
        a.tgt, a.tgt_idx, a.pos, a.mass, a.idx, a.quad, a.sched, a.acc,
        a.pot, a.T, a.Wb, a.block, a.eps2);
    return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_form(const Args& a, bool comp, cudaStream_t stream)
{
    const bool quad = a.quad != nullptr;
    if (comp)
        return quad ? launch<MODE, true, true>(a, stream)
                    : launch<MODE, true, false>(a, stream);
    return quad ? launch<MODE, false, true>(a, stream)
                : launch<MODE, false, false>(a, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch
// (0 = accepted). mode: 0 both, 1 acc only (pot written as 0), 2 pot only
// (acc written as 0). quad: [P, 6] second moments, or null for the
// monopole forms. comp: nonzero for the compensated (TwoSum) sums. Wb:
// blocks per window; block: rows per pool block. Every real pointer and
// eps2 are of the library's scalar type.
extern "C" int rakau_pool(const real* tgt, const int64_t* tgt_idx,
                          const real* pos, const real* mass,
                          const int64_t* idx, const real* quad,
                          const int32_t* sched, real* acc, real* pot,
                          int G, int T, int Wb, int block, int mode, int comp,
                          real eps2, void* stream)
{
    if (G <= 0 || T <= 0) return 0;
    if (Wb <= 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{tgt, tgt_idx, pos, mass, idx, quad, sched, acc, pot,
                 G, T, Wb, block, eps2};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mode) {
    case kBoth: return static_cast<int>(launch_form<kBoth>(a, comp != 0, st));
    case kAcc:  return static_cast<int>(launch_form<kAcc>(a, comp != 0, st));
    case kPot:  return static_cast<int>(launch_form<kPot>(a, comp != 0, st));
    default:    return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Bytes of the scalar type the library was built for (4 or 8).
extern "C" int rakau_pool_real_bytes() { return static_cast<int>(sizeof(real)); }

extern "C" const char* rakau_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
