// gwalk pool kernel (K2, fp32) for NVIDIA Hopper, in four forms.
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
// COMP: each thread sums one pool block (`block` rows) into fp32 partials
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
// shared memory kStage rows at a time: pos + mass as float4 and idx as
// int32, and the 6 second-moment planes while in the node blocks. Every
// thread then reads the same staged row at a time (a broadcast) and
// accumulates in registers. A pool block may hold any number of rows (a
// runtime argument, 512 by default): its last stage may be ragged. Row
// offsets are int64 (at 8M the pool holds 16n = 134M rows, and row * 6
// planes passes 2^31). Indices are compared as int32 (particle counts
// stay below 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // targets per pass, one per thread
constexpr int kStage = 256;     // pool rows staged per step
constexpr int kQuad = 6;
static_assert(kStage * (sizeof(float4) + sizeof(int) + kQuad * sizeof(float))
                  <= 48 * 1024,
              "the staged rows must fit in static shared memory");
enum Mode { kBoth = 0, kAcc = 1, kPot = 2 };

// Knuth TwoSum: s + e == a + b exactly; a becomes s, e is added to err.
__device__ __forceinline__ void two_sum_into(float& a, float b, float& err)
{
    const float s = a + b;
    const float bb = s - a;
    err += (a - (s - bb)) + (b - bb);
    a = s;
}

// Adds the staged rows [0, nj) to one target's block partials.
template <int MODE, bool QUAD>
__device__ __forceinline__ void accumulate(
    const float4* __restrict__ s_pm, const int* __restrict__ s_idx,
    const float* __restrict__ s_q, int nj, float tx, float ty, float tz,
    int ti, float eps2, float& bx, float& by, float& bz, float& bp)
{
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
        const float4 v = s_pm[j];
        const float dx = v.x - tx;
        const float dy = v.y - ty;
        const float dz = v.z - tz;
        const float r2 = dx * dx + dy * dy + dz * dz + eps2;
        float inv_r = rsqrtf(r2);
        if (s_idx[j] == ti || r2 <= 0.f) inv_r = 0.f;
        const float w = v.w * inv_r;
        const float inv2 = inv_r * inv_r;
        float g = w * inv2;                // the factor of d in acc
        float qx = 0.f, qy = 0.f, qz = 0.f;
        if (QUAD) {
            const float qxx = s_q[0 * kStage + j], qxy = s_q[1 * kStage + j];
            const float qxz = s_q[2 * kStage + j], qyy = s_q[3 * kStage + j];
            const float qyz = s_q[4 * kStage + j], qzz = s_q[5 * kStage + j];
            qx = qxx * dx + qxy * dy + qxz * dz;          // Qd
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
}

template <int MODE, bool COMP, bool QUAD>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const float* __restrict__ tgt,         // [G, T, 3]
            const int64_t* __restrict__ tgt_idx,   // [G, T]
            const float* __restrict__ pos,         // [P, 3]
            const float* __restrict__ mass,        // [P]
            const int64_t* __restrict__ idx,       // [P]
            const float* __restrict__ quad,        // [P, 6] (QUAD)
            const int32_t* __restrict__ sched,     // [G, 4]
            float* __restrict__ acc,               // [G, T, 3]
            float* __restrict__ pot,               // [G, T]
            int T, int Wb, int block, float eps2)
{
    __shared__ float4 s_pm[kStage];
    __shared__ int s_idx[kStage];
    __shared__ float s_q[QUAD ? kQuad * kStage : 1];

    const int64_t g = blockIdx.x;
    const int32_t* sg = sched + 4 * g;
    const int64_t row0 = (static_cast<int64_t>(sg[0]) * Wb + sg[1]) * block;
    const int m_nb = sg[2];
    const int nblk = sg[2] + sg[3];

    for (int t0 = 0; t0 < T; t0 += kThreads) {
        const int t = t0 + static_cast<int>(threadIdx.x);
        const bool live = t < T;
        const int64_t tg = g * T + t;
        float tx = 0.f, ty = 0.f, tz = 0.f;
        int ti = -2;   // matches no row index (nodes and padding carry -1)
        if (live) {
            tx = tgt[3 * tg];
            ty = tgt[3 * tg + 1];
            tz = tgt[3 * tg + 2];
            ti = static_cast<int>(tgt_idx[tg]);
        }
        float ax = 0.f, ay = 0.f, az = 0.f, pp = 0.f;   // running sums
        float ex = 0.f, ey = 0.f, ez = 0.f, ep = 0.f;   // TwoSum errors
        for (int b = 0; b < nblk; ++b) {
            const bool with_quad = QUAD && b < m_nb;    // uniform per block
            const int64_t brow = row0 + static_cast<int64_t>(b) * block;
            float bx = 0.f, by = 0.f, bz = 0.f, bp = 0.f;   // block partials
            for (int s0 = 0; s0 < block; s0 += kStage) {
                const int nj = min(kStage, block - s0);
                __syncthreads();        // the previous stage is consumed
                for (int j = threadIdx.x; j < nj; j += kThreads) {
                    const int64_t r = brow + s0 + j;
                    s_pm[j] = make_float4(pos[3 * r], pos[3 * r + 1],
                                          pos[3 * r + 2], mass[r]);
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
    const float* tgt; const int64_t* tgt_idx; const float* pos;
    const float* mass; const int64_t* idx; const float* quad;
    const int32_t* sched; float* acc; float* pot;
    int G, T, Wb, block; float eps2;
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
// blocks per window; block: rows per pool block.
extern "C" int rakau_pool(const float* tgt, const int64_t* tgt_idx,
                          const float* pos, const float* mass,
                          const int64_t* idx, const float* quad,
                          const int32_t* sched, float* acc, float* pot,
                          int G, int T, int Wb, int block, int mode, int comp,
                          float eps2, void* stream)
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

extern "C" const char* rakau_pool_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
