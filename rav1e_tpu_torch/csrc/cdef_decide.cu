// K15 cdef_decide: the CDEF decision between per-superblock and per-frame
// strengths, from K6's superblock SSE, on the card (ops/cdef.py decide).
//
// Replaces rav1e_tpu/ops/cdef_jax.py:279-299 (the joint cost of the 8
// (luma, chroma) pairs, the per-superblock argmin, the count of coded
// superblocks, the frame sums and argmin, the rate test and the index
// map), which the JAX package leaves to XLA inside its search program and
// the port ran as ~15 device torch ops between K6's two launches.  One
// CTA of 512 threads (510 superblocks at 1080p; up to 128 registers a
// thread, so 8 loads stay in flight without spills):
//   1. the skip map: a thread takes rows of 16 mi under one superblock
//      column (a 16-byte load each where the map is 16-byte aligned; 8
//      loads in flight before the first is tested) and, where any mi is
//      not skip, sets the superblock's byte in shared memory (a plain
//      store: every writer stores 1); mi outside nby * 2 x nbx * 2 count
//      as skip;
//   2. per superblock: the 8 costs sse[c] + sse[8 + PAIR_UV_IDX[c]]
//      (int64), their first least (strict <), kept in shared memory; each
//      thread sums its superblocks' costs per pair, their least, and the
//      coded ones;
//   3. warp-shuffle and shared-memory reductions of the 8 frame costs, the
//      per-superblock total and the count (int64 sums are exact, so their
//      order cannot change a bit);
//   4. thread 0: frame_best (first least) and use_sb = double(persb_total)
//      + lam * (84 + 3 n_coded) < double(frame_cost[frame_best]), each
//      operation rounded on its own in the order ops/cdef.py decide_plain
//      takes them (lam = inf gives false);
//   5. idx_map = use_sb ? sb_idx : frame_best.
// use_sb, frame_best and idx_map stay on the card: nothing syncs with the
// host.  Bound on the H100: bytes (the SSE and the skip map read once, the
// map written: ~0.05 us at 1080p); one CTA's latency sets the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;
constexpr int U = 8;  // skip-map segments a thread loads at once
constexpr int NPAIR = 8;
constexpr int NCAND = 11;  // 8 luma, 3 chroma candidates
constexpr int SB_HDR_BITS = 84;

// PAIR_UV_IDX: the chroma candidate of each pair
__device__ __forceinline__ constexpr int pair_uv(int c) {
    return c < 2 ? 0 : c < 4 ? 1 : 2;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__global__ void __launch_bounds__(NT, 1)
cdef_decide_kernel(const long long *__restrict__ sse, int nsby, int nsbx,
                   const uint8_t *__restrict__ skip, int skip_stride,
                   int mi_h, int mi_w, int vec, double lam,
                   bool *__restrict__ use_sb, int32_t *__restrict__ frame_best,
                   int32_t *__restrict__ idx_map) {
    // a byte a superblock: coded (1 where a mi is not skip), and sb_idx
    // (its first least pair) after it
    extern __shared__ __align__(16) uint8_t coded[];
    __shared__ long long red[NT / 32][NPAIR + 1];
    __shared__ long long redn[NT / 32];
    __shared__ int fin;  // use_sb ? -1 : frame_best
    const int nsb = nsby * nsbx;
    uint8_t *sb_idx = coded + ((nsb + 15) & ~15);
    const int tid = threadIdx.x;
    for (int i = tid; i < (nsb + 3) >> 2; i += NT)
        reinterpret_cast<uint32_t *>(coded)[i] = 0;
    // the first superblock's SSE, loaded before the skip map is read
    long long first[NCAND];
#pragma unroll
    for (int k = 0; k < NCAND; k++)
        first[k] = tid < nsb ? sse[(size_t)k * nsb + tid] : 0;
    __syncthreads();

    // 1. a superblock is coded where one of its mi is not skip; U segments
    // a thread are loaded before any is tested, so their loads overlap
    const int nseg = mi_h * nsbx;
    for (int i0 = tid; i0 < nseg; i0 += NT * U) {
        uint4 q[U];
        int rs[U], cs[U];
#pragma unroll
        for (int u = 0; u < U; u++) {
            const int i = i0 + u * NT;
            rs[u] = i / nsbx;
            cs[u] = i - rs[u] * nsbx;
            q[u] = make_uint4(~0u, ~0u, ~0u, ~0u);  // all skip
            if (i < nseg && vec && cs[u] * 16 + 16 <= mi_w)
                q[u] = *reinterpret_cast<const uint4 *>(
                    skip + (size_t)rs[u] * skip_stride + cs[u] * 16);
        }
#pragma unroll
        for (int u = 0; u < U; u++) {
            const int i = i0 + u * NT;
            if (i >= nseg) break;
            const int x0 = cs[u] * 16, x1 = min(x0 + 16, mi_w);
            bool any;
            if (vec && x1 - x0 == 16) {
                any = (__vcmpeq4(q[u].x, 0) | __vcmpeq4(q[u].y, 0)
                       | __vcmpeq4(q[u].z, 0) | __vcmpeq4(q[u].w, 0)) != 0;
            } else {  // a partial or unaligned segment: byte by byte
                const uint8_t *row = skip + (size_t)rs[u] * skip_stride;
                any = false;
                for (int x = x0; x < x1; x++) any |= row[x] == 0;
            }
            // every writer stores the same 1: no atomic needed
            if (any) coded[(rs[u] >> 4) * nsbx + cs[u]] = 1;
        }
    }
    __syncthreads();

    // 2. per superblock: the pairs' costs, their first least
    long long fc[NPAIR];
#pragma unroll
    for (int c = 0; c < NPAIR; c++) fc[c] = 0;
    long long persb = 0, ncoded = 0;
    for (int i = tid; i < nsb; i += NT) {
        long long s[NCAND];
#pragma unroll
        for (int k = 0; k < NCAND; k++)
            s[k] = i == tid ? first[k] : sse[(size_t)k * nsb + i];
        long long best = 0;
        int bi = 0;
#pragma unroll
        for (int c = 0; c < NPAIR; c++) {
            const long long cost = s[c] + s[NPAIR + pair_uv(c)];
            fc[c] += cost;
            if (c == 0 || cost < best) {
                best = cost;
                bi = c;
            }
        }
        persb += best;
        sb_idx[i] = (uint8_t)bi;
        ncoded += coded[i];
    }

    // 3. the frame's sums
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int c = 0; c < NPAIR; c++) {
        const long long v = warp_sum(fc[c]);
        if (lane == 0) red[warp][c] = v;
    }
    {
        const long long v = warp_sum(persb), n = warp_sum(ncoded);
        if (lane == 0) {
            red[warp][NPAIR] = v;
            redn[warp] = n;
        }
    }
    __syncthreads();

    // 4. the frame's pair and the rate test
    if (warp == 0) {
        long long tot[NPAIR + 1];
#pragma unroll
        for (int j = 0; j <= NPAIR; j++)
            tot[j] = warp_sum(lane < NT / 32 ? red[lane][j] : 0);
        const long long n = warp_sum(lane < NT / 32 ? redn[lane] : 0);
        if (lane == 0) {
            int fb = 0;
            long long fcost = tot[0];
#pragma unroll
            for (int c = 1; c < NPAIR; c++) {
                if (tot[c] < fcost) {
                    fcost = tot[c];
                    fb = c;
                }
            }
            const double rate = __dmul_rn(
                lam, __dadd_rn((double)SB_HDR_BITS,
                               __dmul_rn(3.0, (double)n)));
            const bool use = __dadd_rn((double)tot[NPAIR], rate)
                             < (double)fcost;
            *use_sb = use;
            *frame_best = fb;
            fin = use ? -1 : fb;
        }
    }
    __syncthreads();

    // 5. the index map
    const int f = fin;
    for (int i = tid; i < nsb; i += NT) idx_map[i] = f < 0 ? sb_idx[i] : f;
}

}  // namespace

// sse: (11, nsby, nsbx) int64, contiguous; skip: the per-mi map, one byte a
// mi (nonzero: skip), rows of skip_stride bytes, of which mi_h x mi_w
// (nby * 2 x nbx * 2) count; lam: the per-superblock mode's rate weight.
// use_sb: one bool; frame_best: one int32; idx_map: (nsby, nsbx) int32.
extern "C" int cdef_decide(const void *sse, int nsby, int nsbx,
                           const void *skip, int skip_stride, int mi_h,
                           int mi_w, double lam, void *use_sb,
                           void *frame_best, void *idx_map, void *stream) {
    const int nsb = nsby * nsbx;
    if (nsb < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)((nsb + 15) & ~15) + nsb;
    if (smem > 40 * 1024) return (int)cudaErrorInvalidValue;
    const int vec = ((uintptr_t)skip % 16 == 0) && (skip_stride % 16 == 0);
    cdef_decide_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
        (const long long *)sse, nsby, nsbx, (const uint8_t *)skip,
        skip_stride, mi_h, mi_w, vec, lam, (bool *)use_sb,
        (int32_t *)frame_best, (int32_t *)idx_map);
    return (int)cudaGetLastError();
}
