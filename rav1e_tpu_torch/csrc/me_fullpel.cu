// K10 me_fullpel: full-pel motion search of every 32x32 luma block, a
// quarter-resolution exhaustive search then a full-resolution refinement,
// bit-exact with the JAX program (identical MVs), int32.
//
// Replaces rav1e_tpu/models/device_pipeline.py:290 me_fullpel (jit :289),
// inlined in the P-frame wavefront pass (models/wavefront.py:1050).  The
// TPU version builds all 289 shifted quarter planes and all 25 shifted
// full-resolution windows as whole-frame arrays and reduces them.  Here:
//   launch 1 (quarter_kernel): one thread per quarter sample sums its 4x4
//     luma samples, for the source and the reference (int32 planes);
//   launch 2 (search_kernel): one CTA per 32x32 block.
//     Stage A: the 8x8 quarter source block and the (8 + 16)^2 quarter
//     reference window (coordinates clamped to the quarter plane: the JAX
//     program edge-pads it by 8) go to shared memory; the 289 offsets of
//     +-8 are SADs of 64 terms, one thread an offset.
//     Stage B: around the stage-A winner (4x its offset, in pixels), the
//     (32 + 4)^2 full-resolution window (clamped to the plane: the JAX
//     program edge-pads by ME_RANGE_PX + 2 = 34, exactly the reach) and
//     the 32x32 source block; 25 deltas of +-2, a warp a delta, each lane
//     a column of 32.
//   Both argmins keep the FIRST minimum in (dy, dx) raster order, as
//   jnp.argmin does (strict < while scanning upwards, ties to the lower
//   index across lanes).
// Both kernels are templated on the sample type: uint8 planes in the
// inter pass and at 8 bits, uint16 planes for frame_me_map above 8 bits
// (device_pipeline.py:339 runs the JAX search on int32 planes of any bit
// depth).  int32 is exact: at 12 bits a quarter SAD is at most
// 64 * 16 * 4095 and a full one 1024 * 4095.  Bound on the H100:
// operations (289 * 64 + 25 * 1024 absolute differences a block against
// ~4 KB of input, ~8 KB at 16 bits).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RADQ = 8;        // quarter-resolution radius (32 px)
constexpr int NOFF = (2 * RADQ + 1) * (2 * RADQ + 1);
constexpr int WQ = 8 + 2 * RADQ;
constexpr int RAD2 = 2;
constexpr int WF = 32 + 2 * RAD2;

template <typename T>
__global__ void quarter_kernel(const T *__restrict__ src, int ss,
                               const T *__restrict__ ref, int rs,
                               int hq, int wq, int32_t *__restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 2 * hq * wq) return;
    const int p = i / (hq * wq), k = i % (hq * wq);
    const int y = k / wq, x = k % wq;
    const T *a = p ? ref : src;
    const int st = p ? rs : ss;
    int32_t acc = 0;
#pragma unroll
    for (int r = 0; r < 4; r++)
#pragma unroll
        for (int c = 0; c < 4; c++) acc += a[(size_t)(4 * y + r) * st + 4 * x + c];
    out[i] = acc;
}

// lexicographic (cost, index) minimum across a warp
__device__ __forceinline__ void warp_argmin(int &cost, int &idx) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const int c2 = __shfl_down_sync(0xffffffffu, cost, o);
        const int i2 = __shfl_down_sync(0xffffffffu, idx, o);
        if (c2 < cost || (c2 == cost && i2 < idx)) {
            cost = c2;
            idx = i2;
        }
    }
}

template <typename T>
__global__ void search_kernel(const int32_t *__restrict__ quarter, int hq,
                              int wq, const T *__restrict__ src, int ss,
                              const T *__restrict__ ref, int rs, int h,
                              int w, int bxn, int32_t *__restrict__ mv) {
    __shared__ int32_t sq[64];
    __shared__ int32_t rq[WQ * WQ];
    __shared__ int32_t ca[NOFF];
    __shared__ int32_t sf[32 * 32];
    __shared__ int32_t rf[WF * WF];
    __shared__ int32_t cb[(2 * RAD2 + 1) * (2 * RAD2 + 1)];
    __shared__ int32_t best_a;
    const int blk = blockIdx.x;
    const int by = blk / bxn, bx = blk % bxn;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int32_t *srcq = quarter;
    const int32_t *refq = quarter + (size_t)hq * wq;
    const int qy0 = by * 8, qx0 = bx * 8;
    for (int i = tid; i < 64; i += THREADS)
        sq[i] = srcq[(size_t)(qy0 + i / 8) * wq + qx0 + i % 8];
    for (int i = tid; i < WQ * WQ; i += THREADS) {
        const int r = min(max(qy0 - RADQ + i / WQ, 0), hq - 1);
        const int c = min(max(qx0 - RADQ + i % WQ, 0), wq - 1);
        rq[i] = refq[(size_t)r * wq + c];
    }
    __syncthreads();
    for (int o = tid; o < NOFF; o += THREADS) {
        const int dy = o / (2 * RADQ + 1), dx = o % (2 * RADQ + 1);
        int32_t acc = 0;
        for (int i = 0; i < 8; i++)
#pragma unroll
            for (int j = 0; j < 8; j++)
                acc += abs(sq[i * 8 + j] - rq[(i + dy) * WQ + j + dx]);
        ca[o] = acc;
    }
    __syncthreads();
    if (warp == 0) {
        int cost = 0x7fffffff, idx = 0x7fffffff;
        for (int o = lane; o < NOFF; o += 32)
            if (ca[o] < cost) {
                cost = ca[o];
                idx = o;
            }
        warp_argmin(cost, idx);
        if (lane == 0) best_a = idx;
    }
    __syncthreads();
    const int ay = (best_a / (2 * RADQ + 1) - RADQ) * 4;
    const int ax = (best_a % (2 * RADQ + 1) - RADQ) * 4;
    const int y0 = by * 32, x0 = bx * 32;
    for (int i = tid; i < 32 * 32; i += THREADS)
        sf[i] = src[(size_t)(y0 + i / 32) * ss + x0 + i % 32];
    for (int i = tid; i < WF * WF; i += THREADS) {
        const int r = min(max(y0 + ay - RAD2 + i / WF, 0), h - 1);
        const int c = min(max(x0 + ax - RAD2 + i % WF, 0), w - 1);
        rf[i] = ref[(size_t)r * rs + c];
    }
    __syncthreads();
    constexpr int ND = (2 * RAD2 + 1) * (2 * RAD2 + 1);
    for (int d = warp; d < ND; d += THREADS / 32) {
        const int dy = d / (2 * RAD2 + 1), dx = d % (2 * RAD2 + 1);
        int32_t acc = 0;
        for (int r = 0; r < 32; r++)
            acc += abs(sf[r * 32 + lane] - rf[(r + dy) * WF + lane + dx]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
        if (lane == 0) cb[d] = acc;
    }
    __syncthreads();
    if (warp == 0) {
        int cost = lane < ND ? cb[lane] : 0x7fffffff;
        int idx = lane < ND ? lane : 0x7fffffff;
        warp_argmin(cost, idx);
        if (lane == 0) {
            mv[(size_t)blk * 2] = ay + idx / (2 * RAD2 + 1) - RAD2;
            mv[(size_t)blk * 2 + 1] = ax + idx % (2 * RAD2 + 1) - RAD2;
        }
    }
}

template <typename T>
void launch(const void *src, int src_stride, const void *ref, int ref_stride,
            int h, int w, void *quarter, void *mv, cudaStream_t s) {
    const int hq = h / 4, wq = w / 4;
    const int nq = 2 * hq * wq;
    quarter_kernel<T><<<(nq + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        (const T *)src, src_stride, (const T *)ref, ref_stride, hq, wq,
        (int32_t *)quarter);
    const int bxn = w / 32, byn = h / 32;
    search_kernel<T><<<byn * bxn, THREADS, 0, s>>>(
        (const int32_t *)quarter, hq, wq, (const T *)src, src_stride,
        (const T *)ref, ref_stride, h, w, bxn, (int32_t *)mv);
}

}  // namespace

// sample_bytes: 1 (uint8 planes) or 2 (uint16); strides in samples
extern "C" int me_fullpel(const void *src, int src_stride, const void *ref,
                          int ref_stride, int h, int w, int sample_bytes,
                          void *quarter, void *mv, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (h >= 4 && w >= 4) {
        if (sample_bytes == 2)
            launch<uint16_t>(src, src_stride, ref, ref_stride, h, w, quarter,
                             mv, s);
        else
            launch<uint8_t>(src, src_stride, ref, ref_stride, h, w, quarter,
                            mv, s);
    }
    return (int)cudaGetLastError();
}
