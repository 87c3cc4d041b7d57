// K12 mode_sad: the source-edge SAD mode analysis, int32, bit-exact.
//
// Replaces rav1e_tpu/models/device_pipeline.py:118 mode_analysis over :49
// _predict_all (and :351 intra_analysis_step, the same search at n = 8
// over DC, V and H).  The TPU version predicts all 10 candidates of every
// n x n block as one (10, by, bx, n, n) stack in device memory, subtracts
// the source and reduces it.  Here one CTA owns one block:
//   1. the n x n source samples and the block's edges go into shared
//      memory: the row above and the column to the left from the plane
//      itself, 128 outside it, or, for the plane's first block row, from
//      a given row above the plane (a shard's halo row);
//   2. each thread predicts its samples for every candidate from the
//      rule (DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH and the zone-2
//      angles 135, 113, 157 with their clip(., 0, n) edge indices, in
//      CANDIDATES order; `count` = 3 takes DC, V and H only) and keeps
//      one running |pred - src| sum a candidate in registers;
//   3. the sums are reduced over the warps, and thread 0 writes the least
//      SAD and the index of the first candidate that reaches it (argmin's
//      tie rule: flat blocks tie).
// No prediction is written to device memory.
//
// Bound on the H100: bytes (the int32 plane read once: 4 bytes a sample,
// against ~10 integer operations a sample and candidate).  This first
// version runs min(max(n * n, 32), 256) threads a CTA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXC = 10;
constexpr int MAXN = 32;
constexpr int MAXWARPS = 8;
__constant__ int32_t ZONE2[3] = {135, 113, 157};

__global__ void mode_sad_kernel(const int32_t *__restrict__ y, int H, int W,
                                const int32_t *__restrict__ above_row, int n,
                                int count, const int32_t *__restrict__ dr,
                                const int32_t *__restrict__ smw,
                                int32_t *__restrict__ best,
                                int32_t *__restrict__ best_sad) {
    __shared__ int32_t src[MAXN * MAXN];
    __shared__ int32_t az[MAXN + 1], lz[MAXN + 1];  // [top-left, edge...]
    __shared__ int32_t red[MAXC][MAXWARPS];
    __shared__ int32_t dc_val;
    const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int32_t *plane = y + (size_t)b * H * W;
    const int x0 = bx * n, y0 = by * n;
    for (int i = tid; i < n * n; i += nt)
        src[i] = plane[(size_t)(y0 + i / n) * W + x0 + i % n];
    for (int i = tid; i <= n; i += nt) {
        // az[i]: the sample above column x0 + i - 1 (i = 0: the top-left)
        const int c = x0 + i - 1;
        int a;
        if (c < 0) a = 128;
        else if (y0 > 0) a = plane[(size_t)(y0 - 1) * W + c];
        else a = above_row ? above_row[(size_t)b * W + c] : 128;
        az[i] = a;
        if (i == 0) lz[0] = a;
        else lz[i] = x0 > 0 ? plane[(size_t)(y0 + i - 1) * W + x0 - 1] : 128;
    }
    __syncthreads();
    if (tid == 0) {
        int s = 0;
        for (int i = 1; i <= n; i++) s += az[i] + lz[i];
        dc_val = (s + n) / (2 * n);
    }
    __syncthreads();
    int acc[MAXC];
#pragma unroll
    for (int k = 0; k < MAXC; k++) acc[k] = 0;
    const int below = lz[n], right = az[n], tl = az[0];
    for (int i = tid; i < n * n; i += nt) {
        const int r = i / n, c = i % n;
        const int s = src[i], a = az[1 + c], l = lz[1 + r];
        acc[0] += abs(dc_val - s);
        acc[1] += abs(a - s);
        acc[2] += abs(l - s);
        if (count > 3) {
            const int wy = smw[r], wx = smw[c];
            acc[3] += abs(((wy * a + (256 - wy) * below + wx * l
                            + (256 - wx) * right + 256) >> 9) - s);
            acc[4] += abs(((wy * a + (256 - wy) * below + 128) >> 8) - s);
            acc[5] += abs(((wx * l + (256 - wx) * right + 128) >> 8) - s);
            const int base = a + l - tl;
            const int pa = abs(base - a), pl = abs(base - l),
                      ptl = abs(base - tl);
            acc[6] += abs(((pl <= pa && pl <= ptl) ? l
                           : (pa <= ptl ? a : tl)) - s);
#pragma unroll
            for (int z = 0; z < 3; z++) {
                const int ang = ZONE2[z];
                const int xpos = (c << 6) - (r + 1) * dr[180 - ang];
                const int bxp = xpos >> 6;
                int v;
                if (bxp >= -1) {
                    const int sh = (xpos >> 1) & 0x1F;
                    const int i0 = min(max(1 + bxp, 0), n);
                    const int i1 = min(max(2 + bxp, 0), n);
                    v = (az[i0] * (32 - sh) + az[i1] * sh + 16) >> 5;
                } else {
                    const int ypos = (r << 6) - (c + 1) * dr[ang - 90];
                    const int byp = ypos >> 6;
                    const int sh = (ypos >> 1) & 0x1F;
                    const int i0 = min(max(1 + byp, 0), n);
                    const int i1 = min(max(2 + byp, 0), n);
                    v = (lz[i0] * (32 - sh) + lz[i1] * sh + 16) >> 5;
                }
                acc[7 + z] += abs(v - s);
            }
        }
    }
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int k = 0; k < MAXC; k++) {
        int v = acc[k];
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[k][warp] = v;
    }
    __syncthreads();
    if (tid == 0) {
        const int nw = (nt + 31) >> 5;
        int bi = 0, bs = 0;
        for (int k = 0; k < count; k++) {
            int v = 0;
            for (int w = 0; w < nw; w++) v += red[k][w];
            if (k == 0 || v < bs) {
                bs = v;
                bi = k;
            }
        }
        const size_t o = ((size_t)b * gridDim.y + by) * gridDim.x + bx;
        best[o] = bi;
        best_sad[o] = bs;
    }
}

}  // namespace

extern "C" int mode_sad(const void *y, int B, int H, int W,
                        const void *above_row, int n, int count,
                        const void *dr, const void *smw, void *best,
                        void *best_sad, void *stream) {
    if (n < 4 || n > MAXN || (count != 3 && count != MAXC) || H % n || W % n)
        return (int)cudaErrorInvalidValue;
    if (B > 0 && H > 0 && W > 0) {
        const dim3 grid(W / n, H / n, B);
        // whole warps: the reduction shuffles over all 32 lanes
        const int threads = n * n < 32 ? 32 : (n * n < 256 ? n * n : 256);
        mode_sad_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t *)y, H, W, (const int32_t *)above_row, n, count,
            (const int32_t *)dr, (const int32_t *)smw, (int32_t *)best,
            (int32_t *)best_sad);
    }
    return (int)cudaGetLastError();
}
