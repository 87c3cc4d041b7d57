// K5 cdef_dir: the CDEF direction and variance of every 8x8 luma block
// (spec 7.15.2), bit-exact, int32.
//
// Replaces rav1e_tpu/ops/cdef_jax.py:43 _find_dir_all_jnp, as run by the
// search kernel (cdef_jax.py:245) inside the fused filter chain.  The TPU
// version maps each block's 64 pixels to the direction bins with eight
// 64 -> 15 one-hot integer matrices, a shape made for the matrix unit.
// Here one thread owns one block: it adds each pixel straight into its bin
// of each of the eight directions (90 partial sums, all in registers since
// every index is a compile-time constant after unrolling), weighs the
// squared partials by the Div_Table, and takes the first maximum in
// direction order (strict >), as argmax does.
//
// int32 is exact: a direction's cost is at most 840 * sum(x^2) <=
// 840 * 64 * 128^2 < 2^31 (Cauchy-Schwarz over each bin).  Bound on the
// H100: bytes (one read of the plane, two int32 words out per 64 pixels;
// ~20 integer operations a pixel).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void cdef_dir_kernel(const int32_t *__restrict__ img, int stride,
                                int nby, int nbx, int shift,
                                int32_t *__restrict__ dirs,
                                int32_t *__restrict__ var) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= nby * nbx) return;
    const int by = b / nbx, bx = b % nbx;
    const int32_t *p = img + (size_t)by * 8 * stride + bx * 8;
    int p0[15], p1[11], p2[8], p3[11], p4[15], p5[11], p6[8], p7[11];
#pragma unroll
    for (int k = 0; k < 15; k++) p0[k] = p4[k] = 0;
#pragma unroll
    for (int k = 0; k < 11; k++) p1[k] = p3[k] = p5[k] = p7[k] = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) p2[k] = p6[k] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
#pragma unroll
        for (int j = 0; j < 8; j++) {
            const int x = (p[(size_t)i * stride + j] >> shift) - 128;
            p0[i + j] += x;
            p1[i + (j >> 1)] += x;
            p2[i] += x;
            p3[3 + i - (j >> 1)] += x;
            p4[7 + i - j] += x;
            p5[3 - (i >> 1) + j] += x;
            p6[j] += x;
            p7[(i >> 1) + j] += x;
        }
    }
    // Div_Table weights: 840 / bin length (cdef_np._D0_DIV, DIV_TABLE[_ODD_LENS])
    const int d0div[15] = {840, 420, 280, 210, 168, 140, 120, 105,
                           120, 140, 168, 210, 280, 420, 840};
    const int odddiv[11] = {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420};
    int cost[8];
    int c0 = 0, c4 = 0, c2 = 0, c6 = 0, c1 = 0, c3 = 0, c5 = 0, c7 = 0;
#pragma unroll
    for (int k = 0; k < 15; k++) {
        c0 += p0[k] * p0[k] * d0div[k];
        c4 += p4[k] * p4[k] * d0div[k];
    }
#pragma unroll
    for (int k = 0; k < 8; k++) {
        c2 += p2[k] * p2[k];
        c6 += p6[k] * p6[k];
    }
#pragma unroll
    for (int k = 0; k < 11; k++) {
        c1 += p1[k] * p1[k] * odddiv[k];
        c3 += p3[k] * p3[k] * odddiv[k];
        c5 += p5[k] * p5[k] * odddiv[k];
        c7 += p7[k] * p7[k] * odddiv[k];
    }
    cost[0] = c0; cost[1] = c1; cost[2] = c2 * 105; cost[3] = c3;
    cost[4] = c4; cost[5] = c5; cost[6] = c6 * 105; cost[7] = c7;
    int best = 0, best_cost = cost[0];
#pragma unroll
    for (int d = 1; d < 8; d++) {
        if (cost[d] > best_cost) {
            best_cost = cost[d];
            best = d;
        }
    }
    int opp = cost[0];
#pragma unroll
    for (int d = 1; d < 8; d++)
        if (d == ((best + 4) & 7)) opp = cost[d];
    dirs[b] = best;
    var[b] = (best_cost - opp) >> 10;
}

}  // namespace

extern "C" int cdef_dir(const void *img, int stride, int nby, int nbx,
                        int shift, void *dirs, void *var, void *stream) {
    const int n = nby * nbx;
    if (n > 0) {
        const int threads = 128;
        cdef_dir_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
            (const int32_t *)img, stride, nby, nbx, shift, (int32_t *)dirs,
            (int32_t *)var);
    }
    return (int)cudaGetLastError();
}
