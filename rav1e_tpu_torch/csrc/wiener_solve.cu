// K7 wiener_solve: the frame-level symmetric 7-tap Wiener fit of the three
// planes (normal equations, 3x3 solve, rounding and clipping of the taps).
//
// Replaces rav1e_tpu/ops/filter_chain_jax.py:25 _wiener_solve_dev (with
// the chroma outer-tap rule and `en` of :253-256).  The TPU version sums
// the 3x3 matrix and 3-vector of each direction in f32, per 64-row band
// then across bands, and solves in f32.  Here the sums are exact:
//
// stage 1, one CTA per (64-row band, direction, plane): each thread walks
//   its samples, builds f_k = d[-k] + d[+k] - 2 d (edge-replicated, k =
//   3, 2, 1) and b = s - d, and accumulates the 6 distinct entries of
//   M = F^T F and the 3 of r = F^T b in int64 (|f| <= 510, |b| <= 255);
//   a block reduction writes the band's 9 sums to a scratch buffer.
// stage 2, one thread per plane: sums the bands, adds the ridge
//   1e-6 * trace + 1e-3, solves both directions' 3x3 systems in float64
//   by Gaussian elimination with partial pivoting, written out with
//   explicitly rounded operations (no FMA contraction, so the plain
//   version in ops/lrf.py gives the same bits), rounds coef * 128 half to
//   even, clips to WIENER_TAPS_MIN/MAX, zeroes chroma's outer tap, and sets
//   en (any tap nonzero).
//
// Out: taps (6, 3) int32 in the order vY, hY, vU, hU, vV, hV; en (3,)
// int32.  Both stay on the card for K8.  Bound on the H100: bytes (each
// plane read twice, once per direction; ~30 integer operations a sample
// and direction).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int BAND = 64;

struct Planes {
    const int32_t *d[3];
    const int32_t *s[3];
    int stride_d[3], stride_s[3], h[3], w[3];
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__global__ void __launch_bounds__(NT)
wiener_sums_kernel(Planes P, int nbands, long long *__restrict__ part) {
    const int band = blockIdx.x, dir = blockIdx.y, p = blockIdx.z;
    const int h = P.h[p], w = P.w[p];
    const int y0 = band * BAND;
    __shared__ long long red[NT / 32][9];
    long long acc[9];
#pragma unroll
    for (int j = 0; j < 9; j++) acc[j] = 0;
    if (y0 < h) {
        const int y1 = min(y0 + BAND, h);
        const int32_t *d = P.d[p];
        const int32_t *s = P.s[p];
        const int sd = P.stride_d[p], ss = P.stride_s[p];
        const int n = (y1 - y0) * w;
        for (int i = threadIdx.x; i < n; i += NT) {
            const int y = y0 + i / w, x = i % w;
            const int c = d[(size_t)y * sd + x];
            int f[3];
#pragma unroll
            for (int q = 0; q < 3; q++) {
                const int k = 3 - q;
                int a, b;
                if (dir == 0) {
                    a = d[(size_t)max(y - k, 0) * sd + x];
                    b = d[(size_t)min(y + k, h - 1) * sd + x];
                } else {
                    a = d[(size_t)y * sd + max(x - k, 0)];
                    b = d[(size_t)y * sd + min(x + k, w - 1)];
                }
                f[q] = a + b - 2 * c;
            }
            const int r = s[(size_t)y * ss + x] - c;
            acc[0] += (long long)(f[0] * f[0]);
            acc[1] += (long long)(f[0] * f[1]);
            acc[2] += (long long)(f[0] * f[2]);
            acc[3] += (long long)(f[1] * f[1]);
            acc[4] += (long long)(f[1] * f[2]);
            acc[5] += (long long)(f[2] * f[2]);
            acc[6] += (long long)(f[0] * r);
            acc[7] += (long long)(f[1] * r);
            acc[8] += (long long)(f[2] * r);
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < 9; j++) {
        const long long v = warp_sum(acc[j]);
        if (lane == 0) red[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < 9) {
        long long t = 0;
        for (int k = 0; k < NT / 32; k++) t += red[k][threadIdx.x];
        part[(((size_t)p * 2 + dir) * nbands + band) * 9 + threadIdx.x] = t;
    }
}

__constant__ int kTapsMin[3] = {-5, -23, -17};
__constant__ int kTapsMax[3] = {10, 8, 46};

// Solve one direction's system from its summed (M, r); writes 3 taps.
__device__ void solve3(const long long *m9, int chroma, int32_t *taps) {
    // M (symmetric) from its 6 distinct entries, augmented with r
    double A[3][4];
    const double m00 = (double)m9[0], m01 = (double)m9[1], m02 = (double)m9[2];
    const double m11 = (double)m9[3], m12 = (double)m9[4], m22 = (double)m9[5];
    A[0][0] = m00; A[0][1] = m01; A[0][2] = m02; A[0][3] = (double)m9[6];
    A[1][0] = m01; A[1][1] = m11; A[1][2] = m12; A[1][3] = (double)m9[7];
    A[2][0] = m02; A[2][1] = m12; A[2][2] = m22; A[2][3] = (double)m9[8];
    const double trace = __dadd_rn(__dadd_rn(m00, m11), m22);
    const double ridge = __dadd_rn(__dmul_rn(1e-6, trace), 1e-3);
    for (int i = 0; i < 3; i++) A[i][i] = __dadd_rn(A[i][i], ridge);
    for (int c = 0; c < 3; c++) {
        int piv = c;
        for (int r = c + 1; r < 3; r++)
            if (fabs(A[r][c]) > fabs(A[piv][c])) piv = r;
        if (piv != c) {
            for (int k = 0; k < 4; k++) {
                const double t = A[c][k];
                A[c][k] = A[piv][k];
                A[piv][k] = t;
            }
        }
        for (int r = c + 1; r < 3; r++) {
            const double f = __ddiv_rn(A[r][c], A[c][c]);
            for (int k = c; k < 4; k++)
                A[r][k] = __dsub_rn(A[r][k], __dmul_rn(f, A[c][k]));
        }
    }
    double x[3];
    x[2] = __ddiv_rn(A[2][3], A[2][2]);
    x[1] = __ddiv_rn(__dsub_rn(A[1][3], __dmul_rn(A[1][2], x[2])), A[1][1]);
    x[0] = __ddiv_rn(__dsub_rn(__dsub_rn(A[0][3], __dmul_rn(A[0][1], x[1])),
                               __dmul_rn(A[0][2], x[2])),
                     A[0][0]);
    for (int i = 0; i < 3; i++) {
        const double t = rint(__dmul_rn(x[i], 128.0));
        int v = (int)fmin(fmax(t, (double)kTapsMin[i]), (double)kTapsMax[i]);
        if (chroma && i == 0) v = 0;
        taps[i] = v;
    }
}

__global__ void wiener_solve_kernel(const long long *__restrict__ part,
                                    int nbands, int32_t *__restrict__ taps,
                                    int32_t *__restrict__ en) {
    const int p = threadIdx.x;
    if (p >= 3) return;
    int any = 0;
    for (int dir = 0; dir < 2; dir++) {
        long long m9[9];
        for (int j = 0; j < 9; j++) m9[j] = 0;
        const long long *q = part + ((size_t)p * 2 + dir) * nbands * 9;
        for (int b = 0; b < nbands; b++)
            for (int j = 0; j < 9; j++) m9[j] += q[(size_t)b * 9 + j];
        int32_t *t = taps + (p * 2 + dir) * 3;
        solve3(m9, p > 0, t);
        any |= t[0] | t[1] | t[2];
    }
    en[p] = any != 0;
}

}  // namespace

// d*/s*: the degraded (post-CDEF) and source planes, int32, row strides
// sd*/ss*, h* x w* each.  part: int64 scratch of 3 * 2 * nbands * 9 words,
// nbands = ceil(max h / 64).
extern "C" int wiener_solve(const void *d0, const void *s0, int sd0, int ss0,
                            int h0, int w0, const void *d1, const void *s1,
                            int sd1, int ss1, int h1, int w1, const void *d2,
                            const void *s2, int sd2, int ss2, int h2, int w2,
                            int nbands, void *part, void *taps, void *en,
                            void *stream) {
    Planes P;
    P.d[0] = (const int32_t *)d0; P.d[1] = (const int32_t *)d1; P.d[2] = (const int32_t *)d2;
    P.s[0] = (const int32_t *)s0; P.s[1] = (const int32_t *)s1; P.s[2] = (const int32_t *)s2;
    P.stride_d[0] = sd0; P.stride_d[1] = sd1; P.stride_d[2] = sd2;
    P.stride_s[0] = ss0; P.stride_s[1] = ss1; P.stride_s[2] = ss2;
    P.h[0] = h0; P.h[1] = h1; P.h[2] = h2;
    P.w[0] = w0; P.w[1] = w1; P.w[2] = w2;
    cudaStream_t st = (cudaStream_t)stream;
    wiener_sums_kernel<<<dim3(nbands, 2, 3), NT, 0, st>>>(P, nbands,
                                                          (long long *)part);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    wiener_solve_kernel<<<1, 32, 0, st>>>((const long long *)part, nbands,
                                          (int32_t *)taps, (int32_t *)en);
    return (int)cudaGetLastError();
}
