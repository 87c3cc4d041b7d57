// K7 wiener_solve: the frame-level symmetric 7-tap Wiener fit of the three
// planes (normal equations, 3x3 solve, rounding and clipping of the taps).
//
// Replaces rav1e_tpu/ops/filter_chain_jax.py:25 _wiener_solve_dev (with
// the chroma outer-tap rule and `en` of :253-256).  The TPU version sums
// the 3x3 matrix and 3-vector of each direction in f32, per 64-row band
// then across bands, and solves in f32.  Here the sums are exact:
//
// stage 1, one CTA of 256 threads per 64x64 tile of any plane (510 luma
//   and 2 x 135 chroma tiles at 1080p): the tile's degraded samples and a
//   3-sample halo (edge-replicated at the plane's borders) go to shared
//   memory once; each thread walks 16 samples of one column and builds
//   both directions' f_k = d[-k] + d[+k] - 2 d (k = 3, 2, 1) and
//   b = s - d, and sums the 6 distinct entries of M = F^T F and the 3 of
//   r = F^T b of each direction: 18 sums.  Each plane is read once, for
//   both directions.  A thread's sums are int32: |f| <= 2 (2^bd - 1) and
//   |b| < 2^bd, so 16 products stay below 16 * 8190^2 < 2^31 up to 12 bits
//   (the chain runs 8).  The warp and CTA reductions widen to int64 and
//   write the tile's 18 sums to a partials buffer, value-major.
// stage 2, one CTA of 1024 threads: a warp per (plane, value) sums that
//   plane's tiles, 8 loads a lane in flight (exact int64, so the order
//   cannot change a bit), then one thread per
//   plane and direction adds the ridge 1e-6 * trace + 1e-3, solves the
//   3x3 system in float64 by Gaussian elimination with partial pivoting,
//   written out with explicitly rounded operations (no FMA contraction;
//   the division by long division of the significands, correctly
//   rounded like IEEE's, with no call and so no stack: div_rn), so the
//   plain version in ops/lrf.py gives the same bits, rounds coef *
//   128 half to even, clips to WIENER_TAPS_MIN/MAX, zeroes chroma's outer
//   tap; en is set where a plane has a nonzero tap.
//
// Out: taps (6, 3) int32 in the order vY, hY, vU, hU, vV, hV; en (3,)
// int32.  Both stay on the card for K8.  Bound on the H100: bytes (the
// degraded and source planes read once; ~40 integer operations a sample
// for both directions).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // stage 1
constexpr int NT2 = 1024; // stage 2: a warp a (plane, sum), 54 of them
constexpr int TILE = 64;
constexpr int HALO = 3;
constexpr int TS = TILE + 2 * HALO;  // 70
constexpr int NV = 18;               // 9 sums a direction, 2 directions

// a __grid_constant__ parameter: indexed by plane in place, no local copy
struct Planes {
    const int32_t *d[3];
    const int32_t *s[3];
    int stride_d[3], stride_s[3], h[3], w[3];
    int tiles_x[3], first[4];  // tile columns; first tile of each plane
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// one direction's 9 sums at offset OFF of a thread's 18
template <int OFF>
__device__ __forceinline__ void accumulate(int (&a)[NV], int g0, int g1,
                                           int g2, int b) {
    a[OFF + 0] += g0 * g0;
    a[OFF + 1] += g0 * g1;
    a[OFF + 2] += g0 * g2;
    a[OFF + 3] += g1 * g1;
    a[OFF + 4] += g1 * g2;
    a[OFF + 5] += g2 * g2;
    a[OFF + 6] += g0 * b;
    a[OFF + 7] += g1 * b;
    a[OFF + 8] += g2 * b;
}

__global__ void __launch_bounds__(NT)
wiener_sums_kernel(const __grid_constant__ Planes P,
                   long long *__restrict__ part) {
    __shared__ int32_t tile[TS][TS + 1];
    __shared__ long long red[NT / 32][NV];
    const int bid = blockIdx.x, ntiles = gridDim.x;
    const int p = bid >= P.first[2] ? 2 : bid >= P.first[1] ? 1 : 0;
    const int local = bid - P.first[p];
    const int ty = local / P.tiles_x[p], tx = local - ty * P.tiles_x[p];
    const int y0 = ty * TILE, x0 = tx * TILE, h = P.h[p], w = P.w[p];
    const int32_t *d = P.d[p];
    const int sd = P.stride_d[p];
#pragma unroll 5
    for (int i = threadIdx.x; i < TS * TS; i += NT) {
        const int r = i / TS, c = i - r * TS;
        const int y = min(max(y0 - HALO + r, 0), h - 1);
        const int x = min(max(x0 - HALO + c, 0), w - 1);
        tile[r][c] = d[(size_t)y * sd + x];
    }
    __syncthreads();
    int acc[NV];
#pragma unroll
    for (int j = 0; j < NV; j++) acc[j] = 0;
    const int32_t *s = P.s[p];
    const int ss = P.stride_s[p];
    const int c = threadIdx.x & (TILE - 1), x = x0 + c;
    if (x < w) {
        for (int r = threadIdx.x / TILE; r < TILE && y0 + r < h;
             r += NT / TILE) {
            const int cc = tile[r + HALO][c + HALO];
            const int b = s[(size_t)(y0 + r) * ss + x] - cc;
            // f_k of each direction, k = 3, 2, 1
            const int *col = &tile[r + HALO][c + HALO];
            const int v3 = tile[r][c + HALO] + tile[r + 2 * HALO][c + HALO];
            const int v2 = tile[r + 1][c + HALO] + tile[r + 5][c + HALO];
            const int v1 = tile[r + 2][c + HALO] + tile[r + 4][c + HALO];
            const int h3 = col[-3] + col[3], h2 = col[-2] + col[2];
            const int h1 = col[-1] + col[1];
            accumulate<0>(acc, v3 - 2 * cc, v2 - 2 * cc, v1 - 2 * cc, b);
            accumulate<9>(acc, h3 - 2 * cc, h2 - 2 * cc, h1 - 2 * cc, b);
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < NV; j++) {
        const long long v = warp_sum((long long)acc[j]);
        if (lane == 0) red[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < NV) {
        long long t = 0;
#pragma unroll
        for (int k = 0; k < NT / 32; k++) t += red[k][threadIdx.x];
        part[(size_t)threadIdx.x * ntiles + bid] = t;
    }
}

__constant__ int kTapsMin[3] = {-5, -23, -17};
__constant__ int kTapsMax[3] = {10, 8, 46};

// a / b rounded to nearest (ties to even), as IEEE double division, by
// long division of the significands: __ddiv_rn's special-case path is a
// called subroutine, and a call puts the solve's live values on a stack.
// The solve's operands are finite with b nonzero, and every quotient lies
// far inside the normal range (its entries are exact integer sums up to
// 2^63 plus a ridge of at least 1e-3), so the exponent never leaves it.
__device__ __forceinline__ double div_rn(double a, double b) {
    const unsigned long long ua = __double_as_longlong(a);
    const unsigned long long ub = __double_as_longlong(b);
    const unsigned long long sign = (ua ^ ub) & (1ull << 63);
    constexpr unsigned long long FRAC = (1ull << 52) - 1;
    int ea = (int)((ua >> 52) & 0x7ff), eb = (int)((ub >> 52) & 0x7ff);
    unsigned long long ma = ua & FRAC, mb = ub & FRAC;
    if (ea == 0 && ma == 0) return __longlong_as_double(sign);  // +-0
    if (ea) {
        ma |= 1ull << 52;
    } else {  // subnormal: normalise
        ea = 1;
        while (!(ma >> 52)) { ma <<= 1; ea--; }
    }
    if (eb) {
        mb |= 1ull << 52;
    } else {
        eb = 1;
        while (!(mb >> 52)) { mb <<= 1; eb--; }
    }
    int e = ea - eb + 1023;
    if (ma < mb) {  // the significands' ratio into [1, 2)
        ma <<= 1;
        e--;
    }
    // 54 quotient bits: 53 of the result and a guard; rem != 0 the sticky
    unsigned long long q = 0, rem = ma;
    for (int i = 0; i < 54; i++) {
        q <<= 1;
        if (rem >= mb) {
            rem -= mb;
            q |= 1;
        }
        rem <<= 1;
    }
    unsigned long long mant = q >> 1;
    if ((q & 1) && (rem != 0 || (mant & 1))) mant++;
    if (mant >> 53) {
        mant >>= 1;
        e++;
    }
    return __longlong_as_double(sign | ((unsigned long long)e << 52)
                                | (mant & FRAC));
}

// Solve one direction's system from its summed (M, r); writes 3 taps.
// Every loop is unrolled and the pivot rows are exchanged by selects, so
// every index is a compile-time constant and A stays in registers.
__device__ __forceinline__ void solve3(const long long *m9, int chroma,
                                       int32_t *taps) {
    // M (symmetric) from its 6 distinct entries, augmented with r
    double A[3][4];
    const double m00 = (double)m9[0], m01 = (double)m9[1], m02 = (double)m9[2];
    const double m11 = (double)m9[3], m12 = (double)m9[4], m22 = (double)m9[5];
    A[0][0] = m00; A[0][1] = m01; A[0][2] = m02; A[0][3] = (double)m9[6];
    A[1][0] = m01; A[1][1] = m11; A[1][2] = m12; A[1][3] = (double)m9[7];
    A[2][0] = m02; A[2][1] = m12; A[2][2] = m22; A[2][3] = (double)m9[8];
    const double trace = __dadd_rn(__dadd_rn(m00, m11), m22);
    const double ridge = __dadd_rn(__dmul_rn(1e-6, trace), 1e-3);
#pragma unroll
    for (int i = 0; i < 3; i++) A[i][i] = __dadd_rn(A[i][i], ridge);
#pragma unroll
    for (int c = 0; c < 3; c++) {
        // the first row of largest |A[r][c]|, r >= c
        int piv = c;
        double big = fabs(A[c][c]);
#pragma unroll
        for (int r = c + 1; r < 3; r++) {
            const double v = fabs(A[r][c]);
            if (v > big) {
                big = v;
                piv = r;
            }
        }
#pragma unroll
        for (int r = c + 1; r < 3; r++) {
            const bool sw = piv == r;
#pragma unroll
            for (int k = 0; k < 4; k++) {
                const double a = A[c][k], b = A[r][k];
                A[c][k] = sw ? b : a;
                A[r][k] = sw ? a : b;
            }
        }
#pragma unroll
        for (int r = c + 1; r < 3; r++) {
            const double f = div_rn(A[r][c], A[c][c]);
#pragma unroll
            for (int k = c; k < 4; k++)
                A[r][k] = __dsub_rn(A[r][k], __dmul_rn(f, A[c][k]));
        }
    }
    double x[3];
    x[2] = div_rn(A[2][3], A[2][2]);
    x[1] = div_rn(__dsub_rn(A[1][3], __dmul_rn(A[1][2], x[2])), A[1][1]);
    x[0] = div_rn(__dsub_rn(__dsub_rn(A[0][3], __dmul_rn(A[0][1], x[1])),
                               __dmul_rn(A[0][2], x[2])),
                     A[0][0]);
#pragma unroll
    for (int i = 0; i < 3; i++) {
        const double t = rint(__dmul_rn(x[i], 128.0));
        int v = (int)fmin(fmax(t, (double)kTapsMin[i]), (double)kTapsMax[i]);
        if (chroma && i == 0) v = 0;
        taps[i] = v;
    }
}

__global__ void __launch_bounds__(NT2)
wiener_solve_kernel(const long long *__restrict__ part,
                    const __grid_constant__ Planes P, int ntiles,
                    int32_t *__restrict__ taps,
                    int32_t *__restrict__ en) {
    __shared__ long long sums[3][NV];
    __shared__ int32_t t3[6][3];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int pair = warp; pair < 3 * NV; pair += NT2 / 32) {
        const int p = pair / NV, j = pair - p * NV;
        const long long *q = part + (size_t)j * ntiles;
        // 8 loads a lane in flight
        long long v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        int t = P.first[p] + lane;
        for (; t + 7 * 32 < P.first[p + 1]; t += 8 * 32) {
#pragma unroll
            for (int u = 0; u < 8; u++) v[u] += q[t + 32 * u];
        }
        for (; t < P.first[p + 1]; t += 32) v[0] += q[t];
        const long long tot = warp_sum(((v[0] + v[1]) + (v[2] + v[3]))
                                       + ((v[4] + v[5]) + (v[6] + v[7])));
        if (lane == 0) sums[p][j] = tot;
    }
    __syncthreads();
    if (threadIdx.x < 6) {
        const int p = threadIdx.x >> 1, dir = threadIdx.x & 1;
        solve3(sums[p] + 9 * dir, p > 0, t3[threadIdx.x]);
        for (int i = 0; i < 3; i++) taps[threadIdx.x * 3 + i] = t3[threadIdx.x][i];
    }
    __syncthreads();
    if (threadIdx.x < 3) {
        int any = 0;
        for (int k = 0; k < 6; k++) any |= t3[2 * threadIdx.x + k / 3][k % 3];
        en[threadIdx.x] = any != 0;
    }
}

}  // namespace

// d*/s*: the degraded (post-CDEF) and source planes, int32, row strides
// sd*/ss*, h* x w* each.  part: int64 scratch of 18 * ntiles words, ntiles
// the 64x64 tiles of the three planes together.
extern "C" int wiener_solve(const void *d0, const void *s0, int sd0, int ss0,
                            int h0, int w0, const void *d1, const void *s1,
                            int sd1, int ss1, int h1, int w1, const void *d2,
                            const void *s2, int sd2, int ss2, int h2, int w2,
                            int ntiles, void *part, void *taps, void *en,
                            void *stream) {
    Planes P;
    const void *ds[3] = {d0, d1, d2}, *ss[3] = {s0, s1, s2};
    const int sds[3] = {sd0, sd1, sd2}, sss[3] = {ss0, ss1, ss2};
    const int hs[3] = {h0, h1, h2}, ws[3] = {w0, w1, w2};
    P.first[0] = 0;
    for (int p = 0; p < 3; p++) {
        if (hs[p] < 1 || ws[p] < 1) return (int)cudaErrorInvalidValue;
        P.d[p] = (const int32_t *)ds[p];
        P.s[p] = (const int32_t *)ss[p];
        P.stride_d[p] = sds[p];
        P.stride_s[p] = sss[p];
        P.h[p] = hs[p];
        P.w[p] = ws[p];
        P.tiles_x[p] = (ws[p] + TILE - 1) / TILE;
        P.first[p + 1] = P.first[p] + P.tiles_x[p] * ((hs[p] + TILE - 1) / TILE);
    }
    if (P.first[3] != ntiles) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    wiener_sums_kernel<<<ntiles, NT, 0, st>>>(P, (long long *)part);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    wiener_solve_kernel<<<1, NT2, 0, st>>>((const long long *)part, P, ntiles,
                                          (int32_t *)taps, (int32_t *)en);
    return (int)cudaGetLastError();
}
