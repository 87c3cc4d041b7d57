// K3 inv_txfm: normative AV1 inverse transform (spec 7.13.3), int32.
//
// Replaces rav1e_tpu/ops/transforms_jax.py:432 inv_txfm (with idct4..64 at
// 46-208, iadst4/8/16 at 299-363 and iidentity at 408), which the JAX
// package batches as whole-array butterfly networks.  Bit-exact with it and
// with ops/transforms_np.py: every product and rounding is int32, like the
// JAX version.
//
// Layout: one template instantiation per transform size (w, h) (the 19
// AV1 sizes), so every 1-D butterfly is fully unrolled on register arrays
// (ptxas: no stack frame, no spills).  A transform takes max(w, h)
// threads, a thread per row in pass 1 and per column in pass 2, and a CTA
// holds several transforms (8 a warp at 4x4, 4 at 8x8, 2 at 16x16; 1 to 8
// warps a CTA as the batch allows).  The CTA's coefficient blocks are read
// with coalesced 16-byte loads into shared memory, padded so that the
// row reads (16 bytes a thread) and the column reads (4 bytes a thread)
// of a warp hit distinct banks; the rows' results stay there for the
// columns, whose results go back in place, and the output (with the
// flips) leaves with 16-byte stores.  Optional: a fused reconstruction
// epilogue (pred: clamp(pred + residual, 0, maxval) is written instead of
// the residual) and the 64x64 transform of a 32x32 coefficient block (the
// coded corner; the other coefficients are zero, so they are neither
// stored nor read, and pass 1 runs 32 rows).
// Bound on the H100: bytes (each coefficient read once, each output
// written once, the prediction read once where it is fused); the
// butterflies are ~n log2(n) integer operations a line.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int32_t COSPI[64] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
    3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
    3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
    2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
    1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995,
    897,  799,  700,  601,  501,  401,  301,  201,  101};
__constant__ int32_t SINPI[5] = {0, 1321, 2482, 3344, 3803};
constexpr int32_t SQRT2 = 5793;
constexpr int32_t INV_SQRT2 = 2896;

// tx_type -> vert kind, horz kind, flip_v, flip_h; kind 0=dct 1=adst 2=id
__constant__ int32_t TX1D[16][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {0, 1, 0, 0}, {1, 1, 0, 0},
    {1, 0, 1, 0}, {0, 1, 0, 1}, {1, 1, 1, 1}, {1, 1, 0, 1},
    {1, 1, 1, 0}, {2, 2, 0, 0}, {0, 2, 0, 0}, {2, 0, 0, 0},
    {1, 2, 0, 0}, {2, 1, 0, 0}, {1, 2, 1, 0}, {2, 1, 0, 1},
};

typedef int32_t T;

__device__ __forceinline__ T round2(T x, int bit) { return (x + (1 << (bit - 1))) >> bit; }
__device__ __forceinline__ T hb(T w0, T x0, T w1, T x1) { return round2(w0 * x0 + w1 * x1, 12); }
#define C(i) (COSPI[i])

template <int st>
__device__ __forceinline__ void idct4(const T *x, T *o) {
    T s0 = x[0], s1 = x[2 * st], s2 = x[st], s3 = x[3 * st];
    T b0 = hb(C(32), s0, C(32), s1);
    T b1 = hb(C(32), s0, -C(32), s1);
    T b2 = hb(C(48), s2, -C(16), s3);
    T b3 = hb(C(16), s2, C(48), s3);
    o[0] = b0 + b3;
    o[1] = b1 + b2;
    o[2] = b1 - b2;
    o[3] = b0 - b3;
}

template <int st>
__device__ __forceinline__ void idct8(const T *x, T *o) {
    T ev[4];
    idct4<2 * st>(x, ev);
    T s4 = x[st], s5 = x[5 * st], s6 = x[3 * st], s7 = x[7 * st];
    T b4 = hb(C(56), s4, -C(8), s7);
    T b5 = hb(C(24), s5, -C(40), s6);
    T b6 = hb(C(40), s5, C(24), s6);
    T b7 = hb(C(8), s4, C(56), s7);
    T t4 = b4 + b5, t5 = b4 - b5, t6 = -b6 + b7, t7 = b6 + b7;
    b5 = hb(-C(32), t5, C(32), t6);
    b6 = hb(C(32), t5, C(32), t6);
    o[0] = ev[0] + t7;
    o[1] = ev[1] + b6;
    o[2] = ev[2] + b5;
    o[3] = ev[3] + t4;
    o[4] = ev[3] - t4;
    o[5] = ev[2] - b5;
    o[6] = ev[1] - b6;
    o[7] = ev[0] - t7;
}

template <int st>
__device__ __forceinline__ void idct16(const T *x, T *o) {
    T ev[8];
    idct8<2 * st>(x, ev);
    T s8 = x[st], s9 = x[9 * st], s10 = x[5 * st], s11 = x[13 * st];
    T s12 = x[3 * st], s13 = x[11 * st], s14 = x[7 * st], s15 = x[15 * st];
    T b8 = hb(C(60), s8, -C(4), s15);
    T b15 = hb(C(4), s8, C(60), s15);
    T b9 = hb(C(28), s9, -C(36), s14);
    T b14 = hb(C(36), s9, C(28), s14);
    T b10 = hb(C(44), s10, -C(20), s13);
    T b13 = hb(C(20), s10, C(44), s13);
    T b11 = hb(C(12), s11, -C(52), s12);
    T b12 = hb(C(52), s11, C(12), s12);
    T t8 = b8 + b9, t9 = b8 - b9, t10 = -b10 + b11, t11 = b10 + b11;
    T t12 = b12 + b13, t13 = b12 - b13, t14 = -b14 + b15, t15 = b14 + b15;
    b9 = hb(-C(16), t9, C(48), t14);
    b14 = hb(C(48), t9, C(16), t14);
    b10 = hb(-C(48), t10, -C(16), t13);
    b13 = hb(-C(16), t10, C(48), t13);
    T u8 = t8 + t11, u9 = b9 + b10, u10 = b9 - b10, u11 = t8 - t11;
    T u12 = -t12 + t15, u13 = -b13 + b14, u14 = b13 + b14, u15 = t12 + t15;
    T v10 = hb(-C(32), u10, C(32), u13);
    T v13 = hb(C(32), u10, C(32), u13);
    T v11 = hb(-C(32), u11, C(32), u12);
    T v12 = hb(C(32), u11, C(32), u12);
    T odd[8] = {u8, u9, v10, v11, v12, v13, u14, u15};
    #pragma unroll
    for (int i = 0; i < 8; i++) {
        o[i] = ev[i] + odd[7 - i];
        o[8 + i] = ev[7 - i] - odd[i];
    }
}

template <int st>
__device__ __forceinline__ void idct32(const T *x, T *o) {
    T ev[16];
    idct16<2 * st>(x, ev);
    const int idx[16] = {1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31};
    const int ang[8] = {62, 30, 46, 14, 54, 22, 38, 6};
    T s[16], b[16], t[16];
    #pragma unroll
    for (int k = 0; k < 16; k++) s[k] = x[idx[k] * st];
    #pragma unroll
    for (int k = 0; k < 8; k++) {
        b[k] = hb(C(ang[k]), s[k], -C(64 - ang[k]), s[15 - k]);
        b[15 - k] = hb(C(64 - ang[k]), s[k], C(ang[k]), s[15 - k]);
    }
    #pragma unroll
    for (int p = 0; p < 8; p++) {
        int i = 2 * p;
        if (p % 2 == 0) {
            t[i] = b[i] + b[i + 1];
            t[i + 1] = b[i] - b[i + 1];
        } else {
            t[i] = -b[i] + b[i + 1];
            t[i + 1] = b[i] + b[i + 1];
        }
    }
    #pragma unroll
    for (int k = 0; k < 16; k++) b[k] = t[k];
    b[1] = hb(-C(8), t[1], C(56), t[14]);
    b[14] = hb(C(56), t[1], C(8), t[14]);
    b[2] = hb(-C(56), t[2], -C(8), t[13]);
    b[13] = hb(-C(8), t[2], C(56), t[13]);
    b[5] = hb(-C(40), t[5], C(24), t[10]);
    b[10] = hb(C(24), t[5], C(40), t[10]);
    b[6] = hb(-C(24), t[6], -C(40), t[9]);
    b[9] = hb(-C(40), t[6], C(24), t[9]);
    #pragma unroll
    for (int g = 0; g < 4; g++) {
        int base = 4 * g;
        if (g % 2 == 0) {
            t[base + 0] = b[base + 0] + b[base + 3];
            t[base + 1] = b[base + 1] + b[base + 2];
            t[base + 2] = b[base + 1] - b[base + 2];
            t[base + 3] = b[base + 0] - b[base + 3];
        } else {
            t[base + 0] = -b[base + 0] + b[base + 3];
            t[base + 1] = -b[base + 1] + b[base + 2];
            t[base + 2] = b[base + 1] + b[base + 2];
            t[base + 3] = b[base + 0] + b[base + 3];
        }
    }
    #pragma unroll
    for (int k = 0; k < 16; k++) b[k] = t[k];
    b[2] = hb(-C(16), t[2], C(48), t[13]);
    b[13] = hb(C(48), t[2], C(16), t[13]);
    b[3] = hb(-C(16), t[3], C(48), t[12]);
    b[12] = hb(C(48), t[3], C(16), t[12]);
    b[4] = hb(-C(48), t[4], -C(16), t[11]);
    b[11] = hb(-C(16), t[4], C(48), t[11]);
    b[5] = hb(-C(48), t[5], -C(16), t[10]);
    b[10] = hb(-C(16), t[5], C(48), t[10]);
    #pragma unroll
    for (int k = 0; k < 4; k++) {
        t[k] = b[k] + b[7 - k];
        t[7 - k] = b[k] - b[7 - k];
        t[8 + k] = -b[8 + k] + b[15 - k];
        t[15 - k] = b[8 + k] + b[15 - k];
    }
    #pragma unroll
    for (int k = 0; k < 16; k++) b[k] = t[k];
    #pragma unroll
    for (int k = 4; k < 8; k++) {
        b[k] = hb(-C(32), t[k], C(32), t[15 - k]);
        b[15 - k] = hb(C(32), t[k], C(32), t[15 - k]);
    }
    #pragma unroll
    for (int i = 0; i < 16; i++) {
        o[i] = ev[i] + b[15 - i];
        o[16 + i] = ev[15 - i] - b[i];
    }
}

__device__ __forceinline__ void tw64(T *b, const T *t, int i, int j, int a, bool neg) {
    T ti = t[i], tj = t[j];
    if (!neg) {
        b[i] = hb(-C(a), ti, C(64 - a), tj);
        b[j] = hb(C(64 - a), ti, C(a), tj);
    } else {
        b[i] = hb(-C(64 - a), ti, -C(a), tj);
        b[j] = hb(-C(a), ti, C(64 - a), tj);
    }
}

template <int st>
__device__ __forceinline__ void idct64(const T *x, T *o) {
    T ev[32];
    idct32<2 * st>(x, ev);
    const int idx[32] = {1, 33, 17, 49, 9,  41, 25, 57, 5,  37, 21,
                         53, 13, 45, 29, 61, 3,  35, 19, 51, 11, 43,
                         27, 59, 7,  39, 23, 55, 15, 47, 31, 63};
    const int ang[16] = {63, 31, 47, 15, 55, 23, 39, 7,
                         59, 27, 43, 11, 51, 19, 35, 3};
    T s[32], b[32], t[32];
    #pragma unroll
    for (int k = 0; k < 32; k++) s[k] = x[idx[k] * st];
    #pragma unroll
    for (int k = 0; k < 16; k++) {
        b[k] = hb(C(ang[k]), s[k], -C(64 - ang[k]), s[31 - k]);
        b[31 - k] = hb(C(64 - ang[k]), s[k], C(ang[k]), s[31 - k]);
    }
    #pragma unroll
    for (int p = 0; p < 16; p++) {
        int i = 2 * p;
        if (p % 2 == 0) {
            t[i] = b[i] + b[i + 1];
            t[i + 1] = b[i] - b[i + 1];
        } else {
            t[i] = -b[i] + b[i + 1];
            t[i + 1] = b[i] + b[i + 1];
        }
    }
    #pragma unroll
    for (int k = 0; k < 32; k++) b[k] = t[k];
    tw64(b, t, 1, 30, 4, false);
    tw64(b, t, 2, 29, 4, true);
    tw64(b, t, 5, 26, 36, false);
    tw64(b, t, 6, 25, 36, true);
    tw64(b, t, 9, 22, 20, false);
    tw64(b, t, 10, 21, 20, true);
    tw64(b, t, 13, 18, 52, false);
    tw64(b, t, 14, 17, 52, true);
    #pragma unroll
    for (int g = 0; g < 8; g++) {
        int base = 4 * g;
        if (g % 2 == 0) {
            t[base + 0] = b[base + 0] + b[base + 3];
            t[base + 1] = b[base + 1] + b[base + 2];
            t[base + 2] = b[base + 1] - b[base + 2];
            t[base + 3] = b[base + 0] - b[base + 3];
        } else {
            t[base + 0] = -b[base + 0] + b[base + 3];
            t[base + 1] = -b[base + 1] + b[base + 2];
            t[base + 2] = b[base + 1] + b[base + 2];
            t[base + 3] = b[base + 0] + b[base + 3];
        }
    }
    #pragma unroll
    for (int k = 0; k < 32; k++) b[k] = t[k];
    tw64(b, t, 2, 29, 8, false);
    tw64(b, t, 3, 28, 8, false);
    tw64(b, t, 4, 27, 8, true);
    tw64(b, t, 5, 26, 8, true);
    tw64(b, t, 10, 21, 40, false);
    tw64(b, t, 11, 20, 40, false);
    tw64(b, t, 12, 19, 40, true);
    tw64(b, t, 13, 18, 40, true);
    #pragma unroll
    for (int g = 0; g < 4; g++) {
        int base = 8 * g;
        #pragma unroll
        for (int k = 0; k < 4; k++) {
            if (g % 2 == 0) {
                t[base + k] = b[base + k] + b[base + 7 - k];
                t[base + 7 - k] = b[base + k] - b[base + 7 - k];
            } else {
                t[base + k] = -b[base + k] + b[base + 7 - k];
                t[base + 7 - k] = b[base + k] + b[base + 7 - k];
            }
        }
    }
    #pragma unroll
    for (int k = 0; k < 32; k++) b[k] = t[k];
    tw64(b, t, 4, 27, 16, false);
    tw64(b, t, 5, 26, 16, false);
    tw64(b, t, 6, 25, 16, false);
    tw64(b, t, 7, 24, 16, false);
    tw64(b, t, 8, 23, 16, true);
    tw64(b, t, 9, 22, 16, true);
    tw64(b, t, 10, 21, 16, true);
    tw64(b, t, 11, 20, 16, true);
    #pragma unroll
    for (int k = 0; k < 8; k++) {
        t[k] = b[k] + b[15 - k];
        t[15 - k] = b[k] - b[15 - k];
        t[16 + k] = -b[16 + k] + b[31 - k];
        t[31 - k] = b[16 + k] + b[31 - k];
    }
    #pragma unroll
    for (int k = 0; k < 32; k++) b[k] = t[k];
    #pragma unroll
    for (int k = 8; k < 16; k++) {
        b[k] = hb(-C(32), t[k], C(32), t[31 - k]);
        b[31 - k] = hb(C(32), t[k], C(32), t[31 - k]);
    }
    #pragma unroll
    for (int i = 0; i < 32; i++) {
        o[i] = ev[i] + b[31 - i];
        o[32 + i] = ev[31 - i] - b[i];
    }
}

template <int st>
__device__ __forceinline__ void iadst4(const T *x, T *o) {
    T x0 = x[0], x1 = x[st], x2 = x[2 * st], x3 = x[3 * st];
    T s0 = SINPI[1] * x0, s1 = SINPI[2] * x0, s2 = SINPI[3] * x1;
    T s3 = SINPI[4] * x2, s4 = SINPI[1] * x2, s5 = SINPI[2] * x3;
    T s6 = SINPI[4] * x3;
    T b7 = (x0 - x2) + x3;
    s0 = s0 + s3;
    s1 = s1 - s4;
    T s3b = s2;
    s2 = SINPI[3] * b7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    o[0] = round2(s0 + s3b, 12);
    o[1] = round2(s1 + s3b, 12);
    o[2] = round2(s2, 12);
    o[3] = round2(s0 + s1 - s3b, 12);
}

template <int st>
__device__ __forceinline__ void iadst8(const T *x, T *o) {
    T s[8] = {x[7 * st], x[0], x[5 * st], x[2 * st],
              x[3 * st], x[4 * st], x[st], x[6 * st]};
    T b0 = hb(C(4), s[0], C(60), s[1]);
    T b1 = hb(C(60), s[0], -C(4), s[1]);
    T b2 = hb(C(20), s[2], C(44), s[3]);
    T b3 = hb(C(44), s[2], -C(20), s[3]);
    T b4 = hb(C(36), s[4], C(28), s[5]);
    T b5 = hb(C(28), s[4], -C(36), s[5]);
    T b6 = hb(C(52), s[6], C(12), s[7]);
    T b7 = hb(C(12), s[6], -C(52), s[7]);
    T s0 = b0 + b4, s1 = b1 + b5, s2 = b2 + b6, s3 = b3 + b7;
    T s4 = b0 - b4, s5 = b1 - b5, s6 = b2 - b6, s7 = b3 - b7;
    b4 = hb(C(16), s4, C(48), s5);
    b5 = hb(C(48), s4, -C(16), s5);
    b6 = hb(-C(48), s6, C(16), s7);
    b7 = hb(C(16), s6, C(48), s7);
    T t0 = s0 + s2, t1 = s1 + s3, t2 = s0 - s2, t3 = s1 - s3;
    T t4 = b4 + b6, t5 = b5 + b7, t6 = b4 - b6, t7 = b5 - b7;
    T c2 = hb(C(32), t2, C(32), t3);
    T c3 = hb(C(32), t2, -C(32), t3);
    T c6 = hb(C(32), t6, C(32), t7);
    T c7 = hb(C(32), t6, -C(32), t7);
    o[0] = t0;
    o[1] = -t4;
    o[2] = c6;
    o[3] = -c2;
    o[4] = c3;
    o[5] = -c7;
    o[6] = t5;
    o[7] = -t1;
}

template <int st>
__device__ __forceinline__ void iadst16(const T *x, T *o) {
    T s[16] = {x[15 * st], x[0],       x[13 * st], x[2 * st],
               x[11 * st], x[4 * st],  x[9 * st],  x[6 * st],
               x[7 * st],  x[8 * st],  x[5 * st],  x[10 * st],
               x[3 * st],  x[12 * st], x[st],      x[14 * st]};
    const int ang[8] = {2, 10, 18, 26, 34, 42, 50, 58};
    T b[16], t[16];
    #pragma unroll
    for (int k = 0; k < 8; k++) {
        int a = ang[k];
        b[2 * k] = hb(C(a), s[2 * k], C(64 - a), s[2 * k + 1]);
        b[2 * k + 1] = hb(C(64 - a), s[2 * k], -C(a), s[2 * k + 1]);
    }
    #pragma unroll
    for (int i = 0; i < 8; i++) {
        t[i] = b[i] + b[i + 8];
        t[i + 8] = b[i] - b[i + 8];
    }
    #pragma unroll
    for (int k = 0; k < 16; k++) b[k] = t[k];
    b[8] = hb(C(8), t[8], C(56), t[9]);
    b[9] = hb(C(56), t[8], -C(8), t[9]);
    b[10] = hb(C(40), t[10], C(24), t[11]);
    b[11] = hb(C(24), t[10], -C(40), t[11]);
    b[12] = hb(-C(56), t[12], C(8), t[13]);
    b[13] = hb(C(8), t[12], C(56), t[13]);
    b[14] = hb(-C(24), t[14], C(40), t[15]);
    b[15] = hb(C(40), t[14], C(24), t[15]);
    #pragma unroll
    for (int i = 0; i < 4; i++) {
        t[i] = b[i] + b[i + 4];
        t[i + 4] = b[i] - b[i + 4];
        t[8 + i] = b[8 + i] + b[12 + i];
        t[12 + i] = b[8 + i] - b[12 + i];
    }
    #pragma unroll
    for (int k = 0; k < 16; k++) b[k] = t[k];
    #pragma unroll
    for (int base = 4; base <= 12; base += 8) {
        b[base + 0] = hb(C(16), t[base + 0], C(48), t[base + 1]);
        b[base + 1] = hb(C(48), t[base + 0], -C(16), t[base + 1]);
        b[base + 2] = hb(-C(48), t[base + 2], C(16), t[base + 3]);
        b[base + 3] = hb(C(16), t[base + 2], C(48), t[base + 3]);
    }
    #pragma unroll
    for (int g = 0; g < 4; g++) {
        int base = 4 * g;
        t[base + 0] = b[base + 0] + b[base + 2];
        t[base + 1] = b[base + 1] + b[base + 3];
        t[base + 2] = b[base + 0] - b[base + 2];
        t[base + 3] = b[base + 1] - b[base + 3];
    }
    #pragma unroll
    for (int k = 0; k < 16; k++) b[k] = t[k];
    #pragma unroll
    for (int base = 2; base <= 14; base += 4) {
        b[base] = hb(C(32), t[base], C(32), t[base + 1]);
        b[base + 1] = hb(C(32), t[base], -C(32), t[base + 1]);
    }
    const int perm[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    #pragma unroll
    for (int i = 0; i < 16; i++) o[i] = (i & 1) ? -b[perm[i]] : b[perm[i]];
}

template <int N>
__device__ __forceinline__ void iidentity(const T *x, T *o) {
#pragma unroll
    for (int i = 0; i < N; i++) {
        const T v = x[i];
        if (N == 4) o[i] = round2(v * SQRT2, 12);
        else if (N == 8) o[i] = v * 2;
        else if (N == 16) o[i] = round2(v * 2 * SQRT2, 12);
        else o[i] = v * 4;
    }
}

// kind 0 DCT, 1 ADST (n <= 16), 2 identity (n <= 32); a kind the size
// lacks (no stream signals one) takes the DCT
template <int N>
__device__ __forceinline__ void apply_1d(int kind, const T *in, T *out) {
    if constexpr (N <= 16) {
        if (kind == 1) {
            if constexpr (N == 4) iadst4<1>(in, out);
            else if constexpr (N == 8) iadst8<1>(in, out);
            else iadst16<1>(in, out);
            return;
        }
    }
    if constexpr (N <= 32) {
        if (kind == 2) {
            iidentity<N>(in, out);
            return;
        }
    }
    if constexpr (N == 4) idct4<1>(in, out);
    else if constexpr (N == 8) idct8<1>(in, out);
    else if constexpr (N == 16) idct16<1>(in, out);
    else if constexpr (N == 32) idct32<1>(in, out);
    else idct64<1>(in, out);
}

struct K3Args {
    const int32_t *coeffs, *types, *pred;
    int32_t *out;
    // transform b's coefficients start at ((b / cdiv) % cmod) * cstride,
    // its type at ((b / tdiv) % tmod) * tstride (or tx0 without types)
    unsigned nb, cdiv, cmod, cstride, tdiv, tmod, tstride;
    int tx0, row_shift, col_shift, lim, maxval;
};

// Z: a 64x64 transform of a 32x32 coefficient block
template <int W, int H, bool Z>
struct Geo {
    static constexpr int WI = Z ? 32 : W;         // coefficient columns
    static constexpr int HI = Z ? 32 : H;         // coefficient rows (pass 1)
    static constexpr int TPT = W > H ? W : H;     // threads a transform
    static constexpr int RS = W == 4 ? 4 : W + 4;  // row stride: odd in 16 B
    static constexpr int TS0 = H * RS;
    // transform stride: at TPT < 32 (several transforms a warp) the same
    // column of the warp's transforms falls TPT banks apart
    static constexpr int TS =
        TPT >= 32 ? TS0 : TS0 + ((TPT - TS0 % 32) % 32 + 32) % 32;
    static constexpr bool RECT2 = W == 2 * H || H == 2 * W;
};

__device__ __forceinline__ int tx_type_of(const K3Args &a, unsigned b) {
    return a.types ? __ldg(a.types + ((b / a.tdiv) % a.tmod) * a.tstride)
                   : a.tx0;
}

template <int W, int H, bool Z>
__global__ void __launch_bounds__(256) inv_txfm_kernel(const K3Args a) {
    using Gm = Geo<W, H, Z>;
    extern __shared__ int4 smem4[];
    int32_t *sm = reinterpret_cast<int32_t *>(smem4);
    const int tpc = blockDim.x / Gm::TPT;
    const int j = threadIdx.x / Gm::TPT, t = threadIdx.x % Gm::TPT;
    const unsigned blk0 = blockIdx.x * (unsigned)tpc;
    constexpr int UI = Gm::HI * Gm::WI / 4;  // 16-byte units a block
    for (int i = threadIdx.x; i < tpc * UI; i += blockDim.x) {
        const int jj = i / UI, u = i % UI;
        const unsigned b = blk0 + jj;
        int4 v = make_int4(0, 0, 0, 0);
        if (b < a.nb)
            v = __ldg(reinterpret_cast<const int4 *>(
                a.coeffs + (size_t)((b / a.cdiv) % a.cmod) * a.cstride) + u);
        const int r = u / (Gm::WI / 4), c = (u % (Gm::WI / 4)) * 4;
        *reinterpret_cast<int4 *>(sm + jj * Gm::TS + r * Gm::RS + c) = v;
    }
    __syncthreads();
    const unsigned blk = blk0 + j;
    const int type = blk < a.nb ? tx_type_of(a, blk) : 0;
    int32_t *ms = sm + j * Gm::TS;
    if (t < Gm::HI) {  // pass 1: row t
        T x[W], y[W];
#pragma unroll
        for (int c = 0; c < Gm::WI; c += 4) {
            const int4 q = *reinterpret_cast<const int4 *>(ms + t * Gm::RS + c);
            x[c] = q.x;
            x[c + 1] = q.y;
            x[c + 2] = q.z;
            x[c + 3] = q.w;
        }
#pragma unroll
        for (int c = Gm::WI; c < W; c++) x[c] = 0;
        if (Gm::RECT2) {
#pragma unroll
            for (int c = 0; c < W; c++) x[c] = round2(x[c] * INV_SQRT2, 12);
        }
        apply_1d<W>(TX1D[type][1], x, y);
#pragma unroll
        for (int c = 0; c < W; c++) {
            const T v = a.row_shift ? round2(y[c], a.row_shift) : y[c];
            y[c] = min(max(v, -a.lim), a.lim - 1);
        }
#pragma unroll
        for (int c = 0; c < W; c += 4)
            *reinterpret_cast<int4 *>(ms + t * Gm::RS + c) =
                make_int4(y[c], y[c + 1], y[c + 2], y[c + 3]);
    }
    __syncthreads();
    if (t < W) {  // pass 2: column t, in place
        T x[H], y[H];
#pragma unroll
        for (int r = 0; r < Gm::HI; r++) x[r] = ms[r * Gm::RS + t];
#pragma unroll
        for (int r = Gm::HI; r < H; r++) x[r] = 0;
        apply_1d<H>(TX1D[type][0], x, y);
#pragma unroll
        for (int r = 0; r < H; r++) ms[r * Gm::RS + t] = round2(y[r], a.col_shift);
    }
    __syncthreads();
    constexpr int UO = H * W / 4;
    for (int i = threadIdx.x; i < tpc * UO; i += blockDim.x) {
        const int jj = i / UO, u = i % UO;
        const unsigned b = blk0 + jj;
        if (b >= a.nb) continue;
        const int ty = tx_type_of(a, b);
        const int r = u / (W / 4), c = (u % (W / 4)) * 4;
        const int32_t *row = sm + jj * Gm::TS
                             + (TX1D[ty][2] ? H - 1 - r : r) * Gm::RS;
        int4 v;
        if (TX1D[ty][3]) {
            const int4 q = *reinterpret_cast<const int4 *>(row + W - 4 - c);
            v = make_int4(q.w, q.z, q.y, q.x);
        } else {
            v = *reinterpret_cast<const int4 *>(row + c);
        }
        const size_t o = (size_t)b * (H * W) + r * W + c;
        if (a.pred) {
            const int4 p = __ldg(reinterpret_cast<const int4 *>(a.pred + o));
            v = make_int4(min(max(p.x + v.x, 0), a.maxval),
                          min(max(p.y + v.y, 0), a.maxval),
                          min(max(p.z + v.z, 0), a.maxval),
                          min(max(p.w + v.w, 0), a.maxval));
        }
        *reinterpret_cast<int4 *>(a.out + o) = v;
    }
}

template <int W, int H, bool Z>
int run(const K3Args &a, cudaStream_t s) {
    using Gm = Geo<W, H, Z>;
    // warps a CTA: 1 while the batch fills fewer than ~2 CTAs an SM, up to
    // 8 as it grows (each at least one transform's threads)
    const long warps = ((long)a.nb * Gm::TPT + 31) / 32;
    const int wpc = warps >= 8L * 264 ? 8 : warps >= 4L * 264 ? 4
                    : warps >= 2L * 264 ? 2 : 1;
    int tpc = (wpc * 32 > Gm::TPT ? wpc * 32 : Gm::TPT) / Gm::TPT;
    while (tpc > 1 && (size_t)tpc * Gm::TS * 4 > 48 * 1024) tpc--;
    const unsigned blocks = (a.nb + tpc - 1) / tpc;
    inv_txfm_kernel<W, H, Z><<<blocks, tpc * Gm::TPT,
                               (size_t)tpc * Gm::TS * sizeof(int32_t), s>>>(a);
    return 0;
}

int dispatch(int w, int h, int z, const K3Args &a, cudaStream_t s) {
#define SIZE(W, H) \
    if (w == W && h == H) return run<W, H, false>(a, s);
    if (z) return w == 64 && h == 64 ? run<64, 64, true>(a, s) : -1;
    SIZE(4, 4) SIZE(8, 8) SIZE(16, 16) SIZE(32, 32) SIZE(64, 64)
    SIZE(4, 8) SIZE(8, 4) SIZE(8, 16) SIZE(16, 8) SIZE(16, 32) SIZE(32, 16)
    SIZE(32, 64) SIZE(64, 32) SIZE(4, 16) SIZE(16, 4) SIZE(8, 32) SIZE(32, 8)
    SIZE(16, 64) SIZE(64, 16)
#undef SIZE
    return -1;
}

}  // namespace

// ptrs: coeffs, types (or null: tx0 for every block), pred (or null: the
//   residual is written), out;
// ints: n_blocks, w, h, z (1: a 64x64 transform of 32x32 coefficients),
//   cdiv, cmod, cstride, tdiv, tmod, tstride, tx0, row_shift, col_shift,
//   lim, maxval.
// coeffs: each block (h, w) (z: (32, 32)) int32 rows of stride w, 16-byte
// aligned, at the layout's offsets; pred/out: (n_blocks, h, w) int32.
extern "C" int inv_txfm(void *const *ptrs, const int *ints, void *stream) {
    K3Args a;
    a.coeffs = (const int32_t *)ptrs[0];
    a.types = (const int32_t *)ptrs[1];
    a.pred = (const int32_t *)ptrs[2];
    a.out = (int32_t *)ptrs[3];
    a.nb = (unsigned)ints[0];
    a.cdiv = (unsigned)ints[4];
    a.cmod = (unsigned)ints[5];
    a.cstride = (unsigned)ints[6];
    a.tdiv = (unsigned)ints[7];
    a.tmod = (unsigned)ints[8];
    a.tstride = (unsigned)ints[9];
    a.tx0 = ints[10];
    a.row_shift = ints[11];
    a.col_shift = ints[12];
    a.lim = ints[13];
    a.maxval = ints[14];
    if (ints[0] > 0 && dispatch(ints[1], ints[2], ints[3], a, (cudaStream_t)stream) != 0)
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
