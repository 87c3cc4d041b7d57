// K9 mc_pred: single-reference 8-tap separable subpel motion compensation
// of a batch of same-size blocks (spec 7.11.3.4 block_inter_prediction,
// unscaled, non-compound), bit-exact.
//
// Replaces rav1e_tpu/ops/mc_jax.py:71 mc_block_batch (jit :109
// _put_batch_jit), as run by models/wavefront.py:416 _inter_level for
// every inter candidate of the P-frame pass.  The TPU version gathers
// every block's window with a vmapped dynamic_slice and runs the two
// passes as eight broadcast multiply-adds each over the whole batch.
//
// Three modes, one kernel (ops/mc.py mc_block_batch):
//   prediction: the clipped prediction, int32 (N, h, w);
//   residual (src given): the source block at the block's own plane
//     position minus the prediction, int32, and no prediction written:
//     the candidate race feeds it to K2 as it is;
//   two planes (U and V: grid.y = 2, the same positions and MVs): the
//     output is (N, 2, h, w), the prediction, the residual or both.
// Block b takes its position from entry b / cands of px, py (the race's
// Cn candidates of one block share it) and its MV from entry b.
//
// A thread owns 4 adjacent columns of one block and a strip of R rows
// (R = 16, or the width below 16, or 4 where a call has too few blocks to
// fill the card with strips of 16; the width W and R are templates: W 4,
// 8, 16, 32, 64; the height a runtime h <= 64), and works in registers
// only (at most 64 a thread at widths 8-64, so 4 CTAs of 256 share an
// SM): no
// shared memory and no barrier, so warps never wait on each other and
// every load is in flight as early as its address is known.  It walks
// the R + 7 window rows its outputs need, from the (h + 7) x (w + 7)
// window at ((py << 4) + (mvr << (1 - sub_y))) >> 4 minus 3 (rows;
// columns alike) plus the margin:
//   1. each row's 11 samples (its 4 columns and the 7 the taps reach) come
//      as aligned 32-bit words (4 uint8 or 2 uint16 samples each) from the
//      L1-cached plane, funnel-shifted to the window's offset;
//   2. horizontal pass: 4 outputs from the 11 samples, at 8 bits two dp4a
//      an output (4 unsigned samples by 4 int8 taps), above 8 multiply-
//      adds; rounded (x + 4) >> 3 (InterRound0 = 3; 5 at 12 bits) into a
//      rolling window of the last 8 rows (int16 values, two a word;
//      below);
//   3. vertical pass: once 8 rows are in, an output row: two rows of a
//      column packed into one word take one dp2a (2 int16 by 2 int8
//      taps), 4 an output; rounded (x + 1024) >> 11 (InterRound1 = 11; 9
//      at 12 bits), clipped to [0, (1 << bd) - 1] and stored 16 bytes a
//      row (the residual mode subtracts it from the source's 4 samples,
//      read in one load where aligned).
// The horizontal pass runs (R + 7) / R times for each output row (1.44 at
// R = 16), the price of keeping no tile.  The phase-0 pass (taps 0 0 0
// 128 0 0 0 0 in every set) is the sample times 128; every other phase's
// taps lie in [-24, 126] and pack as int8 (the wrapper checks a table's
// both).  The integer pipe issues 64 multiply-adds an SM a clock, so the
// dot-product instructions, four or two multiply-adds each, set the pace.
// The 1/16-pel phase is start & 15 per axis; the 16 x 8 tap table of the
// caller's filter set is a __grid_constant__ kernel parameter (512
// bytes).  Window rows are clamped to the plane, and a thread whose
// aligned words would leave its row (or a plane whose rows are not 4-byte
// aligned) reads a sample at a time with its columns clamped too, so a
// read can never leave the plane; the caller's MV clip and margin keep
// every window inside, so the clamp never changes a sample (the plain
// version asserts it).  One integer division a thread finds its block; no
// index divides per sample.
//
// int16 holds the horizontal pass: over the six filter sets a phase's
// positive taps sum to at most 184 and its negative ones to at least -56,
// so with samples in [0, 2^bd) the rounded sum lies in [-1785, 5865] at 8
// bits, [-7161, 23529] at 10 and [-7166, 23546] at 12 (InterRound0 = 5).
// The wrapper checks any other table against the same bound.
//
// Bound on the H100: bytes (the int32 output, 4 bytes a sample, against
// ~25 integer instructions a sample).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
// CTAs an SM: at most 64 registers a thread (85 at width 4, where 64
// would spill)
constexpr int MIN_CTAS = 4;
constexpr int HMAX = 64;
// threads below which a call takes strips of 4 rows, not 16: two waves
// of the card's 132 SMs
constexpr long long SMALL = 132LL * 2 * NT;

struct Taps {
    int32_t t[16][8];
};

// kernel parameters, __grid_constant__: ref[p] and src[p] are indexed by
// plane in place, with no local copy
struct Args {
    const void *ref[2];
    const void *src[2];
    int stride, ref_h, ref_w, margin, src_stride;
    const int32_t *px, *py, *mvr, *mvc;
    int n, cands, h, sub_x, sub_y, bd;
    int vec;  // the planes' rows start 4-byte aligned
    int32_t *pred, *resid;
};

// dp4a of four unsigned samples by four signed int8 taps, plus c
__device__ __forceinline__ int dp4a_us(uint32_t a, int b, int c) {
    int d;
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// four taps (each in [-128, 127]) as the signed bytes of a word
__device__ __forceinline__ int pack4(const int *t) {
    return (t[0] & 255) | ((t[1] & 255) << 8) | ((t[2] & 255) << 16)
           | (int)((uint32_t)(t[3] & 255) << 24);
}

// 4 adjacent samples from a 4 * sizeof(T)-aligned address
__device__ __forceinline__ void load4(const uint8_t *p, int (&v)[4]) {
    const uint32_t w = *reinterpret_cast<const uint32_t *>(p);
#pragma unroll
    for (int c = 0; c < 4; c++) v[c] = (w >> (8 * c)) & 255;
}

__device__ __forceinline__ void load4(const uint16_t *p, int (&v)[4]) {
    const uint2 w = *reinterpret_cast<const uint2 *>(p);
    v[0] = w.x & 65535;
    v[1] = w.x >> 16;
    v[2] = w.y & 65535;
    v[3] = w.y >> 16;
}

// One window row's samples x .. x + 10 (x .. x + 11 at 8 bits): from
// the row's aligned words wp[] shifted right by sh bits where the row
// allows (fast), else a sample at a time from `row`, its columns clamped.
__device__ __forceinline__ void row_samples(const uint32_t *wp, int sh,
                                            const uint8_t *row, int x,
                                            int ref_w, bool fast,
                                            uint32_t (&u)[3]) {
    if (fast) {
        const uint32_t w0 = wp[0], w1 = wp[1], w2 = wp[2], w3 = wp[3];
        u[0] = __funnelshift_r(w0, w1, sh);
        u[1] = __funnelshift_r(w1, w2, sh);
        u[2] = __funnelshift_r(w2, w3, sh);
    } else {
        u[0] = u[1] = u[2] = 0;
#pragma unroll
        for (int k = 0; k < 12; k++)
            u[k >> 2] |= (uint32_t)row[min(max(x + k, 0), ref_w - 1)]
                         << (8 * (k & 3));
    }
}

// The horizontal pass of one window row at 8 bits: 4 outputs, before
// rounding, from its samples (4 a word).
__device__ __forceinline__ void hpass(const uint32_t (&u)[3], int fx,
                                      int tw0, int tw1, int (&acc)[4]) {
    if (fx) {
        // quad j: samples j .. j + 3
        const uint32_t qd[8] = {
            u[0], __funnelshift_r(u[0], u[1], 8),
            __funnelshift_r(u[0], u[1], 16), __funnelshift_r(u[0], u[1], 24),
            u[1], __funnelshift_r(u[1], u[2], 8),
            __funnelshift_r(u[1], u[2], 16), __funnelshift_r(u[1], u[2], 24)};
#pragma unroll
        for (int j = 0; j < 4; j++)
            acc[j] = dp4a_us(qd[j + 4], tw1, dp4a_us(qd[j], tw0, 0));
    } else {  // samples 3 .. 6, times 128
        const uint32_t q3 = __funnelshift_r(u[0], u[1], 24);
#pragma unroll
        for (int j = 0; j < 4; j++) acc[j] = (int)((q3 >> (8 * j)) & 255) << 7;
    }
}

// The same above 8 bits: 11 samples, 2 a word, 8 multiply-adds an output.
__device__ __forceinline__ void row_samples(const uint32_t *wp, int sh,
                                            const uint16_t *row, int x,
                                            int ref_w, bool fast,
                                            int (&v)[11]) {
    if (fast) {
        uint32_t w[7], u[6];
#pragma unroll
        for (int j = 0; j < 7; j++) w[j] = wp[j];
#pragma unroll
        for (int j = 0; j < 6; j++) u[j] = __funnelshift_r(w[j], w[j + 1], sh);
#pragma unroll
        for (int k = 0; k < 11; k++) v[k] = (u[k >> 1] >> (16 * (k & 1))) & 65535;
    } else {
#pragma unroll
        for (int k = 0; k < 11; k++) v[k] = row[min(max(x + k, 0), ref_w - 1)];
    }
}

__device__ __forceinline__ void hpass(const int (&v)[11], int fx,
                                      const int *tx, int (&acc)[4]) {
#pragma unroll
    for (int j = 0; j < 4; j++) {
        int a = 0;
#pragma unroll
        for (int k = 0; k < 8; k++) a += tx[k] * v[j + k];
        acc[j] = fx ? a : v[j + 3] << 7;
    }
}

template <typename T, int W, int R>
__global__ void __launch_bounds__(NT, W == 4 ? MIN_CTAS - 1 : MIN_CTAS)
mc_pred_kernel(const __grid_constant__ Args A,
               const __grid_constant__ Taps taps) {
    constexpr int G = W / 4;  // column groups of 4
    constexpr int E = 4 / (int)sizeof(T);  // samples a 32-bit word
    // samples a fast row read touches from its aligned start
    constexpr int SPAN = (sizeof(T) == 1 ? 4 : 7) * E;
    const int h = A.h;
    const int per_block = G * ((h + R - 1) / R);
    const int gt = blockIdx.x * NT + threadIdx.x;
    const int b = gt / per_block;
    if (b >= A.n) return;
    const int rem = gt - b * per_block;
    const int strip = rem / G, g = rem - strip * G;  // G: a shift
    const int r0 = strip * R;
    const int rows = h - r0;  // output rows below the strip's top
    const int p = blockIdx.y, P = gridDim.y;
    const int pos = b / A.cands;
    const int sx = (A.px[pos] << 4) + (A.mvc[b] << (1 - A.sub_x));
    const int sy = (A.py[pos] << 4) + (A.mvr[b] << (1 - A.sub_y));
    const int x = (sx >> 4) - 3 + A.margin + 4 * g;  // first column read
    const int iy = (sy >> 4) - 3 + A.margin + r0;    // first row read
    const int fx = sx & 15, fy = sy & 15;
    const bool fast = A.vec && x >= 0 && (x & ~(E - 1)) + SPAN <= A.ref_w;
    // fast rows: words from the aligned column at or before x (the rows
    // start 4-byte aligned), shifted by the same sh on every row; slow
    // rows: samples from the plane's own rows (wbase is then the plane)
    const uint32_t *wbase = reinterpret_cast<const uint32_t *>(
        static_cast<const T *>(A.ref[p]) + (fast ? x & ~(E - 1) : 0));
    const int sh = 8 * (int)sizeof(T) * (x & (E - 1));
    const int wstride = A.stride * (int)sizeof(T) / 4;

    int tx[8], ty[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        tx[k] = taps.t[fx][k];
        ty[k] = taps.t[fy][k];
    }
    const int tw0 = pack4(tx), tw1 = pack4(tx + 4);
    int yw[4];  // tap pairs for dp2a
#pragma unroll
    for (int k = 0; k < 4; k++)
        yw[k] = (ty[2 * k] & 255) | ((ty[2 * k + 1] & 255) << 8);
    // uint8 planes are 8-bit (the wrapper's rule): constants then
    const int round0 = sizeof(T) == 1 || A.bd < 12 ? 3 : 5;
    const int round1 = 14 - round0;
    const int hi = sizeof(T) == 1 ? 255 : (1 << A.bd) - 1;

    // 32-bit offsets (the wrapper keeps every output below 2^31 samples)
    const int obase = ((b * P + p) * h + r0) * W + 4 * g;
    const int soff = (A.py[pos] + r0) * A.src_stride + A.px[pos] + 4 * g;
    // the source's 4 samples a row in one load where aligned
    const bool svec =
        A.resid
        && (uintptr_t)(static_cast<const T *>(A.src[p]) + soff)
                   % (4 * sizeof(T)) == 0
        && (A.src_stride * sizeof(T)) % (4 * sizeof(T)) == 0;

    // the horizontal pass's rows, two int16 columns a word; fully
    // unrolled, each lives until the last output row it feeds, so at most
    // 8 rows (16 words) are held
    uint32_t m[R + 7][2];
#pragma unroll
    for (int j = 0; j < R + 7; j++) {
        const int rj = min(max(iy + j, 0), A.ref_h - 1);
        int acc[4];
        if constexpr (sizeof(T) == 1) {
            uint32_t u[3];
            row_samples(wbase + rj * wstride, sh,
                        reinterpret_cast<const T *>(wbase) + rj * A.stride,
                        x, A.ref_w, fast, u);
            hpass(u, fx, tw0, tw1, acc);
        } else {
            int v[11];
            row_samples(wbase + rj * wstride, sh,
                        reinterpret_cast<const T *>(wbase) + rj * A.stride,
                        x, A.ref_w, fast, v);
            hpass(v, fx, tx, acc);
        }
#pragma unroll
        for (int c = 0; c < 4; c++)
            acc[c] = (acc[c] + (1 << (round0 - 1))) >> round0;
        m[j][0] = __byte_perm(acc[0], acc[1], 0x5410);
        m[j][1] = __byte_perm(acc[2], acc[3], 0x5410);
        if (j < 7) continue;
        const int rr = j - 7;  // the output row now complete
        if (rr >= rows) continue;
        int a[4] = {0, 0, 0, 0};
        if (fy) {
            // column c of rows (rr + 2k, rr + 2k + 1) as one word
#pragma unroll
            for (int k = 0; k < 4; k++) {
                const uint32_t *x0 = m[rr + 2 * k], *x1 = m[rr + 2 * k + 1];
                a[0] = __dp2a_lo((int)__byte_perm(x0[0], x1[0], 0x5410), yw[k], a[0]);
                a[1] = __dp2a_lo((int)__byte_perm(x0[0], x1[0], 0x7632), yw[k], a[1]);
                a[2] = __dp2a_lo((int)__byte_perm(x0[1], x1[1], 0x5410), yw[k], a[2]);
                a[3] = __dp2a_lo((int)__byte_perm(x0[1], x1[1], 0x7632), yw[k], a[3]);
            }
        } else {
            const uint32_t *x3 = m[rr + 3];
            a[0] = (int)(short)(x3[0] & 65535) << 7;
            a[1] = (int)(short)(x3[0] >> 16) << 7;
            a[2] = (int)(short)(x3[1] & 65535) << 7;
            a[3] = (int)(short)(x3[1] >> 16) << 7;
        }
        int out[4];
#pragma unroll
        for (int c = 0; c < 4; c++)
            out[c] = min(max((a[c] + (1 << (round1 - 1))) >> round1, 0), hi);
        const int at = obase + rr * W;
        if (A.pred)
            *reinterpret_cast<int4 *>(A.pred + at) =
                make_int4(out[0], out[1], out[2], out[3]);
        if (A.resid) {
            const T *sr = static_cast<const T *>(A.src[p]) + soff
                          + rr * A.src_stride;
            int sv[4];
            if (svec) {
                load4(sr, sv);
            } else {
#pragma unroll
                for (int c = 0; c < 4; c++) sv[c] = sr[c];
            }
            *reinterpret_cast<int4 *>(A.resid + at) =
                make_int4(sv[0] - out[0], sv[1] - out[1], sv[2] - out[2],
                          sv[3] - out[3]);
        }
    }
}

template <typename T, int W, int R>
int launch_r(const Args &A, const Taps &taps, int planes, long long threads,
             cudaStream_t st) {
    const dim3 grid((unsigned)((threads + NT - 1) / NT), planes);
    mc_pred_kernel<T, W, R><<<grid, NT, 0, st>>>(A, taps);
    return (int)cudaGetLastError();
}

// strips of 16 rows (the least horizontal work a row), or of 4 where
// that leaves the card short of threads
template <typename T, int W>
int launch(const Args &A, const Taps &taps, int planes, cudaStream_t st) {
    constexpr int R = W < 16 ? W : 16;
    const long long threads =
        (long long)A.n * planes * (W / 4) * ((A.h + R - 1) / R);
    if (R > 4 && threads < SMALL)
        return launch_r<T, W, 4>(A, taps, planes,
                                 (long long)A.n * (W / 4) * ((A.h + 3) / 4),
                                 st);
    return launch_r<T, W, R>(A, taps, planes, threads / planes, st);
}

template <typename T>
int dispatch(int w, const Args &A, const Taps &taps, int planes,
             cudaStream_t st) {
    switch (w) {
    case 4: return launch<T, 4>(A, taps, planes, st);
    case 8: return launch<T, 8>(A, taps, planes, st);
    case 16: return launch<T, 16>(A, taps, planes, st);
    case 32: return launch<T, 32>(A, taps, planes, st);
    case 64: return launch<T, 64>(A, taps, planes, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// ref0/ref1: the padded planes (ref1 null: one plane), elt 1 (uint8) or 2
// (uint16), the same stride and shape; px/py (n / cands,) and mvr/mvc
// (n,) int32; src0/src1: source planes of the refs' type (null: no
// residual) with row stride src_stride; taps: the (16, 8) int32 table in
// host memory; pred/resid: int32 outputs (either may be null).
extern "C" int mc_pred(const void *ref0, const void *ref1, int elt,
                       int stride, int ref_h, int ref_w, int margin,
                       const void *px, const void *py, const void *mvr,
                       const void *mvc, int n_blocks, int cands, int w, int h,
                       int sub_x, int sub_y, int bd, const void *taps,
                       const void *src0, const void *src1, int src_stride,
                       void *pred, void *resid, void *stream) {
    if (n_blocks <= 0) return 0;
    if (h < 1 || h > HMAX || h % 4 || cands < 1)
        return (int)cudaErrorInvalidValue;
    Args A;
    A.ref[0] = ref0;
    A.ref[1] = ref1 ? ref1 : ref0;
    A.src[0] = src0;
    A.src[1] = src1 ? src1 : src0;
    A.stride = stride;
    A.ref_h = ref_h;
    A.ref_w = ref_w;
    A.margin = margin;
    A.src_stride = src_stride;
    A.px = (const int32_t *)px;
    A.py = (const int32_t *)py;
    A.mvr = (const int32_t *)mvr;
    A.mvc = (const int32_t *)mvc;
    A.n = n_blocks;
    A.cands = cands;
    A.h = h;
    A.sub_x = sub_x;
    A.sub_y = sub_y;
    A.bd = bd;
    A.vec = (uintptr_t)A.ref[0] % 4 == 0 && (uintptr_t)A.ref[1] % 4 == 0
            && (stride * elt) % 4 == 0;
    A.pred = (int32_t *)pred;
    A.resid = (int32_t *)resid;
    Taps tp;
    const int32_t *t = (const int32_t *)taps;
    for (int i = 0; i < 16; i++)
        for (int k = 0; k < 8; k++) tp.t[i][k] = t[i * 8 + k];
    const int planes = ref1 ? 2 : 1;
    cudaStream_t st = (cudaStream_t)stream;
    return elt == 1 ? dispatch<uint8_t>(w, A, tp, planes, st)
                    : dispatch<uint16_t>(w, A, tp, planes, st);
}
