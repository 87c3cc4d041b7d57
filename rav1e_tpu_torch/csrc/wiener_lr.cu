// K8 wiener_lr: the Wiener loop-restoration filter (spec 7.17) of one plane
// with frame-level taps, the exact per-unit SSE of the unfiltered and the
// restored unit against the source, the none-vs-Wiener choice per unit and
// the composed plane.
//
// Replaces rav1e_tpu/ops/lrf_jax.py:77 _wiener_body with the unit sums,
// choice and composition of ops/filter_chain_jax.py:242-272.  The TPU
// version gathers all 7 source rows of every output row through a
// (h, 7) table (the stripe rule), filters the whole plane, and sums the
// squared error per unit with static slices.  Here one CTA owns one
// restoration unit (the stripe-aligned row ranges of lrf_np.unit_ranges,
// up to ~1.5x the nominal unit).  The unit is taken stripe by stripe: for
// each virtual row yy in [a - 3, b + 3) of a stripe segment [a, b), the
// source row comes from _stripe_source's rule (clamped to the plane, then
// the CDEF output inside the stripe, the deblocked plane across its
// boundary, two rows at most), the
// columns are clamped at the plane's edges, and the horizontal pass
// (round0, clip) goes to shared memory; the vertical pass (round1, clip)
// reads it back.  In the same CTA the unit's SSE of the CDEF output and of
// the restored samples are summed exactly (int32: a unit is at most
// 104 x 95 samples, 104 * 95 * 255^2 < 2^31), and the choice is made
// exactly as the JAX code makes it: each sum converted to float32,
// s1 + lam * rate < s0 in float32, and en.  The restored samples are
// written first; a unit that keeps the CDEF output rewrites them.
//
// Frame mode (choice == nullptr; src, en, lam and rate unused): the whole
// restored plane with the given taps and stripe size, no sums and no
// choice, at bit depth bd (8, 10 or 12: the rounding of lrf_jax.py:50-55,
// round0 = 3 and round1 = 11 below 12 bits, 5 and 9 at 12, the clip to
// (1 << bd) - 1; every intermediate fits int32).  It replaces
// rav1e_tpu/ops/lrf_jax.py:43 _jitted (called by :254
// wiener_filter_frame_device), the host LR search's trial filter.  The
// unit-choice mode runs only in the chain after an 8-bit wavefront pass,
// so its SSE bound above is the 8-bit one.
//
// Bound on the H100: bytes (the CDEF output and the source read, the
// deblocked plane only in the rows the stripe rule takes, one plane
// written; ~42 integer operations a sample).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int MAXW = 96;       // widest unit: 64 + 31 (the merged remainder)
constexpr int MAXROWS = 70;    // one stripe (64) + 2 * 3 rows

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// spec: the number of units along a dimension, the last absorbing the rest
__host__ __device__ __forceinline__ int count_units(int unit, int size) {
    const int n = (size + (unit >> 1)) / unit;
    return n > 1 ? n : 1;
}

// cd/db/src: (>= hh, >= ww) int32 planes with row strides; out (hh, ww)
// int32 contiguous; choice (nr, nc) int32.  taps: int32 [v0 v1 v2 h0 h1 h2]
// (3 taps each, the 7-tap filter is [c0 c1 c2 128-2(c0+c1+c2) c2 c1 c0]).
__global__ void __launch_bounds__(NT)
wiener_lr_kernel(const int32_t *__restrict__ cd, int scd,
                 const int32_t *__restrict__ db, int sdb,
                 const int32_t *__restrict__ src, int ssrc, int hh, int ww,
                 int unit, int bd, const int32_t *__restrict__ taps,
                 const int32_t *__restrict__ en, float lam, float rate,
                 int32_t *__restrict__ out, int32_t *__restrict__ choice) {
    __shared__ int hor[MAXROWS * MAXW];
    __shared__ int red[NT / 32][2];
    __shared__ int take_s;
    const int nr = gridDim.y, nc = gridDim.x;
    const int ur = blockIdx.y, uc = blockIdx.x;
    const int off = unit >> 3;  // stripe offset: the stripe is the unit size
    const int y0 = ur == 0 ? 0 : ur * unit - off;
    const int y1 = ur == nr - 1 ? hh : (ur + 1) * unit - off;
    const int x0 = uc * unit;
    const int x1 = uc == nc - 1 ? ww : (uc + 1) * unit;
    const int uw = x1 - x0;
    int vf[7], hf[7];
    {
        const int v0 = taps[0], v1 = taps[1], v2 = taps[2];
        const int h0 = taps[3], h1 = taps[4], h2 = taps[5];
        vf[0] = vf[6] = v0; vf[1] = vf[5] = v1; vf[2] = vf[4] = v2;
        vf[3] = 128 - 2 * (v0 + v1 + v2);
        hf[0] = hf[6] = h0; hf[1] = hf[5] = h1; hf[2] = hf[4] = h2;
        hf[3] = 128 - 2 * (h0 + h1 + h2);
    }
    // lrf_np.wiener_filter_frame's rounding (8 bits: 3, 11, 1 << 14,
    // (1 << 13) - 1, 1 << 18, 255)
    const int round0 = bd < 12 ? 3 : 5, round1 = bd < 12 ? 11 : 9;
    const int off_h = 1 << (bd + 6), limit = (1 << (bd + 1 + 7 - round0)) - 1;
    const int off_v = 1 << (bd + round1 - 1), mx = (1 << bd) - 1;
    const bool frame = choice == nullptr;
    int s0 = 0, s1 = 0;
    for (int a = y0; a < y1;) {
        const int sidx = (a + off) / unit;
        const int st0 = sidx * unit - off, st1 = st0 + unit;
        const int b = min(y1, st1);
        const int nv = b - a + 6;
        for (int i = threadIdx.x; i < nv * uw; i += NT) {
            const int vr = i / uw, xc = i % uw;
            // the row clamped to the plane first, then the stripe test
            // (spec get_source_sample; lrf_np._stripe_source)
            const int yy = min(max(a - 3 + vr, 0), hh - 1);
            int rr;
            const int32_t *pl;
            int sp;
            if (yy < st0) {
                rr = max(yy, st0 - 2); pl = db; sp = sdb;
            } else if (yy >= st1) {
                rr = min(yy, st1 + 1); pl = db; sp = sdb;
            } else {
                rr = yy; pl = cd; sp = scd;
            }
            const int32_t *row = pl + (size_t)rr * sp;
            const int x = x0 + xc;
            int sum = 0;
#pragma unroll
            for (int t = 0; t < 7; t++)
                sum += hf[t] * row[min(max(x + t - 3, 0), ww - 1)];
            hor[vr * uw + xc] = min(
                max((sum + off_h + (1 << (round0 - 1))) >> round0, 0), limit);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < (b - a) * uw; i += NT) {
            const int r = i / uw, xc = i % uw;
            const int y = a + r, x = x0 + xc;
            int s = -off_v;
#pragma unroll
            for (int t = 0; t < 7; t++) s += vf[t] * hor[(r + t) * uw + xc];
            const int rest = min(max((s + (1 << (round1 - 1))) >> round1, 0), mx);
            out[(size_t)y * ww + x] = rest;
            if (frame) continue;
            const int sv = src[(size_t)y * ssrc + x];
            const int base = cd[(size_t)y * scd + x];
            s0 += (base - sv) * (base - sv);
            s1 += (rest - sv) * (rest - sv);
        }
        __syncthreads();
        a = b;
    }
    if (frame) return;  // uniform across the CTA
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
        red[warp][0] = s0;
        red[warp][1] = s1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int t0 = 0, t1 = 0;
        for (int k = 0; k < NT / 32; k++) {
            t0 += red[k][0];
            t1 += red[k][1];
        }
        const float lhs = __fadd_rn(__int2float_rn(t1), __fmul_rn(lam, rate));
        const int take = (lhs < __int2float_rn(t0)) && en[0] != 0;
        take_s = take;
        choice[ur * nc + uc] = take;
    }
    __syncthreads();
    if (!take_s) {
        for (int i = threadIdx.x; i < (y1 - y0) * uw; i += NT) {
            const int y = y0 + i / uw, x = x0 + i % uw;
            out[(size_t)y * ww + x] = cd[(size_t)y * scd + x];
        }
    }
}

}  // namespace

extern "C" int wiener_lr(const void *cd, int scd, const void *db, int sdb,
                         const void *src, int ssrc, int hh, int ww, int unit,
                         int bd, const void *taps, const void *en, float lam,
                         float rate, void *out, void *choice, void *stream) {
    const int nr = count_units(unit, hh), nc = count_units(unit, ww);
    if (hh > 0 && ww > 0) {
        wiener_lr_kernel<<<dim3(nc, nr), NT, 0, (cudaStream_t)stream>>>(
            (const int32_t *)cd, scd, (const int32_t *)db, sdb,
            (const int32_t *)src, ssrc, hh, ww, unit, bd, (const int32_t *)taps,
            (const int32_t *)en, lam, rate, (int32_t *)out, (int32_t *)choice);
    }
    return (int)cudaGetLastError();
}
