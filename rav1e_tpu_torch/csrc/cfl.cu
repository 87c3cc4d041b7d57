// K11 cfl: chroma-from-luma for 4:2:0 (spec 7.11.5) in the wavefront's
// CFL arm, in two modes (entries cfl_fit and cfl_decide), int32 samples.
//
// Fit mode replaces rav1e_tpu/ops/intra_jax.py:317 cfl_ac_420_batch and
// :329 cfl_predict_batch with the alpha fit of models/wavefront.py:709-731:
// the AC values of the 2x2 luma sums, each plane's alpha fitted to its
// residual against the DC prediction, and both planes' CFL prediction and
// residual src - pred.  Decide mode replaces the CFL-vs-DC choice of
// models/wavefront.py:733-762 (and the SSE of :729): each plane's
// pixel-domain SSE of the CFL residual against its inverse transform (K2
// and K3 ran in between), the CFL cost (the DC cost where a plane's alpha
// is 0), the uv-mode, sign and alpha symbol rates from the pass's tables,
// use_cfl with its strict <, and the selection of prediction, levels,
// inverse, coefficient rates, alphas and uv mode.  The TPU version runs
// both as batched array programs; in the port they were ~60 device
// operations a call issued from Python, one K11 launch among them.
//
// What bounds it on the H100: neither bytes nor operations (a call moves
// a few KB: at most 15 blocks of 32x32 on the speed-5 path) but the
// launches and the host's issue of the arm.  So the arm is K11 fit, K2,
// K3 and K11 decide, four launches, and each mode is one launch that
// reads its inputs in place: the DC prediction, levels and inverse as
// strided views of the leaf's candidate stacks, the sources and the luma
// through their strides (a column stride of 1), the rates, costs,
// lambdas and modes through theirs.  A group of G = min(m, 32) threads
// works one block of m = (n/2)^2 AC samples (half a warp at n = 8, a warp
// at 16 and 32) and 128-thread CTAs hold several blocks, so nothing waits
// at a barrier: every sum is one round of warp shuffles.  Every load of
// a mode is issued before its first store, so that the compiler, which
// must assume that the outputs may alias the inputs, does not serialise
// them one L2 round trip at a time (decide reads both sides' blocks for
// that: a few KB).
//
// The fit needs one round: sum(ac^2) and sum(res * ac) follow exactly
// from sum L, sum L^2, sum res and sum res * L and the mean (integers),
// so the mean need not be known before the products are summed.  At 8
// bits the partial sums stay in int32 (|L| <= 2040: sum L^2 <= 256 *
// 2040^2 < 2^31); above, in int64 (the template argument).  alpha =
// round_half_even(f32(64 * num) / max(f32(den), 1)) clipped to [-16,
// 16], 0 where den == 0; each exact sum is rounded to f32 once.
//
// Decide follows ops/intra.py cfl_decide_plain bit for bit: the SSE is an
// exact int64 sum converted to f32 once, and every float step is one
// correctly rounded __fmul_rn / __fadd_rn in the plain version's order,
// with no FMA contraction.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;

template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, G);
    return v;
}

__device__ __forceinline__ int fit_alpha(long long num, long long den) {
    if (den == 0) return 0;
    const float q = __fdiv_rn(__fmul_rn(__ll2float_rn(num), 64.0f),
                              fmaxf(__ll2float_rn(den), 1.0f));
    const float a = rintf(q);  // half to even, as torch.round
    return (int)fminf(fmaxf(a, -16.0f), 16.0f);
}

struct FitArgs {
    const int32_t *luma, *dc, *src;
    int32_t *alpha, *pred, *resid;
    int nb, maxval;
    int l_b, l_r;          // luma strides: block, row
    int d_b, d_p, d_r;     // DC prediction: block, plane, row
    int s_b, s_p, s_r;     // sources
};

// Outputs alpha (nb, 2), pred and resid (nb, 2, N2, N2), contiguous.
template <int N2, bool WIDE>
__global__ void __launch_bounds__(NT) fit_kernel(const FitArgs a) {
    constexpr int M = N2 * N2, G = M < 32 ? M : 32, S = M / G;
    constexpr int LOG2M = N2 == 4 ? 4 : (N2 == 8 ? 6 : 8);
    using Acc = typename std::conditional<WIDE, long long, int>::type;
    const int l = threadIdx.x % G;
    const int b0 = blockIdx.x * (NT / G) + threadIdx.x / G;
    const bool valid = b0 < a.nb;
    const size_t b = valid ? b0 : 0;
    int L[S], dcv[2][S], sv[2][S];
    Acc sl = 0, sl2 = 0, sr[2] = {0, 0}, srl[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < S; k++) {
        const int i = l + G * k, r = i / N2, c = i % N2;
        const int32_t *p = a.luma + b * a.l_b + (size_t)(2 * r) * a.l_r + 2 * c;
        L[k] = (p[0] + p[1] + p[a.l_r] + p[a.l_r + 1]) << 1;
        sl += L[k];
        sl2 += (Acc)L[k] * L[k];
#pragma unroll
        for (int q = 0; q < 2; q++) {
            dcv[q][k] = a.dc[b * a.d_b + q * a.d_p + (size_t)r * a.d_r + c];
            sv[q][k] = a.src[b * a.s_b + q * a.s_p + (size_t)r * a.s_r + c];
            const int res = sv[q][k] - dcv[q][k];
            sr[q] += res;
            srl[q] += (Acc)res * L[k];
        }
    }
    sl = group_sum<G>(sl);
    sl2 = group_sum<G>(sl2);
#pragma unroll
    for (int q = 0; q < 2; q++) {
        sr[q] = group_sum<G>(sr[q]);
        srl[q] = group_sum<G>(srl[q]);
    }
    const long long avg = ((long long)sl + (1 << (LOG2M - 1))) >> LOG2M;
    // sum (L - avg)^2 and sum res * (L - avg), exactly
    const long long den = (long long)sl2 - 2 * avg * sl + M * avg * avg;
    int al[2];
#pragma unroll
    for (int q = 0; q < 2; q++)
        al[q] = fit_alpha((long long)srl[q] - avg * sr[q], den);
    if (!valid) return;
    if (l < 2) a.alpha[b * 2 + l] = al[l];
#pragma unroll
    for (int q = 0; q < 2; q++) {
#pragma unroll
        for (int k = 0; k < S; k++) {
            const size_t o = (b * 2 + q) * M + l + G * k;
            const int prod = al[q] * (L[k] - (int)avg);
            const int mag = (abs(prod) + 32) >> 6;
            const int scaled = prod < 0 ? -mag : (prod > 0 ? mag : 0);
            const int pc = min(max(dcv[q][k] + scaled, 0), a.maxval);
            a.pred[o] = pc;
            a.resid[o] = sv[q][k] - pc;
        }
    }
}

struct DecideArgs {
    // the CFL side (contiguous, from fit, K2 and K3): resid, inverse,
    // levels, prediction (nb, 2, N2, N2); rate and alpha (nb, 2)
    const int32_t *rc, *ic, *lc, *pc, *alpha;
    const float *ratec;
    // the DC side (views): prediction, levels, inverse (nb, 2, N2, N2);
    // pixel SSE and coefficient rate (nb, 2)
    const int32_t *p_dc, *l_dc, *i_dc;
    const float *dd_dc, *r_dc;
    const float *lam;
    const int64_t *mode;
    const float *uv14, *sign, *atab;  // (13, 14), (8,), (6, 16)
    int32_t *o_p, *o_l, *o_i, *o_a;
    float *o_r;
    int64_t *o_uv;
    int nb;
    int p_b, p_p, p_r, l_b, l_p, l_r, i_b, i_p, i_r;
    int dd_b, dd_p, r_b, r_p, lam_s, mode_s;
};

template <int N2>
__global__ void __launch_bounds__(NT) decide_kernel(const DecideArgs a) {
    constexpr int M = N2 * N2, G = M < 32 ? M : 32, S = M / G;
    const int l = threadIdx.x % G;
    const int b0 = blockIdx.x * (NT / G) + threadIdx.x / G;
    const bool valid = b0 < a.nb;
    const size_t b = valid ? b0 : 0;
    // every load before the first store (the outputs may alias nothing,
    // but the compiler cannot know it): both sides' blocks, then the
    // per-block scalars and the tables they index
    int icv[2][S], cp[2][S], cl[2][S], dp[2][S], dl[2][S], di[2][S];
    long long sse[2] = {0, 0};
#pragma unroll
    for (int q = 0; q < 2; q++) {
#pragma unroll
        for (int k = 0; k < S; k++) {
            const int i = l + G * k, r = i / N2, c = i % N2;
            const size_t o = (b * 2 + q) * M + i;
            icv[q][k] = a.ic[o];
            const long long d = a.rc[o] - icv[q][k];
            sse[q] += d * d;
            cp[q][k] = a.pc[o];
            cl[q][k] = a.lc[o];
            dp[q][k] = a.p_dc[b * a.p_b + q * a.p_p + (size_t)r * a.p_r + c];
            dl[q][k] = a.l_dc[b * a.l_b + q * a.l_p + (size_t)r * a.l_r + c];
            di[q][k] = a.i_dc[b * a.i_b + q * a.i_p + (size_t)r * a.i_r + c];
        }
    }
    const int au = a.alpha[b * 2], av = a.alpha[b * 2 + 1];
    const float lam = a.lam[b * a.lam_s];
    float dd[2], rdc[2], rcf[2];
#pragma unroll
    for (int q = 0; q < 2; q++) {
        dd[q] = a.dd_dc[b * a.dd_b + q * a.dd_p];
        rdc[q] = a.r_dc[b * a.r_b + q * a.r_p];
        rcf[q] = a.ratec[b * 2 + q];
    }
    // sign codes: 0 zero, 1 negative, 2 positive
    const int su = au == 0 ? 0 : (au < 0 ? 1 : 2);
    const int sv = av == 0 ? 0 : (av < 0 ? 1 : 2);
    const int64_t md = a.mode[b * a.mode_s];
    const float rate_dc = a.uv14[md * 14], rate_uv = a.uv14[md * 14 + 13];
    const float rate_s = a.sign[max(su * 3 + sv - 1, 0)];
    const float rate_au = a.atab[((su == 2 ? 3 : 0) + sv) * 16 + max(abs(au) - 1, 0)];
    const float rate_av = a.atab[((sv == 2 ? 3 : 0) + su) * 16 + max(abs(av) - 1, 0)];
#pragma unroll
    for (int q = 0; q < 2; q++) sse[q] = group_sum<G>(sse[q]);
    if (!valid) return;
    // every lane of the group takes the same decision
    float cdc[2], ccfl[2];
#pragma unroll
    for (int q = 0; q < 2; q++) {
        cdc[q] = __fadd_rn(dd[q], __fmul_rn(lam, rdc[q]));
        ccfl[q] = (q ? av : au) == 0
                      ? cdc[q]
                      : __fadd_rn(__ll2float_rn(sse[q]), __fmul_rn(lam, rcf[q]));
    }
    float rate_cfl = __fadd_rn(rate_uv, rate_s);
    if (su > 0) rate_cfl = __fadd_rn(rate_cfl, rate_au);
    if (sv > 0) rate_cfl = __fadd_rn(rate_cfl, rate_av);
    const float lhs = __fadd_rn(__fadd_rn(ccfl[0], ccfl[1]), __fmul_rn(lam, rate_cfl));
    const float rhs = __fadd_rn(__fadd_rn(cdc[0], cdc[1]), __fmul_rn(lam, rate_dc));
    const bool use = (au != 0 || av != 0) && lhs < rhs;
#pragma unroll
    for (int q = 0; q < 2; q++) {
        const bool take = use && (q ? av : au) != 0;
        if (l == 0) {
            a.o_r[b * 2 + q] = take ? rcf[q] : rdc[q];
            a.o_a[b * 2 + q] = take ? (q ? av : au) : 0;
        }
#pragma unroll
        for (int k = 0; k < S; k++) {
            const size_t o = (b * 2 + q) * M + l + G * k;
            a.o_p[o] = take ? cp[q][k] : dp[q][k];
            a.o_l[o] = take ? cl[q][k] : dl[q][k];
            a.o_i[o] = take ? icv[q][k] : di[q][k];
        }
    }
    if (l == 0) a.o_uv[b] = use ? 13 : 0;
}

template <int N2>
void launch_fit(const FitArgs &a, bool wide, cudaStream_t st) {
    constexpr int M = N2 * N2, G = M < 32 ? M : 32;
    const int grid = (a.nb + NT / G - 1) / (NT / G);
    if (wide)
        fit_kernel<N2, true><<<grid, NT, 0, st>>>(a);
    else
        fit_kernel<N2, false><<<grid, NT, 0, st>>>(a);
}

template <int N2>
void launch_decide(const DecideArgs &a, cudaStream_t st) {
    constexpr int M = N2 * N2, G = M < 32 ? M : 32;
    const int grid = (a.nb + NT / G - 1) / (NT / G);
    decide_kernel<N2><<<grid, NT, 0, st>>>(a);
}

}  // namespace

// ops/intra.py cfl: the fit of nb blocks of n2 = n / 2 (4, 8 or 16) AC
// samples; the luma, DC prediction and source strides in elements.
extern "C" int cfl_fit(const int32_t *luma, const int32_t *dc,
                       const int32_t *src, int32_t *alpha, int32_t *pred,
                       int32_t *resid, int nb, int n2, int bd, int l_b,
                       int l_r, int d_b, int d_p, int d_r, int s_b, int s_p,
                       int s_r, void *stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (nb <= 0) return (int)cudaGetLastError();
    FitArgs a;
    a.luma = luma; a.dc = dc; a.src = src;
    a.alpha = alpha; a.pred = pred; a.resid = resid;
    a.nb = nb;
    a.maxval = (1 << bd) - 1;
    a.l_b = l_b; a.l_r = l_r;
    a.d_b = d_b; a.d_p = d_p; a.d_r = d_r;
    a.s_b = s_b; a.s_p = s_p; a.s_r = s_r;
    const bool wide = bd > 8;
    if (n2 == 4) launch_fit<4>(a, wide, st);
    else if (n2 == 8) launch_fit<8>(a, wide, st);
    else if (n2 == 16) launch_fit<16>(a, wide, st);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// ops/intra.py cfl_decide: the CFL side (rc, ic, lc, pc contiguous (nb,
// 2, n2, n2); alpha, ratec (nb, 2)), the DC side through its strides
// (prediction, levels, inverse: block, plane, row; SSE and rates: block,
// plane), lam and mode through theirs, the pass's rate tables; the
// outputs contiguous.
extern "C" int cfl_decide(
    const int32_t *rc, const int32_t *ic, const int32_t *lc,
    const int32_t *pc, const int32_t *alpha, const float *ratec,
    const int32_t *p_dc, const int32_t *l_dc, const int32_t *i_dc,
    const float *dd_dc, const float *r_dc, const float *lam,
    const int64_t *mode, const float *uv14, const float *sign,
    const float *atab, int32_t *o_p, int32_t *o_l, int32_t *o_i,
    int32_t *o_a, float *o_r, int64_t *o_uv, int nb, int n2, int p_b,
    int p_p, int p_r, int l_b, int l_p, int l_r, int i_b, int i_p, int i_r,
    int dd_b, int dd_p, int r_b, int r_p, int lam_s, int mode_s,
    void *stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (nb <= 0) return (int)cudaGetLastError();
    DecideArgs a;
    a.rc = rc; a.ic = ic; a.lc = lc; a.pc = pc;
    a.alpha = alpha; a.ratec = ratec;
    a.p_dc = p_dc; a.l_dc = l_dc; a.i_dc = i_dc;
    a.dd_dc = dd_dc; a.r_dc = r_dc; a.lam = lam; a.mode = mode;
    a.uv14 = uv14; a.sign = sign; a.atab = atab;
    a.o_p = o_p; a.o_l = o_l; a.o_i = o_i;
    a.o_a = o_a; a.o_r = o_r; a.o_uv = o_uv;
    a.nb = nb;
    a.p_b = p_b; a.p_p = p_p; a.p_r = p_r;
    a.l_b = l_b; a.l_p = l_p; a.l_r = l_r;
    a.i_b = i_b; a.i_p = i_p; a.i_r = i_r;
    a.dd_b = dd_b; a.dd_p = dd_p; a.r_b = r_b; a.r_p = r_p;
    a.lam_s = lam_s; a.mode_s = mode_s;
    if (n2 == 4) launch_decide<4>(a, st);
    else if (n2 == 8) launch_decide<8>(a, st);
    else if (n2 == 16) launch_decide<16>(a, st);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
