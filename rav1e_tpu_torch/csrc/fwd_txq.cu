// K2 fwd_txq: forward transform + quantise + dequantise + RD sums, fused.
//
// Replaces rav1e_tpu/ops/transforms_jax.py:465 fdct_batch, :489 quantize and
// :511 dequantize, the tx-domain RD sums of models/wavefront.py:640-646 with
// coeff_rate (545), the level-1 thinning of the inter candidate race
// (models/wavefront.py:441-445, :478-482), and (variant FLOAT_FLOOR) the
// float RD of models/device_pipeline.py:156 rd_analysis (170-183).  On the TPU the
// transform is an fp32 einsum on the matrix unit and the rest separate
// elementwise passes; here nothing but the outputs leaves the SM.
//
// Per transform: the int32 residual x (n x n) goes to shared memory as fp32;
// pass 1 is tmp = Fv . x (m x n), pass 2 y = tmp . FhT (m x m), every output
// one fmaf chain over ascending k from 0, plain fp32 on the CUDA cores (no
// TF32, no tensor cores).  Then, per coefficient:
//   INT variant:   c = rintf(y) (half to even, like jnp.round); level =
//                  min((|c << shift| + bias) / q, 32767) exact; dequant with
//                  the 24-bit mask and clamp; dist += ((c - dq) << shift)^2,
//                  nz and log2(1 + |level|) summed for the rate model.
//                  With a per-block threshold thr (the inter race), a
//                  level of magnitude 1 off the DC position is dropped
//                  where (float)|c << shift| < thr[block], before the
//                  dequantiser, so dequant, dist and rate see the thinned
//                  levels.  Levels and dequantised values are written only
//                  where the caller reads them (levels != nullptr); else
//                  the call is sums-only.
//   FLOAT_FLOOR (a template parameter, chosen at the C entry):
//                  level = floor((|y| + q' * 13/32) / q') with q' = q / 2^shift
//                  in fp32 (each op rounded separately, as XLA does); dist +=
//                  ((|y| - level q') 2^shift)^2.
//
// What bounds it on the H100.  The work is 2 m n (n + m) fp32 FMAs a
// transform against 4 n^2 bytes read and 8 m^2 written (none when
// sums-only): 2-4 flops a byte at n = 4 and 8, so bytes bound those; 8-16
// at n >= 16, so operations (67 TFLOP/s) bound the large calls.  Inside
// the SM the limit is shared memory: it serves 128 bytes a clock to an SM
// whose CUDA cores do 128 FMAs a clock, so an FMA may cost at most one
// byte of operand traffic.  And most of the pass's calls are a few
// hundred transforms, where a launch, the latency of one CTA's work and
// the wrapper's issue time come first.  The design:
//   - one launch a call.  Each per-block input (the residual, the tx-type
//     index, qdc, qac, the thinning threshold) is read through an index
//     map ((b / div) % mod) * stride from the tensor the caller holds (the
//     divisions by a multiply, FastDiv), so a broadcast (a lane's quantiser
//     over its candidates, one residual over five tx types, arange(T) keys
//     over the lanes) is read in place, not copied; scalar quantisers ride
//     as arguments.
//   - a team of TEAM threads a transform, G = THREADS / TEAM transforms a
//     CTA at once, each thread a register tile of R x C outputs in each
//     pass, its operands read from shared memory in 16-byte loads (8
//     threads of a load's phase on distinct or identical operands).  At
//     n = 32 and in the 64-point corner's first pass the tile is 4 x 8:
//     12 operands feed 32 FMAs; 4 x 4 at n = 16 and in the corner's second
//     pass.  (8 x 8 tiles, a byte an FMA, measured slower on the card: at
//     the registers that 2-3 CTAs an SM leave they spill.)  At n = 4 and 8
//     a thread owns a whole column of tmp and a whole row of y (TEAM = n;
//     64 and 32 transforms a 256-thread CTA).  CTAs of 256 threads, 128
//     in the 64-point corner (its residuals are 16 KB a transform).
//   - all T matrix pairs of the call in shared memory, loaded once a CTA
//     while the first residuals land (cp.async; where Fv has 32 rows, a
//     warp transposes it 32 x 32 through registers, so that its global
//     reads coalesce); the grid is persistent
//     (as many CTAs as fit on the SMs at once, each striding over groups
//     of G transforms), and each block's parameters for the next group
//     are read while the current one is transformed.  At n = 4, 8 and 32
//     the next group's residuals land in a second buffer meanwhile too
//     (at n = 16 and 64 that measured no faster on the card).
//   - quantise, dequantise and the sums in registers after pass 2 (the
//     quantiser's exact division by a multiply, log2(1 + level) from a
//     table of log2f's own values, the float variant's floor of a rounded
//     quotient from a reciprocal wherever that decides it, and the rest,
//     with log2f of a large level, out of line, so that the unrolled
//     epilogue stays small); the sums reduce with __shfl_xor in a fixed
//     order, then across a team's warps through shared memory in warp
//     order, so a run gives the same bits every time.
// On the H100 the large calls reach about a third of the fp32 peak: the
// transforms and the epilogue take most of their time, the level stores
// and the residuals' reads a small share each (chip_smoke.py splits the
// thinned inter race's time so).  The short calls, a few hundred
// transforms, take most of their time in a cost a call that does not grow
// with their blocks (the launch and a CTA's first group: matrices,
// residuals and both passes back to back, with little to overlap).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// n / d for 0 <= n < 2^31 by a multiply (CUTLASS's FastDivmod): d == 1
// takes n itself
struct FastDiv {
    unsigned mul, shr;
    int d;
};

__host__ __device__ inline FastDiv fast_div(int d) {
    FastDiv f{0u, 0u, d};
    if (d > 1) {
        unsigned l = 0;
        while ((1u << l) < (unsigned)d) l++;  // ceil(log2(d))
        const unsigned p = 31 + l;
        f.mul = (unsigned)(((1ull << p) + (unsigned)d - 1) / (unsigned)d);
        f.shr = p - 32;
    }
    return f;
}

__device__ __forceinline__ int quot(int n, const FastDiv &f) {
    return f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shr);
}

// block b's element offset in a per-block input: ((b / div) % mod) * stride
struct Idx {
    FastDiv div, mod;
    int stride;
};

__device__ __forceinline__ size_t at(const Idx &x, int b) {
    const int q = quot(b, x.div);
    return (size_t)(q - quot(q, x.mod) * x.mod.d) * (size_t)x.stride;
}

struct Args {
    const int32_t *resid;
    const float *Fv, *FhT;
    const int32_t *tidx, *qdc, *qac;
    const float *thr;
    Idx r, t, qd, qa, th;
    int r_vec;  // the residual's blocks start 16-byte aligned
    int nb, n_mats, qdc_val, qac_val, shift, bias_num, lim;
    float rate_nz, rate_mag;
    int32_t *levels, *dq;
    float *dist, *rate;
    int32_t *nnz;
};

// K floats from shared memory at p (16-byte aligned where K % 4 == 0)
template <int K>
__device__ __forceinline__ void lds(float (&v)[K], const float *p) {
    if constexpr (K % 4 == 0) {
#pragma unroll
        for (int i = 0; i < K; i += 4) {
            const float4 f = *reinterpret_cast<const float4 *>(p + i);
            v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < K; i++) v[i] = p[i];
    }
}

template <int K>
__device__ __forceinline__ void st_row(int32_t *p, const int32_t (&v)[K]) {
    if constexpr (K % 4 == 0) {
#pragma unroll
        for (int i = 0; i < K; i += 4)
            *reinterpret_cast<int4 *>(p + i) =
                make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else {
#pragma unroll
        for (int i = 0; i < K; i++) p[i] = v[i];
    }
}

// N: transform size; M: coded rows/cols (N, or 32 for the 64-point DCT);
// R1 x C1: a thread's tile of tmp (M x N); R2 x C2: its tile of y (M x M);
// THREADS a CTA; PAD floats after each group's and matrix's storage, so
// that the teams sharing a warp's 8-thread phase read disjoint banks;
// STAGES residual buffers a group (2: the next group's residuals land
// while this one's are transformed, where the bytes bound the call)
template <int N, int M, int R1, int C1, int R2, int C2, int THREADS, int PAD,
          int STAGES>
struct Cfg {
    static constexpr int TEAM = M * N / (R1 * C1);
    static_assert(TEAM == M * M / (R2 * C2), "both passes use the team");
    static_assert(THREADS % TEAM == 0 && TEAM % 4 == 0, "team size");
    static constexpr int G = THREADS / TEAM;  // transforms a CTA at once
    static constexpr int XE = G * N * N / THREADS;  // residual samples a thread
    static_assert(XE % 4 == 0 && XE * THREADS == G * N * N, "staging");
    static constexpr int GS = STAGES * N * N + N * M + PAD;  // x, tmpT
    static constexpr int MS = N * M + PAD;          // one matrix
    static_assert(GS % 4 == 0 && MS % 4 == 0, "16-byte rows");
    static size_t smem(int n_mats) {
        return sizeof(float) * ((size_t)2 * n_mats * MS + (size_t)G * GS);
    }
};

__device__ __forceinline__ void cp_async(void *dst, const void *src, int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                     "l"(src));
}

// start copying the residuals of blocks base.. into each group's x (raw
// int32; the issuing thread converts its own chunks once they land): this
// thread's XE / 4 chunks of 4 samples; grp points at the buffer to fill
template <int N, int XE, int GS, int THREADS>
__device__ __forceinline__ void issue_x(float *grp, const Args &a, int base,
                                        int tid) {
    constexpr int NN = N * N;
#pragma unroll
    for (int it = 0; it < XE / 4; it++) {
        const int i = 4 * (it * THREADS + tid);
        const int b = base + i / NN;
        if (b < a.nb) {
            float *dst = grp + (i / NN) * GS + i % NN;
            const int32_t *src = a.resid + at(a.r, b) + i % NN;
            if (a.r_vec) {
                cp_async(dst, src, 16);
            } else {
#pragma unroll
                for (int k = 0; k < 4; k++) cp_async(dst + k, src + k, 4);
            }
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N, int XE, int GS, int THREADS, int PENDING>
__device__ __forceinline__ void convert_x(float *grp, int tid) {
    constexpr int NN = N * N;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
#pragma unroll
    for (int it = 0; it < XE / 4; it++) {
        const int i = 4 * (it * THREADS + tid);
        float4 *p = reinterpret_cast<float4 *>(grp + (i / NN) * GS + i % NN);
        const int4 v = *reinterpret_cast<const int4 *>(p);
        *p = make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
    }
}

// log2(1 + lev) of the rate model: a table in shared memory for levels
// below LOG2_TAB (filled by log2f itself, so the bits are log2f's), log2f
// out of line above; lev = 0 adds log2(1) = 0 exactly, as skipping it would
constexpr int LOG2_TAB = 256;

__device__ __noinline__ float log2_1p_far(float lev) {
    return log2f(__fadd_rn(1.f, lev));
}

__device__ __forceinline__ float log2_1p(const float *tab, int lev) {
    return lev < LOG2_TAB ? tab[lev] : log2_1p_far((float)lev);
}

// FLOAT_FLOOR's level floor(num / qm), num / qm correctly rounded as the
// reference divides: from num * rq (rq = 1 / qm rounded, so within 2^-23 of
// the quotient, relative) wherever that lies more than 2^-20 of itself from
// an integer, where the rounded quotient has the same floor; else by the
// division itself, out of line, so that the unrolled epilogue stays small
__device__ __noinline__ float floor_div_exact(float num, float qm) {
    return floorf(__fdiv_rn(num, qm));
}

__device__ __forceinline__ float floor_div(float num, float qm, float rq) {
    const float qa = __fmul_rn(num, rq);
    const float fl = floorf(qa);
    const float eps = __fmul_rn(qa, 9.5367431640625e-07f);  // 2^-20
    return (qa - fl > eps && fl + 1.f - qa > eps) ? fl
                                                    : floor_div_exact(num, qm);
}

// block b's parameters (read by threads tid < G)
struct Params {
    int t, qdc, qac;
    float thr;
};

__device__ __forceinline__ Params params(const Args &a, int b) {
    Params p;
    p.t = a.tidx ? __ldg(a.tidx + at(a.t, b)) : 0;
    p.qdc = a.qdc ? __ldg(a.qdc + at(a.qd, b)) : a.qdc_val;
    p.qac = a.qac ? __ldg(a.qac + at(a.qa, b)) : a.qac_val;
    p.thr = a.thr ? __ldg(a.thr + at(a.th, b)) : 0.f;
    return p;
}

// an R x C register tile of A . B over K: A^T and B in shared memory with
// row strides M and LDB (A^T[k][r0..], B[k][c0..]), acc[i][c] one fmaf
// chain over ascending k
template <int K, int R, int C, int M, int LDB>
__device__ __forceinline__ void tile(float (&acc)[R][C], const float *at_,
                                     const float *b, int r0, int c0) {
#pragma unroll
    for (int i = 0; i < R; i++)
#pragma unroll
        for (int c = 0; c < C; c++) acc[i][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; k++) {
        float av[R], bv[C];
        lds(av, at_ + k * M + r0);
        lds(bv, b + k * LDB + c0);
#pragma unroll
        for (int i = 0; i < R; i++)
#pragma unroll
            for (int c = 0; c < C; c++) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
}

template <int N, int M, int R1, int C1, int R2, int C2, int THREADS, int PAD,
          int STAGES, bool FLOAT_FLOOR>
__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 2 : 3)
fwd_txq_kernel(const Args a) {
    using C = Cfg<N, M, R1, C1, R2, C2, THREADS, PAD, STAGES>;
    constexpr int TEAM = C::TEAM, G = C::G, XE = C::XE, NN = N * N;
    extern __shared__ __align__(16) float smem[];
    float *fvT = smem;                     // n_mats x (N x M): FvT[j][r]
    float *fh = fvT + a.n_mats * C::MS;    // n_mats x (N x M): FhT[k][c]
    float *grp = fh + a.n_mats * C::MS;    // G x (STAGES x x, tmpT)
    __shared__ int s_t[G], s_qdc[G], s_qac[G];
    __shared__ FastDiv s_fq[G][2];  // qdc, qac
    __shared__ float s_thr[G];
    constexpr int WARPS = THREADS / 32;
    __shared__ float red_d[WARPS], red_r[WARPS];
    __shared__ int red_n[WARPS];
    __shared__ float s_log2[LOG2_TAB];

    const int tid = threadIdx.x;
    for (int i = tid; i < LOG2_TAB; i += THREADS)
        s_log2[i] = log2f(__fadd_rn(1.f, (float)i));
    const int stride = gridDim.x * G;
    int base = blockIdx.x * G;
    // the first residuals and parameters in flight while the matrices load
    issue_x<N, XE, C::GS, THREADS>(grp, a, base, tid);
    Params par{};
    if (tid < G && base + tid < a.nb) par = params(a, base + tid);
    // the matrices: FhT as it is, Fv transposed
    const int total = a.n_mats * N * M;
    if constexpr (M == 32) {
        // a warp a 32 x 32 tile of Fv: lane l reads column l of its 32 rows
        // (each row one coalesced load), so it holds row l of FvT's tile
        constexpr int JT = N / 32;
        const int lane = tid % 32;
        for (int w = tid / 32; w < a.n_mats * JT; w += THREADS / 32) {
            const int t = w / JT, j = (w % JT) * 32 + lane;
            const float *src = a.Fv + (size_t)t * M * N + j;
            float v[32];
#pragma unroll
            for (int r = 0; r < 32; r++) v[r] = __ldg(src + r * N);
            float *dst = fvT + t * C::MS + j * M;
#pragma unroll
            for (int r = 0; r < 32; r += 4)
                *reinterpret_cast<float4 *>(dst + r) =
                    make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
        }
    }
    // at M < 32 consecutive threads read Fv down a column and write
    // consecutive rows r of FvT[j], so the stores do not conflict
    for (int i0 = 0; i0 < total; i0 += 8 * THREADS) {
        float fv[8], fh_[8];
#pragma unroll
        for (int k = 0; k < 8; k++) {
            const int i = i0 + k * THREADS + tid;
            const int t = i / (N * M), e = i % (N * M);
            const int j = e / M, r = e % M;
            if constexpr (M < 32)
                fv[k] = i < total ? __ldg(a.Fv + t * N * M + r * N + j) : 0.f;
            fh_[k] = i < total ? __ldg(a.FhT + i) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; k++) {
            const int i = i0 + k * THREADS + tid;
            if (i < total) {
                const int t = i / (N * M), e = i % (N * M);
                if constexpr (M < 32) fvT[t * C::MS + e] = fv[k];
                fh[t * C::MS + e] = fh_[k];
            }
        }
    }

    // a team's threads walk its tile rows first, so that the 8 threads of a
    // shared-memory phase read distinct or identical 16-byte operands
    const int g = tid / TEAM, tt = tid % TEAM;
    float *tmpT = grp + g * C::GS + STAGES * NN;
    for (int it = 0; base < a.nb; base += stride, it++) {
        const int cur = STAGES == 2 ? it & 1 : 0;
        if constexpr (STAGES == 2) {
            // the next group's residuals into the other buffer (an empty
            // group past the end, so that one group stays pending)
            const int nxt = base + stride < a.nb ? base + stride : a.nb;
            issue_x<N, XE, C::GS, THREADS>(grp + (cur ^ 1) * NN, a, nxt, tid);
            convert_x<N, XE, C::GS, THREADS, 1>(grp + cur * NN, tid);
        } else {
            if (it) issue_x<N, XE, C::GS, THREADS>(grp, a, base, tid);
            convert_x<N, XE, C::GS, THREADS, 0>(grp, tid);
        }
        const float *x = grp + g * C::GS + cur * NN;
        if (tid < G && base + tid < a.nb) {
            s_t[tid] = par.t;
            s_qdc[tid] = par.qdc;
            s_qac[tid] = par.qac;
            s_thr[tid] = par.thr;
            s_fq[tid][0] = fast_div(par.qdc);
            s_fq[tid][1] = fast_div(par.qac);
            if (base + stride + tid < a.nb) par = params(a, base + stride + tid);
        }
        __syncthreads();
        const int b = base + g;
        const bool live = b < a.nb;
        if (live) {
            // pass 1: tmp = Fv . x (tile rows r0.., columns c0..), kept
            // transposed: tmpT[c][r]
            constexpr int RT = M / R1;
            const int r0 = (tt % RT) * R1, c0 = (tt / RT) * C1;
            float acc[R1][C1];
            tile<N, R1, C1, M, N>(acc, fvT + s_t[g] * C::MS, x, r0, c0);
#pragma unroll
            for (int c = 0; c < C1; c++) {
                if constexpr (R1 % 4 == 0) {
#pragma unroll
                    for (int i = 0; i < R1; i += 4)
                        *reinterpret_cast<float4 *>(tmpT + (c0 + c) * M + r0 + i) =
                            make_float4(acc[i][c], acc[i + 1][c], acc[i + 2][c],
                                        acc[i + 3][c]);
                } else {
#pragma unroll
                    for (int i = 0; i < R1; i++)
                        tmpT[(c0 + c) * M + r0 + i] = acc[i][c];
                }
            }
        }
        __syncthreads();
        float d_acc = 0.f, r_acc = 0.f;
        int n_acc = 0;
        if (live) {
            // pass 2: y = tmp . FhT, tile rows r0.., columns c0..
            constexpr int RT = M / R2;
            const int r0 = (tt % RT) * R2, c0 = (tt / RT) * C2;
            float acc[R2][C2];
            tile<N, R2, C2, M, M>(acc, tmpT, fh + s_t[g] * C::MS, r0, c0);
            const int q_dc = s_qdc[g], q_ac = s_qac[g];
            const FastDiv f_dc = s_fq[g][0], f_ac = s_fq[g][1];
            const float thr_b = s_thr[g];
            const int shift = a.shift;
            const float scale = (float)(1 << shift);
            // FLOAT_FLOOR's q' = q / 2^shift and its reciprocal
            const float qm_dc = __fdiv_rn((float)q_dc, scale);
            const float qm_ac = __fdiv_rn((float)q_ac, scale);
            const float rq_dc = __frcp_rn(qm_dc), rq_ac = __frcp_rn(qm_ac);
#pragma unroll
            for (int i = 0; i < R2; i++) {
                int32_t lrow[C2], drow[C2];
#pragma unroll
                for (int c = 0; c < C2; c++) {
                    const int pos = (r0 + i) * M + c0 + c;
                    const float y = acc[i][c];
                    const int q = pos == 0 ? q_dc : q_ac;
                    if constexpr (FLOAT_FLOOR) {
                        const float qm = pos == 0 ? qm_dc : qm_ac;
                        const float mag = fabsf(y);
                        const float num = __fadd_rn(mag, __fmul_rn(qm, 0.40625f));
                        const float lev =
                            floor_div(num, qm, pos == 0 ? rq_dc : rq_ac);
                        const float err = __fmul_rn(
                            __fsub_rn(mag, __fmul_rn(lev, qm)), scale);
                        d_acc = __fadd_rn(d_acc, __fmul_rn(err, err));
                        n_acc += lev > 0.f;
                        r_acc = __fadd_rn(r_acc, log2_1p(s_log2, (int)lev));
                    } else {
                        const int32_t cf = (int32_t)rintf(y);
                        const int32_t xs = cf << shift;
                        const int32_t mag = xs < 0 ? -xs : xs;
                        int32_t lev = quot(mag + ((q * a.bias_num) >> 5),
                                           pos == 0 ? f_dc : f_ac);
                        lev = min(lev, 32767);
                        if (a.thr && lev == 1 && pos != 0 && (float)mag < thr_b)
                            lev = 0;
                        const int32_t sgn = (xs > 0) - (xs < 0);
                        const int32_t dmag = (lev * q) & 0xFFFFFF;
                        int32_t dqv = sgn * (dmag >> shift);
                        dqv = min(max(dqv, -a.lim), a.lim - 1);
                        lrow[c] = sgn * lev;
                        drow[c] = dqv;
                        const float qe = (float)((cf - dqv) << shift);
                        d_acc = __fadd_rn(d_acc, __fmul_rn(qe, qe));
                        n_acc += lev > 0;
                        r_acc = __fadd_rn(r_acc, log2_1p(s_log2, lev));
                    }
                }
                if constexpr (!FLOAT_FLOOR) {
                    if (a.levels) {
                        const size_t o = (size_t)b * M * M + (r0 + i) * M + c0;
                        st_row(a.levels + o, lrow);
                        st_row(a.dq + o, drow);
                    }
                }
            }
        }
        // the team's sums: xor shuffles within the warp (a team of fewer
        // than 32 threads is an aligned segment of one), then the team's
        // warps in order
#pragma unroll
        for (int off = (TEAM < 32 ? TEAM : 32) / 2; off > 0; off >>= 1) {
            d_acc = __fadd_rn(d_acc, __shfl_xor_sync(0xffffffffu, d_acc, off));
            r_acc = __fadd_rn(r_acc, __shfl_xor_sync(0xffffffffu, r_acc, off));
            n_acc += __shfl_xor_sync(0xffffffffu, n_acc, off);
        }
        if constexpr (TEAM > 32) {
            if (tid % 32 == 0) {
                red_d[tid / 32] = d_acc;
                red_r[tid / 32] = r_acc;
                red_n[tid / 32] = n_acc;
            }
            __syncthreads();
            if (tt == 0) {
                d_acc = red_d[tid / 32];
                r_acc = red_r[tid / 32];
                n_acc = red_n[tid / 32];
                for (int w = 1; w < TEAM / 32; w++) {
                    d_acc = __fadd_rn(d_acc, red_d[tid / 32 + w]);
                    r_acc = __fadd_rn(r_acc, red_r[tid / 32 + w]);
                    n_acc += red_n[tid / 32 + w];
                }
            }
        }
        if (tt == 0 && live) {
            a.dist[b] = d_acc;
            a.rate[b] = __fadd_rn(__fmul_rn(a.rate_nz, (float)n_acc),
                                  __fmul_rn(a.rate_mag, r_acc));
            if (a.nnz) a.nnz[b] = n_acc;
        }
        __syncthreads();
    }
}

// CTAs that fit on the device at once for (kernel, dynamic smem), cached
struct GridCache {
    const void *fn[64];
    size_t smem[64];
    int dev[64], ctas[64], used;
};

template <typename K>
int resident_ctas(K kernel, int threads, size_t smem) {
    static GridCache cache = {};
    int dev = 0;
    cudaGetDevice(&dev);
    for (int i = 0; i < cache.used; i++)
        if (cache.fn[i] == (const void *)kernel && cache.smem[i] == smem &&
            cache.dev[i] == dev)
            return cache.ctas[i];
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    const int ctas = sms * (per_sm > 0 ? per_sm : 1);
    if (cache.used < 64) {
        const int i = cache.used++;
        cache.fn[i] = (const void *)kernel;
        cache.smem[i] = smem;
        cache.dev[i] = dev;
        cache.ctas[i] = ctas;
    }
    return ctas;
}

template <int N, int M, int R1, int C1, int R2, int C2, int THREADS, int PAD,
          int STAGES>
int run(const Args &a, bool float_floor, cudaStream_t stream) {
    using C = Cfg<N, M, R1, C1, R2, C2, THREADS, PAD, STAGES>;
    auto kernel =
        float_floor
            ? fwd_txq_kernel<N, M, R1, C1, R2, C2, THREADS, PAD, STAGES, true>
            : fwd_txq_kernel<N, M, R1, C1, R2, C2, THREADS, PAD, STAGES, false>;
    const size_t smem = C::smem(a.n_mats);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    const int groups = (a.nb + C::G - 1) / C::G;
    const int cap = resident_ctas(kernel, THREADS, smem);
    kernel<<<groups < cap ? groups : cap, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// ptrs: 12 host pointers: resid, Fv, FhT, tidx, qdc, qac, thr (inputs),
// levels, dq, dist, rate, nnz (outputs).  args: 25 host ints: 5 x (div,
// mod, stride) for resid (stride in elements, each block's n x n
// contiguous), tidx, qdc, qac, thr; then n_blocks, n, m, n_mats, qdc_val,
// qac_val, shift, bias_num, lim, float_floor.  A null qdc / qac takes
// qdc_val / qac_val for every block; a null tidx reads matrix 0; a null
// thr does not thin; a null levels (and dq) makes the call sums-only; a
// null nnz skips that output.  (Two arrays, so that the host's foreign
// call converts five arguments, not thirty-seven.)
extern "C" int fwd_txq(void *const *ptrs, const int *args, float rate_nz,
                       float rate_mag, void *stream) {
    const int *v = args + 15;
    const int n_blocks = v[0], n = v[1], m = v[2];
    if (n_blocks <= 0) return 0;
    Args a;
    a.resid = (const int32_t *)ptrs[0];
    a.Fv = (const float *)ptrs[1];
    a.FhT = (const float *)ptrs[2];
    a.tidx = (const int32_t *)ptrs[3];
    a.qdc = (const int32_t *)ptrs[4];
    a.qac = (const int32_t *)ptrs[5];
    a.thr = (const float *)ptrs[6];
    Idx *idx[5] = {&a.r, &a.t, &a.qd, &a.qa, &a.th};
    for (int i = 0; i < 5; i++) {
        idx[i]->div = fast_div(args[3 * i] > 0 ? args[3 * i] : 1);
        idx[i]->mod = fast_div(args[3 * i + 1] > 0 ? args[3 * i + 1] : 1);
        idx[i]->stride = args[3 * i + 2];
    }
    a.r_vec = ((uintptr_t)ptrs[0] % 16 == 0) && (args[2] % 4 == 0);
    a.nb = n_blocks;
    a.n_mats = v[3];
    a.qdc_val = v[4];
    a.qac_val = v[5];
    a.shift = v[6];
    a.bias_num = v[7];
    a.lim = v[8];
    a.rate_nz = rate_nz;
    a.rate_mag = rate_mag;
    a.levels = (int32_t *)ptrs[7];
    a.dq = (int32_t *)ptrs[8];
    a.dist = (float *)ptrs[9];
    a.rate = (float *)ptrs[10];
    a.nnz = (int32_t *)ptrs[11];
    const bool ff = v[9] != 0;
    cudaStream_t s = (cudaStream_t)stream;
    // <N, M, R1, C1, R2, C2, THREADS, PAD, STAGES>
    if (n == 4 && m == 4) return run<4, 4, 4, 1, 1, 4, 256, 4, 2>(a, ff, s);
    if (n == 8 && m == 8) return run<8, 8, 8, 1, 1, 8, 256, 8, 2>(a, ff, s);
    if (n == 16 && m == 16)
        return run<16, 16, 4, 4, 4, 4, 256, 16, 1>(a, ff, s);
    if (n == 32 && m == 32) return run<32, 32, 4, 8, 4, 8, 256, 0, 2>(a, ff, s);
    if (n == 64 && m == 32) return run<64, 32, 4, 8, 4, 4, 128, 0, 1>(a, ff, s);
    return (int)cudaErrorInvalidValue;
}
