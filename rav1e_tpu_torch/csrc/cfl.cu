// K11 cfl: chroma-from-luma for 4:2:0 (spec 7.11.5), the encoder's alpha
// fit and the CFL prediction and residual of both chroma planes, int32.
//
// Replaces rav1e_tpu/ops/intra_jax.py:317 cfl_ac_420_batch and :329
// cfl_predict_batch with the alpha fit of models/wavefront.py:709-717.  The
// TPU version runs them as separate batched array programs: the 2x2 luma
// sums and the mean, two f32 reductions a plane for the fit (sum of
// res * ac and of ac^2), then the scaled prediction.  Here one CTA owns one
// block: the (n/2)^2 AC values stay in shared memory, the three sums
// (ac^2, and res * ac for U and V) are exact integer block reductions, and
// the prediction and the residual src - pred of both planes are written in
// the same pass, so nothing but the inputs and the outputs touches device
// memory.
//
// The fit: alpha = round_half_even(f32(64 * sum(res * ac)) / max(f32(sum
// (ac^2)), 1)) clipped to [-16, 16], and 0 where sum(ac^2) == 0.  Each
// exact sum is rounded to f32 once; the JAX version sums in f32 in XLA's
// order, so an alpha may differ where its f32 sums round (a sum above
// 2^24) or where the quotient lies at a .5 tie.
//
// Layout: grid (blocks), 256 threads, one thread an AC sample (n/2 <= 16).
// Bound on the H100: bytes (the luma block, two DC predictions and two
// source blocks in; two predictions, two residuals and two alphas out; a
// few integer operations a sample).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Sums v over the CTA (NT threads); every thread gets the total.
__device__ long long block_sum(long long v, long long *red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_sum(v);
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    long long t = 0;
#pragma unroll
    for (int k = 0; k < NT / 32; k++) t += red[k];
    return t;
}

__device__ __forceinline__ int fit_alpha(long long num, long long den) {
    if (den == 0) return 0;
    const float q = __fdiv_rn(__fmul_rn(__ll2float_rn(num), 64.0f),
                              fmaxf(__ll2float_rn(den), 1.0f));
    const float a = rintf(q);  // half to even, as jnp.round
    return (int)fminf(fmaxf(a, -16.0f), 16.0f);
}

// luma (nb, n, n); dc, src, pred, resid (nb, 2, n2, n2); alpha (nb, 2).
__global__ void __launch_bounds__(NT)
cfl_kernel(const int32_t *__restrict__ luma, int n,
           const int32_t *__restrict__ dc, const int32_t *__restrict__ src,
           int maxval, int32_t *__restrict__ alpha,
           int32_t *__restrict__ pred, int32_t *__restrict__ resid) {
    __shared__ long long red[NT / 32];
    const int n2 = n >> 1, m = n2 * n2, t = threadIdx.x;
    const size_t b = blockIdx.x;
    const int32_t *lb = luma + b * n * n;
    int L = 0;
    if (t < m) {
        const int r = t / n2, c = t % n2;
        const int32_t *p = lb + (2 * r) * n + 2 * c;
        L = (p[0] + p[1] + p[n] + p[n + 1]) << 1;
    }
    const int log2sz = 31 - __clz(m);
    const long long tot = block_sum(L, red);
    const int avg = (int)((tot + (1 << (log2sz - 1))) >> log2sz);
    const int ac = t < m ? L - avg : 0;
    int res[2] = {0, 0};
    if (t < m) {
#pragma unroll
        for (int p = 0; p < 2; p++) {
            const size_t o = (b * 2 + p) * m + t;
            res[p] = src[o] - dc[o];
        }
    }
    const long long den = block_sum((long long)ac * ac, red);
    const long long nu = block_sum((long long)res[0] * ac, red);
    const long long nv = block_sum((long long)res[1] * ac, red);
    const int a[2] = {fit_alpha(nu, den), fit_alpha(nv, den)};
    if (t == 0) {
        alpha[b * 2] = a[0];
        alpha[b * 2 + 1] = a[1];
    }
    if (t < m) {
#pragma unroll
        for (int p = 0; p < 2; p++) {
            const size_t o = (b * 2 + p) * m + t;
            const int prod = a[p] * ac;
            const int mag = (abs(prod) + 32) >> 6;
            const int scaled = prod < 0 ? -mag : (prod > 0 ? mag : 0);
            const int pc = min(max(dc[o] + scaled, 0), maxval);
            pred[o] = pc;
            resid[o] = src[o] - pc;
        }
    }
}

}  // namespace

extern "C" int cfl(const void *luma, int nb, int n, const void *dc,
                   const void *src, int bd, void *alpha, void *pred,
                   void *resid, void *stream) {
    if (nb > 0) {
        cfl_kernel<<<nb, NT, 0, (cudaStream_t)stream>>>(
            (const int32_t *)luma, n, (const int32_t *)dc,
            (const int32_t *)src, (1 << bd) - 1, (int32_t *)alpha,
            (int32_t *)pred, (int32_t *)resid);
    }
    return (int)cudaGetLastError();
}
