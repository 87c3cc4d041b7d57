// K2 fwd_txq: forward transform + quantise + dequantise + RD sums, fused.
//
// Replaces rav1e_tpu/ops/transforms_jax.py:465 fdct_batch, :489 quantize and
// :511 dequantize, the tx-domain RD sums of models/wavefront.py:640-646 with
// coeff_rate (545), the level-1 thinning of the inter candidate race
// (models/wavefront.py:441-445, :478-482), and (variant FLOAT_FLOOR) the
// float RD of models/device_pipeline.py:156 rd_analysis (170-183).  On the TPU the
// transform is an fp32 einsum on the matrix unit and the rest separate
// elementwise passes; here one block owns one transform and nothing but the
// outputs leaves the SM.
//
// Per block: the int32 residual (n x n) goes to shared memory; pass 1 is
// tmp = Fv . x (fp32 FMA, m x n), pass 2 y = tmp . FhT (m x m), both plain
// fp32 on the CUDA cores (no TF32, no tensor cores).  Then, per coefficient:
//   INT variant:   c = rintf(y) (half to even, like jnp.round); level =
//                  min((|c << shift| + bias) / q, 32767) exact; dequant with
//                  the 24-bit mask and clamp; dist += ((c - dq) << shift)^2,
//                  nz and log2(1 + |level|) summed for the rate model.
//                  With a per-block threshold thr (the inter race), a
//                  level of magnitude 1 off the DC position is dropped
//                  where (float)|c << shift| < thr[block], before the
//                  dequantiser, so dequant, dist and rate see the thinned
//                  levels.
//   FLOAT_FLOOR (a template parameter, chosen at the C entry):
//                  level = floor((|y| + q' * 13/32) / q') with q' = q / 2^shift
//                  in fp32 (each op rounded separately, as XLA does); dist +=
//                  ((|y| - level q') 2^shift)^2.
// Sums reduce in a fixed tree, so a run is deterministic.
//
// Bound on the H100: operations.  The two products cost 2*m*n*(n+m) flops a
// block against 4n^2 + 8m^2 bytes, ~10-20 flops a byte at n = 16..64.  This
// first version reads the matrices from L1/L2 and uses one thread an output,
// so it sits well below the 67 TFLOP/s fp32 peak.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool FLOAT_FLOOR>
__global__ void fwd_txq_kernel(const int32_t *__restrict__ resid, int n,
                               int m, const float *__restrict__ Fv,
                               const float *__restrict__ FhT,
                               const int32_t *__restrict__ tidx,
                               const int32_t *__restrict__ qdc,
                               const int32_t *__restrict__ qac,
                               const float *__restrict__ thr, int shift,
                               int bias_num, int lim,
                               float rate_nz, float rate_mag,
                               int32_t *__restrict__ levels,
                               int32_t *__restrict__ dqout,
                               float *__restrict__ dist,
                               float *__restrict__ rate,
                               int32_t *__restrict__ nnz) {
    extern __shared__ float smem[];
    float *x = smem;          // n * n residual
    float *tmp = x + n * n;   // m * n  (Fv . x)
    __shared__ float red_d[THREADS], red_r[THREADS];
    __shared__ int red_n[THREADS];

    const int blk = blockIdx.x;
    const int tid = threadIdx.x;
    const int t = tidx ? tidx[blk] : 0;
    const float *fv = Fv + (size_t)t * m * n;
    const float *fh = FhT + (size_t)t * n * m;
    const int32_t *r = resid + (size_t)blk * n * n;
    for (int i = tid; i < n * n; i += THREADS) x[i] = (float)r[i];
    __syncthreads();
    for (int i = tid; i < m * n; i += THREADS) {
        const int row = i / n, col = i % n;
        float acc = 0.f;
        for (int j = 0; j < n; j++) acc = fmaf(fv[row * n + j], x[j * n + col], acc);
        tmp[i] = acc;
    }
    __syncthreads();
    const int q_dc = qdc[blk], q_ac = qac[blk];
    const float thr_b = thr ? thr[blk] : 0.f;
    float d_acc = 0.f, r_acc = 0.f;
    int n_acc = 0;
    for (int i = tid; i < m * m; i += THREADS) {
        const int row = i / m, col = i % m;
        float y = 0.f;
        for (int k = 0; k < n; k++) y = fmaf(tmp[row * n + k], fh[k * m + col], y);
        const int q = (i == 0) ? q_dc : q_ac;
        if constexpr (FLOAT_FLOOR) {
            const float qm = __fdiv_rn((float)q, (float)(1 << shift));
            const float mag = fabsf(y);
            const float lev = floorf(__fdiv_rn(__fadd_rn(mag, __fmul_rn(qm, 0.40625f)), qm));
            const float err = __fmul_rn(__fsub_rn(mag, __fmul_rn(lev, qm)), (float)(1 << shift));
            d_acc = __fadd_rn(d_acc, __fmul_rn(err, err));
            n_acc += lev > 0.f;
            r_acc = __fadd_rn(r_acc, log2f(__fadd_rn(1.f, lev)));
        } else {
            const int32_t c = (int32_t)rintf(y);
            const int32_t xs = c << shift;
            const int32_t mag = xs < 0 ? -xs : xs;
            int32_t lev = (mag + ((q * bias_num) >> 5)) / q;
            lev = min(lev, 32767);
            if (thr && lev == 1 && i != 0 && (float)mag < thr_b) lev = 0;
            const int32_t sgn = (xs > 0) - (xs < 0);
            const int32_t dmag = (lev * q) & 0xFFFFFF;
            int32_t dq = sgn * (dmag >> shift);
            dq = min(max(dq, -lim), lim - 1);
            levels[(size_t)blk * m * m + i] = sgn * lev;
            dqout[(size_t)blk * m * m + i] = dq;
            const float qe = (float)((c - dq) << shift);
            d_acc = __fadd_rn(d_acc, __fmul_rn(qe, qe));
            n_acc += lev > 0;
            r_acc = __fadd_rn(r_acc, log2f(__fadd_rn(1.f, (float)lev)));
        }
    }
    red_d[tid] = d_acc;
    red_r[tid] = r_acc;
    red_n[tid] = n_acc;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (tid < s) {
            red_d[tid] = __fadd_rn(red_d[tid], red_d[tid + s]);
            red_r[tid] = __fadd_rn(red_r[tid], red_r[tid + s]);
            red_n[tid] += red_n[tid + s];
        }
        __syncthreads();
    }
    if (tid == 0) {
        dist[blk] = red_d[0];
        rate[blk] = __fadd_rn(__fmul_rn(rate_nz, (float)red_n[0]),
                              __fmul_rn(rate_mag, red_r[0]));
        nnz[blk] = red_n[0];
    }
}

}  // namespace

extern "C" int fwd_txq(const void *resid, int n_blocks, int n, int m,
                       const void *Fv, const void *FhT, const void *tidx,
                       const void *qdc, const void *qac, const void *thr,
                       int shift,
                       int bias_num, int lim, int float_floor, float rate_nz,
                       float rate_mag, void *levels, void *dq, void *dist,
                       void *rate, void *nnz, void *stream) {
    if (n_blocks > 0) {
        const size_t smem = (size_t)(n * n + m * n) * sizeof(float);
        auto kernel = float_floor ? fwd_txq_kernel<true> : fwd_txq_kernel<false>;
        kernel<<<n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
            (const int32_t *)resid, n, m, (const float *)Fv,
            (const float *)FhT, (const int32_t *)tidx, (const int32_t *)qdc,
            (const int32_t *)qac, (const float *)thr, shift, bias_num, lim,
            rate_nz, rate_mag,
            (int32_t *)levels, (int32_t *)dq, (float *)dist, (float *)rate,
            (int32_t *)nnz);
    }
    return (int)cudaGetLastError();
}
