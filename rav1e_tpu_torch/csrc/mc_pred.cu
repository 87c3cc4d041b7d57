// K9 mc_pred: single-reference 8-tap separable subpel motion compensation
// of a batch of same-size blocks (spec 7.11.3.4 block_inter_prediction,
// unscaled, non-compound), bit-exact, int32.
//
// Replaces rav1e_tpu/ops/mc_jax.py:71 mc_block_batch (jit :109
// _put_batch_jit), as run by models/wavefront.py:416 _inter_level for
// every inter candidate of the P-frame pass.  The TPU version gathers
// every block's window with a vmapped dynamic_slice and runs the two
// passes as eight broadcast multiply-adds each over the whole batch.
// Here one CTA owns one block:
//   1. the (h + 7) x (w + 7) window at ((py << 4) + (mvr << (1 - sub_y)))
//      >> 4 minus 3 (rows; columns alike) plus the margin is staged from
//      the uint8 padded plane into shared int32;
//   2. the horizontal pass writes the shared (h + 7) x w int32 tile,
//      rounded (x + 4) >> 3 (InterRound0 = 3);
//   3. the vertical pass rounds (x + 1024) >> 11 (InterRound1 = 11),
//      clips to [0, 255] and writes the int32 prediction.
// Above 8 bits (put_single_batch, mc_jax.py:116) the plane is uint16 and
// the passes round by 3 and 11 (10-bit) or 5 and 9 (12-bit, InterRound0
// = 5) and clip to (1 << bd) - 1.
// The 1/16-pel phase is start & 15 per axis; the caller's 16 x 8 tap
// table (REGULAR on the encode path, any filter set through
// put_single_batch) sits in constant memory (copied from the caller's
// device table on the launch's stream).  Window coordinates are clamped to the
// plane so a read can never leave it; the caller's MV clip and margin keep
// every window inside, so the clamp never changes a sample (the plain
// version asserts it).
//
// Bound on the H100: bytes (the int32 prediction written, 4 bytes a
// sample, against ~40 integer operations a sample); this first version
// uses 256 threads a CTA and one output sample a thread per loop step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
__constant__ int32_t c_taps[16 * 8];

template <typename T>
__global__ void mc_pred_kernel(const T *__restrict__ ref, int stride,
                               int ref_h, int ref_w, int margin,
                               const int32_t *__restrict__ px,
                               const int32_t *__restrict__ py,
                               const int32_t *__restrict__ mvr,
                               const int32_t *__restrict__ mvc, int w, int h,
                               int sub_x, int sub_y, int bd,
                               int32_t *__restrict__ out) {
    extern __shared__ int32_t sm[];
    const int ww = w + 7, wh = h + 7;
    int32_t *win = sm;             // wh * ww samples
    int32_t *mid = sm + wh * ww;   // wh * w after the horizontal pass
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int sx = (px[b] << 4) + (mvc[b] << (1 - sub_x));
    const int sy = (py[b] << 4) + (mvr[b] << (1 - sub_y));
    const int ix = (sx >> 4) - 3 + margin, iy = (sy >> 4) - 3 + margin;
    const int fx = sx & 15, fy = sy & 15;
    for (int i = tid; i < wh * ww; i += THREADS) {
        const int r = min(max(iy + i / ww, 0), ref_h - 1);
        const int c = min(max(ix + i % ww, 0), ref_w - 1);
        win[i] = ref[(size_t)r * stride + c];
    }
    __syncthreads();
    const int round0 = bd < 12 ? 3 : 5, round1 = 14 - round0;
    const int hi = (1 << bd) - 1;
    const int32_t *tx = c_taps + fx * 8;
    const int32_t *ty = c_taps + fy * 8;
    for (int i = tid; i < wh * w; i += THREADS) {
        const int r = i / w, c = i % w;
        const int32_t *s = win + r * ww + c;
        int32_t acc = 0;
#pragma unroll
        for (int t = 0; t < 8; t++) acc += tx[t] * s[t];
        mid[i] = (acc + (1 << (round0 - 1))) >> round0;
    }
    __syncthreads();
    int32_t *o = out + (size_t)b * h * w;
    for (int i = tid; i < h * w; i += THREADS) {
        const int r = i / w, c = i % w;
        const int32_t *s = mid + r * w + c;
        int32_t acc = 0;
#pragma unroll
        for (int t = 0; t < 8; t++) acc += ty[t] * s[t * w];
        o[i] = min(max((acc + (1 << (round1 - 1))) >> round1, 0), hi);
    }
}

}  // namespace

extern "C" int mc_pred(const void *ref, int elt, int stride, int ref_h,
                       int ref_w, int margin, const void *px, const void *py,
                       const void *mvr, const void *mvc, int n_blocks, int w,
                       int h, int sub_x, int sub_y, int bd, const void *taps,
                       void *out, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemcpyToSymbolAsync(c_taps, taps, sizeof(int32_t) * 128,
                                            0, cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    if (n_blocks > 0) {
        const size_t smem = sizeof(int32_t) * ((size_t)(h + 7) * (w + 7)
                                               + (size_t)(h + 7) * w);
        if (elt == 1)
            mc_pred_kernel<uint8_t><<<n_blocks, THREADS, smem, s>>>(
                (const uint8_t *)ref, stride, ref_h, ref_w, margin,
                (const int32_t *)px, (const int32_t *)py,
                (const int32_t *)mvr, (const int32_t *)mvc, w, h, sub_x,
                sub_y, bd, (int32_t *)out);
        else
            mc_pred_kernel<uint16_t><<<n_blocks, THREADS, smem, s>>>(
                (const uint16_t *)ref, stride, ref_h, ref_w, margin,
                (const int32_t *)px, (const int32_t *)py,
                (const int32_t *)mvr, (const int32_t *)mvc, w, h, sub_x,
                sub_y, bd, (int32_t *)out);
    }
    return (int)cudaGetLastError();
}
