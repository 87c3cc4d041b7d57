// K13 dr_predict: AV1 directional intra prediction at a per-lane angle
// (spec 7.11.2.4, edge filter and upsampling off), bit-exact, int32.
//
// Replaces rav1e_tpu/ops/intra_jax.py:144 dr_predict_batch (and its six
// calls at the base angles in :100 predict_stack).  The TPU version
// computes all three zones for every sample of every lane, each with two
// take_along_axis gathers from the edges, and selects by the lane's
// angle.  Here one thread owns one output sample and computes only its
// lane's zone:
//   zone 1 (angle < 90) from the above edge, with the samples at and past
//   max_base_x = w + h - 1 taking above[max_base_x];
//   zone 2 (90 < angle < 180) from above where base_x >= -1, else left;
//   zone 3 (angle > 180) from the left edge, max_base_y alike;
//   exactly 90 and 180 copy above / left.
// Edge indices are clamped to [0, w + h], as the JAX function clamps
// them, and derivative indices into dr_intra_derivative's 90 entries
// (JAX clamps into a zero-padded 274-entry table; the zone an angle
// selects indexes below 90 for every angle, so the predictions agree).
//
// Bound on the H100: bytes (the int32 prediction written, 4 bytes a
// sample, against ~12 integer operations a sample).  This first version
// reads the edges straight from device memory (they stay in L1/L2).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int DR_LAST = 89;  // dr_intra_derivative: 90 entries

__global__ void dr_predict_kernel(const int32_t *__restrict__ above,
                                  const int32_t *__restrict__ left,
                                  const int32_t *__restrict__ p_angle, int B,
                                  int w, int h,
                                  const int32_t *__restrict__ dr,
                                  int32_t *__restrict__ out) {
    const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= (size_t)B * h * w) return;
    const int b = (int)(idx / (h * w));
    const int rem = (int)(idx % (h * w));
    const int r = rem / w, c = rem % w;
    const int ne = w + h;
    const int32_t *A = above + (size_t)b * (ne + 1);
    const int32_t *L = left + (size_t)b * (ne + 1);
    const int pa = p_angle[b];
#define EDGE(e, i) (e)[min(max((i), 0), ne)]
#define DR(i) dr[min(max((i), 0), DR_LAST)]
    const int mx = ne - 1;
    int v;
    if (pa < 90) {
        const int xpos = (r + 1) * DR(pa);
        const int bx = (xpos >> 6) + c;
        const int s = (xpos >> 1) & 0x1F;
        v = bx >= mx ? A[1 + mx]
                     : (EDGE(A, 1 + bx) * (32 - s) + EDGE(A, 2 + bx) * s + 16) >> 5;
    } else if (pa == 90) {
        v = A[1 + c];
    } else if (pa < 180) {
        const int xpos = (c << 6) - (r + 1) * DR(180 - pa);
        const int bx = xpos >> 6;
        if (bx >= -1) {
            const int s = (xpos >> 1) & 0x1F;
            v = (EDGE(A, 1 + bx) * (32 - s) + EDGE(A, 2 + bx) * s + 16) >> 5;
        } else {
            const int ypos = (r << 6) - (c + 1) * DR(pa - 90);
            const int by = ypos >> 6;
            const int s = (ypos >> 1) & 0x1F;
            v = (EDGE(L, 1 + by) * (32 - s) + EDGE(L, 2 + by) * s + 16) >> 5;
        }
    } else if (pa == 180) {
        v = L[1 + r];
    } else {
        const int ypos = (c + 1) * DR(270 - pa);
        const int by = (ypos >> 6) + r;
        const int s = (ypos >> 1) & 0x1F;
        v = by >= mx ? L[1 + mx]
                     : (EDGE(L, 1 + by) * (32 - s) + EDGE(L, 2 + by) * s + 16) >> 5;
    }
#undef EDGE
#undef DR
    out[idx] = v;
}

}  // namespace

extern "C" int dr_predict(const void *above, const void *left,
                          const void *p_angle, int B, int w, int h,
                          const void *dr, void *out, void *stream) {
    const size_t total = (size_t)B * h * w;
    if (total > 0) {
        const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
        dr_predict_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const int32_t *)above, (const int32_t *)left,
            (const int32_t *)p_angle, B, w, h, (const int32_t *)dr,
            (int32_t *)out);
    }
    return (int)cudaGetLastError();
}
