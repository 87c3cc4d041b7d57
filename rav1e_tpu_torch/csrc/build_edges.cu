// K14 build_edges: the AV1 intra edge build (spec 7.11.2) of a batch of
// blocks, int32, bit-exact.
//
// Replaces rav1e_tpu/ops/intra_jax.py:44 build_edges_batch.  The TPU
// version gathers every lane's (w + h) above and left samples from the
// reconstructed plane with clamped indices and selects by availability.
// Here one thread owns one (lane, edge index) pair and writes above[j]
// and left[j] of its lane, j = 0 being the top-left corner:
//   above[1 + i]: rec[max(y - 1, 0), min(x + min(i, w + min(n_tr, h) - 1),
//                 max_x)] where the above row is available, else the
//                 sample left of the block's top row where the left
//                 column is, else (1 << (bd - 1)) - 1;
//   left[1 + i]:  rec[min(y + min(i, h + min(n_bl, w) - 1), max_y),
//                 max(x - 1, 0)] where the left column is available, else
//                 the sample above the block's left column where the
//                 above row is, else (1 << (bd - 1)) + 1;
//   the corner:   rec[y - 1, x - 1] with both, the above or the left
//                 neighbour with one, else 1 << (bd - 1).
// Every plane index is clamped into the plane, as JAX's gathers clamp.
//
// Bound on the H100: bytes (two int32 edge samples written a thread,
// and the rec samples they read: ~16 bytes an edge index, a few integer
// operations).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void build_edges_kernel(const int32_t *__restrict__ rec, int H,
                                   int W, int stride,
                                   const int32_t *__restrict__ ys,
                                   const int32_t *__restrict__ xs,
                                   const int32_t *__restrict__ ha,
                                   const int32_t *__restrict__ hl,
                                   const int32_t *__restrict__ n_tr,
                                   const int32_t *__restrict__ n_bl, int B,
                                   int w, int h, int max_x, int max_y, int bd,
                                   int32_t *__restrict__ above,
                                   int32_t *__restrict__ left) {
    const int n = w + h;
    const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= (size_t)B * (n + 1)) return;
    const int b = (int)(idx / (n + 1)), j = (int)(idx % (n + 1));
#define REC(r, c) rec[(size_t)min(max((r), 0), H - 1) * stride \
                      + min(max((c), 0), W - 1)]
    const int y = ys[b], x = xs[b];
    const bool a = ha[b] != 0, l = hl[b] != 0;
    const int base = 1 << (bd - 1);
    const int row_above = max(y - 1, 0), col_left = max(x - 1, 0);
    int av, lv;
    if (j == 0) {
        av = lv = (a && l) ? REC(row_above, col_left)
                 : a ? REC(row_above, x)
                 : l ? REC(y, col_left)
                 : base;
    } else {
        const int i = j - 1;
        const int avail_a = w + min(n_tr[b], h);
        const int col = min(x + min(i, avail_a - 1), max_x);
        av = a ? REC(row_above, col) : (l ? REC(y, col_left) : base - 1);
        const int avail_l = h + min(n_bl[b], w);
        const int row = min(y + min(i, avail_l - 1), max_y);
        lv = l ? REC(row, col_left) : (a ? REC(row_above, x) : base + 1);
    }
#undef REC
    above[idx] = av;
    left[idx] = lv;
}

}  // namespace

extern "C" int build_edges(const void *rec, int H, int W, int stride,
                           const void *ys, const void *xs, const void *ha,
                           const void *hl, const void *n_tr, const void *n_bl,
                           int B, int w, int h, int max_x, int max_y, int bd,
                           void *above, void *left, void *stream) {
    const size_t total = (size_t)B * (w + h + 1);
    if (total > 0) {
        const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
        build_edges_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const int32_t *)rec, H, W, stride, (const int32_t *)ys,
            (const int32_t *)xs, (const int32_t *)ha, (const int32_t *)hl,
            (const int32_t *)n_tr, (const int32_t *)n_bl, B, w, h, max_x,
            max_y, bd, (int32_t *)above, (int32_t *)left);
    }
    return (int)cudaGetLastError();
}
