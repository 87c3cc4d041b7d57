// K4 deblock: one direction of the normative AV1 deblocking filter
// (spec 7.14), 4/6/8/14 taps, bit-exact, int32, at bit depth 8, 10 or 12.
//
// Replaces rav1e_tpu/ops/deblock_jax.py:125 _pass_dir with :35 _filter_taps,
// as run by the deblock part of ops/filter_chain_jax.py:184-203.  The TPU
// version builds every edge's 14-sample window from static lane shifts and
// selects the written taps back.  Here one thread owns one (line, edge)
// pair: it reads the 7 samples on each side of the edge from the pass's
// input plane, derives the filter size from the per-mi maps exactly as
// _pass_dir does, runs the filter, and writes the taps its mask selects to
// the output plane (a copy of the input).  Reads come from the unmodified
// input, as in the dense JAX pass; the spec's tap-length rule makes the
// writes of different edges disjoint.
//
// The plane is addressed through strides, so the vertical-edge pass
// (edges along rows) and the horizontal-edge pass (the transposed view)
// are the same kernel.
//
// The slab window (rav1e_tpu/parallel/tiles.py:153 deblock_sharded, its
// edge_valid mask at :216-219): the pass may run over a column slab of a
// wider plane, its neighbours' halo columns included, whose column 0 lies
// at plane x = x0 (negative where the slab starts with a halo).  An edge
// filters only where its plane x, ex + x0, is an edge of the plane (4 <=
// ex + x0 <= plane_w - 4), and it is a transform edge where its plane x is
// a multiple of the transform width.  With x0 = 0 and plane_w = w the
// window is the whole view, as for a whole plane.
//
// Bound on the H100: bytes (one read and at most one write of each
// sample; ~100 integer operations per line and edge).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }
__device__ __forceinline__ int r3(int x) { return (x + 4) >> 3; }
__device__ __forceinline__ int r4(int x) { return (x + 8) >> 4; }

// img: h lines (along the edge) x w samples (across), element (y, x) at
// y * s_line + x * s_samp.  Maps: element (mi_along, mi_across) at
// mi_along * m_line + mi_across * m_samp.
__global__ void deblock_pass_kernel(const int32_t *__restrict__ in,
                                    int32_t *__restrict__ out, int h, int w,
                                    int s_line, int s_samp,
                                    const int32_t *__restrict__ tx_across,
                                    const int32_t *__restrict__ bpos,
                                    const uint8_t *__restrict__ skip,
                                    int m_line, int m_samp, int s_along,
                                    int s_across, int limit, int blimit,
                                    int thresh, int plane_idx, int x0,
                                    int plane_w, int F) {
    const int E = w / 4 - 1;  // edges at x = 4, 8, ..., 4E
    const long long total = (long long)h * E;
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
         t += (long long)gridDim.x * blockDim.x) {
        const int y = (int)(t / E);
        const int ex = ((int)(t % E) + 1) * 4;
        const int xp = ex + x0;  // the edge's plane x
        if (xp < 4 || xp > plane_w - 4) continue;
        const int mi_along = ((y & ~3) << s_along) >> 2;
        const int mi_cur = (ex << s_across) >> 2;
        const int mi_prev = ((ex - 1) << s_across) >> 2;
        const int mc = mi_along * m_line + mi_cur * m_samp;
        const int mp = mi_along * m_line + mi_prev * m_samp;
        const int cur_tx = tx_across[mc], prev_tx = tx_across[mp];
        const bool is_tx_edge = (xp % max(cur_tx, 1)) == 0;
        const bool is_blk = bpos[mc] == ex;
        const bool apply = is_tx_edge && (is_blk || !skip[mc] || !skip[mp]);
        if (!apply) continue;
        const int sa = min(cur_tx, prev_tx);
        const int size = plane_idx == 0 ? (sa >= 16 ? 14 : (sa >= 8 ? 8 : 4))
                                        : (sa >= 8 ? 6 : 4);
        const int32_t *row = in + (size_t)y * s_line;
        int p[7], q[7];  // p[k] = sample ex - 1 - k, q[k] = sample ex + k
        for (int k = 0; k < 7; k++) {
            p[k] = row[(size_t)clampi(ex - 1 - k, 0, w - 1) * s_samp];
            q[k] = row[(size_t)clampi(ex + k, 0, w - 1) * s_samp];
        }
        const int p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3], p4 = p[4], p5 = p[5], p6 = p[6];
        const int q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3], q4 = q[4], q5 = q[5], q6 = q[6];
        const bool fm4 = abs(p1 - p0) <= limit && abs(q1 - q0) <= limit &&
                         abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= blimit;
        const bool fm6 = fm4 && abs(p2 - p1) <= limit && abs(q2 - q1) <= limit;
        const bool fm8 = fm6 && abs(p3 - p2) <= limit && abs(q3 - q2) <= limit;
        const bool flat = abs(p1 - p0) <= F && abs(q1 - q0) <= F &&
                          abs(p2 - p0) <= F && abs(q2 - q0) <= F;
        const bool flat8 = flat && abs(p3 - p0) <= F && abs(q3 - q0) <= F;
        const bool flat2 = abs(p4 - p0) <= F && abs(q4 - q0) <= F &&
                           abs(p5 - p0) <= F && abs(q5 - q0) <= F &&
                           abs(p6 - p0) <= F && abs(q6 - q0) <= F;
        const bool mask = size >= 8 ? fm8 : (size == 6 ? fm6 : fm4);
        if (!mask) continue;
        int np[6], nq[6];  // new values of p[0..5] / q[0..5]
        int wp = 0, wq = 0;  // taps written on each side
        if (size == 14 && flat8 && flat2) {
            np[5] = r4(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0);
            np[4] = r4(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1);
            np[3] = r4(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2);
            np[2] = r4(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3);
            np[1] = r4(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4);
            np[0] = r4(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5);
            nq[0] = r4(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6);
            nq[1] = r4(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2);
            nq[2] = r4(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3);
            nq[3] = r4(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4);
            nq[4] = r4(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5);
            nq[5] = r4(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7);
            wp = wq = 6;
        } else if (size >= 8 && flat8) {
            np[2] = r3(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0);
            np[1] = r3(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1);
            np[0] = r3(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2);
            nq[0] = r3(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3);
            nq[1] = r3(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3);
            nq[2] = r3(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3);
            wp = wq = 3;
        } else if (size == 6 && flat) {
            np[1] = r3(p2 * 3 + p1 * 2 + p0 * 2 + q0);
            np[0] = r3(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1);
            nq[0] = r3(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2);
            nq[1] = r3(p0 + q0 * 2 + q1 * 2 + q2 * 3);
            wp = wq = 2;
        } else {
            const int lo = -128 * F, hi = 128 * F - 1;
            const int ps1 = p1 - 128 * F, ps0 = p0 - 128 * F;
            const int qs0 = q0 - 128 * F, qs1 = q1 - 128 * F;
            const bool hev = abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
            int f = hev ? clampi(ps1 - qs1, lo, hi) : 0;
            f = clampi(f + 3 * (qs0 - ps0), lo, hi);
            const int f1 = clampi(f + 4, lo, hi) >> 3;
            const int f2 = clampi(f + 3, lo, hi) >> 3;
            nq[0] = clampi(qs0 - f1, lo, hi) + 128 * F;
            np[0] = clampi(ps0 + f2, lo, hi) + 128 * F;
            const int f3 = (f1 + 1) >> 1;
            nq[1] = hev ? q1 : clampi(qs1 - f3, lo, hi) + 128 * F;
            np[1] = hev ? p1 : clampi(ps1 + f3, lo, hi) + 128 * F;
            wp = wq = 2;
        }
        int32_t *orow = out + (size_t)y * s_line;
        for (int k = 0; k < wp; k++) {
            const int col = ex - 1 - k;
            if (col >= 0) orow[(size_t)col * s_samp] = np[k];
        }
        for (int k = 0; k < wq; k++) {
            const int col = ex + k;
            if (col < w) orow[(size_t)col * s_samp] = nq[k];
        }
    }
}

}  // namespace

extern "C" int deblock_pass(const void *in, void *out, int h, int w,
                            int s_line, int s_samp, const void *tx_across,
                            const void *bpos, const void *skip, int m_line,
                            int m_samp, int s_along, int s_across, int limit,
                            int blimit, int thresh, int plane_idx, int x0,
                            int plane_w, int bd, void *stream) {
    const long long total = (long long)h * (w / 4 - 1);
    if (total > 0) {
        const int threads = 256;
        const int blocks = (int)((total + threads - 1) / threads);
        deblock_pass_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t *)in, (int32_t *)out, h, w, s_line, s_samp,
            (const int32_t *)tx_across, (const int32_t *)bpos,
            (const uint8_t *)skip, m_line, m_samp, s_along, s_across, limit,
            blimit, thresh, plane_idx, x0, plane_w, 1 << (bd - 8));
    }
    return (int)cudaGetLastError();
}
