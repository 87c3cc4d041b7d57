// K6 cdef_filter: the CDEF filter (spec 7.15.3) over one 64x64 superblock
// per CTA, for the strength search and for the apply, bit-exact, int32.
//
// Replaces rav1e_tpu/ops/cdef_jax.py:84 _filter_plane_jnp (with :67
// _adjust_vec_jnp and :75 _constrain_jnp) and the candidate loop and
// per-superblock SSE of the search kernel (cdef_jax.py:250-277), as run by
// the fused filter chain (filter_chain_jax.py:213).  The TPU version
// filters the whole frame once per candidate with 96 statically shifted,
// masked tap planes (one per direction and tap) and sums the squared error
// per superblock in f32.  Here a CTA loads its superblock's luma and its
// two 32x32 chroma blocks with a 3-px halo into shared memory
// (CDEF_VERY_LARGE outside the frame), with the 8x8 blocks' directions,
// variances and skip flags, and each thread gathers only the 12 taps of
// its pixel's own direction.
//
// mode 0 (search): for each of the 8 luma and 3 chroma candidates, the
//   superblock's exact integer SSE against the source (a block reduction
//   in int64: a 10-bit luma superblock reaches 4096 * 1023^2 > 2^31),
//   written to sse[c][sb].
// mode 1 (apply): the candidate pair idx_map[sb] picked (luma candidate
//   idx, chroma candidate PAIR_UV_IDX[idx]), written to the output planes.
//
// Above 8 bits (scale = bd - 8 > 0; cdef_jax.py:238-311) every candidate
// strength is shifted left by scale before the variance adjustment, the
// primary taps' weights follow the parity of the strength >> scale, and
// the caller passes the damping already grown by scale.
//
// floor(log2) of a strength or of var >> 6 is 31 - __clz(x) (the JAX
// version goes through a float log2).  Bound on the H100: integer
// operations (about 12 a tap, for the 0, 4, 8 or 12 taps each candidate
// runs on a sample), not bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LARGE = 0x4000;  // CDEF_VERY_LARGE
constexpr int TY = 70;         // luma tile: 64 + 2 * 3
constexpr int TC = 38;         // chroma tile: 32 + 2 * 3
constexpr int NT = 256;

__constant__ int kDirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},  {{0, 1}, {1, 2}},
    {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}},  {{1, 0}, {2, -1}}};
// Y_CANDIDATES (pri, sec), UV_CANDIDATES, PAIR_UV_IDX of cdef_jax.py:211-217
__constant__ int kYPri[8] = {0, 0, 1, 1, 2, 2, 4, 4};
__constant__ int kYSec[8] = {0, 2, 0, 2, 0, 2, 0, 2};
__constant__ int kUVPri[3] = {0, 1, 2};
__constant__ int kPairUV[8] = {0, 0, 1, 1, 2, 2, 2, 2};

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

__device__ __forceinline__ int constrain(int diff, int s, int shift) {
    const int a = abs(diff);
    const int v = min(a, max(0, s - (a >> shift)));
    return diff < 0 ? -v : v;
}

__device__ __forceinline__ int adjust(int s, int var) {
    if (var <= 0 || s <= 0) return 0;
    const int v6 = var >> 6;
    const int i = v6 > 0 ? min(ilog2(v6), 12) : 0;
    return (s * (4 + i) + 8) >> 4;
}

// One filtered sample.  t: the tile, ts: its row stride, c: the centre's
// offset in it.  pri/sec: the (adjusted) strengths, both > 0 or not used.
__device__ int filter_px(const int *t, int ts, int c, int pri, int sec,
                         int damping, int dir, int scale) {
    const int x = t[c];
    int sum = 0, mx = x, mn = x;
    if (pri > 0) {
        const int shift = max(0, damping - ilog2(pri));
        const int odd = (pri >> scale) & 1;
#pragma unroll
        for (int k = 0; k < 2; k++) {
            const int tw = odd ? 3 : (k == 0 ? 4 : 2);
            const int o = kDirs[dir][k][0] * ts + kDirs[dir][k][1];
#pragma unroll
            for (int s = 0; s < 2; s++) {
                const int p = t[s ? c - o : c + o];
                sum += tw * constrain(p - x, pri, shift);
                if (p != LARGE) {
                    mx = max(mx, p);
                    mn = min(mn, p);
                }
            }
        }
    }
    if (sec > 0) {
        const int shift = max(0, damping - ilog2(sec));
#pragma unroll
        for (int e = 0; e < 2; e++) {
            const int d2 = (dir + (e ? 6 : 2)) & 7;
#pragma unroll
            for (int k = 0; k < 2; k++) {
                const int tw = k == 0 ? 2 : 1;
                const int o = kDirs[d2][k][0] * ts + kDirs[d2][k][1];
#pragma unroll
                for (int s = 0; s < 2; s++) {
                    const int p = t[s ? c - o : c + o];
                    sum += tw * constrain(p - x, sec, shift);
                    if (p != LARGE) {
                        mx = max(mx, p);
                        mn = min(mn, p);
                    }
                }
            }
        }
    }
    const int out = x + ((8 + sum - (sum < 0)) >> 4);
    return min(max(out, mn), mx);
}

// A block's output sample for one candidate: filtered where the block is
// active and a strength is nonzero, else the input.
__device__ __forceinline__ int cand_px(const int *t, int ts, int c, int pri,
                                       int sec, int damping, int dir,
                                       bool act, int scale) {
    if (!act || (pri <= 0 && sec <= 0)) return t[c];
    return filter_px(t, ts, c, pri, sec, damping, dir, scale);
}

__device__ void load_tile(int *tile, int tn, const int32_t *__restrict__ img,
                          int stride, int h, int w, int y0, int x0) {
    for (int i = threadIdx.x; i < tn * tn; i += NT) {
        const int gy = y0 - 3 + i / tn, gx = x0 - 3 + i % tn;
        tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                      ? img[(size_t)gy * stride + gx]
                      : LARGE;
    }
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// planes: y (h, w), u/v (h/2, w/2), int32, row strides sy/sc; src the same
// shapes and strides.  dirs/var/active: (nby, nbx) int32/int32/uint8.
__global__ void __launch_bounds__(NT)
cdef_filter_kernel(const int32_t *__restrict__ y, const int32_t *__restrict__ u,
                   const int32_t *__restrict__ v, int sy, int sc,
                   const int32_t *__restrict__ srcy,
                   const int32_t *__restrict__ srcu,
                   const int32_t *__restrict__ srcv, int ssy, int ssc, int h,
                   int w, const int32_t *__restrict__ dirs,
                   const int32_t *__restrict__ var,
                   const uint8_t *__restrict__ active, int nbx, int damping,
                   int scale, int mode, const int32_t *__restrict__ idx_map,
                   int64_t *__restrict__ sse, int32_t *__restrict__ yo,
                   int32_t *__restrict__ uo, int32_t *__restrict__ vo) {
    __shared__ int ty[TY * TY];
    __shared__ int tu[TC * TC];
    __shared__ int tv[TC * TC];
    __shared__ int bdir[64], bvar[64];
    __shared__ unsigned char bact[64];
    __shared__ long long red[NT / 32][11];

    const int nsbx = gridDim.x;
    const int sbr = blockIdx.y, sbc = blockIdx.x;
    const int sb = sbr * nsbx + sbc;
    const int ch = h >> 1, cw = w >> 1;
    const int nby = h >> 3;
    load_tile(ty, TY, y, sy, h, w, sbr * 64, sbc * 64);
    load_tile(tu, TC, u, sc, ch, cw, sbr * 32, sbc * 32);
    load_tile(tv, TC, v, sc, ch, cw, sbr * 32, sbc * 32);
    if (threadIdx.x < 64) {
        const int by = sbr * 8 + (threadIdx.x >> 3);
        const int bx = sbc * 8 + (threadIdx.x & 7);
        const bool in = by < nby && bx < nbx;
        const size_t bi = (size_t)by * nbx + bx;
        bdir[threadIdx.x] = in ? dirs[bi] : 0;
        bvar[threadIdx.x] = in ? var[bi] : 0;
        bact[threadIdx.x] = in ? active[bi] : 0;
    }
    __syncthreads();

    if (mode == 1) {
        const int ci = idx_map[sb];
        const int ypri = kYPri[ci] << scale, ysec = kYSec[ci] << scale;
        const int uvpri = kUVPri[kPairUV[ci]] << scale;
        for (int i = threadIdx.x; i < 4096; i += NT) {
            const int ly = i >> 6, lx = i & 63;
            const int gy = sbr * 64 + ly, gx = sbc * 64 + lx;
            if (gy >= h || gx >= w) continue;
            const int b = (ly >> 3) * 8 + (lx >> 3);
            const int pa = adjust(ypri, bvar[b]);
            yo[(size_t)gy * w + gx] =
                cand_px(ty, TY, (ly + 3) * TY + lx + 3, pa, ysec, damping,
                        ypri ? bdir[b] : 0, bact[b], scale);
        }
        for (int i = threadIdx.x; i < 2048; i += NT) {
            const int pl = i >> 10, j = i & 1023;
            const int ly = j >> 5, lx = j & 31;
            const int gy = sbr * 32 + ly, gx = sbc * 32 + lx;
            if (gy >= ch || gx >= cw) continue;
            const int b = (ly >> 2) * 8 + (lx >> 2);
            const int out = cand_px(pl ? tv : tu, TC, (ly + 3) * TC + lx + 3,
                                    uvpri, 0, damping - 1,
                                    uvpri ? bdir[b] : 0, bact[b], scale);
            (pl ? vo : uo)[(size_t)gy * cw + gx] = out;
        }
        return;
    }

    long long acc[11];
#pragma unroll
    for (int c = 0; c < 11; c++) acc[c] = 0;
    for (int i = threadIdx.x; i < 4096; i += NT) {
        const int ly = i >> 6, lx = i & 63;
        const int gy = sbr * 64 + ly, gx = sbc * 64 + lx;
        if (gy >= h || gx >= w) continue;
        const int b = (ly >> 3) * 8 + (lx >> 3);
        const int s = srcy[(size_t)gy * ssy + gx];
        const int c0 = (ly + 3) * TY + lx + 3;
#pragma unroll
        for (int c = 0; c < 8; c++) {
            const int e = cand_px(ty, TY, c0, adjust(kYPri[c] << scale, bvar[b]),
                                  kYSec[c] << scale, damping,
                                  kYPri[c] ? bdir[b] : 0, bact[b], scale) - s;
            acc[c] += (long long)(e * e);
        }
    }
    for (int i = threadIdx.x; i < 2048; i += NT) {
        const int pl = i >> 10, j = i & 1023;
        const int ly = j >> 5, lx = j & 31;
        const int gy = sbr * 32 + ly, gx = sbc * 32 + lx;
        if (gy >= ch || gx >= cw) continue;
        const int b = (ly >> 2) * 8 + (lx >> 2);
        const int s = (pl ? srcv : srcu)[(size_t)gy * ssc + gx];
        const int c0 = (ly + 3) * TC + lx + 3;
#pragma unroll
        for (int c = 0; c < 3; c++) {
            const int e = cand_px(pl ? tv : tu, TC, c0, kUVPri[c] << scale, 0,
                                  damping - 1, kUVPri[c] ? bdir[b] : 0,
                                  bact[b], scale) - s;
            acc[8 + c] += (long long)(e * e);
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < 11; c++) {
        const long long r = warp_sum(acc[c]);
        if (lane == 0) red[warp][c] = r;
    }
    __syncthreads();
    if (threadIdx.x < 11) {
        long long tot = 0;
        for (int k = 0; k < NT / 32; k++) tot += red[k][threadIdx.x];
        sse[(size_t)threadIdx.x * gridDim.x * gridDim.y + sb] = tot;
    }
}

}  // namespace

extern "C" int cdef_filter(const void *y, const void *u, const void *v,
                           int sy, int sc, const void *srcy, const void *srcu,
                           const void *srcv, int ssy, int ssc, int h, int w,
                           const void *dirs, const void *var,
                           const void *active, int nbx, int damping,
                           int scale, int mode,
                           const void *idx_map, void *sse, void *yo, void *uo,
                           void *vo, void *stream) {
    const int nsby = (h + 63) / 64, nsbx = (w + 63) / 64;
    if (nsby > 0 && nsbx > 0) {
        cdef_filter_kernel<<<dim3(nsbx, nsby), NT, 0, (cudaStream_t)stream>>>(
            (const int32_t *)y, (const int32_t *)u, (const int32_t *)v, sy, sc,
            (const int32_t *)srcy, (const int32_t *)srcu,
            (const int32_t *)srcv, ssy, ssc, h, w, (const int32_t *)dirs,
            (const int32_t *)var, (const uint8_t *)active, nbx, damping, scale,
            mode, (const int32_t *)idx_map, (int64_t *)sse, (int32_t *)yo,
            (int32_t *)uo, (int32_t *)vo);
    }
    return (int)cudaGetLastError();
}
