// K6 cdef_filter: the CDEF filter (spec 7.15.3) over one 64x64 superblock
// per CTA, for the strength search and for the apply, bit-exact.
//
// Replaces rav1e_tpu/ops/cdef_jax.py:84 _filter_plane_jnp (with :67
// _adjust_vec_jnp and :75 _constrain_jnp) and the candidate loop and
// per-superblock SSE of the search kernel (cdef_jax.py:250-277), as run by
// the fused filter chain (filter_chain_jax.py:213), by the search outside
// it (cdef_jax.py:321 _make_search_kernel_packed, :374
// cdef_search_apply_device) and by the fixed-strength apply (:133
// _make_kernel, :168 cdef_frame_device).  The TPU version filters the
// whole frame once per candidate with 96 statically shifted, masked tap
// planes and sums the squared error per superblock in f32.
//
// mode 0 (search): for each of the 8 luma and 3 chroma candidates, the
//   superblock's exact integer SSE against the source, written to
//   sse[c][sb] (int64, the layout K15 reads).
// mode 1 (apply): the candidate pair idx_map[sb] picked (luma candidate
//   idx, chroma candidate PAIR_UV_IDX[idx]), written to the output planes.
//
// Above 8 bits (scale = bd - 8 > 0; cdef_jax.py:238-311) every candidate
// strength is shifted left by scale before the variance adjustment, the
// primary taps' weights follow the parity of the strength >> scale, and
// the caller passes the damping already grown by scale.
//
// What bounds it on the H100: integer operations (about 12 a tap), not
// bytes.  The first design ran every candidate's filter from scratch: the
// same 12 taps re-read from shared memory, their differences and the
// clamp window recomputed, and adjust() recomputed, for each of the 11
// candidates, on int32 tiles loaded with a division per element, in 510
// CTAs of 256 threads at 1080p (under one wave: 16 luma samples a thread
// in series).  The search here shares what the candidates share.  Every
// luma candidate of a block uses the block's direction (or direction 0
// where its primary strength is 0) and one secondary strength, so a
// sample's taps are read once: the 4 primary and 8 secondary differences
// and their clamp windows, the secondary sum once for the block's
// direction and once for direction 0, then a primary sum for each of the
// three primary strengths (adjusted per block once, in a shared table),
// and each candidate is a sum, a rounding and a clamp.  Chroma likewise
// (2 primary strengths).  Tiles are int16 (CDEF_VERY_LARGE = 0x4000
// fits), loaded a row per warp with every row's loads in flight at once;
// 512 threads a superblock (8 luma and 4 chroma samples a thread), so at
// 1080p the 510 CTAs fill every SM twice over; a thread's SSE stays in
// int32 (8 samples of at most 4095^2), the warp sums in uint32 and the
// CTA sums in int64.
//
// floor(log2) of a strength or of var >> 6 is 31 - __clz(x) (the JAX
// version goes through a float log2).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LARGE = 0x4000;  // CDEF_VERY_LARGE
constexpr int TY = 70, TYS = 72;  // luma tile: 64 + 2 * 3 rows, row stride
constexpr int TC = 38, TCS = 40;  // chroma tile
constexpr int NT = 512;
constexpr int NW = NT / 32;

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

// x + the rounded tap sum, clamped into [mn, mx]
__device__ __forceinline__ int finish(int x, int sum, int mn, int mx) {
    return min(max(x + ((8 + sum - (sum < 0)) >> 4), mn), mx);
}

// A strength with what its taps need: the strength, its shift and the
// primary weights' parity, packed s | shift << 12 | odd << 20.
__device__ __forceinline__ int pack(int s, int damping, int scale) {
    return s <= 0 ? 0
                  : s | max(0, damping - ilog2(s)) << 12 | ((s >> scale) & 1) << 20;
}

// The 2 * 2 taps of direction d around c: their differences to x, the
// window over the valid ones (mx, mn, starting at x).
__device__ __forceinline__ void taps(const int16_t *t, int c, int x, const int *off,
                                     int d[4], int &mx, int &mn) {
#pragma unroll
    for (int k = 0; k < 2; k++) {
#pragma unroll
        for (int s = 0; s < 2; s++) {
            const int p = t[s ? c - off[k] : c + off[k]];
            d[2 * k + s] = p - x;
            if (p != LARGE) {
                mx = max(mx, p);
                mn = min(mn, p);
            }
        }
    }
}

// The primary sum of 4 differences at packed strength pk (nonzero).
__device__ __forceinline__ int pri_sum(const int d[4], int pk) {
    const int s = pk & 0xfff, sh = (pk >> 12) & 0xff, odd = pk >> 20;
    const int w0 = odd ? 3 : 4, w1 = odd ? 3 : 2;
    return w0 * (constrain(d[0], s, sh) + constrain(d[1], s, sh)) +
           w1 * (constrain(d[2], s, sh) + constrain(d[3], s, sh));
}

// The secondary sum of two directions' differences (weights 2, 1).
__device__ __forceinline__ int sec_sum(const int a[4], const int b[4], int s, int sh) {
    return 2 * (constrain(a[0], s, sh) + constrain(a[1], s, sh) +
                constrain(b[0], s, sh) + constrain(b[1], s, sh)) +
           constrain(a[2], s, sh) + constrain(a[3], s, sh) +
           constrain(b[2], s, sh) + constrain(b[3], s, sh);
}

// One filtered sample for one strength pair (the apply): pk the packed
// primary strength (0: none), sec/shs the secondary strength and shift,
// dir the direction, off the tile's offsets by direction.
__device__ int filter_px(const int16_t *t, int c, int pk, int sec, int shs,
                         int dir, const int (*off)[2]) {
    const int x = t[c];
    int sum = 0, mx = x, mn = x;
    if (pk) {
        int d[4];
        taps(t, c, x, off[dir], d, mx, mn);
        sum += pri_sum(d, pk);
    }
    if (sec > 0) {
        int a[4], b[4];
        taps(t, c, x, off[(dir + 2) & 7], a, mx, mn);
        taps(t, c, x, off[(dir + 6) & 7], b, mx, mn);
        sum += sec_sum(a, b, sec, shs);
    }
    return finish(x, sum, mn, mx);
}

// Row `row` of a tile of COLS columns, the tile's (0, 0) at plane (y0 -
// 3, x0 - 3), read from a plane (h, w, row stride) into v (a lane's
// columns lane + 32k), CDEF_VERY_LARGE outside the plane.
template <int COLS>
__device__ __forceinline__ void fetch_row(int (&v)[(COLS + 31) / 32], int row, int lane,
                                          const int32_t *__restrict__ img, int stride,
                                          int h, int w, int y0, int x0) {
    const int gy = y0 - 3 + row;
    const bool in_y = gy >= 0 && gy < h;
    const int32_t *src = img + (size_t)(in_y ? gy : 0) * stride;
#pragma unroll
    for (int k = 0; k < (COLS + 31) / 32; k++) {
        const int gx = x0 - 3 + lane + 32 * k;
        v[k] = (in_y && lane + 32 * k < COLS && gx >= 0 && gx < w) ? src[gx] : LARGE;
    }
}

template <int COLS>
__device__ __forceinline__ void store_row(int16_t *tile, int ts, int row, int lane,
                                          const int (&v)[(COLS + 31) / 32]) {
#pragma unroll
    for (int k = 0; k < (COLS + 31) / 32; k++)
        if (lane + 32 * k < COLS) tile[row * ts + lane + 32 * k] = (int16_t)v[k];
}

// planes: y (h, w), u/v (h/2, w/2), int32, row strides sy/sc; src the same
// shapes and strides.  dirs/var/active: (nby, nbx) int32/int32/uint8.
__global__ void __launch_bounds__(NT, 2)
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
    __shared__ int16_t ty[TY * TYS];
    __shared__ int16_t tc[2][TC * TCS];
    __shared__ int offy[8][2], offc[8][2];
    __shared__ int bpk[3][64];  // the 3 primary strengths, adjusted, packed
    __shared__ unsigned char bdir[64], bact[64];
    __shared__ long long red[NW][11];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nsbx = gridDim.x;
    const int sbr = blockIdx.y, sbc = blockIdx.x;
    const int sb = sbr * nsbx + sbc;
    const int ch = h >> 1, cw = w >> 1;
    const int nby = h >> 3;
    {  // a row a warp; every load issued before the first store
        constexpr int RY = (TY + NW - 1) / NW, RC = (2 * TC + NW - 1) / NW;
        int vy[RY][(TY + 31) / 32], vc[RC][(TC + 31) / 32];
#pragma unroll
        for (int i = 0; i < RY; i++)
            if (warp + NW * i < TY)
                fetch_row<TY>(vy[i], warp + NW * i, lane, y, sy, h, w, sbr * 64, sbc * 64);
#pragma unroll
        for (int i = 0; i < RC; i++) {
            const int r = warp + NW * i, pl = r >= TC;
            if (r < 2 * TC)
                fetch_row<TC>(vc[i], r - pl * TC, lane, pl ? v : u, sc, ch, cw, sbr * 32,
                              sbc * 32);
        }
#pragma unroll
        for (int i = 0; i < RY; i++)
            if (warp + NW * i < TY) store_row<TY>(ty, TYS, warp + NW * i, lane, vy[i]);
#pragma unroll
        for (int i = 0; i < RC; i++) {
            const int r = warp + NW * i, pl = r >= TC;
            if (r < 2 * TC) store_row<TC>(tc[pl], TCS, r - pl * TC, lane, vc[i]);
        }
    }
    if (tid < 64) {
        const int by = sbr * 8 + (tid >> 3);
        const int bx = sbc * 8 + (tid & 7);
        const bool in = by < nby && bx < nbx;
        const size_t bi = (size_t)by * nbx + bx;
        const int vr = in ? var[bi] : 0;
        bdir[tid] = in ? dirs[bi] : 0;
        bact[tid] = in ? active[bi] : 0;
#pragma unroll
        for (int j = 0; j < 3; j++)
            bpk[j][tid] = pack(adjust((1 << j) << scale, vr), damping, scale);
    } else if (tid < 64 + 16) {
        const int d = (tid - 64) >> 1, k = tid & 1;
        offy[d][k] = kDirs[d][k][0] * TYS + kDirs[d][k][1];
        offc[d][k] = kDirs[d][k][0] * TCS + kDirs[d][k][1];
    }
    __syncthreads();

    if (mode == 1) {
        const int ci = idx_map[sb];
        const int ypri = kYPri[ci], ysec = kYSec[ci] << scale;
        const int uvpri = kUVPri[kPairUV[ci]] << scale;
        const int shs = ysec > 0 ? max(0, damping - ilog2(ysec)) : 0;
        const int uvpk = pack(uvpri, damping - 1, scale);
        const int yj = ypri == 4 ? 2 : ypri - 1;  // bpk's row of ypri
#pragma unroll 2
        for (int k = 0; k < 8; k++) {
            const int ly = (tid >> 6) + 8 * k, lx = tid & 63;
            const int gy = sbr * 64 + ly, gx = sbc * 64 + lx;
            if (gy >= h || gx >= w) continue;
            const int b = (ly >> 3) * 8 + (lx >> 3);
            const int c = (ly + 3) * TYS + lx + 3;
            const int pk = ypri ? bpk[yj][b] : 0;
            yo[(size_t)gy * w + gx] =
                bact[b] && (pk || ysec)
                    ? filter_px(ty, c, pk, ysec, shs, ypri ? bdir[b] : 0, offy)
                    : ty[c];
        }
#pragma unroll 2
        for (int k = 0; k < 4; k++) {
            const int pl = tid >> 8, j = tid & 255;
            const int ly = (j >> 5) + 8 * k, lx = j & 31;
            const int gy = sbr * 32 + ly, gx = sbc * 32 + lx;
            if (gy >= ch || gx >= cw) continue;
            const int b = (ly >> 2) * 8 + (lx >> 2);
            const int c = (ly + 3) * TCS + lx + 3;
            (pl ? vo : uo)[(size_t)gy * cw + gx] =
                bact[b] && uvpk ? filter_px(tc[pl], c, uvpk, 0, 0, bdir[b], offc)
                                : tc[pl][c];
        }
        return;
    }

    // search: a thread's squared errors by candidate, int32
    int acc[11];
#pragma unroll
    for (int c = 0; c < 11; c++) acc[c] = 0;
    const int sec = 2 << scale, shs = max(0, damping - ilog2(sec));
    for (int k = 0; k < 8; k++) {
        const int ly = (tid >> 6) + 8 * k, lx = tid & 63;
        const int gy = sbr * 64 + ly, gx = sbc * 64 + lx;
        if (gy >= h || gx >= w) continue;
        const int b = (ly >> 3) * 8 + (lx >> 3);
        const int c = (ly + 3) * TYS + lx + 3;
        const int x = ty[c];
        const int s = srcy[(size_t)gy * ssy + gx];
        const int e0 = x - s;
        if (!bact[b]) {
#pragma unroll
            for (int q = 0; q < 8; q++) acc[q] += e0 * e0;
            continue;
        }
        acc[0] += e0 * e0;
        {  // (0, 2): the secondary taps of direction 0
            int a0[4], b0[4], zmx = x, zmn = x;
            taps(ty, c, x, offy[2], a0, zmx, zmn);
            taps(ty, c, x, offy[6], b0, zmx, zmn);
            const int e = finish(x, sec_sum(a0, b0, sec, shs), zmn, zmx) - s;
            acc[1] += e * e;
        }
        const int dir = bdir[b];
        int dp[4], pmx = x, pmn = x, smx = x, smn = x, ssum;
        taps(ty, c, x, offy[dir], dp, pmx, pmn);
        {
            int a[4], bb[4];
            taps(ty, c, x, offy[(dir + 2) & 7], a, smx, smn);
            taps(ty, c, x, offy[(dir + 6) & 7], bb, smx, smn);
            ssum = sec_sum(a, bb, sec, shs);
        }
        const int bmx = max(pmx, smx), bmn = min(pmn, smn);
        const int es = finish(x, ssum, smn, smx) - s;
#pragma unroll
        for (int j = 0; j < 3; j++) {
            // (p, 0) and (p, 2) for p = 1, 2, 4, adjusted for the block
            const int pk = bpk[j][b];
            int e1 = e0, e2 = es;
            if (pk) {
                const int ps = pri_sum(dp, pk);
                e1 = finish(x, ps, pmn, pmx) - s;
                e2 = finish(x, ps + ssum, bmn, bmx) - s;
            }
            acc[2 + 2 * j] += e1 * e1;
            acc[3 + 2 * j] += e2 * e2;
        }
    }
    const int pk1 = pack(1 << scale, damping - 1, scale);
    const int pk2 = pack(2 << scale, damping - 1, scale);
    for (int k = 0; k < 4; k++) {
        const int pl = tid >> 8, j = tid & 255;
        const int ly = (j >> 5) + 8 * k, lx = j & 31;
        const int gy = sbr * 32 + ly, gx = sbc * 32 + lx;
        if (gy >= ch || gx >= cw) continue;
        const int b = (ly >> 2) * 8 + (lx >> 2);
        const int c = (ly + 3) * TCS + lx + 3;
        const int16_t *t = tc[pl];
        const int x = t[c];
        const int s = (pl ? srcv : srcu)[(size_t)gy * ssc + gx];
        int o1 = x, o2 = x;
        if (bact[b]) {
            int dp[4], mx = x, mn = x;
            taps(t, c, x, offc[bdir[b]], dp, mx, mn);
            o1 = finish(x, pri_sum(dp, pk1), mn, mx);
            o2 = finish(x, pri_sum(dp, pk2), mn, mx);
        }
        const int e0 = x - s, e1 = o1 - s, e2 = o2 - s;
        acc[8] += e0 * e0;
        acc[9] += e1 * e1;
        acc[10] += e2 * e2;
    }
    // 32 threads' sums of at most 8 * 4095^2 fit in uint32; the CTA's in int64
#pragma unroll
    for (int c = 0; c < 11; c++) {
        unsigned int r = (unsigned int)acc[c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) r += __shfl_down_sync(0xffffffffu, r, o);
        if (lane == 0) red[warp][c] = r;
    }
    __syncthreads();
    if (tid < 11) {
        long long tot = 0;
#pragma unroll
        for (int k = 0; k < NW; k++) tot += red[k][tid];
        sse[(size_t)tid * gridDim.x * gridDim.y + sb] = tot;
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
