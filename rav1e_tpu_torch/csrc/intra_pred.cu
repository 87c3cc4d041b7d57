// K1 intra_pred: AV1 intra prediction (spec 7.11.2), bit-exact, int32.
//
// Replaces rav1e_tpu/ops/intra_jax.py:305 predict_dirs (with :217
// dir_matrices), :82 dc_predict, models/wavefront.py:520 _nondir_preds, the
// fine-direction SAD pick of models/wavefront.py:614-631 and the
// source-edge predictions of models/device_pipeline.py:49 _predict_all.
// The TPU version turns the 56 directional variants into one fp32 product
// against a (4n+1, 56n^2) weight matrix (29.6 MB at n = 32) for the matrix
// unit.  Here every sample is computed straight from the rule: two edge
// taps, (a * (32 - s) + b * s + 16) >> 5, so the only device-memory traffic
// is the edges in and the predictions out.
//
// Channels are named by their index in the FULL enumeration (61): DC, the
// 56 directional variants (8 modes x 7 angle deltas, enum order V H D45
// D135 D113 D157 D203 D67), SMOOTH, SMOOTH_V, SMOOTH_H, PAETH.  Two modes:
//   list: the caller's channel list for every lane (FULL, NONDIR = DC, V,
//         H and the last four, or any other), out (lanes, nch, n, n); the
//         lanes may come from two planes' edge vectors (U and V of one
//         call: out (B, 2, nch, n, n));
//   race: for the fine-direction pick of the key pass, each base
//         direction's 7 deltas are predicted, their SADs against the
//         lane's source block (read in place through its strides) summed,
//         and the first least SAD among the allowed deltas kept (zone-1
//         deltas barred where allow_z1 is false); out is the 13-candidate
//         stack (DC, the 8 picked directions, SMOOTH, SMOOTH_V, SMOOTH_H,
//         PAETH) and di8 (B, 8), the picked delta indices.  48 of the 61
//         channels are never written.
//
// Layout: n is a template parameter (4 to 64).  A thread owns groups of 4
// samples of one row and writes each with one 16-byte store.  The CTA's
// lanes' edge vectors e = [top-left, above[0..2n), left[0..2n)] go to
// shared memory once for all the channels the CTA writes; DC is reduced
// with warp shuffles.
//   list: a lane's n*n/4 groups are taken by up to 256 threads (at n = 64
//         four a thread); at n <= 8 a CTA of 64 threads holds 64 /
//         (n*n/4) lanes so that every thread has samples.  The grid's
//         second axis gives each CTA a share of the list, sized so that
//         small batches still spread over the SMs.
//   race: a CTA takes one base direction of its lanes, 7 x 64 threads:
//         the 7 deltas side by side, each over up to 64 threads (n = 32:
//         four groups a thread; at n <= 8 several lanes a CTA), so a
//         thread predicts one delta; the SADs are summed by shuffles and
//         across warps in shared memory, and the picked delta's threads
//         store.  A ninth CTA a lane writes the five other channels.
//         The batches are small (15 to 60 lanes), so the short chain a
//         thread runs sets the time more than the work does.
// Bound on the H100: bytes (the edges and source in, the predictions
// out); a sample is ~10 integer operations a channel, and the race adds
// 3 a sample and delta for the SADs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CH = 64;
constexpr int BIG = 1 << 30;
__constant__ int32_t BASE_ANGLE[8] = {90, 180, 45, 135, 113, 157, 203, 67};

struct K1Args {
    const int32_t *above[2];
    const int32_t *left[2];
    const uint8_t *ha, *hl, *allow_z1;
    int ha_st, hl_st, az_st;
    const int32_t *dr, *smw;
    const int32_t *src;
    int src_lane, src_row;
    int32_t *out;
    int32_t *di8;
    int planes, lanes, bd, nch, cpc;
    int8_t ch[MAX_CH];
};

template <int N>
struct Geo {
    static constexpr int G = N * N / 4;                  // groups a channel
    static constexpr int TPL = G < 256 ? G : 256;        // threads a lane
    static constexpr int LPC = TPL >= 64 ? 1 : 64 / TPL;  // lanes a CTA
    static constexpr int THREADS = TPL * LPC;
    static constexpr int GPT = G / TPL;                  // groups a thread
    static constexpr int NE = 4 * N + 1;                 // edge vector
    static constexpr int S = TPL < 32 ? TPL : 32;        // DC shuffle width
    static constexpr int LOG2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4
                               : N == 32 ? 5 : 6;
};

// channel -> kind: 0 DC, 1 directional (angle), 2..5 SM/SMV/SMH/PAETH
__device__ __forceinline__ void decode(int ch, int &kind, int &angle) {
    if (ch == 0) {
        kind = 0;
    } else if (ch <= 56) {
        kind = 1;
        angle = BASE_ANGLE[(ch - 1) / 7] + 3 * ((ch - 1) % 7 - 3);
    } else {
        kind = ch - 55;
    }
}

// the 4 samples (r, c0 .. c0 + 3) of one channel from the lane's edge
// vector e (A(i) = e[1 + i], L(i) = e[2n + 1 + i], index -1 the corner)
template <int N>
__device__ __forceinline__ void pred4(const int32_t *__restrict__ e,
                                      const int32_t *__restrict__ smw,
                                      const int32_t *__restrict__ dr, int kind,
                                      int angle, int dcv, int r, int c0,
                                      int v[4]) {
#define A(i) e[(i) < 0 ? 0 : 1 + (i)]
#define L(i) e[(i) < 0 ? 0 : 2 * N + 1 + (i)]
    constexpr int mx = 2 * N - 1;
    if (kind == 0) {
#pragma unroll
        for (int q = 0; q < 4; q++) v[q] = dcv;
    } else if (kind == 1) {
        if (angle == 90) {
#pragma unroll
            for (int q = 0; q < 4; q++) v[q] = A(c0 + q);
        } else if (angle == 180) {
            const int l = L(r);
#pragma unroll
            for (int q = 0; q < 4; q++) v[q] = l;
        } else if (angle < 90) {
            const int xpos = (r + 1) * __ldg(dr + angle);
            const int s = (xpos >> 1) & 0x1F;
            // bx >= 0; past mx both taps are A(mx), which blends to A(mx)
#pragma unroll
            for (int q = 0; q < 4; q++) {
                const int bx = (xpos >> 6) + c0 + q;
                v[q] = (e[1 + min(bx, mx)] * (32 - s)
                        + e[1 + min(bx + 1, mx)] * s + 16) >> 5;
            }
        } else if (angle < 180) {
            const int dx = __ldg(dr + 180 - angle), dy = __ldg(dr + angle - 90);
#pragma unroll
            for (int q = 0; q < 4; q++) {
                const int c = c0 + q;
                const int xpos = (c << 6) - (r + 1) * dx;
                const int bx = xpos >> 6;
                if (bx >= -1) {  // A(-1) is the corner e[0]
                    const int s = (xpos >> 1) & 0x1F;
                    v[q] = (e[1 + bx] * (32 - s) + e[2 + bx] * s + 16) >> 5;
                } else {
                    const int ypos = (r << 6) - (c + 1) * dy;
                    const int by = ypos >> 6;
                    const int s = (ypos >> 1) & 0x1F;
                    v[q] = (L(by) * (32 - s) + L(by + 1) * s + 16) >> 5;
                }
            }
        } else {
            const int d = __ldg(dr + 270 - angle);
            // by >= 0; past mx both taps are L(mx)
#pragma unroll
            for (int q = 0; q < 4; q++) {
                const int ypos = (c0 + q + 1) * d;
                const int by = (ypos >> 6) + r;
                const int s = (ypos >> 1) & 0x1F;
                v[q] = (e[2 * N + 1 + min(by, mx)] * (32 - s)
                        + e[2 * N + 1 + min(by + 1, mx)] * s + 16) >> 5;
            }
        }
    } else {
        const int l = L(r), wy = smw[r];
        const int below = L(N - 1), right = A(N - 1), tl = e[0];
#pragma unroll
        for (int q = 0; q < 4; q++) {
            const int c = c0 + q;
            const int a = A(c), wx = smw[c];
            int x;
            if (kind == 2) {
                x = (wy * a + (256 - wy) * below + wx * l + (256 - wx) * right
                     + 256) >> 9;
            } else if (kind == 3) {
                x = (wy * a + (256 - wy) * below + 128) >> 8;
            } else if (kind == 4) {
                x = (wx * l + (256 - wx) * right + 128) >> 8;
            } else {
                const int base = a + l - tl;
                const int pa = abs(base - a), pl = abs(base - l),
                          ptl = abs(base - tl);
                x = (pl <= pa && pl <= ptl) ? l : (pa <= ptl ? a : tl);
            }
            v[q] = x;
        }
    }
#undef A
#undef L
}

// DC of the thread's lane: the n above and n left samples summed over the
// lane's threads by warp shuffles (a lane's threads are S-aligned segments
// of a warp, or whole warps), then spec 7.11.2.5's rounding
template <int N>
__device__ __forceinline__ int dc_value(const int32_t *__restrict__ e, int t,
                                        bool ha, bool hl, int bd) {
    using Gm = Geo<N>;
    int sa = 0, sl = 0;
    for (int j = t % Gm::S; j < N; j += Gm::S) {
        sa += e[1 + j];
        sl += e[2 * N + 1 + j];
    }
#pragma unroll
    for (int off = Gm::S / 2; off > 0; off >>= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, off);
        sl += __shfl_xor_sync(0xffffffffu, sl, off);
    }
    if (ha && hl) return (sa + sl + N) >> (Gm::LOG2 + 1);
    if (ha) return (sa + (N >> 1)) >> Gm::LOG2;
    if (hl) return (sl + (N >> 1)) >> Gm::LOG2;
    return 1 << (bd - 1);
}

__device__ __forceinline__ void store4(int32_t *p, const int v[4]) {
    *reinterpret_cast<int4 *>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// the edge vectors of a CTA's LPC lanes (lane L = b * planes + p, from
// blockIdx.x * LPC on) and the n smooth weights into shared memory
template <int N, int LPC, int THREADS>
__device__ __forceinline__ void load_edges(const K1Args &a,
                                           int32_t (*e_all)[4 * N + 1],
                                           int32_t *smw) {
    constexpr int NE = 4 * N + 1;
    const int nl = a.planes * a.lanes;
    for (int i = threadIdx.x; i < LPC * NE; i += THREADS) {
        const int l2 = i / NE, k = i - l2 * NE;
        const int L2 = blockIdx.x * LPC + l2;
        int v = 0;
        if (L2 < nl) {
            const int b2 = a.planes == 2 ? L2 >> 1 : L2, p2 = L2 - b2 * a.planes;
            const size_t row = (size_t)b2 * (2 * N + 1);
            v = k <= 2 * N ? a.above[p2][row + k] : a.left[p2][row + k - 2 * N];
        }
        e_all[l2][k] = v;
    }
    for (int i = threadIdx.x; i < N; i += THREADS) smw[i] = a.smw[i];
    __syncthreads();
}

// list mode: a CTA's lanes, a share (cpc) of the channel list each
template <int N>
__global__ void __launch_bounds__(Geo<N>::THREADS)
intra_list_kernel(const K1Args a) {
    using Gm = Geo<N>;
    __shared__ __align__(16) int32_t e_all[Gm::LPC][Gm::NE];
    __shared__ int32_t smw[N];
    load_edges<N, Gm::LPC, Gm::THREADS>(a, e_all, smw);
    const int li = threadIdx.x / Gm::TPL, t = threadIdx.x % Gm::TPL;
    const int L = blockIdx.x * Gm::LPC + li;
    const bool live = L < a.planes * a.lanes;
    const int b = live ? (a.planes == 2 ? L >> 1 : L) : 0;
    const int32_t *e = e_all[li];
    const bool ha = a.ha[(size_t)b * a.ha_st] != 0;
    const bool hl = a.hl[(size_t)b * a.hl_st] != 0;
    constexpr int GW = N / 4;  // groups a row
    const int c_lo = blockIdx.y * a.cpc;
    const int c_hi = min(a.nch, c_lo + a.cpc);
    for (int ci = c_lo; ci < c_hi; ci++) {
        int kind, angle = 0;
        decode(a.ch[ci], kind, angle);
        const int dcv = kind == 0 ? dc_value<N>(e, t, ha, hl, a.bd) : 0;
        int32_t *o = a.out + ((size_t)L * a.nch + ci) * (N * N);
#pragma unroll
        for (int k = 0; k < Gm::GPT; k++) {
            const int g = t + k * Gm::TPL;
            const int r = g / GW, c0 = (g % GW) * 4;
            int v[4];
            pred4<N>(e, smw, a.dr, kind, angle, dcv, r, c0, v);
            if (live) store4(o + r * N + c0, v);
        }
    }
}

// race mode: threads (lane, delta, group); up to 64 threads a lane and
// delta (at n = 32 four groups each), at n <= 8 several lanes a CTA
template <int N>
struct Race {
    static constexpr int G = N * N / 4;
    static constexpr int TPD = G < 64 ? G : 64;           // threads a delta
    static constexpr int LPC = TPD >= 64 ? 1 : 64 / TPD;  // lanes a CTA
    static constexpr int THREADS = 7 * TPD * LPC;         // 448
    static constexpr int GPT = G / TPD;                   // groups a thread
    static constexpr int S = TPD < 32 ? TPD : 32;         // shuffle width
    static constexpr int SEGS = TPD / S;                  // warps a delta
};

// a CTA takes one base direction of its lanes (y < 8: the 7 deltas side
// by side, their SADs summed by shuffles and across warps in shared
// memory, the pick, the winner's samples stored) or their five other
// channels (y == 8: DC, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, stack
// channels 0 and 9-12)
template <int N>
__global__ void __launch_bounds__(Race<N>::THREADS)
intra_race_kernel(const K1Args a) {
    using Rc = Race<N>;
    static_assert(Rc::S == Geo<N>::S, "DC's shuffle width");
    __shared__ __align__(16) int32_t e_all[Rc::LPC][4 * N + 1];
    __shared__ int32_t smw[N];
    __shared__ int32_t red[Rc::LPC][7][Rc::SEGS];
    load_edges<N, Rc::LPC, Rc::THREADS>(a, e_all, smw);
    const int li = threadIdx.x / (7 * Rc::TPD);
    const int d = (threadIdx.x / Rc::TPD) % 7, t = threadIdx.x % Rc::TPD;
    const int L = blockIdx.x * Rc::LPC + li;
    const bool live = L < a.lanes;
    const int b = live ? L : 0;
    const int32_t *e = e_all[li];
    constexpr int GW = N / 4;
    int32_t *o = a.out + (size_t)b * 13 * (N * N);
    if (blockIdx.y == 8) {
        const bool ha = a.ha[(size_t)b * a.ha_st] != 0;
        const bool hl = a.hl[(size_t)b * a.hl_st] != 0;
        const int dcv = dc_value<N>(e, t, ha, hl, a.bd);  // every thread
        if (d >= 5) return;
        const int kind = d == 0 ? 0 : d + 1;
        int32_t *oc = o + (d == 0 ? 0 : 8 + d) * (N * N);
#pragma unroll
        for (int k = 0; k < Rc::GPT; k++) {
            const int g = t + k * Rc::TPD;
            const int r = g / GW, c0 = (g % GW) * 4;
            int v[4];
            pred4<N>(e, smw, a.dr, kind, 0, dcv, r, c0, v);
            if (live) store4(oc + r * N + c0, v);
        }
        return;
    }
    const int mi = blockIdx.y;
    const int angle = BASE_ANGLE[mi] + 3 * (d - 3);
    int v[Rc::GPT][4];
    int sad = 0;
#pragma unroll
    for (int k = 0; k < Rc::GPT; k++) {
        const int g = t + k * Rc::TPD;
        const int r = g / GW, c0 = (g % GW) * 4;
        pred4<N>(e, smw, a.dr, 1, angle, 0, r, c0, v[k]);
        const int32_t *s = a.src + (size_t)b * a.src_lane + (size_t)r * a.src_row + c0;
#pragma unroll
        for (int q = 0; q < 4; q++) sad += abs(v[k][q] - s[q]);
    }
#pragma unroll
    for (int off = Rc::S / 2; off > 0; off >>= 1)
        sad += __shfl_xor_sync(0xffffffffu, sad, off);
    if (t % Rc::S == 0) red[li][d][t / Rc::S] = sad;
    __syncthreads();
    const bool z1 = a.allow_z1[(size_t)b * a.az_st] != 0;
    int best = 0, key = BIG + 1;
#pragma unroll
    for (int dd = 0; dd < 7; dd++) {
        int x = 0;
#pragma unroll
        for (int w = 0; w < Rc::SEGS; w++) x += red[li][dd][w];
        if (BASE_ANGLE[mi] + 3 * (dd - 3) < 90 && !z1) x = BIG;
        if (x < key) {
            key = x;
            best = dd;
        }
    }
    if (!live || d != best) return;
#pragma unroll
    for (int k = 0; k < Rc::GPT; k++) {
        const int g = t + k * Rc::TPD;
        store4(o + (1 + mi) * (N * N) + (g / GW) * N + (g % GW) * 4, v[k]);
    }
    if (t == 0) a.di8[b * 8 + mi] = best;
}

template <int N>
void run(const K1Args &a, bool race, cudaStream_t stream) {
    if (race) {
        using Rc = Race<N>;
        intra_race_kernel<N><<<dim3((a.lanes + Rc::LPC - 1) / Rc::LPC, 9),
                               Rc::THREADS, 0, stream>>>(a);
    } else {
        using Gm = Geo<N>;
        const int nl = a.planes * a.lanes;
        intra_list_kernel<N><<<dim3((nl + Gm::LPC - 1) / Gm::LPC,
                                    (a.nch + a.cpc - 1) / a.cpc),
                               Gm::THREADS, 0, stream>>>(a);
    }
}

}  // namespace

// ptrs: above0, left0, above1, left1, ha, hl, allow_z1, dr, smw, src, out,
//   di8 (above1/left1 used with 2 planes; allow_z1, src and di8 in race
//   mode, which src non-null selects);
// ints: planes, lanes (B), n, bd, ha stride, hl stride, allow_z1 stride,
//   source lane stride, source row stride, nch, then the nch channels.
// above/left: (B, 2n+1) int32 edge vectors (index 0 = top-left); ha, hl,
// allow_z1: bool (uint8) with a stride; dr: dr_intra_derivative (90); smw:
// the n smooth weights; out: list (B, planes, nch, n, n), race (B, 13, n,
// n) and di8 (B, 8), all int32.
extern "C" int intra_pred(void *const *ptrs, const int *ints, void *stream) {
    K1Args a;
    for (int p = 0; p < 2; p++) {
        a.above[p] = (const int32_t *)ptrs[2 * p];
        a.left[p] = (const int32_t *)ptrs[2 * p + 1];
    }
    a.ha = (const uint8_t *)ptrs[4];
    a.hl = (const uint8_t *)ptrs[5];
    a.allow_z1 = (const uint8_t *)ptrs[6];
    a.dr = (const int32_t *)ptrs[7];
    a.smw = (const int32_t *)ptrs[8];
    a.src = (const int32_t *)ptrs[9];
    a.out = (int32_t *)ptrs[10];
    a.di8 = (int32_t *)ptrs[11];
    a.planes = ints[0];
    a.lanes = ints[1];
    const int n = ints[2];
    a.bd = ints[3];
    a.ha_st = ints[4];
    a.hl_st = ints[5];
    a.az_st = ints[6];
    a.src_lane = ints[7];
    a.src_row = ints[8];
    a.nch = ints[9];
    if (a.nch < 0 || a.nch > MAX_CH || a.planes < 1 || a.planes > 2)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < a.nch; i++) a.ch[i] = (int8_t)ints[10 + i];
    const bool race = a.src != nullptr;
    if (a.lanes <= 0) return (int)cudaGetLastError();
    if (race ? (n > 32 || a.planes != 1) : a.nch < 1)
        return (int)cudaErrorInvalidValue;
    // list mode, channels a CTA: all of them once the lanes alone give ~2
    // CTAs an SM (edges loaded once); fewer, so more CTAs, for small batches
    const int lpc = n <= 4 ? 16 : n == 8 ? 4 : 1;
    const long ctas = ((long)a.planes * a.lanes + lpc - 1) / lpc;
    const long cpc = ((long)a.nch * ctas + 263) / 264;
    a.cpc = (int)(cpc < 1 ? 1 : cpc > a.nch ? a.nch : cpc);
    cudaStream_t s = (cudaStream_t)stream;
    switch (n) {
        case 4: run<4>(a, race, s); break;
        case 8: run<8>(a, race, s); break;
        case 16: run<16>(a, race, s); break;
        case 32: run<32>(a, race, s); break;
        case 64: run<64>(a, false, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
