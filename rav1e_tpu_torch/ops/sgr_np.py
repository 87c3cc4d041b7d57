"""Self-guided (SGRPROJ) loop restoration — numpy oracle.

Reference analog: rav1e src/lrf.rs sgrproj_* (integral-image box sums,
self-guided a/b solve, 16 parameter sets, projection onto the two guided
outputs).  A copy of the JAX package's oracle; bit-exactness is held
against libdav1d decode of streams with SGR units
(tests/test_torch_speed5.py), the same differential gate used for the
Wiener path.

The s values below were extracted from the system dav1d binary's
sgr_params table (s = round(2^20 / (n^2 * e)) for the spec's e values);
sets 10..13 have no 5x5 pass (r0 = 0), 14..15 no 3x3 pass (r1 = 0).
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.ops import lrf_np as lr

SGRPROJ_PARAMS = 16
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_SGR_BITS = 8
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12
SGRPROJ_PRJ_SUBEXP_K = 4

# (s0, s1) per set; radius r0 = 2 iff s0 > 0, r1 = 1 iff s1 > 0
SGR_S = (
    (140, 3236), (112, 2158), (93, 1618), (80, 1438),
    (70, 1295), (58, 1177), (47, 1079), (37, 996),
    (30, 925), (25, 863), (0, 2589), (0, 1618),
    (0, 1177), (0, 925), (56, 0), (22, 0),
)

XQD_MIN = (-96, -32)
XQD_MAX = (31, 95)
XQD_REF_DEFAULT = (-32, 31)


def sgr_radii(set_idx: int) -> tuple:
    s0, s1 = SGR_S[set_idx]
    return (2 if s0 else 0), (1 if s1 else 0)


def _round2(x, bits):
    return (x + (1 << (bits - 1))) >> bits


def _stripe_ext(cdef_p, deblock_p, y0, y1, w, frame_h, stripe, pad=3):
    """Extended source for one stripe: rows [y0-pad, y1+pad) under the LR
    stripe boundary rule (2 deblocked rows beyond the stripe), columns
    [-pad, w+pad) clamped at the frame edge.  int64 (rows, w+2*pad)."""
    xs = np.clip(np.arange(-pad, w + pad), 0, w - 1)
    rows = []
    for yy in range(y0 - pad, y1 + pad):
        rr, use_db = lr._stripe_source(None, None, y0, yy - y0, stripe, frame_h)
        src = deblock_p if use_db else cdef_p
        rows.append(src[rr, xs].astype(np.int64))
    return np.stack(rows)


def _box_ab(ext, r, s, bd, h):
    """A/B grids for one pass over a stripe.  ext: (h+6, w+6) source with
    3-px border; returns A, B at positions i in [-1, h], j in [-1, w]
    (arrays of shape (h+2, w+2); for r == 2 only rows i = -1, 1, 3, ...
    hold values).  Follows the normative integer pipeline."""
    n = (2 * r + 1) ** 2
    pad = 3
    # windowed sums via integral images over the extended source
    c1 = np.zeros((ext.shape[0] + 1, ext.shape[1] + 1), np.int64)
    c2 = np.zeros_like(c1)
    np.cumsum(np.cumsum(ext, 0), 1, out=c1[1:, 1:])
    np.cumsum(np.cumsum(ext * ext, 0), 1, out=c2[1:, 1:])

    def wsum(c, i0, j0, hh, ww):
        # sum over window [i0-r, i0+r] x [j0-r, j0+r] at grid of positions
        a = c[i0 - r : i0 - r + hh, j0 - r : j0 - r + ww]
        b = c[i0 + r + 1 : i0 + r + 1 + hh, j0 + r + 1 : j0 + r + 1 + ww]
        x = c[i0 - r : i0 - r + hh, j0 + r + 1 : j0 + r + 1 + ww]
        y = c[i0 + r + 1 : i0 + r + 1 + hh, j0 - r : j0 - r + ww]
        return b + a - x - y

    hh, ww = h + 2, ext.shape[1] - 2 * pad + 2  # positions -1..h, -1..w
    i0 = pad - 1  # ext row of position i=-1
    j0 = pad - 1
    sum1 = wsum(c1, i0, j0, hh, ww)
    sum2 = wsum(c2, i0, j0, hh, ww)
    if bd > 8:
        a = _round2(sum2, 2 * (bd - 8))
        b = _round2(sum1, bd - 8)
    else:
        a, b = sum2, sum1
    p = np.maximum(0, a * n - b * b)
    z = _round2(p * s, SGRPROJ_MTABLE_BITS)
    a2 = np.where(z >= 255, 256,
                  np.where(z == 0, 1, ((z << SGRPROJ_SGR_BITS) + z // 2) // np.maximum(z + 1, 1)))
    one_over_n = ((1 << SGRPROJ_RECIP_BITS) + n // 2) // n
    b2 = _round2((256 - a2) * b * one_over_n, SGRPROJ_RECIP_BITS)
    return a2, b2


def _guided_pass(ext, r, s, bd, h, w):
    """One self-guided pass over a stripe; returns flt (h, w) int64 at
    SGRPROJ_RST_BITS precision."""
    A, B = _box_ab(ext, r, s, bd, h)  # (h+2, w+2), positions -1..h/-1..w
    pad = 3
    x = ext[pad : pad + h, pad : pad + w]
    flt = np.zeros((h, w), np.int64)
    # index helpers into A/B: position i maps to row i+1
    if r == 2:
        for i in range(h):
            if i % 2 == 0:
                ar = 5 * (A[i, :-2] + A[i, 2:] + A[i + 2, :-2] + A[i + 2, 2:]) \
                    + 6 * (A[i, 1:-1] + A[i + 2, 1:-1])
                br = 5 * (B[i, :-2] + B[i, 2:] + B[i + 2, :-2] + B[i + 2, 2:]) \
                    + 6 * (B[i, 1:-1] + B[i + 2, 1:-1])
                nb = 5
            else:
                ar = 5 * (A[i + 1, :-2] + A[i + 1, 2:]) + 6 * A[i + 1, 1:-1]
                br = 5 * (B[i + 1, :-2] + B[i + 1, 2:]) + 6 * B[i + 1, 1:-1]
                nb = 4
            v = ar * x[i] + br
            flt[i] = _round2(v, SGRPROJ_SGR_BITS + nb - SGRPROJ_RST_BITS)
    else:
        for i in range(h):
            ar = 3 * (A[i, :-2] + A[i, 2:] + A[i + 2, :-2] + A[i + 2, 2:]) \
                + 4 * (A[i, 1:-1] + A[i + 1, :-2] + A[i + 1, 1:-1]
                       + A[i + 1, 2:] + A[i + 2, 1:-1])
            br = 3 * (B[i, :-2] + B[i, 2:] + B[i + 2, :-2] + B[i + 2, 2:]) \
                + 4 * (B[i, 1:-1] + B[i + 1, :-2] + B[i + 1, 1:-1]
                       + B[i + 1, 2:] + B[i + 2, 1:-1])
            v = ar * x[i] + br
            flt[i] = _round2(v, SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
    return flt


def sgr_flt_frame(cdef_p, deblock_p, set_idx: int, bd: int,
                  frame_w: int, frame_h: int, stripe: int = 64):
    """Both guided-pass outputs for the whole frame (stripe by stripe).
    Returns (flt0, flt1) int64 (frame_h, frame_w); a pass with radius 0
    yields None."""
    s0, s1 = SGR_S[set_idx]
    r0, r1 = sgr_radii(set_idx)
    flt0 = np.zeros((frame_h, frame_w), np.int64) if r0 else None
    flt1 = np.zeros((frame_h, frame_w), np.int64) if r1 else None
    off = stripe >> 3
    y0 = 0
    while y0 < frame_h:
        stripe_idx = (y0 + off) // stripe
        y1 = min((stripe_idx + 1) * stripe - off, frame_h)
        ext = _stripe_ext(cdef_p, deblock_p, y0, y1, frame_w, frame_h, stripe)
        h = y1 - y0
        if r0:
            flt0[y0:y1] = _guided_pass(ext, 2, s0, bd, h, frame_w)
        if r1:
            flt1[y0:y1] = _guided_pass(ext, 1, s1, bd, h, frame_w)
        y0 = y1
    return flt0, flt1


def decode_xq(xqd, set_idx: int) -> tuple:
    """(xq0, xq1) actually applied for coded xqd (libaom decode_xq;
    validated against libdav1d by weight-fitting decoded frames)."""
    r0, r1 = sgr_radii(set_idx)
    if r0 == 0:
        return 0, (1 << SGRPROJ_PRJ_BITS) - xqd[1]
    if r1 == 0:
        return xqd[0], 0
    return xqd[0], (1 << SGRPROJ_PRJ_BITS) - xqd[0] - xqd[1]


def sgr_apply(x, flt0, flt1, xqd, set_idx: int, bd: int):
    """Projection combine: x (h, w) source ints, flt0/flt1 from
    sgr_flt_frame (slices), coded xqd.  Returns restored plane slice."""
    xq0, xq1 = decode_xq(xqd, set_idx)
    u = x.astype(np.int64) << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    if flt0 is not None and xq0:
        v = v + xq0 * (flt0 - u)
    if flt1 is not None and xq1:
        v = v + xq1 * (flt1 - u)
    out = _round2(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return np.clip(out, 0, (1 << bd) - 1)


def solve_xqd(x, src, flt0, flt1, set_idx: int) -> list:
    """Least-squares projection weights for one unit (libaom
    get_proj_subspace analog), quantized and clamped to the coded range."""
    r0, r1 = sgr_radii(set_idx)
    u = x.astype(np.float64) * (1 << SGRPROJ_RST_BITS)
    s = src.astype(np.float64) * (1 << SGRPROJ_RST_BITS) - u
    f0 = (flt0 - (x.astype(np.int64) << SGRPROJ_RST_BITS)).astype(np.float64) if r0 else None
    f1 = (flt1 - (x.astype(np.int64) << SGRPROJ_RST_BITS)).astype(np.float64) if r1 else None
    xqd = [0, 0]
    if r0 and r1:
        h00 = (f0 * f0).sum(); h11 = (f1 * f1).sum(); h01 = (f0 * f1).sum()
        c0 = (f0 * s).sum(); c1 = (f1 * s).sum()
        det = h00 * h11 - h01 * h01
        if det > 1e-8:
            x0 = (h11 * c0 - h01 * c1) / det
            x1 = (h00 * c1 - h01 * c0) / det
        else:
            x0 = x1 = 0.0
        xqd[0] = int(np.clip(round(x0 * (1 << SGRPROJ_PRJ_BITS)),
                             XQD_MIN[0], XQD_MAX[0]))
        # coded xqd[1] is the residual: xq1 = 128 - xq0 - xqd1
        xq1 = int(round(x1 * (1 << SGRPROJ_PRJ_BITS)))
        xqd[1] = int(np.clip((1 << SGRPROJ_PRJ_BITS) - xqd[0] - xq1,
                             XQD_MIN[1], XQD_MAX[1]))
    elif r0:
        h00 = (f0 * f0).sum(); c0 = (f0 * s).sum()
        x0 = c0 / h00 if h00 > 1e-8 else 0.0
        xqd[0] = int(np.clip(round(x0 * (1 << SGRPROJ_PRJ_BITS)),
                             XQD_MIN[0], XQD_MAX[0]))
        # syntax: xqd[1] derived, not coded
        xqd[1] = int(np.clip((1 << SGRPROJ_PRJ_BITS) - xqd[0],
                             XQD_MIN[1], XQD_MAX[1]))
    else:
        h11 = (f1 * f1).sum(); c1 = (f1 * s).sum()
        x1 = c1 / h11 if h11 > 1e-8 else 0.0
        # decode_xq applies (128 - xqd1) when r0 == 0
        xqd[1] = int(np.clip((1 << SGRPROJ_PRJ_BITS) - round(x1 * (1 << SGRPROJ_PRJ_BITS)),
                             XQD_MIN[1], XQD_MAX[1]))
    return xqd
