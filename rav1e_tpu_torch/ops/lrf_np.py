"""Loop restoration (Wiener), spec 7.17.

Reference analog: src/lrf.rs.  The restored frame is computed from the
CDEF output, except that rows crossing a 64-px stripe boundary come from
the pre-CDEF (deblocked) frame with 2-row duplication - the decoder's
line-buffer rule.  Unit grid: 64/128/256 px units with the trailing
partial unit merged when smaller than half (count_units_in_frame).

Encoder side: per-unit symmetric 7-tap separable Wiener solve via the
autocorrelation normal equations, taps quantized to the coded ranges.
"""

from __future__ import annotations

import numpy as np

WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_TAPS_K = (1, 2, 3)
WIENER_DEFAULT = (3, -7, 15)


def count_units(unit_size: int, frame_size: int) -> int:
    return max((frame_size + (unit_size >> 1)) // unit_size, 1)


def unit_ranges(unit_size: int, frame_size: int, shifted: bool = False) -> list:
    """[(start, end)] covering frame_size; last unit absorbs the remainder.
    shifted: vertical unit ranges are stripe-aligned, i.e. pulled up by
    unit_size/8 px (unit k covers [64k-8, 64(k+1)-8) for 64-px units), so
    each restoration unit spans whole filter stripes."""
    n = count_units(unit_size, frame_size)
    off = (unit_size >> 3) if shifted else 0
    out = []
    for i in range(n):
        s = 0 if i == 0 else i * unit_size - off
        e = frame_size if i == n - 1 else (i + 1) * unit_size - off
        out.append((s, e))
    return out


def wiener_7tap(taps3) -> np.ndarray:
    c0, c1, c2 = (int(t) for t in taps3)
    return np.array([c0, c1, c2, 128 - 2 * (c0 + c1 + c2), c2, c1, c0], np.int64)


def _stripe_source(cdef_p: np.ndarray, deblock_p: np.ndarray, y: int, t: int,
                   stripe_size: int, h: int) -> tuple:
    """Row index + which plane for filter tap row y+t under the stripe rule.
    Luma stripes run [0,56), [56,120), ...; returns (row, use_deblocked).
    The row is clamped to the plane before the stripe test, as the spec's
    get_source_sample does (7.17.7): where a stripe ends at the plane's
    last row, the taps below it read that row of the CDEF output, not of
    the deblocked plane.  (The JAX package's copy tests first and so reads
    the deblocked row there, which libdav1d does not: ROADMAP F7.)"""
    off = stripe_size >> 3  # 8 luma, 4 chroma
    stripe_idx = (y + off) // stripe_size
    s0 = stripe_idx * stripe_size - off
    s1 = s0 + stripe_size
    yy = max(0, min(y + t, h - 1))
    if yy < s0:
        return max(yy, s0 - 2), True
    if yy >= s1:
        return min(yy, s1 + 1), True
    return yy, False


def wiener_filter_unit(
    cdef_p: np.ndarray,
    deblock_p: np.ndarray,
    x0: int,
    y0: int,
    x1: int,
    y1: int,
    vtaps3,
    htaps3,
    stripe_size: int,
    bd: int,
    frame_w: int,
    frame_h: int,
) -> np.ndarray:
    """Restore one unit [(x0,y0), (x1,y1)).  Returns the restored block."""
    vf = wiener_7tap(vtaps3)
    hf = wiener_7tap(htaps3)
    round0 = 3 if bd < 12 else 5
    round1 = 11 if bd < 12 else 9
    off_h = 1 << (bd + 6)  # keeps the horizontal intermediate positive
    limit = (1 << (bd + 1 + 7 - round0)) - 1
    off_v = 1 << (bd + round1 - 1)

    w = x1 - x0
    h = y1 - y0
    out = np.zeros((h, w), np.int64)
    xs = np.arange(x0 - 3, x1 + 3)
    xs = np.clip(xs, 0, frame_w - 1)
    for row in range(h):
        y = y0 + row
        # gather the 7 source rows under the stripe-boundary rule
        rows = []
        for t in range(-3, 4):
            rr, use_db = _stripe_source(cdef_p, deblock_p, y, t, stripe_size, frame_h)
            src = deblock_p if use_db else cdef_p
            rows.append(src[rr, xs].astype(np.int64))
        rows = np.stack(rows)  # (7, w+6)
        # horizontal pass on each of the 7 rows
        hor = np.zeros((7, w), np.int64)
        for t in range(7):
            hor += hf[t] * rows[:, t : t + w]
        hor = (hor + off_h + (1 << (round0 - 1))) >> round0
        hor = np.clip(hor, 0, limit)
        # vertical pass
        s = (vf[:, None] * hor).sum(axis=0) - off_v
        v = (s + (1 << (round1 - 1))) >> round1
        out[row] = np.clip(v, 0, (1 << bd) - 1)
    return out


def wiener_filter_frame(
    cdef_p: np.ndarray,
    deblock_p: np.ndarray,
    vtaps3,
    htaps3,
    stripe_size: int,
    bd: int,
    frame_w: int,
    frame_h: int,
) -> np.ndarray:
    """Whole-frame Wiener restore (vectorized).  Equivalent to running
    wiener_filter_unit over every unit with the same taps: the stripe rule
    is encoded in a per-(row, tap) source-row gather table."""
    vf = wiener_7tap(vtaps3)
    hf = wiener_7tap(htaps3)
    round0 = 3 if bd < 12 else 5
    round1 = 11 if bd < 12 else 9
    off_h = 1 << (bd + 6)
    limit = (1 << (bd + 1 + 7 - round0)) - 1
    off_v = 1 << (bd + round1 - 1)

    h, w = frame_h, frame_w
    xs = np.clip(np.arange(-3, w + 3), 0, w - 1)
    # gather 7 source rows per output row under the stripe rule
    ridx = np.zeros((h, 7), np.int64)
    use_db = np.zeros((h, 7), np.bool_)
    for t in range(-3, 4):
        for y in range(h):
            rr, db = _stripe_source(cdef_p, deblock_p, y, t, stripe_size, h)
            ridx[y, t + 3] = rr
            use_db[y, t + 3] = db
    cd = cdef_p[:, xs].astype(np.int64)
    db_ = deblock_p[:, xs].astype(np.int64)
    rows = np.where(use_db[:, :, None], db_[ridx], cd[ridx])  # (h, 7, w+6)
    hor = np.zeros((h, 7, w), np.int64)
    for t in range(7):
        if hf[t]:
            hor += hf[t] * rows[:, :, t : t + w]
    hor = (hor + off_h + (1 << (round0 - 1))) >> round0
    hor = np.clip(hor, 0, limit)
    s = (vf[None, :, None] * hor).sum(axis=1) - off_v
    v = (s + (1 << (round1 - 1))) >> round1
    return np.clip(v, 0, (1 << bd) - 1)


def solve_wiener(degraded: np.ndarray, source: np.ndarray) -> tuple:
    """Least-squares symmetric separable 7-tap fit; returns (vtaps3, htaps3)
    quantized to the coded ranges (encoder choice, any value decodable).
    Large planes are subsampled (the fit is statistical)."""
    h, w = degraded.shape
    if h * w > (1 << 17):
        # fit on evenly spaced bands of contiguous rows (vertical pairs
        # need real neighbors, so no row striding)
        band = 32
        nbands = max(1, (1 << 17) // (band * w))
        starts = np.linspace(0, max(0, h - band), nbands).astype(int)
        idx = np.concatenate([np.arange(s, min(s + band, h)) for s in starts])
        degraded = degraded[idx]
        source = source[idx]

    def solve_dir(d, s, axis):
        # model s ~ conv(d, f) along axis with symmetric 7-tap, f in 1/128
        # build features: symmetric pairs (x[-k]+x[k]) for k=1..3 and x[0]
        if axis == 0:
            pad = np.pad(d, ((3, 3), (0, 0)), mode="edge")
            cols = [pad[3 - k : pad.shape[0] - 3 - k, :] + pad[3 + k : pad.shape[0] - 3 + k, :]
                    for k in (3, 2, 1)]
            center = d
        else:
            pad = np.pad(d, ((0, 0), (3, 3)), mode="edge")
            cols = [pad[:, 3 - k : pad.shape[1] - 3 - k] + pad[:, 3 + k : pad.shape[1] - 3 + k]
                    for k in (3, 2, 1)]
            center = d
        # residual against identity: find c s.t. s - d ~ sum c_k (pair_k - 2 d)
        A = np.stack([(c - 2 * center).ravel() for c in cols], axis=1).astype(np.float64)
        b = (s - d).ravel().astype(np.float64)
        try:
            coef, *_ = np.linalg.lstsq(A, b, rcond=None)
        except np.linalg.LinAlgError:
            coef = np.zeros(3)
        taps = np.round(coef * 128).astype(int)
        out = []
        for i, t in enumerate(taps):
            out.append(int(np.clip(t, WIENER_TAPS_MIN[i], WIENER_TAPS_MAX[i])))
        return tuple(out)

    v = solve_dir(degraded, source, 0)
    h = solve_dir(degraded, source, 1)
    return v, h
