"""Inter motion compensation: AV1 8-tap separable subpel interpolation.

Reference analog: src/mc.rs (put_8tap).  NumPy oracle implementation of
spec 7.11.3 block_inter_predict for single (non-compound) prediction with
unscaled references; the device version (ops/mc.py, K9) is validated
against this.

Filter tables: Subpel_Filters[6][16][8] extracted from libdav1d
(tools/extract_filters.py): 0=REGULAR 1=SMOOTH 2=SHARP 3=REGULAR-4tap
4=SMOOTH-4tap 5=BILINEAR, indexed by 1/16-pel phase.
"""

from __future__ import annotations

import numpy as np

_TBL = np.load(__file__.rsplit("/", 1)[0] + "/av1_tables.npz")
MC_FILTERS = _TBL["mc_filters"].astype(np.int64)  # [6][16][8]

FILTER_REGULAR = 0
FILTER_SMOOTH = 1
FILTER_SHARP = 2
FILTER_REGULAR4 = 3
FILTER_SMOOTH4 = 4
FILTER_BILINEAR = 5


def _round2(x, n: int):
    return (x + (1 << (n - 1))) >> n


def filter_set_for(filter_mode: int, w: int) -> int:
    """spec: blocks 4 wide/tall use the 4-tap variants."""
    if w > 4:
        return filter_mode
    if filter_mode == FILTER_REGULAR or filter_mode == FILTER_SHARP:
        return FILTER_REGULAR4
    if filter_mode == FILTER_SMOOTH:
        return FILTER_SMOOTH4
    return filter_mode  # bilinear


def put_single(
    ref: np.ndarray,
    x0: int,
    y0: int,
    w: int,
    h: int,
    mv_row: int,
    mv_col: int,
    sub_x: int,
    sub_y: int,
    bit_depth: int = 8,
    filter_x: int = FILTER_REGULAR,
    filter_y: int = FILTER_REGULAR,
    ref_w: int | None = None,
    ref_h: int | None = None,
) -> np.ndarray:
    """Single-reference translational prediction of a w*h block at plane
    position (x0, y0).  mv is the block's luma-space MV in 1/8 pel; ref is
    the reference plane (this plane's subsampling already applied).  Sample
    coordinates clamp to [0, ref_w/h - 1] (spec: the reference's real frame
    dimensions, not the padded coded area)."""
    ref_h_full, ref_w_full = ref.shape
    max_x = (ref_w if ref_w is not None else ref_w_full) - 1
    max_y = (ref_h if ref_h is not None else ref_h_full) - 1

    # 1/16-pel plane-space position (spec 7.11.3.2, no scaling)
    start_x = (x0 << 4) + (mv_col << (1 - sub_x))
    start_y = (y0 << 4) + (mv_row << (1 - sub_y))
    ix = start_x >> 4
    iy = start_y >> 4
    fx = start_x & 15
    fy = start_y & 15

    # spec: InterRound0 = 3 (5 at 12-bit); single-pred InterRound1 keeps the
    # total downshift at 2*FILTER_BITS = 14
    round0 = 3 if bit_depth < 12 else 5
    round1 = 14 - round0

    interior = (
        ix - 3 >= 0 and iy - 3 >= 0 and ix + w + 4 <= max_x + 1 and iy + h + 4 <= max_y + 1
    )
    if fx == 0 and fy == 0:
        if interior:
            return ref[iy : iy + h, ix : ix + w].astype(np.int32)
        ys = np.clip(np.arange(iy, iy + h), 0, max_y)
        xs = np.clip(np.arange(ix, ix + w), 0, max_x)
        return ref[np.ix_(ys, xs)].astype(np.int32)

    fset_x = filter_set_for(filter_x, w)
    fset_y = filter_set_for(filter_y, h)
    taps_x = MC_FILTERS[fset_x][fx]
    taps_y = MC_FILTERS[fset_y][fy]

    # horizontal pass over rows [iy-3, iy+h+3]
    if interior:
        src = ref[iy - 3 : iy + h + 4, ix - 3 : ix + w + 4].astype(np.int64)
    else:
        ys = np.clip(np.arange(iy - 3, iy + h + 4), 0, max_y)
        cols = np.clip(np.arange(ix - 3, ix + w + 4), 0, max_x)
        src = ref[np.ix_(ys, cols)].astype(np.int64)  # [h+7, w+7]
    inter = np.zeros((h + 7, w), np.int64)
    for t in range(8):
        tw_ = int(taps_x[t])
        if tw_:
            inter += tw_ * src[:, t : t + w]
    inter = _round2(inter, round0)

    out = np.zeros((h, w), np.int64)
    for t in range(8):
        tw_ = int(taps_y[t])
        if tw_:
            out += tw_ * inter[t : t + h, :]
    out = _round2(out, round1)
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def put_prep(
    ref: np.ndarray,
    x0: int,
    y0: int,
    w: int,
    h: int,
    mv_row: int,
    mv_col: int,
    sub_x: int,
    sub_y: int,
    bit_depth: int = 8,
    filter_x: int = FILTER_REGULAR,
    filter_y: int = FILTER_REGULAR,
    ref_w: int | None = None,
    ref_h: int | None = None,
) -> np.ndarray:
    """Compound-precision prediction (spec 7.11.3 with InterIsCompound=1):
    InterRound1 = 7 keeps extra fractional bits; the result is the
    *unclipped* intermediate signal at scale 1 << (14 - round0 - 7), to be
    combined by avg_compound (reference analog: src/mc.rs prep_8tap)."""
    ref_h_full, ref_w_full = ref.shape
    max_x = (ref_w if ref_w is not None else ref_w_full) - 1
    max_y = (ref_h if ref_h is not None else ref_h_full) - 1

    start_x = (x0 << 4) + (mv_col << (1 - sub_x))
    start_y = (y0 << 4) + (mv_row << (1 - sub_y))
    ix = start_x >> 4
    iy = start_y >> 4
    fx = start_x & 15
    fy = start_y & 15

    round0 = 3 if bit_depth < 12 else 5
    round1 = 7
    scale_bits = 14 - round0 - round1  # InterPostRound: 4 (8/10b), 2 (12b)

    interior = (
        ix - 3 >= 0 and iy - 3 >= 0 and ix + w + 4 <= max_x + 1 and iy + h + 4 <= max_y + 1
    )
    if fx == 0 and fy == 0:
        # phase-0 taps are a pure 128 gain: exact shortcut (no rounding loss)
        if interior:
            block = ref[iy : iy + h, ix : ix + w].astype(np.int64)
        else:
            ys = np.clip(np.arange(iy, iy + h), 0, max_y)
            xs = np.clip(np.arange(ix, ix + w), 0, max_x)
            block = ref[np.ix_(ys, xs)].astype(np.int64)
        return (block << scale_bits).astype(np.int32)

    fset_x = filter_set_for(filter_x, w)
    fset_y = filter_set_for(filter_y, h)
    taps_x = MC_FILTERS[fset_x][fx]
    taps_y = MC_FILTERS[fset_y][fy]

    if interior:
        src = ref[iy - 3 : iy + h + 4, ix - 3 : ix + w + 4].astype(np.int64)
    else:
        ys = np.clip(np.arange(iy - 3, iy + h + 4), 0, max_y)
        cols = np.clip(np.arange(ix - 3, ix + w + 4), 0, max_x)
        src = ref[np.ix_(ys, cols)].astype(np.int64)
    inter = np.zeros((h + 7, w), np.int64)
    for t in range(8):
        tw_ = int(taps_x[t])
        if tw_:
            inter += tw_ * src[:, t : t + w]
    inter = _round2(inter, round0)

    out = np.zeros((h, w), np.int64)
    for t in range(8):
        tw_ = int(taps_y[t])
        if tw_:
            out += tw_ * inter[t : t + h, :]
    return _round2(out, round1).astype(np.int32)


def avg_compound(p0: np.ndarray, p1: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """COMPOUND_AVERAGE combination (spec 7.11.3.1): the simple mean of two
    prep-precision predictions (enable_jnt_comp=0, enable_masked_compound=0
    so no distance weights / wedges are signaled)."""
    post = (14 - (3 if bit_depth < 12 else 5) - 7) + 1
    out = _round2(p0.astype(np.int64) + p1.astype(np.int64), post)
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)
