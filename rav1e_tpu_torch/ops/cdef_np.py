"""CDEF (constrained directional enhancement filter), spec 7.15.

Reference analog: src/cdef.rs (paper: arXiv 1602.05975, see PAPERS.md).
NumPy oracle: the whole-frame batched filter of the JAX package's
cdef_np (validated there against libdav1d), copied for the port's tests
and for chip_smoke.py's re-derivation of the filtered frame.

Key normative pieces:
- 8x8 direction estimation from luma partial sums (Div_Table costs)
- primary taps {4,2}/{3,3} along the direction, secondary {2,1} at 45 deg
- constrain() with damping, final clamp to the tap min/max
- CDEF_VERY_LARGE (0x4000) for out-of-frame samples
"""

from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 0x4000

DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], np.int64)

# (dy, dx) per direction, two primary tap distances
CDEF_DIRECTIONS = np.array(
    [
        [[-1, 1], [-2, 2]],
        [[0, 1], [-1, 2]],
        [[0, 1], [0, 2]],
        [[0, 1], [1, 2]],
        [[1, 1], [2, 2]],
        [[1, 0], [2, 1]],
        [[1, 0], [2, 0]],
        [[1, 0], [2, -1]],
    ],
    np.int32,
)

PRI_TAPS = ((4, 2), (3, 3))  # indexed by pri_strength & 1
SEC_TAPS = (2, 1)


_BIN_MATS = None


def _bin_mats():
    """One-hot [8][nbins, 64] matrices mapping 8x8 pixels to direction bins."""
    global _BIN_MATS
    if _BIN_MATS is None:
        i = np.repeat(np.arange(8), 8)
        j = np.tile(np.arange(8), 8)
        bins = [
            i + j, i + (j >> 1), i, 3 + i - (j >> 1),
            7 + i - j, 3 - (i >> 1) + j, j, (i >> 1) + j,
        ]
        mats = []
        for b in bins:
            m = np.zeros((int(b.max()) + 1, 64), np.int64)
            m[b, np.arange(64)] = 1
            mats.append(m)
        _BIN_MATS = mats
    return _BIN_MATS


_ODD_LENS = np.array([2, 4, 6, 8, 8, 8, 8, 8, 6, 4, 2], np.int64)
_D0_DIV = DIV_TABLE[np.minimum(np.arange(15) + 1, 15 - np.arange(15)).clip(max=8)]


def find_dir_all(plane: np.ndarray, bd: int, h: int, w: int):
    """Directions + variances for every 8x8 block at once.
    Returns (dirs [h/8, w/8], vars [h/8, w/8])."""
    nby, nbx = h // 8, w // 8
    x = (plane[:h, :w].astype(np.int64) >> (bd - 8)) - 128
    blocks = x.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
    mats = _bin_mats()
    costs = np.zeros((8, blocks.shape[0]), np.int64)
    for d in range(8):
        partial = blocks @ mats[d].T  # [nb, nbins]
        if d in (0, 4):
            costs[d] = (partial**2 * _D0_DIV[None, :]).sum(axis=1)
        elif d in (2, 6):
            costs[d] = (partial**2).sum(axis=1) * 105
        else:
            costs[d] = (partial**2 * DIV_TABLE[_ODD_LENS][None, :]).sum(axis=1)
    best = costs.argmax(axis=0)
    nb = blocks.shape[0]
    var = (costs[best, np.arange(nb)] - costs[(best + 4) & 7, np.arange(nb)]) >> 10
    return best.reshape(nby, nbx).astype(np.int32), var.reshape(nby, nbx)


def _adjust_strength_vec(strength: int, var: np.ndarray) -> np.ndarray:
    if strength == 0:
        return np.zeros(var.shape, np.int64)
    v6 = var >> 6
    i = np.zeros(var.shape, np.int64)
    nz = v6 > 0
    i[nz] = np.minimum(np.log2(v6[nz]).astype(np.int64), 12)
    out = (strength * (4 + i) + 8) >> 4
    return np.where(var > 0, out, 0)


def _constrain_vec(diff, strength, damping):
    """strength: per-pixel int array (0 disables).  Vectorized constrain."""
    a = np.abs(diff)
    s = strength
    with np.errstate(divide="ignore"):
        shift = np.zeros(np.shape(s), np.int64)
        nz = s > 0
        bl = np.zeros(np.shape(s), np.int64)
        bl[nz] = np.int64(np.log2(s[nz]))
        shift = np.maximum(0, damping - bl)
    v = np.minimum(a, np.maximum(0, s - (a >> shift)))
    return np.where(s > 0, np.sign(diff) * v, 0)


def _cdef_plane_batched(plane, dirs, pri_map, sec, damping, bd, w, h,
                        active, sub):
    """Filter one plane in place.  dirs/pri_map/active: per-8x8-luma-block
    maps; sec: scalar strength; sub: chroma subsampling (block = 8>>sub)."""
    bs = 8 >> sub
    pad = 3
    src = np.full((h + 2 * pad, w + 2 * pad), CDEF_VERY_LARGE, np.int64)
    src[pad : pad + h, pad : pad + w] = plane[:h, :w]
    x = src[pad : pad + h, pad : pad + w]

    # per-pixel maps
    pri_px = np.repeat(np.repeat(pri_map, bs, 0), bs, 1)[:h, :w]
    act_px = np.repeat(np.repeat(active, bs, 0), bs, 1)[:h, :w]
    dir_px = np.repeat(np.repeat(dirs, bs, 0), bs, 1)[:h, :w]

    summ = np.zeros((h, w), np.int64)
    mx = x.copy()
    mn = x.copy()

    def tap(dy, dx):
        return src[pad + dy : pad + dy + h, pad + dx : pad + dx + w]

    for d in range(8):
        dmask = dir_px == d
        if not dmask.any():
            continue
        for k in range(2):
            dy, dx = int(CDEF_DIRECTIONS[d][k][0]), int(CDEF_DIRECTIONS[d][k][1])
            for s in (1, -1):
                p = tap(s * dy, s * dx)
                tap_w = np.where((pri_px >> (bd - 8)) & 1, PRI_TAPS[1][k], PRI_TAPS[0][k])
                contrib = tap_w * _constrain_vec(p - x, pri_px, damping)
                summ += np.where(dmask, contrib, 0)
                valid = dmask & (p != CDEF_VERY_LARGE) & (pri_px > 0)
                mx = np.where(valid, np.maximum(mx, p), mx)
                mn = np.where(valid, np.minimum(mn, p), mn)
        if sec:
            sec_arr = np.full((h, w), sec, np.int64)
            for d2 in ((d + 2) & 7, (d + 6) & 7):
                for k in range(2):
                    dy, dx = int(CDEF_DIRECTIONS[d2][k][0]), int(CDEF_DIRECTIONS[d2][k][1])
                    for s in (1, -1):
                        p = tap(s * dy, s * dx)
                        contrib = SEC_TAPS[k] * _constrain_vec(p - x, sec_arr, damping)
                        summ += np.where(dmask, contrib, 0)
                        valid = dmask & (p != CDEF_VERY_LARGE)
                        mx = np.where(valid, np.maximum(mx, p), mx)
                        mn = np.where(valid, np.minimum(mn, p), mn)

    out = x + ((8 + summ - (summ < 0)) >> 4)
    out = np.clip(out, mn, mx)
    write = act_px & ((pri_px > 0) | bool(sec))
    plane[:h, :w] = np.where(write, out, plane[:h, :w]).astype(plane.dtype)


def cdef_frame_batched(
    rec: list,
    skip: np.ndarray,
    y_pri: int,
    y_sec: int,
    uv_pri: int,
    uv_sec: int,
    damping: int,
    bd: int,
    coded_w: int,
    coded_h: int,
) -> None:
    """Vectorized whole-frame CDEF (equivalent to cdef_frame; validated
    against it and against libdav1d)."""
    if (y_pri | y_sec | uv_pri | uv_sec) == 0:
        return
    damping += bd - 8  # spec 7.15.3: damping scales with bit depth
    nby, nbx = coded_h // 8, coded_w // 8
    dirs, var = find_dir_all(rec[0], bd, coded_h, coded_w)
    s4 = skip[: nby * 2, : nbx * 2].reshape(nby, 2, nbx, 2).transpose(0, 2, 1, 3)
    active = ~s4.reshape(nby, nbx, 4).all(axis=2)

    scale = bd - 8
    # spec 7.15.3: secondary-only filtering uses direction 0 (per plane)
    zdirs = np.zeros_like(dirs)
    if y_pri or y_sec:
        pri_map = _adjust_strength_vec(y_pri << scale, var)
        _cdef_plane_batched(rec[0], dirs if y_pri else zdirs, pri_map,
                            y_sec << scale, damping,
                            bd, coded_w, coded_h, active, 0)
    if uv_pri or uv_sec:
        pri_map = np.full(dirs.shape, uv_pri << scale, np.int64)
        for p in (1, 2):
            _cdef_plane_batched(rec[p], dirs if uv_pri else zdirs, pri_map,
                                uv_sec << scale,
                                damping - 1, bd, coded_w >> 1, coded_h >> 1,
                                active, 1)
