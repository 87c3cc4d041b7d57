"""Synthetic test content: the clip bench.py encodes, and a clip whose
chroma follows its luma.

make_planes: a diagonal luma ramp with +-8 noise from a fixed seed, and
chroma ramps, each moving a little from frame to frame.  Its chroma does
not follow its luma, so chroma-from-luma prediction (CFL) seldom wins.
Above 8 bits each sample is the 8-bit one shifted left by bit_depth - 8,
with its low bits drawn from the same generator.
make_planes_cfl: smooth luma waves drifting 3 px a frame with +-2 noise,
and U and V linear in the 2x2-averaged luma, the content CFL is for.
make_planes_split8: make_planes with the luma of the left half of the
frame in flat 8x8 patches of random levels, which an 8x8 partition codes
far more cheaply than a 16x16 one.
Deterministic, so two encoders (or two runs) fed them see the same
pixels.
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.utils.frame import Frame


def make_planes(w: int, h: int, n: int, seed: int = 0,
                bit_depth: int = 8) -> list:
    """n frames of (y, u, v) 4:2:0 planes: uint8 at 8 bits, else uint16
    samples of bit_depth bits."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    s = bit_depth - 8
    out = []
    for t in range(n):
        y = ((xx + yy + 4 * t) % 256).astype(np.uint8)
        y = np.clip(y.astype(np.int16) + rng.integers(-8, 8, y.shape),
                    0, 255).astype(np.uint8)
        u = ((xx[::2, ::2] // 2 + t) % 256).astype(np.uint8)
        v = ((yy[::2, ::2] // 2 + 2 * t) % 256).astype(np.uint8)
        if s:
            y, u, v = (np.clip((p.astype(np.int32) << s)
                               + rng.integers(0, 1 << s, p.shape),
                               0, (1 << bit_depth) - 1).astype(np.uint16)
                       for p in (y, u, v))
        out.append((y, u, v))
    return out


def make_frames(w: int, h: int, n: int, seed: int = 0,
                bit_depth: int = 8) -> list:
    """n Frames of make_planes content."""
    return [Frame.from_planes(*p, bit_depth=bit_depth)
            for p in make_planes(w, h, n, seed, bit_depth)]


def make_planes_cfl(w: int, h: int, n: int, seed: int = 1) -> list:
    """n frames of (y, u, v) uint8 4:2:0 planes whose chroma is a linear
    function of the luma (w, h even)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for t in range(n):
        y = (128 + 60 * np.sin((xx + 3 * t) / 9.0) * np.cos(yy / 13.0)
             + 30 * np.sin((xx + yy) / 23.0))
        y = np.clip(y + rng.integers(-2, 3, y.shape), 0, 255)
        yd = y.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
        u = np.clip(64 + 0.5 * yd, 0, 255)
        v = np.clip(200 - 0.4 * yd, 0, 255)
        out.append((y.astype(np.uint8), u.astype(np.uint8),
                    v.astype(np.uint8)))
    return out


def make_frames_cfl(w: int, h: int, n: int, seed: int = 1) -> list:
    """n Frames of make_planes_cfl content."""
    return [Frame.from_planes(*p) for p in make_planes_cfl(w, h, n, seed)]


def make_planes_split8(w: int, h: int, n: int, seed: int = 2) -> list:
    """n frames of make_planes content (uint8 4:2:0) whose luma in the
    columns [0, w/2) is flat 8x8 patches of random levels instead."""
    rng = np.random.default_rng(seed)
    out = []
    for y, u, v in make_planes(w, h, n, seed):
        pw = -(-(w // 2) // 8)
        lv = rng.integers(0, 256, (-(-h // 8), pw))
        patch = np.repeat(np.repeat(lv, 8, 0), 8, 1)[:h, : w // 2]
        y = y.copy()
        y[:, : w // 2] = patch.astype(np.uint8)
        out.append((y, u, v))
    return out


def make_frames_split8(w: int, h: int, n: int, seed: int = 2) -> list:
    """n Frames of make_planes_split8 content."""
    return [Frame.from_planes(*p) for p in make_planes_split8(w, h, n, seed)]
