"""Quality metrics on reconstructions (reference analog: the av-metrics
crate used by the CLI's --psnr/--metrics flags)."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, bit_depth: int = 8) -> float:
    peak = (1 << bit_depth) - 1
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(peak * peak / mse))


def frame_psnr(rec: list, src: list, bit_depth: int = 8) -> dict:
    """Per-plane + combined (4:2:0-weighted) PSNR."""
    p = [psnr(rec[i], src[i], bit_depth) for i in range(3)]
    mses = [
        np.mean((rec[i].astype(np.float64) - src[i].astype(np.float64)) ** 2)
        for i in range(3)
    ]
    peak = (1 << bit_depth) - 1
    wmse = (4 * mses[0] + mses[1] + mses[2]) / 6
    combined = 99.0 if wmse == 0 else float(10 * np.log10(peak * peak / wmse))
    return {"y": p[0], "u": p[1], "v": p[2], "combined": combined}


def ssim(a: np.ndarray, b: np.ndarray, bit_depth: int = 8) -> float:
    """Global SSIM over 8x8 windows (the av-metrics-style plane SSIM)."""
    L = (1 << bit_depth) - 1
    c1 = (0.01 * L) ** 2
    c2 = (0.03 * L) ** 2
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    h, w = a.shape
    h8, w8 = h // 8 * 8, w // 8 * 8
    aw = a[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8)
    bw = b[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8)
    mu_a = aw.mean(axis=(1, 3))
    mu_b = bw.mean(axis=(1, 3))
    var_a = aw.var(axis=(1, 3))
    var_b = bw.var(axis=(1, 3))
    cov = (aw * bw).mean(axis=(1, 3)) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return float(s.mean())
