"""Intra prediction in PyTorch (K1) and chroma-from-luma (K11), bit-exact
with ops/intra_np.py.

Counterpart of rav1e_tpu/ops/intra_jax.py (predict_dirs, dir_matrices,
dc_predict; cfl_ac_420_batch and cfl_predict_batch with the wavefront's
alpha fit, K11) and of the wavefront's _nondir_preds.  NORMATIVE (spec 7.11.2):
the wavefront encoder reconstructs with these predictions.  Edge filtering
and upsampling are off in this encoder's streams.

`intra_pred(above, left, ha, hl, n, full)` evaluates a whole channel set
for a batch of lanes: FULL = DC, the 56 directional variants (8 modes x 7
angle deltas, enum order) and SMOOTH/SMOOTH_V/SMOOTH_H/PAETH (61
channels); NONDIR = DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH (7).  On a
CUDA tensor it launches the hand-written kernel csrc/intra_pred.cu; on a
CPU tensor it runs the plain version below.
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.ops import intra_np as ip

DC, V, H = ip.DC_PRED, ip.V_PRED, ip.H_PRED
D45, D135, D113, D157, D203, D67 = (ip.D45_PRED, ip.D135_PRED, ip.D113_PRED,
                                    ip.D157_PRED, ip.D203_PRED, ip.D67_PRED)
SMOOTH, SMOOTH_V, SMOOTH_H, PAETH = (ip.SMOOTH_PRED, ip.SMOOTH_V_PRED,
                                     ip.SMOOTH_H_PRED, ip.PAETH_PRED)
DIR_MODE_IDS = (V, H, D45, D135, D113, D157, D203, D67)
DIR_ANGLES = np.array([[ip.MODE_ANGLE[m] + 3 * d for d in range(-3, 4)]
                       for m in DIR_MODE_IDS], np.int32)  # (8, 7)
N_FULL = 61
N_NONDIR = 7


def dir_taps(n: int):
    """Per-sample taps of the 56 directional variants of an n x n block:
    (i0, w0, i1, w1) int arrays (56, n, n) into the edge vector e =
    [top-left, above[0..2n), left[0..2n)], so that the prediction is
    (e[i0] * w0 + e[i1] * w1 + 16) >> 5 — the same rule dir_matrices
    encodes as a matrix."""
    ne = 2 * n
    rr = np.arange(n)[:, None]
    cc = np.arange(n)[None, :]

    def ea(i):
        return np.where(i < 0, 0, 1 + i)

    def el(i):
        return np.where(i < 0, 0, 1 + ne + i)

    i0 = np.zeros((56, n, n), np.int64)
    i1 = np.zeros((56, n, n), np.int64)
    w0 = np.zeros((56, n, n), np.int32)
    w1 = np.zeros((56, n, n), np.int32)
    mx = ne - 1
    for mi in range(8):
        for dd in range(7):
            k = mi * 7 + dd
            p = int(DIR_ANGLES[mi, dd])
            if p == 90:
                a, b, s = ea(cc + 0 * rr), ea(cc + 0 * rr), np.zeros((n, n), int)
            elif p == 180:
                a, b, s = el(rr + 0 * cc), el(rr + 0 * cc), np.zeros((n, n), int)
            elif p < 90:
                xpos = (rr + 1) * int(ip._DR[p])
                bx = (xpos >> 6) + cc
                s = np.broadcast_to((xpos >> 1) & 0x1F, (n, n))
                a = np.where(bx >= mx, ea(mx + 0 * bx), ea(bx))
                b = np.where(bx >= mx, ea(mx + 0 * bx), ea(bx + 1))
            elif p < 180:
                xpos = (cc << 6) - (rr + 1) * int(ip._DR[180 - p])
                bx = xpos >> 6
                ypos = (rr << 6) - (cc + 1) * int(ip._DR[p - 90])
                by = ypos >> 6
                use_a = bx >= -1
                a = np.where(use_a, ea(bx), el(by))
                b = np.where(use_a, ea(bx + 1), el(by + 1))
                s = np.where(use_a, (xpos >> 1) & 0x1F, (ypos >> 1) & 0x1F)
            else:
                ypos = (cc + 1) * int(ip._DR[270 - p])
                by = (ypos >> 6) + rr
                s = np.broadcast_to((ypos >> 1) & 0x1F, (n, n))
                a = np.where(by >= mx, el(mx + 0 * by), el(by))
                b = np.where(by >= mx, el(mx + 0 * by), el(by + 1))
            i0[k], i1[k] = a, b
            w0[k], w1[k] = 32 - s, s
    return i0, w0, i1, w1


_TAPS: dict = {}


def _taps_for(n: int, device):
    key = (n, str(device))
    t = _TAPS.get(key)
    if t is None:
        t = tuple(torch.as_tensor(a, device=device) for a in dir_taps(n))
        _TAPS[key] = t
    return t


def dc_predict(above, left, n: int, ha, hl, bd: int = 8):
    """(B, n, n) DC prediction of square blocks."""
    base = 1 << (bd - 1)
    sA = above[:, 1 : 1 + n].sum(-1)
    sL = left[:, 1 : 1 + n].sum(-1)
    lg = int(np.log2(n))
    avg = torch.where(ha & hl, (sA + sL + n) >> (lg + 1),
                      torch.where(ha, (sA + (n >> 1)) >> lg,
                                  torch.where(hl, (sL + (n >> 1)) >> lg,
                                              torch.full_like(sA, base))))
    return avg[:, None, None].expand(above.shape[0], n, n)


def nondir_preds(above, left, n: int):
    """SMOOTH / SMOOTH_V / SMOOTH_H / PAETH: (B, 4, n, n)."""
    A = above[:, 1 : 1 + n]
    L = left[:, 1 : 1 + n]
    tl = above[:, 0][:, None, None]
    w = torch.as_tensor(np.asarray(ip.sm_weights(n), np.int32),
                        device=above.device)
    wx = w[None, None, :]
    wy = w[None, :, None]
    below = L[:, n - 1][:, None, None]
    right = A[:, n - 1][:, None, None]
    Ab = A[:, None, :]
    Lb = L[:, :, None]
    sm = (wy * Ab + (256 - wy) * below + wx * Lb + (256 - wx) * right + 256) >> 9
    smv = (wy * Ab + (256 - wy) * below + 128) >> 8
    smh = (wx * Lb + (256 - wx) * right + 128) >> 8
    shape = (above.shape[0], n, n)
    b = Ab + Lb - tl
    pa = torch.abs(b - Ab)
    pl = torch.abs(b - Lb)
    ptl = torch.abs(b - tl)
    paeth = torch.where((pl <= pa) & (pl <= ptl), Lb.expand(shape),
                        torch.where(pa <= ptl, Ab.expand(shape),
                                    tl.expand(shape)))
    return torch.stack([sm, smv, smh, paeth], dim=1)


def predict_dirs(above, left, n: int):
    """All 56 directional predictions: (B, 8, 7, n, n) int32."""
    B = above.shape[0]
    e = torch.cat([above, left[:, 1:]], dim=1)
    i0, w0, i1, w1 = _taps_for(n, above.device)
    g0 = e[:, i0.reshape(-1)].reshape(B, 56, n, n)
    g1 = e[:, i1.reshape(-1)].reshape(B, 56, n, n)
    return ((g0 * w0 + g1 * w1 + 16) >> 5).reshape(B, 8, 7, n, n)


def intra_pred_plain(above, left, ha, hl, n: int, full: bool, bd: int = 8):
    B = above.shape[0]
    dc = dc_predict(above, left, n, ha, hl, bd)[:, None]
    nd = nondir_preds(above, left, n)
    if full:
        mid = predict_dirs(above, left, n).reshape(B, 56, n, n)
    else:
        mid = torch.stack([above[:, None, 1 : 1 + n].expand(B, n, n),
                           left[:, 1 : 1 + n, None].expand(B, n, n)], dim=1)
    return torch.cat([dc, mid, nd], dim=1).to(torch.int32)


_DEV_TABLES: dict = {}


def _dev_tables(device):
    t = _DEV_TABLES.get(str(device))
    if t is None:
        t = (torch.as_tensor(np.asarray(ip._DR, np.int32), device=device),
             {n: torch.as_tensor(np.asarray(ip.sm_weights(n), np.int32),
                                 device=device) for n in (4, 8, 16, 32, 64)})
        _DEV_TABLES[str(device)] = t
    return t


def intra_pred(above: torch.Tensor, left: torch.Tensor, ha: torch.Tensor,
               hl: torch.Tensor, n: int, full: bool,
               bd: int = 8) -> torch.Tensor:
    """Predictions of one channel set for B lanes of n x n blocks.

    above/left: (B, 2n+1) int32 edges (index 0 = top-left, as
    build_edges_batch makes them); ha/hl: (B,) bool availability.
    Returns (B, 61 | 7, n, n) int32 (K1)."""
    if above.device.type == "cpu":
        return intra_pred_plain(above, left, ha, hl, n, full, bd)
    B = above.shape[0]
    nch = N_FULL if full else N_NONDIR
    a = above.to(torch.int32).contiguous()
    lf = left.to(torch.int32).contiguous()
    hai = ha.to(torch.int32).contiguous()
    hli = hl.to(torch.int32).contiguous()
    out = torch.empty((B, nch, n, n), dtype=torch.int32, device=a.device)
    dr, smw = _dev_tables(a.device)
    kernels.launch("intra_pred", a, a.data_ptr(), lf.data_ptr(),
                   hai.data_ptr(), hli.data_ptr(), B, n, 1 if full else 0, bd,
                   dr.data_ptr(), smw[n].data_ptr(), out.data_ptr())
    return out


# -- K11 cfl ----------------------------------------------------------------------

def cfl_plain(luma: torch.Tensor, dc: torch.Tensor, src: torch.Tensor,
              bd: int = 8):
    """Plain version of K11.  luma: (B, n, n) reconstructed luma blocks;
    dc, src: (B, 2, n/2, n/2) the DC predictions and sources of U and V.
    Returns (alpha (B, 2), pred (B, 2, n/2, n/2), resid = src - pred), all
    int32: the AC values of the 2x2 luma sums (cfl_ac_420_batch), each
    plane's alpha fitted to src - dc (exact int64 sums, each rounded to
    float32 once, the quotient rounded half to even, clipped to +-16, 0
    for flat luma) and the CFL prediction (cfl_predict_batch)."""
    y = luma.to(torch.int64)
    L = (y[:, 0::2, 0::2] + y[:, 0::2, 1::2] + y[:, 1::2, 0::2]
         + y[:, 1::2, 1::2]) << 1
    m = L.shape[1] * L.shape[2]
    log2sz = m.bit_length() - 1
    avg = (L.sum((-1, -2)) + (1 << (log2sz - 1))) >> log2sz
    ac = (L - avg[:, None, None])[:, None]  # (B, 1, n2, n2)
    res = src.to(torch.int64) - dc.to(torch.int64)
    den = (ac * ac).sum((-1, -2)).to(torch.float32)  # (B, 1)
    num = (res * ac).sum((-1, -2)).to(torch.float32)  # (B, 2)
    q = torch.round(num * 64.0 / torch.clamp(den, min=1.0))
    alpha = torch.where(den > 0, torch.clamp(q, -16, 16),
                        torch.zeros_like(q)).to(torch.int64)
    prod = alpha[:, :, None, None] * ac
    scaled = torch.sign(prod) * ((prod.abs() + 32) >> 6)
    pred = torch.clamp(dc.to(torch.int64) + scaled, 0, (1 << bd) - 1)
    return (alpha.to(torch.int32), pred.to(torch.int32),
            (src.to(torch.int64) - pred).to(torch.int32))


def cfl(luma: torch.Tensor, dc: torch.Tensor, src: torch.Tensor,
        bd: int = 8):
    """CFL fit and prediction of B blocks of n x n luma (n in 8, 16, 32)
    and their U and V (K11); see cfl_plain."""
    if luma.device.type == "cpu":
        return cfl_plain(luma, dc, src, bd)
    B, n, _ = luma.shape
    n2 = n >> 1
    if n not in (8, 16, 32) or luma.shape != (B, n, n) or \
            dc.shape != (B, 2, n2, n2) or src.shape != dc.shape:
        raise ValueError("cfl: luma (B, n, n) with n in 8, 16, 32 and dc, "
                         "src (B, 2, n/2, n/2)")
    y = luma.to(torch.int32).contiguous()
    d = dc.to(torch.int32).contiguous()
    s = src.to(torch.int32).contiguous()
    alpha = torch.empty((B, 2), dtype=torch.int32, device=y.device)
    pred = torch.empty_like(d)
    resid = torch.empty_like(d)
    kernels.launch("cfl", y, y.data_ptr(), B, n, d.data_ptr(), s.data_ptr(),
                   bd, alpha.data_ptr(), pred.data_ptr(), resid.data_ptr())
    return alpha, pred, resid
