"""Intra prediction in PyTorch (K1) and chroma-from-luma (K11), bit-exact
with ops/intra_np.py.

Counterpart of rav1e_tpu/ops/intra_jax.py (predict_dirs, dir_matrices,
dc_predict; cfl_ac_420_batch and cfl_predict_batch with the wavefront's
alpha fit, K11's fit mode, and the wavefront's CFL-vs-DC choice, its
decide mode; dr_predict_batch, K13; predict_stack over K1 and K13;
build_edges_batch, K14) and of the wavefront's _nondir_preds.  NORMATIVE (spec 7.11.2):
the wavefront encoder reconstructs with these predictions.  Edge filtering
and upsampling are off in this encoder's streams.

`intra_pred(above, left, ha, hl, n, full)` evaluates a channel list for
a batch of lanes, each channel named by its index in the FULL set: DC,
the 56 directional variants (8 modes x 7 angle deltas, enum order) and
SMOOTH/SMOOTH_V/SMOOTH_H/PAETH (61 channels); NONDIR = DC, V, H, SMOOTH,
SMOOTH_V, SMOOTH_H, PAETH (7) is the list FULL[NONDIR_CHANNELS], and
`channels=` names any other.  Given two planes' edges (U and V) it
predicts both in one call.  Given a source block (`src=`, with
`allow_z1=`) it is the key pass's fine-direction race instead: each base
direction's angle delta picked by SAD, the 13-candidate stack and the
picks returned.  On a CUDA tensor it launches the hand-written kernel
csrc/intra_pred.cu; on a CPU tensor it runs the plain version below.
Likewise dr_predict_batch (csrc/dr_predict.cu: one lane's prediction at
its own angle, any w x h) and build_edges_batch (csrc/build_edges.cu:
the edge vectors of B blocks from a reconstructed plane).
"""

from __future__ import annotations

import ctypes
import threading

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
FULL_CHANNELS = tuple(range(N_FULL))
# NONDIR in FULL's enumeration: DC, V and H at angle delta 0, SMOOTH,
# SMOOTH_V, SMOOTH_H, PAETH
NONDIR_CHANNELS = (0, 4, 11, 57, 58, 59, 60)
# the 13 modes at angle delta 0 in mode order: DC, the 8 base directions,
# SMOOTH, SMOOTH_V, SMOOTH_H, PAETH (the race's stack without its pick)
STACK13_CHANNELS = (0,) + tuple(1 + 7 * m + 3 for m in range(8)) + (
    57, 58, 59, 60)


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


def _channels(full: bool, channels) -> tuple:
    if channels is None:
        return FULL_CHANNELS if full else NONDIR_CHANNELS
    return channels if type(channels) is tuple else tuple(
        int(c) for c in channels)


def _race_plain(above, left, ha, hl, n: int, src, allow_z1, bd: int):
    """The fine-direction race (rav1e_tpu/models/wavefront.py:614-631):
    the 56 directional variants' SADs against src, each base direction's
    first least among its allowed deltas (zone-1 deltas barred where
    allow_z1 is false), and the 13-candidate stack."""
    B = above.shape[0]
    dirs = predict_dirs(above, left, n)  # (B, 8, 7, n, n)
    sad56 = (dirs - src[:, None, None]).abs().sum((-1, -2))
    angs = torch.as_tensor(DIR_ANGLES, device=above.device)
    bad56 = (angs[None] < 90) & ~allow_z1.to(torch.bool)[:, None, None]
    di8 = torch.argmin(torch.where(bad56, 1 << 30, sad56), dim=2)
    pick = torch.gather(dirs, 2, di8[:, :, None, None, None].expand(
        B, 8, 1, n, n))[:, :, 0]
    stack = torch.cat([dc_predict(above, left, n, ha, hl, bd)[:, None], pick,
                       nondir_preds(above, left, n)], 1)
    return stack.to(torch.int32), di8.to(torch.int32)


def intra_pred_plain(above, left, ha, hl, n: int, full: bool = True,
                     bd: int = 8, channels=None, src=None, allow_z1=None):
    """Plain version of K1 (intra_pred's arguments and results)."""
    if src is not None:
        return _race_plain(above, left, ha.to(torch.bool), hl.to(torch.bool),
                           n, src, allow_z1, bd)
    if isinstance(above, (tuple, list)):
        return torch.stack([intra_pred_plain(a, lf, ha, hl, n, full, bd,
                                             channels)
                            for a, lf in zip(above, left)], 1)
    chans = _channels(full, channels)
    B = above.shape[0]
    ha, hl = ha.to(torch.bool), hl.to(torch.bool)
    nd = nondir_preds(above, left, n) if max(chans) >= 57 else None
    dirs = (predict_dirs(above, left, n).reshape(B, 56, n, n)
            if any(0 < c < 57 and c not in (4, 11) for c in chans) else None)
    out = []
    for c in chans:
        if c == 0:
            out.append(dc_predict(above, left, n, ha, hl, bd))
        elif c < 57 and dirs is not None:
            out.append(dirs[:, c - 1])
        elif c == 4:  # V at delta 0 repeats the above edge
            out.append(above[:, None, 1 : 1 + n].expand(B, n, n))
        elif c == 11:  # H at delta 0 the left one
            out.append(left[:, 1 : 1 + n, None].expand(B, n, n))
        else:
            out.append(nd[:, c - 57])
    return torch.stack(out, 1).to(torch.int32)


_DEV_TABLES: dict = {}


def _dev_tables(device):
    t = _DEV_TABLES.get(str(device))
    if t is None:
        t = (torch.as_tensor(np.asarray(ip._DR, np.int32), device=device),
             {n: torch.as_tensor(np.asarray(ip.sm_weights(n), np.int32),
                                 device=device) for n in (4, 8, 16, 32, 64)})
        _DEV_TABLES[str(device)] = t
    return t


# a K1 launch's pointer and integer arguments, read by the C entry before
# it returns: one buffer of each serves a thread's launches
_K1_ARGS = threading.local()
_CHECKED: set = set()  # the channel lists checked once


def _flag(v: torch.Tensor) -> torch.Tensor:
    """A per-lane flag as K1 reads it: bool (one byte), any stride."""
    return v if v.dtype in (torch.bool, torch.uint8) else v != 0


def _edges(v: torch.Tensor, B: int, n: int) -> torch.Tensor:
    if v.dtype != torch.int32 or not v.is_contiguous():
        v = v.to(torch.int32).contiguous()
    if v.shape != (B, 2 * n + 1):
        raise ValueError(f"intra_pred: edges {tuple(v.shape)}, expected "
                         f"({B}, {2 * n + 1})")
    return v


def intra_pred(above, left, ha: torch.Tensor, hl: torch.Tensor, n: int,
               full: bool = True, bd: int = 8, channels=None, src=None,
               allow_z1=None):
    """Intra predictions of B lanes of n x n blocks (K1).

    above/left: (B, 2n+1) int32 edges (index 0 = top-left, as
    build_edges_batch makes them), or a tuple of two such (U and V: one
    call predicts both planes); ha/hl: (B,) bool availability.  List mode
    (src None): the channels `channels` (indices into FULL; by default
    FULL or NONDIR by `full`), (B, nch, n, n) int32, or (B, 2, nch, n, n)
    for two planes.  Race mode (src: the lanes' (B, n, n) int32 source
    blocks, any strides with unit columns; allow_z1: (B,) bool): returns
    (stack (B, 13, n, n): DC, each base direction at its picked delta,
    SMOOTH, SMOOTH_V, SMOOTH_H, PAETH; di8 (B, 8) int32, the picked delta
    indices), the fine-direction pick of rav1e_tpu/models/wavefront.py
    :614-631.  On the card: one launch, an allocation an output, the
    flags and the source read in place."""
    planes = isinstance(above, (tuple, list))
    first = above[0] if planes else above
    if first.device.type == "cpu":
        return intra_pred_plain(above, left, ha, hl, n, full, bd, channels,
                                src, allow_z1)
    B = first.shape[0]
    ab = list(above) if planes else [above]
    lf = list(left) if planes else [left]
    if n not in (4, 8, 16, 32, 64) or len(ab) not in (1, 2) or \
            len(lf) != len(ab):
        raise ValueError("intra_pred: n in 4..64 and one or two planes")
    ab = [_edges(v, B, n) for v in ab]
    lf = [_edges(v, B, n) for v in lf]
    ha, hl = _flag(ha), _flag(hl)
    dev = first.device
    dr, smw = _dev_tables(dev)
    s_ptr = az_ptr = di8 = None
    src_st = (0, 0)
    az_st = 0
    if src is not None:
        if planes or n > 32:
            raise ValueError("intra_pred: the race takes one plane, n <= 32")
        if src.dtype != torch.int32 or src.shape != (B, n, n) or \
                src.stride(2) != 1:
            src = src.to(torch.int32).contiguous()
        allow_z1 = _flag(allow_z1)
        out = torch.empty((B, 13, n, n), dtype=torch.int32, device=dev)
        di8 = torch.empty((B, 8), dtype=torch.int32, device=dev)
        s_ptr, az_ptr = src.data_ptr(), allow_z1.data_ptr()
        src_st, az_st = (src.stride(0), src.stride(1)), allow_z1.stride(0)
        chans = ()
    else:
        chans = _channels(full, channels)
        if chans not in _CHECKED:
            if not 0 < len(chans) <= 64 or min(chans) < 0 or \
                    max(chans) >= N_FULL:
                raise ValueError("intra_pred: 1 to 64 channels of FULL's 61")
            _CHECKED.add(chans)
        shape = (B, len(ab), len(chans), n, n) if planes else \
            (B, len(chans), n, n)
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    bufs = getattr(_K1_ARGS, "bufs", None)
    if bufs is None:
        bufs = _K1_ARGS.bufs = ((ctypes.c_void_p * 12)(),
                                (ctypes.c_int * 74)())
    edges = [ab[0], lf[0]] + ([ab[1], lf[1]] if len(ab) == 2 else [None] * 2)
    bufs[0][:] = [kernels.ptr(v) for v in edges] + [
        ha.data_ptr(), hl.data_ptr(), az_ptr, dr.data_ptr(),
        smw[n].data_ptr(), s_ptr, out.data_ptr(),
        None if di8 is None else di8.data_ptr()]
    head = (len(ab), B, n, bd, ha.stride(0), hl.stride(0), az_st) + \
        src_st + (len(chans),)
    bufs[1][: 10 + len(chans)] = head + chans
    kernels.launch("intra_pred", first, *bufs)
    return out if src is None else (out, di8)


# -- K11 cfl ----------------------------------------------------------------------

def cfl_plain(luma: torch.Tensor, dc: torch.Tensor, src: torch.Tensor,
              bd: int = 8):
    """Plain version of K11's fit.  luma: (B, n, n) reconstructed luma
    blocks; dc, src: (B, 2, n/2, n/2) the DC predictions and sources of U
    and V.  Returns (alpha (B, 2), pred (B, 2, n/2, n/2), resid = src -
    pred), all int32: the AC values of the 2x2 luma sums
    (cfl_ac_420_batch), each plane's alpha fitted to src - dc (exact int64
    sums, each rounded to float32 once, the quotient rounded half to even,
    clipped to +-16, 0 for flat luma) and the CFL prediction
    (cfl_predict_batch)."""
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


def cfl_decide_plain(rc, ic, lc, ratec, alpha, pc, pred_dc, lv_dc, inv_dc,
                     dd_dc, rate_dc, lam, mode, tabs):
    """Plain version of K11's decision: CFL against DC for both planes
    (wavefront.py:726-762 of the JAX package).  The CFL side: the
    residual rc, its inverse ic and levels lc (B, 2, n2, n2) after K2 and
    K3, their coefficient rates ratec (B, 2), the alphas and the CFL
    prediction pc; the DC side: pred_dc, lv_dc, inv_dc (B, 2, n2, n2),
    the pixel SSE dd_dc and the coefficient rates rate_dc (B, 2).  lam,
    mode (B,); tabs: the pass's (bits_uv14, bits_sign, bits_alpha).
    Each plane's CFL SSE is an exact integer sum rounded to float32 once;
    a plane whose alpha is 0 costs its DC cost.  Returns the chosen
    (pred, levels, inverse) per plane, the rates (B, 2), the alphas kept
    (0 where DC stays) and the uv mode (13 where CFL won, else 0)."""
    bits_uv14, bits_sign, bits_alpha = tabs[:3]
    lam2 = lam[:, None]
    cost_dc = dd_dc + lam2 * rate_dc  # (B, 2)
    sse = ((rc.to(torch.int64) - ic.to(torch.int64)) ** 2).sum(
        (-1, -2)).to(torch.float32)
    cost_cfl = torch.where(alpha == 0, cost_dc, sse + lam2 * ratec)
    a_u, a_v = alpha[:, 0].long(), alpha[:, 1].long()
    # sign codes: 0 zero, 1 negative, 2 positive
    su = torch.where(a_u == 0, 0, torch.where(a_u < 0, 1, 2))
    sv = torch.where(a_v == 0, 0, torch.where(a_v < 0, 1, 2))
    rate_dc_uv = bits_uv14[mode, 0]
    rate_cfl = bits_uv14[mode, 13] + bits_sign[
        torch.clamp(su * 3 + sv - 1, min=0)]
    rate_cfl = rate_cfl + torch.where(
        su > 0, bits_alpha[torch.where(su == 2, 3, 0) + sv,
                           torch.clamp(a_u.abs() - 1, min=0)], 0.0)
    rate_cfl = rate_cfl + torch.where(
        sv > 0, bits_alpha[torch.where(sv == 2, 3, 0) + su,
                           torch.clamp(a_v.abs() - 1, min=0)], 0.0)
    use_cfl = ((a_u != 0) | (a_v != 0)) & (
        cost_cfl[:, 0] + cost_cfl[:, 1] + lam * rate_cfl
        < cost_dc[:, 0] + cost_dc[:, 1] + lam * rate_dc_uv)
    take = use_cfl[:, None] & (alpha != 0)  # (B, 2)
    t4 = take[:, :, None, None]
    return (torch.where(t4, pc, pred_dc), torch.where(t4, lc, lv_dc),
            torch.where(t4, ic, inv_dc), torch.where(take, ratec, rate_dc),
            torch.where(take, alpha, 0),
            torch.where(use_cfl, 13, torch.zeros_like(mode)))


def _rows(t: torch.Tensor, dtype) -> torch.Tensor:
    """t as K11 reads it in place: dtype, unit column stride (else a
    copy)."""
    if t.dtype != dtype or t.stride(-1) != 1:
        t = t.to(dtype).contiguous()
    return t


def cfl(luma: torch.Tensor, dc: torch.Tensor, src: torch.Tensor,
        bd: int = 8):
    """CFL fit and prediction of B blocks of n x n luma (n in 8, 16, 32)
    and their U and V (K11's fit mode, one launch); see cfl_plain.  The
    inputs are read in place through their strides (the DC prediction as
    a view of K1's candidate stack) where their columns are contiguous
    int32."""
    if luma.device.type == "cpu":
        return cfl_plain(luma, dc, src, bd)
    B, n, _ = luma.shape
    n2 = n >> 1
    if n not in (8, 16, 32) or luma.shape != (B, n, n) or \
            dc.shape != (B, 2, n2, n2) or src.shape != dc.shape:
        raise ValueError("cfl: luma (B, n, n) with n in 8, 16, 32 and dc, "
                         "src (B, 2, n/2, n/2)")
    y, d, s = (_rows(t, torch.int32) for t in (luma, dc, src))
    alpha = torch.empty((B, 2), dtype=torch.int32, device=y.device)
    out = torch.empty((2, B, 2, n2, n2), dtype=torch.int32, device=y.device)
    kernels.launch("cfl", y, y.data_ptr(), d.data_ptr(), s.data_ptr(),
                   alpha.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                   B, n2, bd, *y.stride()[:2], *d.stride()[:3],
                   *s.stride()[:3])
    return alpha, out[0], out[1]


def cfl_decide(rc, ic, lc, ratec, alpha, pc, pred_dc, lv_dc, inv_dc, dd_dc,
               rate_dc, lam, mode, tabs):
    """K11's decide mode, one launch: CFL against DC for both planes; see
    cfl_decide_plain.  The DC side, lam and mode are read in place through
    their strides."""
    if rc.device.type == "cpu":
        return cfl_decide_plain(rc, ic, lc, ratec, alpha, pc, pred_dc,
                                lv_dc, inv_dc, dd_dc, rate_dc, lam, mode,
                                tabs)
    B, _, n2, _ = rc.shape
    shp = (B, 2, n2, n2)
    if n2 not in (4, 8, 16) or mode.dtype != torch.int64 or any(
            t.shape != shp for t in (rc, ic, lc, pc, pred_dc, lv_dc, inv_dc)) \
            or any(t.shape != (B, 2) for t in (ratec, alpha, dd_dc, rate_dc)):
        raise ValueError("cfl_decide: blocks (B, 2, n2, n2) with n2 in 4, 8, "
                         "16, per-plane (B, 2) rates, costs and alphas, "
                         "int64 modes")
    i32, f32 = torch.int32, torch.float32
    rc, ic, lc, pc, alpha, ratec = (
        t if t.dtype == dt and t.is_contiguous() else t.to(dt).contiguous()
        for t, dt in ((rc, i32), (ic, i32), (lc, i32), (pc, i32),
                      (alpha, i32), (ratec, f32)))
    p_dc, l_dc, i_dc = (_rows(t, i32) for t in (pred_dc, lv_dc, inv_dc))
    dd, rd = (t if t.dtype == f32 else t.to(f32) for t in (dd_dc, rate_dc))
    lam = lam if lam.dtype == f32 else lam.to(f32)
    tab = [t if t.dtype == f32 and t.is_contiguous() else
           t.to(f32).contiguous() for t in tabs[:3]]
    dev = rc.device
    out = torch.empty((3,) + shp, dtype=i32, device=dev)
    o_a = torch.empty((B, 2), dtype=i32, device=dev)
    o_r = torch.empty((B, 2), dtype=f32, device=dev)
    o_uv = torch.empty((B,), dtype=torch.int64, device=dev)
    kernels.launch("cfl_decide", rc, *(t.data_ptr() for t in (
        rc, ic, lc, pc, alpha, ratec, p_dc, l_dc, i_dc, dd, rd, lam, mode,
        *tab, out[0], out[1], out[2], o_a, o_r, o_uv)), B, n2,
        *p_dc.stride()[:3], *l_dc.stride()[:3], *i_dc.stride()[:3],
        *dd.stride(), *rd.stride(), *lam.stride(), *mode.stride())
    return out[0], out[1], out[2], o_r, o_a, o_uv


# -- K13 dr_predict, predict_stack --------------------------------------------------

def dr_predict_plain(above, left, p_angle, w: int, h: int):
    """Plain version of K13: intra_jax.dr_predict_batch in torch, all
    three zones computed and selected by each lane's angle.  The JAX
    function clamps derivative indices into a zero-padded 274-entry
    table; the zone an angle selects indexes below 90 for every angle,
    so clamping into dr_intra_derivative's 90 entries gives the same
    predictions."""
    B = above.shape[0]
    dev = above.device
    dr = _dev_tables(dev)[0]
    rr = torch.arange(h, device=dev)[None, :, None]
    cc = torch.arange(w, device=dev)[None, None, :]
    n_edge = w + h
    pa = p_angle.to(torch.int64)[:, None, None]
    above = above.to(torch.int32)
    left = left.to(torch.int32)

    def gat(edge, idx):
        idx = torch.clamp(idx, 0, n_edge).reshape(B, h * w)
        return torch.gather(edge, 1, idx).reshape(B, h, w)

    d = lambda i: dr[torch.clamp(i, 0, len(ip._DR) - 1)]
    mx = w + h - 1
    xpos1 = (rr + 1) * d(pa)
    bx1 = (xpos1 >> 6) + cc
    sh1 = (xpos1 >> 1) & 0x1F
    v1 = (gat(above, 1 + bx1) * (32 - sh1) + gat(above, 2 + bx1) * sh1
          + 16) >> 5
    z1 = torch.where(bx1 >= mx, above[:, 1 + mx][:, None, None], v1)
    xpos2 = (cc << 6) - (rr + 1) * d(180 - pa)
    bx2 = xpos2 >> 6
    shx = (xpos2 >> 1) & 0x1F
    av2 = (gat(above, 1 + bx2) * (32 - shx) + gat(above, 2 + bx2) * shx
           + 16) >> 5
    ypos2 = (rr << 6) - (cc + 1) * d(pa - 90)
    by2 = ypos2 >> 6
    shy = (ypos2 >> 1) & 0x1F
    lv2 = (gat(left, 1 + by2) * (32 - shy) + gat(left, 2 + by2) * shy
           + 16) >> 5
    z2 = torch.where(bx2 >= -1, av2, lv2)
    ypos3 = (cc + 1) * d(270 - pa)
    by3 = (ypos3 >> 6) + rr
    sh3 = (ypos3 >> 1) & 0x1F
    v3 = (gat(left, 1 + by3) * (32 - sh3) + gat(left, 2 + by3) * sh3
          + 16) >> 5
    z3 = torch.where(by3 >= mx, left[:, 1 + mx][:, None, None], v3)
    vert = above[:, None, 1 : 1 + w].expand(B, h, w)
    horz = left[:, 1 : 1 + h, None].expand(B, h, w)
    out = torch.where(pa < 90, z1, torch.where(
        pa == 90, vert, torch.where(pa < 180, z2, torch.where(
            pa == 180, horz, z3))))
    return out.to(torch.int32)


def dr_predict_batch(above: torch.Tensor, left: torch.Tensor,
                     p_angle: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """Directional prediction of B lanes of w x h blocks, each at its own
    angle (intra_jax.py:144, K13).  above/left: (B, 1 + w + h) int32 edges
    (index 0 = top-left, as build_edges_batch makes them); p_angle: (B,)
    int32, multiples of 3 in [36, 212].  Returns (B, h, w) int32."""
    if above.device.type == "cpu":
        return dr_predict_plain(above, left, p_angle, w, h)
    B = above.shape[0]
    if w not in (4, 8, 16, 32, 64) or h not in (4, 8, 16, 32, 64) or \
            above.shape != (B, 1 + w + h) or left.shape != above.shape or \
            p_angle.shape != (B,):
        raise ValueError("dr_predict_batch: w, h in 4..64, edges (B, 1 + w "
                         "+ h) and angles (B,)")
    a = above.to(torch.int32).contiguous()
    lf = left.to(torch.int32).contiguous()
    ang = p_angle.to(torch.int32).contiguous()
    dr = _dev_tables(a.device)[0]
    out = torch.empty((B, h, w), dtype=torch.int32, device=a.device)
    kernels.launch("dr_predict", a, a.data_ptr(), lf.data_ptr(),
                   ang.data_ptr(), B, w, h, dr.data_ptr(), out.data_ptr())
    return out


# the six modes predict_stack takes from K13, at their base angles
STACK_DIRS = (D45, D135, D113, D157, D203, D67)


def predict_stack(above, left, w: int, h: int, ha, hl,
                  bd: int = 8) -> torch.Tensor:
    """All 13 intra modes at angle delta 0 (intra_jax.py:100): (B, 13, h,
    w) int32 in mode order.  DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H and
    PAETH come from K1's non-directional set, the six directional modes
    from one K13 launch over B x 6 lanes at their base angles.  Square
    blocks only, as the JAX function's dc_predict asserts."""
    if w != h:
        raise ValueError("predict_stack: square blocks only")
    B = above.shape[0]
    nd = intra_pred(above, left, ha, hl, w, False, bd)  # (B, 7, n, n)
    ang = torch.as_tensor([ip.MODE_ANGLE[m] for m in STACK_DIRS],
                          dtype=torch.int32, device=above.device)
    dirs = dr_predict_batch(above.repeat_interleave(6, 0),
                            left.repeat_interleave(6, 0), ang.repeat(B),
                            w, h).reshape(B, 6, h, w)
    out = torch.empty((B, 13, h, w), dtype=torch.int32, device=above.device)
    for ch, m in enumerate((DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH)):
        out[:, m] = nd[:, ch]
    for k, m in enumerate(STACK_DIRS):
        out[:, m] = dirs[:, k]
    return out


# -- K14 build_edges ----------------------------------------------------------------


def build_edges_plain(rec, y, x, w: int, h: int, ha, hl, n_tr, n_bl,
                      max_x: int, max_y: int, bd: int = 8):
    """Plain version of K14: intra_jax.build_edges_batch in torch, with
    every plane index clamped into the plane as JAX's gathers clamp."""
    base = 1 << (bd - 1)
    n = w + h
    dev = rec.device
    Hh, Ww = rec.shape
    rec = rec.to(torch.int32)
    y, x = y.to(torch.int64), x.to(torch.int64)
    ha, hl = ha.to(torch.bool), hl.to(torch.bool)
    i = torch.arange(n, device=dev)[None, :]
    at = lambda r, c: rec[torch.clamp(r, 0, Hh - 1), torch.clamp(c, 0, Ww - 1)]
    avail_a = w + torch.clamp(n_tr.to(torch.int64), max=h)
    col = torch.clamp(x[:, None] + torch.minimum(i, avail_a[:, None] - 1),
                      max=max_x)
    row_above = torch.clamp(y - 1, min=0)
    col_left = torch.clamp(x - 1, min=0)
    left_top = at(y, col_left)
    top_row = at(row_above, x)
    fill = lambda v: torch.full_like(left_top, v)
    above_v = torch.where(ha[:, None], at(row_above[:, None], col),
                          torch.where(hl, left_top, fill(base - 1))[:, None])
    avail_l = h + torch.clamp(n_bl.to(torch.int64), max=w)
    rr = torch.clamp(y[:, None] + torch.minimum(i, avail_l[:, None] - 1),
                     max=max_y)
    left_v = torch.where(hl[:, None], at(rr, col_left[:, None]),
                         torch.where(ha, top_row, fill(base + 1))[:, None])
    tl = torch.where(ha & hl, at(row_above, col_left),
                     torch.where(ha, top_row,
                                 torch.where(hl, left_top, fill(base))))
    return (torch.cat([tl[:, None], above_v], 1),
            torch.cat([tl[:, None], left_v], 1))


def build_edges_batch(rec: torch.Tensor, y, x, w: int, h: int, ha, hl,
                      n_tr, n_bl, max_x: int, max_y: int, bd: int = 8):
    """The spec 7.11.2 edges of B blocks (intra_jax.py:44, K14).  rec:
    (H, W) int32 plane; y/x: (B,) block origins; ha/hl: (B,) bool
    availability; n_tr/n_bl: (B,) int32 valid samples past the block's
    edge.  Returns (above, left), each (B, 1 + w + h) int32 with index 0
    the top-left corner."""
    if rec.device.type == "cpu":
        return build_edges_plain(rec, y, x, w, h, ha, hl, n_tr, n_bl, max_x,
                                 max_y, bd)
    r = rec.to(torch.int32)
    r = r if r.stride(1) == 1 else r.contiguous()
    lanes = [torch.as_tensor(v, device=r.device).to(torch.int32).contiguous()
             for v in (y, x, ha, hl, n_tr, n_bl)]
    B = lanes[0].shape[0]
    above = torch.empty((B, 1 + w + h), dtype=torch.int32, device=r.device)
    left = torch.empty_like(above)
    kernels.launch("build_edges", r, r.data_ptr(), r.shape[0], r.shape[1],
                   r.stride(0), *(v.data_ptr() for v in lanes), B, w, h,
                   max_x, max_y, bd, above.data_ptr(), left.data_ptr())
    return above, left
