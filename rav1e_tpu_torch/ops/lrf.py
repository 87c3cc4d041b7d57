"""Wiener loop restoration on the GPU (K7 wiener_solve, K8 wiener_lr).

Counterpart of the fused LR stage of rav1e_tpu/ops/filter_chain_jax.py
(:230-291): _wiener_solve_dev (K7) fits one symmetric 7-tap Wiener filter
per plane and direction to the CDEF output; lrf_jax.py:77 _wiener_body
with the per-unit SSE, the none-vs-Wiener choice and the composition
(K8) restores each plane.  NORMATIVE (spec 7.17): the decoder restores the
chosen units with these taps, so K8 is bit-exact with
lrf_np.wiener_filter_frame.

K7's normal equations are exact int64 sums and its 3x3 solve is float64
with every operation rounded on its own, so the kernel and the plain
version below give the same taps.  The JAX version sums and solves in
f32: a tap may round the other way where coef * 128 lies near a .5 tie.

K8 also has a frame mode (wiener_filter_frame): the whole restored plane
with given taps, no unit choice, at 8, 10 or 12 bits.
wiener_filter_frame_device runs it for the host LR search (lrf_jax.py:254)
of speed <= 5 and of the host-coded frames, whose tap solve stays on the
host.  The unit-choice mode runs in the chain only, after an 8-bit
wavefront pass.

On a CUDA tensor the wrappers launch the kernels in csrc/; on a CPU
tensor they run the plain versions below.
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.ops import lrf_np as lr

# per-unit header rate (bits) charged against the restored SSE (the JAX
# package's lrf_jax.LR_RATE_Y/C, its host path's constants)
LR_RATE_Y = 12.0
LR_RATE_C = 9.0
BAND = 64  # rows per stage-1 partial sum of K7


def taps7(t3: torch.Tensor) -> torch.Tensor:
    """wiener_7tap: [c0, c1, c2, 128 - 2*(c0+c1+c2), c2, c1, c0]."""
    mid = 128 - 2 * (t3[0] + t3[1] + t3[2])
    return torch.stack([t3[0], t3[1], t3[2], mid, t3[2], t3[1], t3[0]])


# -- K7 wiener_solve ------------------------------------------------------------

def _normal_sums(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(2, 9) int64: per direction (vertical, horizontal) the 6 distinct
    entries of M = F^T F (00, 01, 02, 11, 12, 22) and r = F^T b, with
    f_k = d[-k] + d[+k] - 2 d (edge-replicated, k = 3, 2, 1), b = s - d."""
    h, w = d.shape
    dev = d.device
    d64 = d.to(torch.int64)
    b = s.to(torch.int64) - d64
    out = []
    for axis in (0, 1):
        n = h if axis == 0 else w
        ar = torch.arange(n, device=dev)
        f = []
        for k in (3, 2, 1):
            lo = torch.clamp(ar - k, min=0)
            hi = torch.clamp(ar + k, max=n - 1)
            pair = (d64[lo] + d64[hi]) if axis == 0 else \
                (d64[:, lo] + d64[:, hi])
            f.append(pair - 2 * d64)
        out.append(torch.stack([
            (f[0] * f[0]).sum(), (f[0] * f[1]).sum(), (f[0] * f[2]).sum(),
            (f[1] * f[1]).sum(), (f[1] * f[2]).sum(), (f[2] * f[2]).sum(),
            (f[0] * b).sum(), (f[1] * b).sum(), (f[2] * b).sum()]))
    return torch.stack(out)


def solve_taps(sums: torch.Tensor) -> torch.Tensor:
    """The 3x3 solves of K7's stage 2 for (6, 9) int64 sums (vY, hY, vU,
    hU, vV, hV): ridge, Gaussian elimination with partial pivoting in
    float64 (the same operations in the same order as the kernel), then
    round(coef * 128) half to even and clip.  Returns (6, 3) int32."""
    dev = sums.device
    n = sums.shape[0]
    m = sums.to(torch.float64)
    A = torch.stack([
        torch.stack([m[:, 0], m[:, 1], m[:, 2], m[:, 6]], 1),
        torch.stack([m[:, 1], m[:, 3], m[:, 4], m[:, 7]], 1),
        torch.stack([m[:, 2], m[:, 4], m[:, 5], m[:, 8]], 1)], 1)
    trace = (m[:, 0] + m[:, 3]) + m[:, 5]
    ridge = 1e-6 * trace + 1e-3
    for i in range(3):
        A[:, i, i] = A[:, i, i] + ridge
    rows = torch.arange(n, device=dev)
    for c in range(3):
        piv = c + A[:, c:, c].abs().argmax(1)
        perm = torch.arange(3, device=dev).repeat(n, 1)
        perm[rows, c] = piv
        perm[rows, piv] = c
        A = A.gather(1, perm[:, :, None].expand(n, 3, 4))
        for r in range(c + 1, 3):
            f = A[:, r, c] / A[:, c, c]
            A[:, r, c:] = A[:, r, c:] - f[:, None] * A[:, c, c:]
    x2 = A[:, 2, 3] / A[:, 2, 2]
    x1 = (A[:, 1, 3] - A[:, 1, 2] * x2) / A[:, 1, 1]
    x0 = ((A[:, 0, 3] - A[:, 0, 1] * x1) - A[:, 0, 2] * x2) / A[:, 0, 0]
    t = torch.round(torch.stack([x0, x1, x2], 1) * 128.0)
    lo = torch.as_tensor(lr.WIENER_TAPS_MIN, dtype=torch.float64, device=dev)
    hi = torch.as_tensor(lr.WIENER_TAPS_MAX, dtype=torch.float64, device=dev)
    return torch.minimum(torch.maximum(t, lo), hi).to(torch.int32)


def wiener_solve_plain(ds, ss):
    """Plain version of K7.  ds/ss: the three (post-CDEF, source) planes
    (Y, U, V), each (h, w) at the restored size.  Returns (taps (6, 3)
    int32: vY, hY, vU, hU, vV, hV with chroma's outer tap 0; en (3,) int32:
    the plane has a nonzero tap)."""
    sums = torch.cat([_normal_sums(d, s) for d, s in zip(ds, ss)])
    taps = solve_taps(sums)
    taps[2:, 0] = 0  # chroma outer tap is 0 (spec)
    en = (taps.reshape(3, 6) != 0).any(1).to(torch.int32)
    return taps, en


def _rows(t):
    t = t.to(torch.int32)
    return t if t.stride(-1) == 1 else t.contiguous()


def wiener_solve(ds, ss):
    """The frame-level Wiener taps of the three planes (K7); see
    wiener_solve_plain.  The taps stay on the planes' device."""
    if ds[0].device.type == "cpu":
        return wiener_solve_plain(ds, ss)
    if len(ds) != 3 or any(d.shape != s.shape for d, s in zip(ds, ss)):
        raise ValueError("wiener_solve: three (degraded, source) pairs of "
                         "equal shapes")
    ds = [_rows(d) for d in ds]
    ss = [_rows(s) for s in ss]
    dev = ds[0].device
    nbands = -(-max(d.shape[0] for d in ds) // BAND)
    part = torch.empty(3 * 2 * nbands * 9, dtype=torch.int64, device=dev)
    taps = torch.empty((6, 3), dtype=torch.int32, device=dev)
    en = torch.empty(3, dtype=torch.int32, device=dev)
    args = []
    for d, s in zip(ds, ss):
        args += [d.data_ptr(), s.data_ptr(), d.stride(0), s.stride(0),
                 d.shape[0], d.shape[1]]
    kernels.launch("wiener_solve", ds[0], *args, nbands, part.data_ptr(),
                   taps.data_ptr(), en.data_ptr())
    return taps, en


# -- K8 wiener_lr -----------------------------------------------------------------

_GATHER: dict = {}


def stripe_table(h: int, stripe: int):
    """(ridx (h, 7) int64, use_db (h, 7) bool) numpy: the source row of
    tap row y + t of every output row y under the stripe rule
    (lrf_np._stripe_source), and whether it comes from the deblocked
    plane."""
    t = _GATHER.get((h, stripe))
    if t is None:
        ridx = np.zeros((h, 7), np.int64)
        use_db = np.zeros((h, 7), np.bool_)
        for tap in range(-3, 4):
            for y in range(h):
                ridx[y, tap + 3], use_db[y, tap + 3] = lr._stripe_source(
                    None, None, y, tap, stripe, h)
        t = _GATHER[(h, stripe)] = (ridx, use_db)
    return t


def unit_index(unit: int, size: int, shifted: bool) -> np.ndarray:
    """(size,) int64: the restoration unit of each row or column."""
    idx = np.zeros(size, np.int64)
    for i, (s0, e0) in enumerate(lr.unit_ranges(unit, size, shifted=shifted)):
        idx[s0:e0] = i
    return idx


def wiener_filter_plain(cd, db, vt, ht, stripe: int, hh: int, ww: int,
                        bd: int = 8):
    """The Wiener-restored (hh, ww) int32 plane (lrf_np.wiener_filter_frame)
    from the CDEF output cd and the deblocked db (>= hh x ww each, bd-bit
    samples) with 3-tap sets vt/ht (int32 tensors)."""
    dev = cd.device
    vf, hf = taps7(vt.to(torch.int32)), taps7(ht.to(torch.int32))
    ridx, use_db = (torch.as_tensor(a, device=dev)
                    for a in stripe_table(hh, stripe))
    xs = torch.clamp(torch.arange(-3, ww + 3, device=dev), 0, ww - 1)
    cdx = cd[:hh].to(torch.int32)[:, xs]
    dbx = db[:hh].to(torch.int32)[:, xs]
    rows = torch.where(use_db[:, :, None], dbx[ridx], cdx[ridx])
    hor = torch.zeros((hh, 7, ww), dtype=torch.int32, device=dev)
    for t in range(7):
        hor = hor + hf[t] * rows[:, :, t : t + ww]
    round0, round1 = (3, 11) if bd < 12 else (5, 9)
    hor = torch.clamp((hor + ((1 << (bd + 6)) + (1 << (round0 - 1))))
                      >> round0, 0, (1 << (bd + 1 + 7 - round0)) - 1)
    s = (vf[None, :, None] * hor).sum(1, dtype=torch.int32) \
        - (1 << (bd + round1 - 1))
    return torch.clamp((s + (1 << (round1 - 1))) >> round1, 0, (1 << bd) - 1)


def wiener_lr_plain(cd, db, src, taps, en, lam: float, rate: float,
                    unit: int, hh: int, ww: int):
    """Plain version of K8 for one plane: restore (stripe = unit), sum the
    exact int32 SSE of each unit for the CDEF output (s0) and the restored
    plane (s1), take s1 + lam * rate < s0 in float32 where en, and compose.
    taps: (2, 3) int32 (vertical, horizontal); en: (1,) int32.  Returns
    (composed (hh, ww) int32, choice (nr, nc) bool)."""
    dev = cd.device
    rest = wiener_filter_plain(cd, db, taps[0], taps[1], unit, hh, ww)
    base = cd[:hh, :ww].to(torch.int32)
    sv = src[:hh, :ww].to(torch.int32)
    ru = torch.as_tensor(unit_index(unit, hh, True), device=dev)
    cu = torch.as_tensor(unit_index(unit, ww, False), device=dev)
    nr, nc = lr.count_units(unit, hh), lr.count_units(unit, ww)

    def unit_sse(d):
        a = torch.zeros((nr, ww), dtype=torch.int32, device=dev)
        a.index_add_(0, ru, d)
        out = torch.zeros((nr, nc), dtype=torch.int32, device=dev)
        return out.index_add_(1, cu, a)

    s0 = unit_sse((base - sv) ** 2)
    s1 = unit_sse((rest - sv) ** 2)
    lr_cost = torch.tensor(np.float32(lam), device=dev) * np.float32(rate)
    take = (s1.to(torch.float32) + lr_cost < s0.to(torch.float32)) & \
        (en.reshape(()) != 0)
    comp = torch.where(take[ru][:, cu], rest, base)
    return comp, take


def wiener_lr(cd, db, src, taps, en, lam: float, rate: float, unit: int,
              hh: int, ww: int):
    """One plane's Wiener restoration, unit choice and composition (K8);
    see wiener_lr_plain."""
    if cd.device.type == "cpu":
        return wiener_lr_plain(cd, db, src, taps, en, lam, rate, unit, hh,
                               ww)
    # the kernel's shared tile holds one stripe (<= 64 rows) of a unit
    # (<= 96 columns)
    if unit not in (32, 64) or taps.shape != (2, 3) or any(
            t.shape[0] < hh or t.shape[1] < ww for t in (cd, db, src)):
        raise ValueError("wiener_lr: unit 32 or 64, taps (2, 3), planes "
                         "of at least hh x ww")
    cd, db, src = _rows(cd), _rows(db), _rows(src)
    taps = taps.to(torch.int32).contiguous()
    en = en.to(torch.int32).contiguous()
    nr, nc = lr.count_units(unit, hh), lr.count_units(unit, ww)
    out = torch.empty((hh, ww), dtype=torch.int32, device=cd.device)
    choice = torch.empty((nr, nc), dtype=torch.int32, device=cd.device)
    kernels.launch("wiener_lr", cd, cd.data_ptr(), cd.stride(0),
                   db.data_ptr(), db.stride(0), src.data_ptr(), src.stride(0),
                   hh, ww, unit, 8, taps.data_ptr(), en.data_ptr(),
                   float(np.float32(lam)), float(np.float32(rate)),
                   out.data_ptr(), choice.data_ptr())
    return out, choice.to(torch.bool)


def wiener_filter_frame(cd, db, taps, stripe: int, hh: int, ww: int,
                        bd: int = 8):
    """The whole Wiener-restored (hh, ww) int32 plane of bd-bit samples
    with taps (2, 3) int32 (vertical, horizontal) and the given stripe
    size: K8 in frame mode, no unit sums or choice (plain version:
    wiener_filter_plain)."""
    if cd.device.type == "cpu":
        return wiener_filter_plain(cd, db, taps[0], taps[1], stripe, hh, ww,
                                   bd)
    if stripe not in (32, 64) or taps.shape != (2, 3) or bd not in (
            8, 10, 12) or any(t.shape[0] < hh or t.shape[1] < ww
                              for t in (cd, db)):
        raise ValueError("wiener_filter_frame: stripe 32 or 64, taps "
                         "(2, 3), bit depth 8, 10 or 12, planes of at "
                         "least hh x ww")
    cd, db = _rows(cd), _rows(db)
    taps = taps.to(torch.int32).contiguous()
    out = torch.empty((hh, ww), dtype=torch.int32, device=cd.device)
    kernels.launch("wiener_lr", cd, cd.data_ptr(), cd.stride(0),
                   db.data_ptr(), db.stride(0), None, 0, hh, ww, stripe, bd,
                   taps.data_ptr(), None, 0.0, 0.0, out.data_ptr(), None,
                   count="wiener_lr_frame")
    return out


def wiener_filter_frame_device(cdef_p, deblock_p, vtaps3, htaps3,
                               stripe_size: int, bd: int, frame_w: int,
                               frame_h: int, dev_cdef=None, dev_db=None,
                               device="cuda") -> np.ndarray:
    """lrf_np.wiener_filter_frame on the device (lrf_jax.py:254): the
    (frame_h, frame_w) int64 restored plane of bd-bit samples.
    dev_cdef/dev_db: planes already on the device (the CDEF pass's luma),
    used instead of uploading cdef_p/deblock_p."""
    up = lambda a: torch.as_tensor(
        np.ascontiguousarray(a[:frame_h, :frame_w], np.int32), device=device)
    cd = dev_cdef if dev_cdef is not None else up(cdef_p)
    db = dev_db if dev_db is not None else up(deblock_p)
    taps = torch.as_tensor(np.asarray([vtaps3, htaps3], np.int32),
                           device=cd.device)
    out = wiener_filter_frame(cd, db, taps, stripe_size, frame_h, frame_w,
                              bd)
    return out.cpu().numpy().astype(np.int64)
