"""AV1 deblocking in PyTorch (K4), bit-exact with ops/deblock_np.py.

Counterpart of rav1e_tpu/ops/deblock_jax.py (_filter_taps, _pass_dir).
NORMATIVE (spec 7.14).  Every edge of one direction filters in one dense
pass: the spec's filter-size rule keeps the samples an edge reads and uses
apart from the samples any other edge writes, so a pass that reads the
unmodified plane and writes each edge's taps equals the serial walk.

`deblock_pass` filters the vertical edges of a (h, w) plane view; the
horizontal edges are the same pass over the transposed view.  On a CUDA
tensor it launches csrc/deblock.cu; on a CPU tensor it runs the plain
version below.  Its slab window (x0, width) lets it run over a column slab
of a wider plane with its neighbours' halo columns (parallel/tiles.py
deblock_sharded): only the edges of the plane itself filter.
`deblock_plane` is both directions over one plane (the counterpart of
deblock_jax.py:203 deblock_plane_jnp).
"""

from __future__ import annotations

import torch

from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.ops.deblock_np import thresholds


def _r3(x):
    return (x + 4) >> 3


def _r4(x):
    return (x + 8) >> 4


def filter_taps(p, q, limit, blimit, thresh, size, bd):
    """Vectorized deblock_np._filter_line.  p/q: (..., 7) int32 taps (p[6]
    = p0, q[0] = q0); size: (...,) int32 in {0, 4, 6, 8, 14}.  Returns
    (new value per tap offset t in -6..5, write mask per offset)."""
    F = 1 << (bd - 8)
    p0, p1, p2, p3 = p[..., 6], p[..., 5], p[..., 4], p[..., 3]
    p4, p5, p6 = p[..., 2], p[..., 1], p[..., 0]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    q4, q5, q6 = q[..., 4], q[..., 5], q[..., 6]
    ab = torch.abs

    fm4 = ((ab(p1 - p0) <= limit) & (ab(q1 - q0) <= limit)
           & (ab(p0 - q0) * 2 + (ab(p1 - q1) >> 1) <= blimit))
    fm6 = fm4 & (ab(p2 - p1) <= limit) & (ab(q2 - q1) <= limit)
    fm8 = fm6 & (ab(p3 - p2) <= limit) & (ab(q3 - q2) <= limit)
    flat = ((ab(p1 - p0) <= F) & (ab(q1 - q0) <= F)
            & (ab(p2 - p0) <= F) & (ab(q2 - q0) <= F))
    flat8 = flat & (ab(p3 - p0) <= F) & (ab(q3 - q0) <= F)
    flat2 = ((ab(p4 - p0) <= F) & (ab(q4 - q0) <= F)
             & (ab(p5 - p0) <= F) & (ab(q5 - q0) <= F)
             & (ab(p6 - p0) <= F) & (ab(q6 - q0) <= F))

    mask = torch.where(size >= 8, fm8, torch.where(size == 6, fm6, fm4)) \
        & (size > 0)

    lo, hi = -128 * F, 128 * F - 1

    def cl(x):
        return torch.clamp(x, lo, hi)

    ps1, ps0 = p1 - 128 * F, p0 - 128 * F
    qs0, qs1 = q0 - 128 * F, q1 - 128 * F
    hev = (ab(p1 - p0) > thresh) | (ab(q1 - q0) > thresh)
    f = torch.where(hev, cl(ps1 - qs1), torch.zeros_like(ps1))
    f = cl(f + 3 * (qs0 - ps0))
    f1 = cl(f + 4) >> 3
    f2 = cl(f + 3) >> 3
    n_q0 = cl(qs0 - f1) + 128 * F
    n_p0 = cl(ps0 + f2) + 128 * F
    f3 = (f1 + 1) >> 1
    n_q1 = torch.where(hev, q1, cl(qs1 - f3) + 128 * F)
    n_p1 = torch.where(hev, p1, cl(ps1 + f3) + 128 * F)
    use4 = mask & ~((size >= 8) & flat8) & ~((size == 6) & flat)
    m6 = mask & (size == 6) & flat
    m8 = mask & (size >= 8) & flat8 & ~((size == 14) & flat2)
    m14 = mask & (size == 14) & flat8 & flat2

    val = {}
    wm = {}

    def put(t, m, v):
        if t in val:
            val[t] = torch.where(m, v, val[t])
            wm[t] = wm[t] | m
        else:
            orig = p[..., 7 + t] if t < 0 else q[..., t]
            val[t] = torch.where(m, v, orig)
            wm[t] = m

    put(-1, use4, n_p0)
    put(-2, use4, n_p1)
    put(0, use4, n_q0)
    put(1, use4, n_q1)

    put(-2, m6, _r3(p2 * 3 + p1 * 2 + p0 * 2 + q0))
    put(-1, m6, _r3(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1))
    put(0, m6, _r3(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2))
    put(1, m6, _r3(p0 + q0 * 2 + q1 * 2 + q2 * 3))

    put(-3, m8, _r3(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0))
    put(-2, m8, _r3(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1))
    put(-1, m8, _r3(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2))
    put(0, m8, _r3(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3))
    put(1, m8, _r3(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3))
    put(2, m8, _r3(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3))

    put(-6, m14, _r4(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0))
    put(-5, m14, _r4(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1))
    put(-4, m14, _r4(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2))
    put(-3, m14, _r4(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3))
    put(-2, m14, _r4(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4))
    put(-1, m14, _r4(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5))
    put(0, m14, _r4(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6))
    put(1, m14, _r4(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2))
    put(2, m14, _r4(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3))
    put(3, m14, _r4(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4))
    put(4, m14, _r4(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5))
    put(5, m14, _r4(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7))
    return val, wm


def deblock_pass_plain(img, limit, blimit, thresh, bd, plane_idx, tx_across,
                       bpos, skip, s_along, s_across, x0: int = 0,
                       width: int | None = None):
    """One direction over a (h, w) plane view, edges along axis 0.
    tx_across/bpos/skip: per-mi maps oriented like img.  The view's column
    0 lies at plane x = x0 of a plane `width` wide (default: the view):
    only edges at plane x in [4, width - 4] filter, and transform edges
    are found at plane x (tiles.py:216-219 edge_valid)."""
    h, w = img.shape
    E = w // 4 - 1  # edges at x = 4, 8, ..., 4E
    if E <= 0:
        return img
    width = w if width is None else width
    dev = img.device
    g = torch.arange(0, h, 4, device=dev)
    mi_along = (g << s_along) >> 2
    ex = (torch.arange(E, device=dev) + 1) * 4
    xp = ex + x0  # each edge's plane x
    mi_cur = (ex << s_across) >> 2
    mi_prev = ((ex - 1) << s_across) >> 2
    cur_tx = tx_across[mi_along[:, None], mi_cur[None, :]]
    prev_tx = tx_across[mi_along[:, None], mi_prev[None, :]]
    is_tx_edge = (xp[None, :] % torch.clamp(cur_tx, min=1)) == 0
    is_blk = bpos[mi_along[:, None], mi_cur[None, :]] == ex[None, :]
    cur_sk = skip[mi_along[:, None], mi_cur[None, :]]
    prev_sk = skip[mi_along[:, None], mi_prev[None, :]]
    apply_ = (is_tx_edge & (is_blk | ~cur_sk | ~prev_sk)
              & ((xp >= 4) & (xp <= width - 4))[None, :])
    size_across = torch.minimum(cur_tx, prev_tx)
    if plane_idx == 0:
        fsize = torch.where(size_across >= 16, 14,
                            torch.where(size_across >= 8, 8, 4))
    else:
        fsize = torch.where(size_across >= 8, 6, 4)
    fsize = torch.where(apply_, fsize, 0)
    size_r = torch.repeat_interleave(fsize, 4, dim=0)[:h]

    x = img.to(torch.int32)
    cols = torch.clamp(ex[:, None] + torch.arange(-7, 7, device=dev)[None, :],
                       0, w - 1)  # (E, 14) tap columns
    win = x[:, cols]  # (h, E, 14)
    val, wm = filter_taps(win[..., :7], win[..., 7:], limit, blimit, thresh,
                          size_r, bd)
    out = x.clone()
    for t in range(-6, 6):
        col = ex + t  # every edge's column for tap t
        keep = (col >= 0) & (col < w)
        col = col[keep]
        out[:, col] = torch.where(wm[t][:, keep], val[t][:, keep],
                                  out[:, col])
    return out


def deblock_pass(img: torch.Tensor, limit: int, blimit: int, thresh: int,
                 plane_idx: int, tx_across: torch.Tensor, bpos: torch.Tensor,
                 skip: torch.Tensor, s_along: int, s_across: int,
                 bd: int = 8, x0: int = 0,
                 width: int | None = None) -> torch.Tensor:
    """Filter the vertical edges of `img` (h, w) int32 (K4) at bit depth
    bd.  tx_across / bpos (int32) and skip (bool) are per-mi maps indexed
    [mi_along, mi_across]; transposed views are fine.  x0, width: the slab
    window of deblock_pass_plain.  Returns a new plane."""
    if img.device.type == "cpu":
        return deblock_pass_plain(img, limit, blimit, thresh, bd, plane_idx,
                                  tx_across, bpos, skip, s_along, s_across,
                                  x0, width)
    if bd not in (8, 10, 12):
        raise ValueError(f"the deblock kernel takes bit depth 8, 10 or 12, "
                         f"not {bd}")
    x = img.to(torch.int32)
    # the kernel addresses input and output through the same strides (a
    # transposed view serves the horizontal-edge pass without a copy)
    out = torch.empty_strided(x.shape, x.stride(), dtype=torch.int32,
                              device=x.device).copy_(x)
    tx = tx_across.to(torch.int32)
    bp = bpos.to(torch.int32)
    sk = skip.to(torch.uint8)
    if tx.stride() != bp.stride() or tx.stride() != sk.stride():
        tx, bp, sk = tx.contiguous(), bp.contiguous(), sk.contiguous()
    h, w = x.shape
    kernels.launch("deblock", x, x.data_ptr(), out.data_ptr(), h, w,
                   x.stride(0), x.stride(1), tx.data_ptr(), bp.data_ptr(),
                   sk.data_ptr(), tx.stride(0), tx.stride(1), s_along,
                   s_across, int(limit), int(blimit), int(thresh), plane_idx,
                   int(x0), w if width is None else int(width), bd)
    return out


def plane_lims(levels, sharpness: int, plane_idx: int, bd: int):
    """(lims_v, lims_h) of one plane for deblock_plane: (limit, blimit,
    thresh, enabled) of its vertical and horizontal level slots, as
    deblock_np.deblock_plane picks them from the frame's four levels."""
    slots = (0, 1) if plane_idx == 0 else (1 + plane_idx,) * 2
    return tuple(tuple(int(v) for v in thresholds(levels[s], sharpness, bd))
                 + (levels[s] != 0,) for s in slots)


def deblock_plane(img, txw, txh, bx, by, skip, plane_idx, sub_x, sub_y,
                  lims_v, lims_h, bd: int = 8):
    """Both directions over one plane (vertical edges first) through
    deblock_pass.  lims_*: (limit, blimit, thresh, enabled) of the pass's
    level slot (plane_lims)."""
    if lims_v[3]:
        img = deblock_pass(img, *lims_v[:3], plane_idx, txw >> sub_x,
                           bx >> sub_x, skip, sub_y, sub_x, bd)
    if lims_h[3]:
        img = deblock_pass(img.t(), *lims_h[:3], plane_idx,
                           (txh >> sub_y).t(), (by >> sub_y).t(), skip.t(),
                           sub_x, sub_y, bd).t()
    return img
