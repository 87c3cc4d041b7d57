"""CDEF strength search and apply on the GPU (K5 cdef_dir, K6 cdef_filter),
bit-exact with ops/cdef_np.py.

Counterpart of rav1e_tpu/ops/cdef_jax.py: _find_dir_all_jnp (K5),
_filter_plane_jnp with _adjust_vec_jnp and _constrain_jnp (K6), and
_make_search_kernel, the fused search that the filter chain runs after
deblock (filter_chain_jax.py:213).  NORMATIVE (spec 7.15): the decoder
filters with the strengths chosen here.

`search_apply` finds every 8x8 block's direction (K5), sums each
superblock's SSE against the source for the 8 luma and 3 chroma
candidates (K6, search mode), decides between per-superblock and
per-frame strengths with a few device-side torch ops (no host sync), and
writes the chosen candidate of each superblock (K6, apply mode).  CDEF
reads only pre-CDEF samples, so each 8x8 block's output does not depend
on its neighbours' strengths and a per-superblock gather equals a
per-superblock decode (cdef_jax.py:301-303).

Outside the chain (the host deblock level search of speed <= 5):
cdef_search_apply_device runs the same search on uploaded host-deblocked
planes (cdef_jax.py:374), and cdef_frame_device applies the fixed
strengths of the sampled host search (cdef_jax.py:168).

Above 8 bits the planes carry bd-bit samples: the candidate strengths
are shifted left by bd - 8 before the variance adjustment, the damping
grows by bd - 8 (callers pass it so), and the direction search reads
(x >> (bd - 8)) - 128 (cdef_jax.py:238-311, spec 7.15).

The JAX search sums the SSE in f32; here the sums are exact int64, so a
superblock whose two best candidates lie within f32 rounding of each
other may pick the other one (see tests/test_torch_filters.py and
tests/test_torch_hbd.py).

On a CUDA tensor the wrappers launch the kernels in csrc/; on a CPU
tensor they run the plain versions below.
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.ops.cdef_np import (
    CDEF_DIRECTIONS,
    CDEF_VERY_LARGE,
    DIV_TABLE,
    _D0_DIV,
    _ODD_LENS,
)

Y_CANDIDATES = tuple((pri, sec) for pri in (0, 1, 2, 4) for sec in (0, 2))
UV_CANDIDATES = ((0, 0), (1, 0), (2, 0))

# Per-superblock mode (cdef_bits = 3): the 8 header strength pairs are the
# 8 Y_CANDIDATES in order; each pairs with the UV candidate below (the
# cdef_idx selects BOTH the luma and chroma strengths — spec 5.9.19).
PAIR_UV_IDX = (0, 0, 1, 1, 2, 2, 2, 2)

# extra header bits of per-SB mode vs one pair: 7 more (y,uv) pairs x 12 bits
_SB_HDR_BITS = 84.0

SEARCH, APPLY = 0, 1


def strength_codes(sb: bool, frame_best: int):
    """Header (y, uv) strength code lists for a search result: the fixed
    8-pair table in per-SB mode, or the single winning pair."""
    y_codes = [(pri << 2) | (3 if sec == 4 else sec) for pri, sec in Y_CANDIDATES]
    uv_codes = [(UV_CANDIDATES[i][0] << 2) | UV_CANDIDATES[i][1]
                for i in PAIR_UV_IDX]
    if sb:
        return 3, tuple(y_codes), tuple(uv_codes)
    return 0, (y_codes[frame_best],), (uv_codes[frame_best],)


def _sb_result(use_sb: bool, frame_best: int, idx_map):
    """(strengths, sb_info) from a search's selection outputs.  strengths
    is the frame-level (y, uv) code pair (for cdef_bits = 0 emission);
    sb_info is (bits, y_codes, uv_codes, idx_map) when the per-SB mode won,
    else None."""
    bits, y_codes, uv_codes = strength_codes(use_sb, frame_best)
    if use_sb:
        return (y_codes[0], uv_codes[0]), (bits, y_codes, uv_codes, idx_map)
    return (y_codes[0], uv_codes[0]), None


# -- K5 cdef_dir ------------------------------------------------------------------

def _bins():
    """Per direction: the bin of each of a block's 64 pixels (row-major)
    and the Div_Table weight of each bin (cdef_np.find_dir_all)."""
    i = np.repeat(np.arange(8), 8)
    j = np.tile(np.arange(8), 8)
    bins = [i + j, i + (j >> 1), i, 3 + i - (j >> 1),
            7 + i - j, 3 - (i >> 1) + j, j, (i >> 1) + j]
    weights = []
    for d in range(8):
        if d in (0, 4):
            weights.append(_D0_DIV)
        elif d in (2, 6):
            weights.append(np.full(8, 105, np.int64))
        else:
            weights.append(DIV_TABLE[_ODD_LENS])
    return bins, weights


_BINS, _BIN_W = _bins()


def cdef_dir_plain(plane: torch.Tensor, bd: int = 8):
    """Directions and variances of the 8x8 blocks of a (h, w) luma plane
    (h, w multiples of 8): (dirs, var), (h/8, w/8) int32 each."""
    h, w = plane.shape
    nby, nbx = h // 8, w // 8
    dev = plane.device
    x = (plane[: nby * 8, : nbx * 8].to(torch.int64) >> (bd - 8)) - 128
    blocks = x.reshape(nby, 8, nbx, 8).permute(0, 2, 1, 3).reshape(-1, 64)
    nb = blocks.shape[0]
    costs = []
    for b, wt in zip(_BINS, _BIN_W):
        part = torch.zeros((nb, len(wt)), dtype=torch.int64, device=dev)
        part.index_add_(1, torch.as_tensor(b, device=dev), blocks)
        costs.append((part * part * torch.as_tensor(wt, device=dev)).sum(1))
    costs = torch.stack(costs)  # (8, nb)
    best = costs.argmax(0)
    ar = torch.arange(nb, device=dev)
    var = (costs[best, ar] - costs[(best + 4) & 7, ar]) >> 10
    return (best.reshape(nby, nbx).to(torch.int32),
            var.reshape(nby, nbx).to(torch.int32))


def cdef_dir(plane: torch.Tensor, bd: int = 8):
    """(dirs, var) of every 8x8 block of `plane` (K5)."""
    if plane.device.type == "cpu":
        return cdef_dir_plain(plane, bd)
    h, w = plane.shape
    nby, nbx = h // 8, w // 8
    x = plane.to(torch.int32)
    if x.stride(1) != 1:
        x = x.contiguous()
    dirs = torch.empty((nby, nbx), dtype=torch.int32, device=x.device)
    var = torch.empty_like(dirs)
    kernels.launch("cdef_dir", x, x.data_ptr(), x.stride(0), nby, nbx,
                   bd - 8, dirs.data_ptr(), var.data_ptr())
    return dirs, var


# -- K6 cdef_filter ---------------------------------------------------------------

def _ilog2(t: torch.Tensor) -> torch.Tensor:
    """floor(log2(t)) of a positive integer tensor, exactly."""
    out = torch.zeros_like(t)
    for k in range(1, 31):
        out += (t >= (1 << k)).to(t.dtype)
    return out


def _adjust(strength, var: torch.Tensor) -> torch.Tensor:
    """Per-block adjusted primary strength (cdef_np._adjust_strength_vec)."""
    s = torch.as_tensor(strength, dtype=torch.int32, device=var.device)
    i = torch.clamp(_ilog2(torch.clamp(var >> 6, min=1)), max=12)
    out = (s * (4 + i) + 8) >> 4
    return torch.where((var > 0) & (s > 0), out, torch.zeros_like(out))


def _filter_plane_plain(plane, dir_b, pri_b, sec_b, damping: int, act_b,
                        sub: int, scale: int = 0) -> torch.Tensor:
    """CDEF of a (h, w) plane with per-8x8-luma-block maps (directions,
    adjusted primary strengths, secondary strengths, active flags), as
    _filter_plane_jnp with per-block secondary strengths.  Each sample
    gathers the 12 taps of its block's direction; the primary taps'
    weights follow the parity of the strength >> scale (bd - 8)."""
    h, w = plane.shape
    bs = 8 >> sub
    dev = plane.device
    rep = lambda m: m.repeat_interleave(bs, 0).repeat_interleave(bs, 1)[:h, :w]
    x = plane.to(torch.int32)
    ws = w + 6
    pad = torch.full((h + 6, ws), CDEF_VERY_LARGE, dtype=torch.int32,
                     device=dev)
    pad[3 : 3 + h, 3 : 3 + w] = x
    flat = pad.reshape(-1)
    base = ((torch.arange(h, device=dev)[:, None] + 3) * ws
            + torch.arange(w, device=dev)[None, :] + 3)
    pri, sec = rep(pri_b).to(torch.int32), rep(sec_b).to(torch.int32)
    d = rep(dir_b).to(torch.int64)
    dirs = torch.as_tensor(CDEF_DIRECTIONS, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(x)
    summ, mx, mn = zero.clone(), x.clone(), x.clone()

    def taps(dd, k, strength, weight):
        nonlocal summ, mx, mn
        on = strength > 0
        shift = torch.clamp(damping - _ilog2(torch.clamp(strength, min=1)),
                            min=0)
        o = dirs[dd, k, 0] * ws + dirs[dd, k, 1]
        for sg in (1, -1):
            p = flat[base + sg * o]
            diff = p - x
            a = diff.abs()
            v = torch.minimum(a, torch.clamp(strength - (a >> shift), min=0))
            summ = summ + torch.where(on, weight * torch.sign(diff) * v, zero)
            valid = on & (p != CDEF_VERY_LARGE)
            mx = torch.where(valid, torch.maximum(mx, p), mx)
            mn = torch.where(valid, torch.minimum(mn, p), mn)

    odd = ((pri >> scale) & 1) == 1
    for k in range(2):
        taps(d, k, pri, torch.where(odd, 3, 4 if k == 0 else 2))
    for d2 in ((d + 2) & 7, (d + 6) & 7):
        for k in range(2):
            taps(d2, k, sec, 2 if k == 0 else 1)
    out = x + ((8 + summ - (summ < 0).to(torch.int32)) >> 4)
    out = torch.minimum(torch.maximum(out, mn), mx)
    write = rep(act_b) & ((pri > 0) | (sec > 0))
    return torch.where(write, out, x)


def _sb_sse(diff: torch.Tensor, bs: int) -> torch.Tensor:
    """Per-superblock (bs x bs, edge blocks zero-padded) sums of diff^2."""
    h, w = diff.shape
    nsy, nsx = -(-h // bs), -(-w // bs)
    sq = torch.zeros((nsy * bs, nsx * bs), dtype=torch.int64,
                     device=diff.device)
    sq[:h, :w] = diff.to(torch.int64) ** 2
    return sq.reshape(nsy, bs, nsx, bs).sum((1, 3))


def _cand_maps(dirs, var, idx_b, scale: int = 0):
    """Per-block (luma pri, luma sec, luma dir, chroma pri, chroma dir) for
    per-block candidate-pair indices idx_b, the strengths shifted left by
    scale (bd - 8)."""
    dev = dirs.device
    ypri = torch.as_tensor([p for p, _ in Y_CANDIDATES], dtype=torch.int32,
                           device=dev)[idx_b]
    ysec = torch.as_tensor([s for _, s in Y_CANDIDATES], dtype=torch.int32,
                           device=dev)[idx_b]
    uvpri = torch.as_tensor([UV_CANDIDATES[i][0] for i in PAIR_UV_IDX],
                            dtype=torch.int32, device=dev)[idx_b]
    zero = torch.zeros_like(dirs)
    return (_adjust(ypri << scale, var), ysec << scale,
            torch.where(ypri > 0, dirs, zero), uvpri << scale,
            torch.where(uvpri > 0, dirs, zero))


def cdef_filter_plain(y, u, v, sy, su, sv, dirs, var, active, damping: int,
                      mode: int, idx_map=None, bd: int = 8):
    """Plain version of K6.  SEARCH: (11, nsby, nsbx) int64 superblock SSE
    of the 8 luma candidates and of the 3 chroma candidates (U + V).
    APPLY: the (Y, U, V) int32 planes of the candidate pair idx_map
    (nsby, nsbx) picks for each superblock.  damping: the luma damping,
    already grown by bd - 8 (chroma filters with damping - 1); the
    candidates' strengths are shifted left by bd - 8."""
    h, w = y.shape
    nby, nbx = h // 8, w // 8
    sc = bd - 8
    act = active.to(torch.bool)
    zero = torch.zeros_like(dirs)
    if mode == APPLY:
        idx_b = idx_map.to(torch.int64).repeat_interleave(8, 0) \
            .repeat_interleave(8, 1)[:nby, :nbx]
        ypri, ysec, ydir, uvpri, uvdir = _cand_maps(dirs, var, idx_b, sc)
        yo = _filter_plane_plain(y, ydir, ypri, ysec, damping, act, 0, sc)
        uo, vo = (_filter_plane_plain(p, uvdir, uvpri, zero, damping - 1,
                                      act, 1, sc) for p in (u, v))
        return yo, uo, vo
    sse = []
    for pri, sec in Y_CANDIDATES:
        out = _filter_plane_plain(y, dirs if pri else zero,
                                  _adjust(pri << sc, var),
                                  torch.full_like(dirs, sec << sc), damping,
                                  act, 0, sc)
        sse.append(_sb_sse(out - sy.to(torch.int32), 64))
    for pri, _sec in UV_CANDIDATES:
        pm = torch.full_like(dirs, pri << sc)
        tot = 0
        for p, s in ((u, su), (v, sv)):
            out = _filter_plane_plain(p, dirs if pri else zero, pm, zero,
                                      damping - 1, act, 1, sc)
            tot = tot + _sb_sse(out - s.to(torch.int32), 32)
        sse.append(tot)
    return torch.stack(sse)


def _i32(t):
    t = t.to(torch.int32)
    return t if t.stride(-1) == 1 else t.contiguous()


def cdef_filter(y, u, v, sy, su, sv, dirs, var, active, damping: int,
                mode: int, idx_map=None, bd: int = 8):
    """K6 on one frame: y (h, w), u/v (h/2, w/2) and the sources of the same
    shapes, bd-bit samples; dirs/var/active (h/8, w/8).  Returns what
    cdef_filter_plain returns for `mode`."""
    if y.device.type == "cpu":
        return cdef_filter_plain(y, u, v, sy, su, sv, dirs, var, active,
                                 damping, mode, idx_map, bd)
    if bd not in (8, 10, 12):
        raise ValueError(f"cdef_filter: bit depth {bd}")
    h, w = y.shape
    nby, nbx = h // 8, w // 8
    nsby, nsbx = -(-h // 64), -(-w // 64)
    if (h % 8 or w % 8 or sy.shape != y.shape
            or any(t.shape != (h >> 1, w >> 1) for t in (u, v, su, sv))
            or any(t.shape != (nby, nbx) for t in (dirs, var, active))
            or (mode == APPLY and idx_map.shape != (nsby, nsbx))):
        raise ValueError("cdef_filter: inconsistent plane or map shapes")
    y, u, v, sy, su, sv = (_i32(t) for t in (y, u, v, sy, su, sv))
    if u.stride(0) != v.stride(0) or su.stride(0) != sv.stride(0):
        u, v, su, sv = (t.contiguous() for t in (u, v, su, sv))
    dirs, var = dirs.to(torch.int32).contiguous(), var.to(torch.int32).contiguous()
    act = active.to(torch.uint8).contiguous()
    dev = y.device
    sse = yo = uo = vo = idx = None
    if mode == APPLY:
        idx = idx_map.to(torch.int32).contiguous()
        yo = torch.empty((h, w), dtype=torch.int32, device=dev)
        uo = torch.empty((h >> 1, w >> 1), dtype=torch.int32, device=dev)
        vo = torch.empty_like(uo)
    else:
        sse = torch.empty((11, nsby, nsbx), dtype=torch.int64, device=dev)
    kernels.launch("cdef_filter", y, y.data_ptr(), u.data_ptr(),
                   v.data_ptr(), y.stride(0), u.stride(0), sy.data_ptr(),
                   su.data_ptr(), sv.data_ptr(), sy.stride(0), su.stride(0),
                   h, w, dirs.data_ptr(), var.data_ptr(), act.data_ptr(), nbx,
                   damping, bd - 8, mode, kernels.ptr(idx), kernels.ptr(sse),
                   kernels.ptr(yo), kernels.ptr(uo), kernels.ptr(vo))
    return (yo, uo, vo) if mode == APPLY else sse


# -- the search ---------------------------------------------------------------------

def decide(sse: torch.Tensor, skip: torch.Tensor, sb_lam: float, h: int,
           w: int):
    """Per-superblock vs per-frame strengths from K6's superblock SSE
    (cdef_jax.py:279-299), on the device: (use_sb, frame_best, idx_map).
    Costs are exact integers; the per-SB mode's extra header and cdef_idx
    bits are charged at sb_lam (inf forces the frame pair)."""
    nby, nbx = h // 8, w // 8
    nsby, nsbx = -(-h // 64), -(-w // 64)
    dev = sse.device
    s = sse.to(torch.int64)
    cost = s[:8] + s[8:][torch.as_tensor(PAIR_UV_IDX, device=dev)]
    sb_idx = cost.argmin(0)
    # cdef_idx is only coded for SBs with a non-skip block (spec read_cdef)
    mi = torch.ones((nsby * 16, nsbx * 16), dtype=torch.bool, device=dev)
    mi[: nby * 2, : nbx * 2] = skip[: nby * 2, : nbx * 2].to(torch.bool)
    sb_coded = ~mi.reshape(nsby, 16, nsbx, 16).all(3).all(1)
    n_coded = sb_coded.sum().to(torch.float64)
    frame_cost = cost.sum((1, 2))
    frame_best = frame_cost.argmin()
    persb_total = cost.min(0).values.sum()
    use_sb = (persb_total.to(torch.float64)
              + float(sb_lam) * (_SB_HDR_BITS + 3.0 * n_coded)
              < frame_cost[frame_best].to(torch.float64))
    idx_map = torch.where(use_sb, sb_idx, frame_best).to(torch.int32)
    return use_sb, frame_best.to(torch.int32), idx_map


def active_blocks(skip: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h/8, w/8) bool: 8x8 blocks with a non-skip 4x4 mi (per-mi skip)."""
    nby, nbx = h // 8, w // 8
    s4 = skip[: nby * 2, : nbx * 2].to(torch.bool).reshape(nby, 2, nbx, 2)
    return ~s4.all(3).all(1)


def search_apply(y, u, v, sy, su, sv, skip, sb_lam: float, damping: int,
                 bd: int = 8):
    """CDEF search and apply of one frame (the coded area): y (h, w), u/v
    (h/2, w/2), sources alike, bd-bit samples, skip the per-mi map.
    Returns (use_sb, frame_best, idx_map, y_out, u_out, v_out), all on y's
    device."""
    h, w = y.shape
    damping = damping + bd - 8  # spec: damping scales with bit depth
    dirs, var = cdef_dir(y, bd)
    act = active_blocks(skip, h, w)
    sse = cdef_filter(y, u, v, sy, su, sv, dirs, var, act, damping, SEARCH,
                      None, bd)
    use_sb, frame_best, idx_map = decide(sse, skip, sb_lam, h, w)
    yo, uo, vo = cdef_filter(y, u, v, sy, su, sv, dirs, var, act, damping,
                             APPLY, idx_map, bd)
    return use_sb, frame_best, idx_map, yo, uo, vo


# -- outside the filter chain (the host deblock search's path) ------------------

def _planes(rec, h: int, w: int, device):
    """Copies of the coded-area (Y, U, V) planes of `rec` on the device,
    int32 (copies also on the CPU: rec is written over afterwards)."""
    up = lambda a: torch.tensor(np.ascontiguousarray(a, np.int32),
                                device=device)
    return [up(rec[0][:h, :w]), up(rec[1][: h >> 1, : w >> 1]),
            up(rec[2][: h >> 1, : w >> 1])]


def cdef_search_apply_device(rec, src, skip, damping: int, bd: int,
                             coded_w: int, coded_h: int, sb_lam=None,
                             device="cuda"):
    """Search the strengths over the whole frame and apply the winner
    (cdef_jax.py:374): the host-deblocked planes and the source go up, K5
    and K6 search, decide and apply on the device, and the filtered planes
    come back into rec (in place).  Returns (strengths, (dev_db_y,
    dev_cdef_y), sb_info): the deblocked and filtered luma stay on the
    device for the Wiener trial (lrf.wiener_filter_frame_device).  With
    sb_lam None the frame-level pair is forced (cdef_bits = 0)."""
    h, w = coded_h, coded_w
    lam = np.float32(np.inf if sb_lam is None else sb_lam)
    planes = _planes(rec, h, w, device)
    srcs = _planes(src, h, w, device)
    sk = torch.as_tensor(np.ascontiguousarray(skip), device=device)
    use_sb, frame_best, idx_map, yo, uo, vo = search_apply(
        *planes, *srcs, sk, float(lam), damping, bd)
    for p, o in enumerate((yo, uo, vo)):
        hh, ww = o.shape
        rec[p][:hh, :ww] = o.cpu().numpy()
    strengths, sb_info = _sb_result(bool(use_sb), int(frame_best),
                                    idx_map.cpu().numpy().astype(np.int32))
    return strengths, (planes[0], yo), sb_info


def cdef_frame_device(rec, skip, y_pri: int, y_sec: int, uv_pri: int,
                      uv_sec: int, damping: int, bd: int, coded_w: int,
                      coded_h: int, device="cuda") -> None:
    """CDEF with one strength pair for the frame, in place on rec
    (cdef_jax.py:168): K5, then K6 in apply mode with every superblock on
    the candidate pair of those strengths.  The host search
    (intra_frame._cdef_search) picks luma and chroma strengths apart; when
    no pair of the table joins them, a second apply gives the chroma."""
    if (y_pri | y_sec | uv_pri | uv_sec) == 0:
        return
    if (y_pri, y_sec) not in Y_CANDIDATES or \
            (uv_pri, uv_sec) not in UV_CANDIDATES:
        raise ValueError("cdef_frame_device: strengths outside the "
                         "candidate table")
    h, w = coded_h, coded_w
    ky = Y_CANDIDATES.index((y_pri, y_sec))
    kc = PAIR_UV_IDX.index(UV_CANDIDATES.index((uv_pri, uv_sec)))
    y, u, v = _planes(rec, h, w, device)
    sk = torch.as_tensor(np.ascontiguousarray(skip), device=device)
    dirs, var = cdef_dir(y, bd)
    act = active_blocks(sk, h, w)
    nsb = (-(-h // 64), -(-w // 64))
    apply = lambda k: cdef_filter(
        y, u, v, y, u, v, dirs, var, act, damping + bd - 8, APPLY,
        torch.full(nsb, k, dtype=torch.int32, device=y.device), bd)
    yo, uo, vo = apply(ky)
    if PAIR_UV_IDX[ky] != PAIR_UV_IDX[kc]:
        _y, uo, vo = apply(kc)
    for p, o in enumerate((yo, uo, vo)):
        hh, ww = o.shape
        rec[p][:hh, :ww] = o.cpu().numpy()
