"""Inter motion compensation on the GPU: the AV1 8-tap separable subpel
interpolation of a batch of same-size blocks (K9), bit-exact.

Counterpart of rav1e_tpu/ops/mc_jax.py (pad_ref_plane, the tap tables of
_taps_i32, mc_block_batch, and put_single_batch: the host wrapper that
pads a plane and predicts B blocks with any filter set, at 8, 10 or 12
bits).  Every block reads its (h + 7, w + 7)
window from an edge-replicated padded reference plane (replication == the
decoder's sample clamp to the real frame, spec 7.11.3.2), runs the
horizontal taps with InterRound0 = 3 and the vertical taps with
InterRound1 = 11 (8- and 10-bit), all in exact int32, and clips to the
pixel range.  The oracle is ops/mc_np.py::put_single.

Beyond the prediction, K9 writes the residual against the source planes
in place of it (the inter race: src - prediction is what K2 reads, so no
prediction tensor is kept), and predicts U and V in one launch (the same
positions and MVs; prediction, residual or both).

On a CUDA tensor the wrapper launches csrc/mc_pred.cu and raises if it
cannot; on a CPU tensor it runs the plain PyTorch version beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.ops.mc_np import MC_FILTERS

# MVs are clipped to +-MV_LIMIT (1/8 pel, 44 px); the padded planes carry
# MC_MARGIN samples a side, which covers that reach plus the 8-tap
# footprint (models/wavefront.py MC_MARGIN)
MC_MARGIN = 48
MV_LIMIT = 352


def filter_taps(fset: int) -> np.ndarray:
    """(16, 8) int32 tap table of filter set `fset`, 8 taps per 1/16-pel
    phase (mc_jax._taps_i32)."""
    return np.ascontiguousarray(MC_FILTERS[fset], np.int32)


# the REGULAR filter set (the frame header signals it on the device path)
REGULAR_TAPS = filter_taps(0)


def pad_ref_plane(ref: np.ndarray, margin: int, pad_h: int,
                  pad_w: int) -> np.ndarray:
    """Edge-replicate a real-size reference plane into a
    (pad_h + 2*margin, pad_w + 2*margin) array.  Replication from the real
    frame edges reproduces the decoder's sample-coordinate clamp exactly."""
    rh, rw = ref.shape
    return np.pad(np.asarray(ref, np.int32),
                  ((margin, margin + pad_h - rh),
                   (margin, margin + pad_w - rw)), mode="edge")


def _planes(x):
    """x as a tuple of planes (one tensor: one plane)."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def mc_block_batch_plain(ref_pad, margin: int, px, py, mvr, mvc, w: int,
                         h: int, sub_x: int, sub_y: int, bd: int = 8,
                         taps=REGULAR_TAPS, src=None, cands: int = 1,
                         both: bool = False):
    """Plain version of K9 (see mc_block_batch for the modes)."""
    if isinstance(ref_pad, (tuple, list)):
        srcs = _planes(src) if src is not None else (None,) * len(ref_pad)
        outs = [mc_block_batch_plain(r, margin, px, py, mvr, mvc, w, h,
                                     sub_x, sub_y, bd, taps, s, cands, both)
                for r, s in zip(ref_pad, srcs)]
        if both:
            return tuple(torch.stack(o, 1) for o in zip(*outs))
        return torch.stack(outs, 1)
    px, py = px.long().repeat_interleave(cands), py.long().repeat_interleave(
        cands)
    # each block's window origin in the padded plane (3 samples above and
    # left of its integer position) and its 1/16-pel phases
    start_x = (px << 4) + (mvc.long() << (1 - sub_x))
    start_y = (py << 4) + (mvr.long() << (1 - sub_y))
    iy, ix = (start_y >> 4) - 3 + margin, (start_x >> 4) - 3 + margin
    fy, fx = start_y & 15, start_x & 15
    H, W = ref_pad.shape
    n = iy.shape[0]
    if n:
        assert int(iy.min()) >= 0 and int(iy.max()) + h + 7 <= H, \
            "MC window leaves the padded plane (rows)"
        assert int(ix.min()) >= 0 and int(ix.max()) + w + 7 <= W, \
            "MC window leaves the padded plane (columns)"
    dev = ref_pad.device
    rows = iy[:, None] + torch.arange(h + 7, device=dev)[None]
    cols = ix[:, None] + torch.arange(w + 7, device=dev)[None]
    win = ref_pad.to(torch.int32)[rows[:, :, None], cols[:, None, :]]
    taps = torch.as_tensor(taps, device=dev)
    tx, ty = taps[fx], taps[fy]  # (N, 8)
    round0 = 3 if bd < 12 else 5
    inter = torch.zeros((n, h + 7, w), dtype=torch.int32, device=dev)
    for t in range(8):
        inter += tx[:, t, None, None] * win[:, :, t : t + w]
    inter = (inter + (1 << (round0 - 1))) >> round0
    out = torch.zeros((n, h, w), dtype=torch.int32, device=dev)
    for t in range(8):
        out += ty[:, t, None, None] * inter[:, t : t + h, :]
    out = (out + (1 << (14 - round0 - 1))) >> (14 - round0)
    pred = torch.clamp(out, 0, (1 << bd) - 1)
    if src is None:
        return pred
    rows = py[:, None] + torch.arange(h, device=dev)[None]
    cols = px[:, None] + torch.arange(w, device=dev)[None]
    resid = src.to(torch.int32)[rows[:, :, None], cols[:, None, :]] - pred
    return (pred, resid) if both else resid


# the widths K9 is built for, and its tallest block
K9_WIDTHS = (4, 8, 16, 32, 64)
K9_MAX_H = 64
_TAPS_HOST: dict = {}


def _taps_host(taps, bd: int) -> np.ndarray:
    """The (16, 8) int32 table K9 takes as a kernel parameter, checked
    once: phase 0 the identity times 128, the other phases' taps int8 (the
    kernel's dot products), and its horizontal pass's rounded sums within
    the int16 the kernel keeps them in at bd bits (csrc/mc_pred.cu)."""
    t = np.ascontiguousarray(taps, np.int32)
    key = (t.tobytes(), bd)
    got = _TAPS_HOST.get(key)
    if got is None:
        if (t.shape != (16, 8) or list(t[0]) != [0, 0, 0, 128, 0, 0, 0, 0]
                or t[1:].min() < -128 or t[1:].max() > 127):
            raise ValueError("K9 takes a (16, 8) tap table whose phase 0 is "
                             "the identity (x 128) and whose other taps are "
                             "int8")
        r0 = 3 if bd < 12 else 5
        top = (1 << bd) - 1
        pos, neg = np.where(t > 0, t, 0).sum(1), np.where(t < 0, t, 0).sum(1)
        hi = (top * int(pos.max()) + (1 << (r0 - 1))) >> r0
        lo = (top * int(neg.min()) + (1 << (r0 - 1))) >> r0
        if hi > 32767 or lo < -32768:
            raise ValueError("K9: this tap table's horizontal pass leaves "
                             "int16")
        got = _TAPS_HOST[key] = t
    return got


def mc_block_batch(ref_pad, margin: int, px, py, mvr, mvc, w: int, h: int,
                   sub_x: int, sub_y: int, bd: int = 8, taps=REGULAR_TAPS,
                   src=None, cands: int = 1, both: bool = False):
    """Batched single-reference prediction of N blocks of w x h (K9).

    ref_pad: the (Hp, Wp) padded plane of this plane's subsampling
    (pad_ref_plane; on the card uint8 at 8 bits, uint16 above), or a
    tuple of two (U and V: the same positions and MVs, one launch; every
    output then gains a plane axis, (N, 2, h, w)).  px/py: (N / cands,)
    int32 plane coordinates: block b sits at entry b // cands (the race's
    candidates of one block share it); mvr/mvc: (N,) int32 luma-space
    1/8-pel MVs (chroma derives its 1/16-pel position by the subsampling
    shift).  taps: the (16, 8) int32 table of the filter set
    (filter_taps).  The caller keeps every window inside the padded plane
    (|mv| <= MV_LIMIT with margin MC_MARGIN).

    Returns the int32 prediction (N, h, w).  With src, the source plane
    (or U and V's) of the ref's type, whose block b is the h x w block at
    its plane position: the residual src - prediction instead, and with
    both (prediction, residual)."""
    planes = _planes(ref_pad)
    if planes[0].device.type == "cpu":
        return mc_block_batch_plain(ref_pad, margin, px, py, mvr, mvc, w, h,
                                    sub_x, sub_y, bd, taps, src, cands, both)
    want = torch.uint8 if bd == 8 else torch.uint16
    srcs = _planes(src) if src is not None else None
    if bd not in (8, 10, 12) or any(p.dtype != want for p in planes + (
            srcs or ())):
        raise ValueError("K9 reads uint8 planes at 8 bits and uint16 ones "
                         "at 10 or 12")
    if len(planes) not in (1, 2) or (srcs is not None
                                     and len(srcs) != len(planes)):
        raise ValueError("K9 takes one plane or two (U and V), and a source "
                         "plane for each or none")
    if w not in K9_WIDTHS or not 4 <= h <= K9_MAX_H or h % 4:
        raise ValueError(f"K9: blocks {w} wide (one of {K9_WIDTHS}) and a "
                         f"multiple of 4 up to {K9_MAX_H} tall, not {w}x{h}")
    if both and srcs is None:
        raise ValueError("K9: both needs src")
    if any(p.shape != planes[0].shape or p.stride() != planes[0].stride()
           or p.stride(1) != 1 for p in planes):
        planes = tuple(p.contiguous() for p in planes)
        if any(p.shape != planes[0].shape for p in planes):
            raise ValueError("K9: U and V planes of one shape")
    if srcs is not None and any(s.stride(1) != 1
                                or s.stride(0) != srcs[0].stride(0)
                                for s in srcs):
        srcs = tuple(s.contiguous() for s in srcs)
    dev = planes[0].device
    lanes = [torch.as_tensor(a, device=dev).to(torch.int32).contiguous()
             for a in (px, py, mvr, mvc)]
    n = lanes[2].shape[0]
    if lanes[0].shape[0] * cands != n or lanes[3].shape[0] != n:
        raise ValueError("K9: px/py of N / cands blocks, MVs of N")
    table = _taps_host(taps, bd)
    if n * len(planes) * h * w >= 1 << 31:
        raise ValueError("K9: at most 2^31 output samples a call")
    shape = (n, h, w) if len(planes) == 1 else (n, 2, h, w)
    new = lambda: torch.empty(shape, dtype=torch.int32, device=dev)
    pred = new() if srcs is None or both else None
    resid = new() if srcs is not None else None
    ref = planes[0]
    kernels.launch("mc_pred", ref, ref.data_ptr(),
                   planes[1].data_ptr() if len(planes) == 2 else None,
                   ref.element_size(), ref.stride(0), ref.shape[0],
                   ref.shape[1], margin, *(a.data_ptr() for a in lanes), n,
                   cands, w, h, sub_x, sub_y, bd, table.ctypes.data,
                   *(kernels.ptr(srcs[i]) if srcs and i < len(srcs) else None
                     for i in range(2)),
                   srcs[0].stride(0) if srcs else 0, kernels.ptr(pred),
                   kernels.ptr(resid))
    if both:
        return pred, resid
    return resid if srcs is not None else pred


def put_single_batch(ref: np.ndarray, blocks, mvs, w: int, h: int,
                     sub_x: int = 0, sub_y: int = 0, bd: int = 8,
                     fset: int = 0, margin: int = 48,
                     device="cuda") -> np.ndarray:
    """The host wrapper of mc_jax.py:116: B blocks of w x h predicted from
    the real-size plane `ref` (this plane's subsampling) with filter set
    `fset` (K9).  blocks: (B, 2) (px, py) plane coordinates; mvs: (B, 2)
    luma-space (row, col) 1/8-pel MVs.  The plane is edge-padded to its
    64-aligned size plus 64 and `margin` a side (pad_ref_plane) and goes
    up as uint8 at 8 bits, uint16 above.  Returns (B, h, w) int32."""
    blocks = np.asarray(blocks, np.int32)
    mvs = np.asarray(mvs, np.int32)
    pad_h = ((ref.shape[0] + 63) & ~63) + 64
    pad_w = ((ref.shape[1] + 63) & ~63) + 64
    rp = pad_ref_plane(ref, margin, pad_h, pad_w)
    dtype = np.uint8 if bd == 8 else np.uint16
    rp = torch.as_tensor(rp if torch.device(device).type == "cpu"
                         else rp.astype(dtype), device=device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    out = mc_block_batch(rp, margin, t(blocks[:, 0]), t(blocks[:, 1]),
                         t(mvs[:, 0]), t(mvs[:, 1]), w, h, sub_x, sub_y, bd,
                         filter_taps(fset))
    return out.cpu().numpy()
