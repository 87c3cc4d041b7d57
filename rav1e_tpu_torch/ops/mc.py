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


def mc_block_batch_plain(ref_pad: torch.Tensor, margin: int, px, py, mvr,
                         mvc, w: int, h: int, sub_x: int, sub_y: int,
                         bd: int = 8, taps=REGULAR_TAPS) -> torch.Tensor:
    """Plain version of K9: (N, h, w) int32 predictions."""
    # each block's window origin in the padded plane (3 samples above and
    # left of its integer position) and its 1/16-pel phases
    start_x = (px.long() << 4) + (mvc.long() << (1 - sub_x))
    start_y = (py.long() << 4) + (mvr.long() << (1 - sub_y))
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
    return torch.clamp(out, 0, (1 << bd) - 1)


_TAPS_DEV: dict = {}


def mc_block_batch(ref_pad: torch.Tensor, margin: int, px, py, mvr, mvc,
                   w: int, h: int, sub_x: int, sub_y: int,
                   bd: int = 8, taps=REGULAR_TAPS) -> torch.Tensor:
    """Batched single-reference prediction: (N, h, w) int32 (K9).

    ref_pad: (Hp, Wp) padded plane of this plane's subsampling
    (pad_ref_plane; on the card uint8 at 8 bits, uint16 above).  px/py:
    (N,) int32 plane coordinates of each block; mvr/mvc: (N,) int32
    luma-space 1/8-pel MVs (chroma derives its 1/16-pel position by the
    subsampling shift).  taps: the (16, 8) int32 table of the filter set
    (filter_taps).  The caller keeps every window inside the padded plane
    (|mv| <= MV_LIMIT with margin MC_MARGIN)."""
    if ref_pad.device.type == "cpu":
        return mc_block_batch_plain(ref_pad, margin, px, py, mvr, mvc, w, h,
                                    sub_x, sub_y, bd, taps)
    want = torch.uint8 if bd == 8 else torch.uint16
    if bd not in (8, 10, 12) or ref_pad.dtype != want:
        raise ValueError("K9 reads uint8 reference planes at 8 bits and "
                         "uint16 ones at 10 or 12")
    dev = ref_pad.device
    ref = ref_pad if ref_pad.stride(1) == 1 else ref_pad.contiguous()
    args = [torch.as_tensor(a, device=dev).to(torch.int32).contiguous()
            for a in (px, py, mvr, mvc)]
    n = args[0].shape[0]
    out = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    key = (str(dev), np.asarray(taps).tobytes())
    table = _TAPS_DEV.get(key)
    if table is None:
        table = _TAPS_DEV[key] = torch.as_tensor(taps, device=dev)
    kernels.launch("mc_pred", ref, ref.data_ptr(), ref.element_size(),
                   ref.stride(0), ref.shape[0], ref.shape[1], margin,
                   *(a.data_ptr() for a in args), n, w, h, sub_x, sub_y, bd,
                   table.data_ptr(), out.data_ptr())
    return out


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
