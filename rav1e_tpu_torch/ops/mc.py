"""Inter motion compensation on the GPU: the AV1 8-tap separable subpel
interpolation of a batch of same-size blocks (K9), bit-exact.

Counterpart of rav1e_tpu/ops/mc_jax.py (pad_ref_plane, the REGULAR tap
table of _taps_i32, mc_block_batch).  Every block reads its (h + 7, w + 7)
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


# the REGULAR filter set (the frame header signals it on the device path),
# 8 taps per 1/16-pel phase (mc_jax._taps_i32(0))
REGULAR_TAPS = np.ascontiguousarray(MC_FILTERS[0], np.int32)


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
                         bd: int = 8) -> torch.Tensor:
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
    taps = torch.as_tensor(REGULAR_TAPS, device=dev)
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
                   bd: int = 8) -> torch.Tensor:
    """Batched single-reference prediction: (N, h, w) int32 (K9).

    ref_pad: (Hp, Wp) padded plane of this plane's subsampling
    (pad_ref_plane; uint8 on the card).  px/py: (N,) int32 plane
    coordinates of each block; mvr/mvc: (N,) int32 luma-space 1/8-pel MVs
    (chroma derives its 1/16-pel position by the subsampling shift).  The
    caller keeps every window inside the padded plane (|mv| <= MV_LIMIT
    with margin MC_MARGIN)."""
    if ref_pad.device.type == "cpu":
        return mc_block_batch_plain(ref_pad, margin, px, py, mvr, mvc, w, h,
                                    sub_x, sub_y, bd)
    if ref_pad.dtype != torch.uint8 or bd != 8:
        raise ValueError("K9 reads 8-bit uint8 reference planes")
    dev = ref_pad.device
    ref = ref_pad if ref_pad.stride(1) == 1 else ref_pad.contiguous()
    args = [torch.as_tensor(a, device=dev).to(torch.int32).contiguous()
            for a in (px, py, mvr, mvc)]
    n = args[0].shape[0]
    out = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    taps = _TAPS_DEV.get(str(dev))
    if taps is None:
        taps = _TAPS_DEV[str(dev)] = torch.as_tensor(REGULAR_TAPS, device=dev)
    fn = kernels.lib("mc_pred").mc_pred
    kernels.COUNTS["mc_pred"] += 1
    kernels.check(fn(ref.data_ptr(), ref.stride(0), ref.shape[0],
                     ref.shape[1], margin, *(a.data_ptr() for a in args), n,
                     w, h, sub_x, sub_y, taps.data_ptr(), out.data_ptr(),
                     kernels.stream_ptr(ref)), "mc_pred")
    return out
