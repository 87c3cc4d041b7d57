"""Device RD maps for the frame-edge band, in PyTorch on the GPU.

Counterpart of the band-map part of rav1e_tpu/models/device_pipeline.py
(_predict_all, rd_analysis, _band_maps_packed, launch_band_rd_maps).  The
partial superblocks at a frame's bottom (1080 = 16*64 + 56) are coded by
the host block path; these maps give it a mode per 32x32 and 16x16 block
and the 32 -> 16 split decision, so it runs no per-block RD trials.

Also the full-pel motion search of the P-frame pass (me_fullpel, K10):
quarter-resolution exhaustive search, then a full-resolution refinement,
one motion vector per 32x32 block.

The maps come from source edges (no reconstruction): every candidate mode
is predicted by intra_pred (K1) and costed through the float-floor variant
of fwd_txq (K2): fp32 transform, deadzone quantiser, tx-domain distortion
and the level-magnitude rate model.

The same maps over a whole luma plane (frame_rd_maps) steer the host walk
of the intra frames outside the wavefront: lossless frames and frames
above 8 bits.  The same search serves the host inter path of the frames
outside the inter wavefront (frame_me_map: one map a reference, over the
edge-padded reference plane, uint8 or uint16 samples).

The SAD mode maps (mode_analysis, frame_mode_maps) and the sharded
analysis steps of the JAX module have no caller on any path and are not
ported (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.ops import intra as ij
from rav1e_tpu_torch.ops import transforms as tt
from rav1e_tpu_torch.ops import transforms_np as tn

# mode ids (ops.intra_np order)
DC, V, H = 0, 1, 2
D45, D135, D113, D157, D203, D67 = 3, 4, 5, 6, 7, 8
SMOOTH, SMOOTH_V, SMOOTH_H, PAETH = 9, 10, 11, 12

# candidate list mirrored from the host encoder (zone-2 directional only)
CANDIDATES = (DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, D135, D113, D157)
# their channels in intra_pred's FULL set: DC, V/H/D135/D113/D157 at angle
# delta 0 (channel 1 + 7 * (mode - 1) + 3), SMOOTH* and PAETH
_CHANNELS = (0, 4, 11, 57, 58, 59, 60, 25, 32, 39)
DIST_SCALE = {32: 0.0164, 16: 0.0164}


def _fwd_mats(n: int, device):
    Fv, FhT = tt.fwd_mats(tn.DCT_DCT, n, n)
    return torch.as_tensor(Fv, device=device), torch.as_tensor(FhT,
                                                               device=device)


def source_edges(y: torch.Tensor, n: int):
    """(blocks (by, bx, n, n), above, left (by*bx, 2n+1)) edge vectors from
    the source plane itself, 128 outside it; entries past n repeat the
    last sample (no candidate here reads them)."""
    Hh, Ww = y.shape
    by, bx = Hh // n, Ww // n
    blocks = y.reshape(by, n, bx, n).permute(0, 2, 1, 3)
    pad = torch.nn.functional.pad(y, (1, 0, 1, 0), value=128)
    above = pad[0:Hh:n, 1:].reshape(by, bx, n)
    left = pad[1:, 0:Ww:n].reshape(by, n, bx).transpose(1, 2)
    topleft = pad[0:Hh:n, 0:Ww:n].reshape(by, bx, 1)
    ext = lambda a: torch.cat([topleft, a, a[..., -1:].expand(by, bx, n)], -1)
    return blocks, ext(above).reshape(-1, 2 * n + 1), \
        ext(left).reshape(-1, 2 * n + 1)


def predict_all(y: torch.Tensor, n: int):
    """All candidate intra predictions for every n x n block from source
    edges: (blocks (by, bx, n, n), preds (nmodes, by, bx, n, n))."""
    blocks, above, left = source_edges(y, n)
    by, bx = blocks.shape[:2]
    on = torch.ones((above.shape[0],), dtype=torch.bool, device=y.device)
    preds = ij.intra_pred(above, left, on, on, n, True)
    preds = preds[:, list(_CHANNELS)].reshape(by, bx, len(_CHANNELS), n, n)
    return blocks, preds.permute(2, 0, 1, 3, 4)


def rd_analysis(y: torch.Tensor, n: int, q: tuple, lam: float):
    """Per-block best mode + RD cost for n x n blocks: the tx-domain RD is
    evaluated for every candidate mode and the argmin taken over it.
    q: (dc_q, ac_q).  Returns (mode, cost, nnz) maps (by, bx)."""
    blocks, stack = predict_all(y, n)
    resid = blocks[None] - stack
    Fv, FhT = _fwd_mats(n, y.device)
    shift = 1 if n == 32 else 0
    dist, rate, nnz_all = tt.fwd_rd_float(resid, Fv, FhT, int(q[0]),
                                          int(q[1]), shift)
    cost_all = dist * DIST_SCALE[n] + lam * (rate + 6.0)
    best = torch.argmin(cost_all, dim=0)
    mode_ids = torch.as_tensor(CANDIDATES, dtype=torch.int32, device=y.device)
    cost = torch.gather(cost_all, 0, best[None])[0]
    nnz = torch.gather(nnz_all, 0, best[None])[0]
    return mode_ids[best], cost, nnz


def rd_maps(y: torch.Tensor, q: tuple, lam: torch.Tensor) -> tuple:
    """rd_analysis at n = 32 and 16 and the 32 -> 16 split decision:
    ((mode, cost, nnz) at 32, the same at 16, split (by, bx) bool).
    lam: a float32 scalar tensor."""
    m32 = rd_analysis(y, 32, q, lam)
    m16 = rd_analysis(y, 16, q, lam)
    by, bx = m32[1].shape
    c16sum = m16[1].reshape(by, 2, bx, 2).sum(dim=(1, 3))
    return m32, m16, c16sum + lam * 6.0 < m32[1]


def band_maps_packed(y: torch.Tensor, q: tuple, lam: float) -> torch.Tensor:
    """Mode maps for 32/16 blocks plus the 32 -> 16 split decision, packed
    into one int32 vector."""
    m32, m16, split = rd_maps(y, q, torch.tensor(lam, dtype=torch.float32))
    return torch.cat([m32[0].reshape(-1), m16[0].reshape(-1),
                      split.to(torch.int32).reshape(-1)])


class LaunchedBandMaps:
    """Handle to an enqueued band RD analysis: maps for the frame's
    host-path edge band (partial superblocks), launched right after the
    wavefront pass.  collect() returns frame_rd_maps-shaped numpy maps;
    the band's pixel offset rides on the handle."""

    def __init__(self, y0: int, x0: int, out: torch.Tensor, shape: tuple):
        self.y0 = y0
        self.x0 = x0
        self._out = out
        self._shape = shape  # band (h, w)

    def collect(self) -> dict:
        v = self._out.cpu().numpy()
        h, w = self._shape
        n32 = (h // 32) * (w // 32)
        n16 = (h // 16) * (w // 16)
        return {
            32: (v[:n32].reshape(h // 32, w // 32),),
            16: (v[n32 : n32 + n16].reshape(h // 16, w // 16),),
            "split32": v[n32 + n16 :].reshape(h // 32, w // 32).astype(bool),
        }


def launch_band_rd_maps(y_band: np.ndarray, dc_q: int, ac_q: int,
                        lam: float, y0: int, x0: int,
                        device="cuda") -> LaunchedBandMaps:
    """Band RD maps (dims multiples of 32) on `device`."""
    yt = torch.as_tensor(np.ascontiguousarray(y_band, np.int32),
                         device=device)
    out = band_maps_packed(yt, (int(dc_q), int(ac_q)), float(lam))
    return LaunchedBandMaps(y0, x0, out, y_band.shape)


def frame_rd_maps(y_plane: np.ndarray, dc_q: int, ac_q: int, lam: float,
                  device="cuda") -> dict:
    """RD maps of a whole luma plane for the host walk of an intra frame
    off the wavefront (device_pipeline.py:191 of the JAX package): for the
    32 and 16 block sizes numpy (mode int32, cost float32, nnz int32) maps,
    and "split32", the 32 -> 16 split decision.  y_plane: the SB-padded
    int32 plane at any bit depth (the edges outside it are 128, as in the
    JAX package)."""
    yt = torch.as_tensor(np.ascontiguousarray(y_plane, np.int32),
                         device=device)
    if yt.device.type == "cuda":
        kernels.COUNTS["frame_rd_maps"] += 1
    lam_t = torch.tensor(float(lam), dtype=torch.float32)
    m32, m16, split = rd_maps(yt, (int(dc_q), int(ac_q)), lam_t)
    out = {n: (m.cpu().numpy(), c.cpu().numpy(),
               z.cpu().numpy().astype(np.int32))
           for n, (m, c, z) in ((32, m32), (16, m16))}
    out["split32"] = split.cpu().numpy()
    return out


# -- motion estimation: hierarchical full search (K10) -------------------------
#
# Stage A searches +-ME_RANGE_PX at quarter resolution (4x4 sums, +-8 over
# 8x8 quarter blocks: 289 offsets); stage B refines +-2 px at full
# resolution around each block's stage-A winner (25 deltas).  Both take the
# first minimum in (dy, dx) raster order, as argmin does; reference samples
# outside the plane repeat its edge.

ME_RANGE_PX = 32
ME_RAD2 = 2


def me_fullpel_plain(src: torch.Tensor, ref: torch.Tensor,
                     n: int = 32) -> torch.Tensor:
    """Plain version of K10: (H/n, W/n, 2) int32 full-pel MVs in pixels
    for the n x n blocks of src (H, W) against ref (H, W)."""
    Hh, Ww = src.shape
    q = 4
    Hq, Wq = Hh // q, Ww // q
    s32 = src.to(torch.int32)
    r32 = ref.to(torch.int32)
    srcq = s32[: Hq * q, : Wq * q].reshape(Hq, q, Wq, q).sum((1, 3))
    refq = r32[: Hq * q, : Wq * q].reshape(Hq, q, Wq, q).sum((1, 3))
    nq = max(2, n // q)
    rad = ME_RANGE_PX // q
    pad_ref = torch.nn.functional.pad(refq[None, None].float(),
                                      (rad, rad, rad, rad),
                                      mode="replicate")[0, 0].to(torch.int32)
    offs = [(dy, dx) for dy in range(-rad, rad + 1)
            for dx in range(-rad, rad + 1)]
    by, bx = Hq // nq, Wq // nq
    costs = torch.stack([
        (srcq - pad_ref[rad + dy : rad + dy + Hq, rad + dx : rad + dx + Wq]
         ).abs().reshape(by, nq, bx, nq).sum((1, 3))
        for dy, dx in offs])
    offs_t = torch.as_tensor(offs, dtype=torch.int32, device=src.device) * q
    mv_a = offs_t[costs.argmin(0)]  # (by, bx, 2) px
    pad = ME_RANGE_PX + ME_RAD2
    pad_full = torch.nn.functional.pad(r32[None, None].float(),
                                       (pad, pad, pad, pad),
                                       mode="replicate")[0, 0].to(torch.int32)
    ar = torch.arange(n, device=src.device)
    base_y = (torch.arange(by, device=src.device)[:, None] * n
              + mv_a[..., 0] + pad)
    base_x = (torch.arange(bx, device=src.device)[None, :] * n
              + mv_a[..., 1] + pad)
    src_b = s32.reshape(by, n, bx, n).permute(0, 2, 1, 3)
    deltas = [(dy, dx) for dy in range(-ME_RAD2, ME_RAD2 + 1)
              for dx in range(-ME_RAD2, ME_RAD2 + 1)]
    costs2 = []
    for dy, dx in deltas:
        yy = (base_y[..., None] + dy + ar).long()
        xx = (base_x[..., None] + dx + ar).long()
        win = pad_full[yy[..., :, None], xx[..., None, :]]
        costs2.append((src_b - win).abs().sum((-1, -2)))
    d_t = torch.as_tensor(deltas, dtype=torch.int32, device=src.device)
    return mv_a + d_t[torch.stack(costs2).argmin(0)]


def me_fullpel(src: torch.Tensor, ref: torch.Tensor, n: int = 32,
               count: str = "me_fullpel") -> torch.Tensor:
    """Full-pel motion map of the n x n blocks: (H/n, W/n, 2) int32 in
    pixels (K10).  src, ref: (H, W) planes of the same shape, H and W
    multiples of 64 (both uint8 or both uint16 on the card).  count: the
    launch counter of the caller's route ("me_fullpel" in the inter pass,
    "me_fullpel_frame" from frame_me_map)."""
    if src.device.type == "cpu":
        return me_fullpel_plain(src, ref, n)
    if n != 32 or src.dtype != ref.dtype \
            or src.dtype not in (torch.uint8, torch.uint16):
        raise ValueError("K10 searches 32x32 blocks of uint8 or uint16 "
                         "planes")
    Hh, Ww = src.shape
    s = src if src.stride(1) == 1 else src.contiguous()
    r = ref if ref.stride(1) == 1 else ref.contiguous()
    dev = src.device
    quarter = torch.empty((2, Hh // 4, Ww // 4), dtype=torch.int32,
                          device=dev)
    mv = torch.empty((Hh // n, Ww // n, 2), dtype=torch.int32, device=dev)
    kernels.launch("me_fullpel", s, s.data_ptr(), s.stride(0), r.data_ptr(),
                   r.stride(0), Hh, Ww, s.element_size(), quarter.data_ptr(),
                   mv.data_ptr(), count=count)
    return mv


def frame_me_map(src_y: np.ndarray, ref_y: np.ndarray, n: int = 32,
                 bit_depth: int = 8, device="cuda") -> np.ndarray:
    """The ME map of the host inter search (device_pipeline.py:339 of the
    JAX package): me_fullpel over two host int32 planes of the same
    64-aligned shape, as (by, bx, 2) int32 full-pel MVs in 1/8 pel.  The
    planes go up as uint8 at 8 bits and as uint16 above."""
    src_y, ref_y = np.asarray(src_y), np.asarray(ref_y)
    if src_y.shape != ref_y.shape or src_y.shape[0] % 64 \
            or src_y.shape[1] % 64:
        raise ValueError("frame_me_map: planes of one 64-aligned shape")
    hi = (1 << bit_depth) - 1
    for a in (src_y, ref_y):
        if a.min() < 0 or a.max() > hi:
            raise ValueError(f"frame_me_map: samples outside 0..{hi}")
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype),
                                   device=device)
    mv = me_fullpel(up(src_y), up(ref_y), n, count="me_fullpel_frame")
    return mv.cpu().numpy().astype(np.int32) * 8
