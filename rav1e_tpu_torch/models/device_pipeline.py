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

And the SAD mode analysis (mode_sad, K12): the best of the same 10
source-edge candidates (or of DC, V and H) by SAD for every n x n block,
with no prediction written to device memory; over it mode_analysis and
frame_mode_maps, the superblock step intra_analysis_step, and their
sharded forms over a parallel/mesh.py Mesh (sharded_intra_analysis,
sharded_mode_analysis, whose shards read their first row's edge from a
halo row copied from the previous shard).
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
    # contiguous, as K2 reads them (a strided stack is copied each call)
    return (torch.as_tensor(np.ascontiguousarray(Fv), device=device),
            torch.as_tensor(np.ascontiguousarray(FhT), device=device))


def source_edges(y: torch.Tensor, n: int, above_row=None):
    """(blocks (..., by, bx, n, n), above, left (... * by * bx, 2n+1))
    edge vectors of the planes y (..., H, W) from the planes themselves,
    128 outside them, or for the first block row from above_row (..., W),
    the row above the plane where given; entries past n repeat the last
    sample (no candidate here reads them)."""
    *lead, Hh, Ww = y.shape
    by, bx = Hh // n, Ww // n
    blocks = y.reshape(*lead, by, n, bx, n).transpose(-3, -2)
    pad = torch.nn.functional.pad(y, (1, 0, 1, 0), value=128)
    if above_row is not None:
        pad[..., 0, 1:] = above_row
    above = pad[..., 0:Hh:n, 1:].reshape(*lead, by, bx, n)
    left = pad[..., 1:, 0:Ww:n].reshape(*lead, by, n, bx).transpose(-1, -2)
    topleft = pad[..., 0:Hh:n, 0:Ww:n].reshape(*lead, by, bx, 1)
    ext = lambda a: torch.cat([topleft, a, a[..., -1:].expand_as(a)], -1)
    return blocks, ext(above).reshape(-1, 2 * n + 1), \
        ext(left).reshape(-1, 2 * n + 1)


def predict_all(y: torch.Tensor, n: int):
    """All candidate intra predictions for every n x n block from source
    edges: (blocks (by, bx, n, n), preds (nmodes, by, bx, n, n))."""
    blocks, above, left = source_edges(y, n)
    by, bx = blocks.shape[:2]
    on = torch.ones((above.shape[0],), dtype=torch.bool, device=y.device)
    preds = ij.intra_pred(above, left, on, on, n, True, channels=_CHANNELS)
    preds = preds.reshape(by, bx, len(_CHANNELS), n, n)
    return blocks, preds.permute(2, 0, 1, 3, 4)


def rd_analysis(y: torch.Tensor, n: int, q: tuple, lam: float):
    """Per-block best mode + RD cost for n x n blocks: the tx-domain RD is
    evaluated for every candidate mode and the argmin taken over it.
    q: (dc_q, ac_q).  Returns (mode, cost, nnz) maps (by, bx)."""
    blocks, stack = predict_all(y, n)
    # the residuals with the candidates last among the batch dimensions,
    # as K1 wrote the predictions, so that K2 reads them in place (the
    # (nmodes, by, bx) order would give a strided batch K2 must copy)
    resid = blocks[:, :, None] - stack.permute(1, 2, 0, 3, 4)
    Fv, FhT = _fwd_mats(n, y.device)
    shift = 1 if n == 32 else 0
    dist, rate, nnz_all = (v.permute(2, 0, 1) for v in tt.fwd_rd_float(
        resid, Fv, FhT, int(q[0]), int(q[1]), shift))
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


# -- SAD mode analysis (K12) ---------------------------------------------------

def mode_sad_plain(planes: torch.Tensor, n: int, count: int = 10,
                   above_row=None):
    """Plain version of K12: the candidates predicted by K1's plain
    version over source_edges (never launching K1), their SADs, and the
    first least one.  planes: (B, H, W) int32; above_row: (B, W) or None.
    Returns (index into CANDIDATES, SAD), each (B, H/n, W/n) int32."""
    B, Hh, Ww = planes.shape
    p = planes.to(torch.int32)
    blocks, above, left = source_edges(p, n, above_row)
    on = torch.ones((above.shape[0],), dtype=torch.bool, device=p.device)
    chans = list(_CHANNELS[:count]) if count == len(CANDIDATES) else [0, 1, 2]
    preds = ij.intra_pred_plain(above, left, on, on, n, count > 3)[:, chans]
    preds = preds.reshape(B, Hh // n, Ww // n, count, n, n)
    sads = (preds - blocks[:, :, :, None]).abs().sum((-1, -2),
                                                     dtype=torch.int32)
    idx = torch.argmin(sads, dim=-1)  # the first least, as jnp.argmin
    return idx.to(torch.int32), sads.min(-1).values.to(torch.int32)


def mode_sad(planes: torch.Tensor, n: int, count: int = 10,
             above_row=None):
    """The best of the first `count` (10 or 3) CANDIDATES by SAD for every
    n x n block of B planes (K12); see mode_sad_plain.  H and W multiples
    of n, n in 8, 16, 32."""
    if planes.device.type == "cpu":
        return mode_sad_plain(planes, n, count, above_row)
    B, Hh, Ww = planes.shape
    if n not in (8, 16, 32) or count not in (3, 10) or Hh % n or Ww % n:
        raise ValueError("mode_sad: n in 8, 16, 32, 3 or 10 candidates, "
                         "planes of a multiple of n")
    p = planes.to(torch.int32).contiguous()
    row = None
    if above_row is not None:
        row = above_row.to(torch.int32).contiguous()
        if row.shape != (B, Ww):
            raise ValueError("mode_sad: above_row (B, W)")
    dr, smw = ij._dev_tables(p.device)
    best = torch.empty((B, Hh // n, Ww // n), dtype=torch.int32,
                       device=p.device)
    sad = torch.empty_like(best)
    kernels.launch("mode_sad", p, p.data_ptr(), B, Hh, Ww, kernels.ptr(row),
                   n, count, dr.data_ptr(), smw[n].data_ptr(),
                   best.data_ptr(), sad.data_ptr())
    return best, sad


def mode_analysis(y: torch.Tensor, n: int, above_row=None) -> tuple:
    """The best candidate of every n x n block of the luma plane y (H, W)
    by source-edge SAD (device_pipeline.py:118 of the JAX package):
    (mode (by, bx) int32, in ops.intra_np's ids, SAD (by, bx) int32).
    above_row: the (W,) row above the plane (a shard's halo), else 128."""
    idx, sad = mode_sad(y[None], n, 10,
                        None if above_row is None else above_row[None])
    mode_ids = torch.as_tensor(CANDIDATES, dtype=torch.int32, device=y.device)
    return mode_ids[idx[0].long()], sad[0]


def frame_mode_maps(y_plane: np.ndarray, device="cuda") -> dict:
    """mode_analysis at n = 32 and 16 of an SB-padded int32 luma plane
    (device_pipeline.py:262 of the JAX package): {n: (mode, SAD)} numpy
    maps."""
    yt = torch.as_tensor(np.ascontiguousarray(y_plane, np.int32),
                         device=device)
    out = {}
    for n in (32, 16):
        mode, sad = mode_analysis(yt, n)
        out[n] = (mode.cpu().numpy(), sad.cpu().numpy())
    return out


def intra_analysis_step(sbs: torch.Tensor, qidx) -> torch.Tensor:
    """(N, 8, 8) int32: each 8x8 block's least DC / V / H SAD from its
    superblock's own edges (every (N, 64, 64) superblock a plane, 128
    outside it) plus 2 + (qidx >> 5) (device_pipeline.py:351 of the JAX
    package, the lookahead's intra cost model)."""
    _idx, sad = mode_sad(sbs.to(torch.int32), 8, 3)
    return sad + (2 + (int(qidx) >> 5))


def _gather(parts: list, device) -> torch.Tensor:
    return torch.cat([p.to(device) for p in parts])


def sharded_intra_analysis(mesh, sbs, qidx) -> torch.Tensor:
    """intra_analysis_step with the superblocks laid over the slots of a
    parallel/mesh.py Mesh as its shards are (Mesh.groups): each slot runs
    its part on its device, and the parts are concatenated on the first
    slot (device_pipeline.py:372 of the JAX package)."""
    sbs = torch.as_tensor(sbs)
    parts = [intra_analysis_step(sbs[r.start : r.stop].to(dev), qidx)
             for dev, r in mesh.groups(sbs.shape[0])]
    return _gather(parts, mesh.slots[0])


def sharded_mode_analysis(mesh, y, n: int) -> tuple:
    """mode_analysis with the plane's block rows laid over the slots of a
    parallel/mesh.py Mesh (device_pipeline.py:384 of the JAX package).
    Each slot holds its rows and one halo row, the row above its first
    one, copied from the previous slot's device: its first block row
    reads that row as its above edge instead of the 128 padding, so the
    maps, gathered on the first slot, equal the unsharded ones for any
    split."""
    y = torch.as_tensor(y)
    groups = mesh.groups(y.shape[0] // n)
    slabs = [y[r.start * n : r.stop * n].to(dev) for dev, r in groups]
    parts = [mode_analysis(slab, n, slabs[i - 1][-1].to(dev) if i else None)
             for i, (slab, (dev, _r)) in enumerate(zip(slabs, groups))]
    dev0 = mesh.slots[0]
    return (_gather([m for m, _ in parts], dev0),
            _gather([s for _, s in parts], dev0))


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
