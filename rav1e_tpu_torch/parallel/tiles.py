"""Tile-column encode of key frames: the tile columns as a batch axis.

Counterpart of rav1e_tpu/parallel/tiles.py (reference analog: rav1e's
rayon tile parallelism, src/tiling/tiler.rs + encode_tile_group).  AV1
tiles cut every prediction and context dependency, so each tile column's
wavefront pass (models/wavefront.py) runs with no exchange between
columns.  The JAX package lays the columns over a device mesh with a
`vmap`; here the T columns are laid contiguously over the mesh's slots
(parallel/mesh.py), and each slot's columns are stacked like the frames of
`launch_wavefront_batch`: one pass over its columns' lanes, the column
planes stacked along rows, on the slot's device.  One slot takes all T
columns in one pass over T*B lanes.  A column has a quarter (or less) of
the frame's superblock columns, so the pass takes fewer steps (k = 2r + c
over the column's width) for more lanes each.  The slots' passes are
issued one after another from this thread; each slot's results come back
in column order, so the bytes do not depend on the slots.

The route's envelope is the JAX package's: at least 2 tile columns of
equal superblock width, no partial superblock, one tile row (a frame with
tile rows is accepted at launch and declined at collect, as there).  Each
column's lanes carry the lambda and quantisers of the superblocks they
code, from the frame's psychovisual lambda map and segment map, as the
single-device pass's do, so the route writes the single-device encode's
bytes under any tune (the JAX route fills every lane with the frame's own
values: ROADMAP F8).

The result has no device-resident recon (`dev_out`) and no packed
records: the frame takes the per-superblock cache walk and the host
filter path, as the JAX route does (it has no device-resident source).

`deblock_sharded` is the JAX package's halo-exchange deblock over the
mesh's shards: the `ppermute` of the halos becomes a copy from the
neighbour's device.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.models import wavefront as wfm
from rav1e_tpu_torch.ops import deblock as db


class ShardedWavefrontResult:
    """WavefrontResult-compatible view over per-tile results:
    frame-coordinate sb_records / split_map / recon assembled from T
    tile-local results."""

    route = "tiles"

    def __init__(self, fe, tile_results, tile_w_sb):
        self.tile_results = tile_results
        self.tile_w_sb = tile_w_sb
        t0 = tile_results[0]
        sb_rows = t0.geom.device_sb.shape[0]
        sb_cols = tile_w_sb * len(tile_results)
        self.geom_device_sb = np.zeros((sb_rows, sb_cols), bool)
        self.split_map = np.zeros((sb_rows * 2, sb_cols * 2), bool)
        self.split16_map = np.zeros((sb_rows * 4, sb_cols * 4), bool)
        # full-grid 64-root map assembled from the per-tile none64 lanes
        self.none64_full = np.zeros((sb_rows, sb_cols), bool)
        for t, r in enumerate(tile_results):
            c0 = t * tile_w_sb
            self.geom_device_sb[:, c0 : c0 + tile_w_sb] = r.geom.device_sb
            self.split_map[:, 2 * c0 : 2 * (c0 + tile_w_sb)] = r.split_map
            self.split16_map[:, 4 * c0 : 4 * (c0 + tile_w_sb)] = r.split16_map
            if r.none64 is not None:
                g = r.geom
                dev = g.device_sb
                n64 = np.zeros(dev.shape, bool)
                n64[dev] = r.none64[g.sb_step[dev], g.sb_lane[dev]]
                self.none64_full[:, c0 : c0 + tile_w_sb] = n64
        self.rec = [
            np.concatenate([r.rec[p] for r in tile_results], axis=1)
            for p in range(3)
        ]

        class _G:  # geometry facade for _encode_tiles_wavefront
            device_sb = self.geom_device_sb

        self.geom = _G()

    def sb_records(self, r, c):
        t = c // self.tile_w_sb
        recs = self.tile_results[t].sb_records(r, c % self.tile_w_sb)
        x_off = t * self.tile_w_sb * 64
        return [(x + x_off, y, bw, bh, *rest)
                for (x, y, bw, bh, *rest) in recs]


def _in_envelope(fe, tiles) -> bool:
    ncols = len(tiles)
    sb_cols = (fe.coded_w + 63) >> 6
    return not (ncols < 2 or sb_cols % ncols or fe.coded_w % 64
                or fe.coded_h % 64)


def column_grids(fe, geom, t: int, tw: int):
    """Tile column t's (lambda, dc_q, ac_q) lane grids over the
    tile-relative geometry `geom` (tw superblock columns a tile): the
    single-device pass's per-quadrant values (wavefront._fill_lane_params)
    at the column's frame coordinates."""
    grids = wfm._uniform_grids(fe, geom)
    wfm._fill_lane_params(fe, SimpleNamespace(
        sbr=geom.sbr, sbc=geom.sbc + t * tw, valid=geom.valid), *grids)
    return grids


def run_wavefront_sharded(fe, tiles, mesh):
    """The pass over the frame's tile columns: each slot of the mesh one
    pass over its contiguous columns' stacked lanes.  Requirements:
    uniform tile columns of equal SB width, one tile row, no partial
    superblocks.  Returns a WavefrontResult facade, or None if the frame
    does not fit the envelope."""
    if not _in_envelope(fe, tiles):
        return None
    ncols = len(tiles)
    sb_cols = fe.coded_w >> 6
    sb_rows = fe.coded_h >> 6
    if any(r0 != 0 or r1 != sb_rows for (_, r0, _, r1) in tiles):
        return None  # tile rows are outside the route
    tw = sb_cols // ncols
    tile_w = tw * 64

    # per-tile geometry: identical for every column (tile-relative
    # availability; contexts reset per tile)
    geom = wfm.geometry_for(tile_w, fe.coded_h, tile_w, fe.h, tile_w // 4,
                            fe.mi_rows, ((0, 0, tw, sb_rows),))
    if geom is None:
        return None
    K, B = geom.steps, geom.width
    # the single-device pass's flags (drift here would desync the
    # byte-identical contract)
    flags = wfm._pass_flags(fe)
    bits = wfm._mode_bit_params(fe)
    groups = mesh.groups(ncols)
    if any(dev.type == "cuda" for dev, _ in groups):
        kernels.COUNTS["wavefront_tiles"] += 1
    outs = []
    for dev, cols in groups:
        F = len(cols)
        fn = wfm.build_pass(F * fe.h, tile_w, K, F * B, flags[0], flags[1],
                            flags[2], flags[3], flags[4], tile_w // 4,
                            fe.mi_rows, flags[5], flags[6], flags[7],
                            flags[8], device=dev)
        srcs = [[p[:, (t * tile_w) >> s : ((t + 1) * tile_w) >> s]
                 for p, s in zip(fe.src, (0, 1, 1))] for t in cols]
        grids = [column_grids(fe, geom, t, tw) for t in cols]
        up = torch.from_numpy(wfm.pack_upload(srcs, grids, bits)).to(dev)
        outs.append((F, fn(up, *wfm._geom_dev(geom, dev, F))))
    results = [wfm.unpack_wavefront(geom, part) for F, out in outs
               for part in wfm.split_batch(out, F, B, fe.h)]
    return ShardedWavefrontResult(fe, results, tw)


# ---------------------------------------------------------------------------
# the sharded deblock with a halo exchange
# ---------------------------------------------------------------------------

HPX = 64  # halo columns: a multiple of the largest transform width


def deblock_sharded(mesh, plane: np.ndarray, info, levels, sharpness,
                    plane_idx, sub_x, sub_y, bd, width, height) -> np.ndarray:
    """Column-sharded deblock of one plane, identical to the whole-plane
    pass (rav1e_tpu/parallel/tiles.py:153; ops/deblock.deblock_plane,
    deblock_np).  Shard i filters the columns [i*wt, (i+1)*wt) on its
    device: the vertical edges over its slab widened by HPX columns of
    each neighbour (and the neighbours' per-mi maps), through K4's slab
    window, so that the edges near a boundary are filtered on both sides
    alike; then the horizontal edges over the slab alone.  At the frame's
    two outer shards the missing halo replicates the edge column, with
    skip set and no block edge, as the whole-plane pass clamps.  Envelope
    (the JAX one, whose halo slices need wt >= HPX): width % n == 0,
    wt % 4 == 0 and wt >= HPX, else ValueError."""
    n = mesh.size
    wt = width // n
    if width % n or wt % 4 or wt < HPX:
        raise ValueError(f"deblock_sharded: a {width}-wide plane over {n} "
                         f"shards needs width % n == 0 and slabs of a "
                         f"multiple of 4 and at least {HPX} columns")
    h_mi = (HPX << sub_x) // 4  # halo width in luma mi units
    mi_per = (wt << sub_x) // 4
    devs = mesh.devices
    lim_v, lim_h = db.plane_lims(levels, sharpness, plane_idx, bd)

    def shards(a, per):
        return [torch.as_tensor(np.ascontiguousarray(a[:, i * per :
                                                       (i + 1) * per]),
                                device=devs[i]) for i in range(n)]

    def halo(parts, i, k, left, right):
        """Shard i's part between k columns of each neighbour's (copied
        from its device), or `left` / `right` at the frame's edges."""
        d = devs[i]
        lo = parts[i - 1][:, -k:].to(d, non_blocking=True) if i else left
        hi = (parts[i + 1][:, :k].to(d, non_blocking=True) if i < n - 1
              else right)
        return torch.cat([lo, parts[i], hi], dim=1)

    img = shards(np.asarray(plane[:height, :width], np.int32), wt)
    skp = shards(info.skip, mi_per)
    if lim_v[3]:
        txv = shards(info.txw >> sub_x, mi_per)
        bxv = shards(info.bx >> sub_x, mi_per)
        out = []
        for i in range(n):
            edge = lambda parts, v: torch.full(
                (parts[i].shape[0], h_mi), v, dtype=parts[i].dtype,
                device=devs[i])
            ext = halo(img, i, HPX, img[i][:, :1].expand(-1, HPX),
                       img[i][:, -1:].expand(-1, HPX))
            txe = halo(txv, i, h_mi, edge(txv, 0), edge(txv, 0))
            ske = halo(skp, i, h_mi, edge(skp, True), edge(skp, True))
            # block origins in slab coordinates; none in the outer halos
            bpe = halo(bxv, i, h_mi, edge(bxv, 0),
                       edge(bxv, 0)) - (i * wt - HPX)
            if i == 0:
                bpe[:, :h_mi] = -(1 << 20)
            if i == n - 1:
                bpe[:, -h_mi:] = -(1 << 20)
            res = db.deblock_pass(ext, lim_v[0], lim_v[1], lim_v[2],
                                  plane_idx, txe, bpe, ske, sub_y, sub_x, bd,
                                  x0=i * wt - HPX, width=width)
            out.append(res[:, HPX : HPX + wt])
        img = out
    if lim_h[3]:
        txh = shards(info.txh >> sub_y, mi_per)
        byh = shards(info.by >> sub_y, mi_per)
        img = [db.deblock_pass(img[i].t(), lim_h[0], lim_h[1], lim_h[2],
                               plane_idx, txh[i].t(), byh[i].t(), skp[i].t(),
                               sub_x, sub_y, bd).t() for i in range(n)]
    return np.concatenate([p.cpu().numpy() for p in img], axis=1)


class ShardedLaunch:
    """LaunchedWavefront-compatible handle for the tile route (the pass
    runs at collect, as in the JAX package)."""

    def __init__(self, fe, tiles, mesh):
        self.fe = fe
        self.tiles = tiles
        self.mesh = mesh

    def collect(self):
        return run_wavefront_sharded(self.fe, self.tiles, self.mesh)


def launch_sharded(fe, tiles, mesh):
    """The tile route's launch hook for IntraFrameEncoder
    (fe.wavefront_mesh).  Returns None when the frame/tile layout is
    outside the envelope (the caller launches the single-device pass)."""
    if not _in_envelope(fe, tiles):
        return None
    return ShardedLaunch(fe, tiles, mesh)
