"""Tile-column encode of key frames: the tile columns as a batch axis.

Counterpart of rav1e_tpu/parallel/tiles.py (reference analog: rav1e's
rayon tile parallelism, src/tiling/tiler.rs + encode_tile_group).  AV1
tiles cut every prediction and context dependency, so each tile column's
wavefront pass (models/wavefront.py) runs with no exchange between
columns.  The JAX package lays the columns over a device mesh with a
`vmap`; here the T columns are stacked like the frames of
`launch_wavefront_batch`: one pass over T*B lanes, the column planes
stacked along rows, on the one device that holds the mesh's shards.  A
column has a quarter (or less) of the frame's superblock columns, so the
pass takes fewer steps (k = 2r + c over the column's width) for more
lanes each.

The route's envelope is the JAX package's: at least 2 tile columns of
equal superblock width, no partial superblock, one tile row (a frame with
tile rows is accepted at launch and declined at collect, as there).  Its
lane parameters are uniform (lambda, dc_q, ac_q of the frame): the
psychovisual lambda map and segment quantisers are not applied, as in
the JAX route (ROADMAP F8), so with either on its bytes differ from the
single-device encode's.

The result has no device-resident recon (`dev_out`) and no packed
records: the frame takes the per-superblock cache walk and the host
filter path, as the JAX route does (it has no device-resident source).
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.models import wavefront as wfm


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


def run_wavefront_sharded(fe, tiles, mesh):
    """The pass over the frame's tile columns, T*B lanes in one pass.
    Requirements: uniform tile columns of equal SB width, one tile row, no
    partial superblocks.  Returns a WavefrontResult facade, or None if the
    frame does not fit the envelope."""
    if any(torch.device(d) != torch.device(fe.device) for d in mesh.devices):
        raise NotImplementedError(
            "tile columns on several GPUs: ROADMAP queue 2 item 16b")
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
    fn = wfm.build_pass(ncols * fe.h, tile_w, K, ncols * B, flags[0],
                        flags[1], flags[2], flags[3], flags[4], tile_w // 4,
                        fe.mi_rows, flags[5], flags[6], flags[7], flags[8],
                        device=fe.device)
    srcs = [[p[:, (t * tile_w) >> s : ((t + 1) * tile_w) >> s]
             for p, s in zip(fe.src, (0, 1, 1))] for t in range(ncols)]
    grids = wfm._uniform_grids(fe, geom)
    upload = wfm.pack_upload(srcs, [grids] * ncols, wfm._mode_bit_params(fe))
    up = torch.from_numpy(upload).to(fe.device)
    if up.device.type == "cuda":
        kernels.COUNTS["wavefront_tiles"] += 1
    out = fn(up, *wfm._geom_dev(geom, fe.device, ncols))
    results = [wfm.unpack_wavefront(geom, part)
               for part in wfm.split_batch(out, ncols, B, fe.h)]
    return ShardedWavefrontResult(fe, results, tw)


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
