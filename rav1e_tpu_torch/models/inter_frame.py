"""Inter (P) frame encoder of the port.

Counterpart of rav1e_tpu/models/inter_frame.py.  A frame takes one of two
paths, by an explicit condition (_pre_encode):

- The inter wavefront: single-LAST-reference, 8-bit 4:2:0 lossy frames.
  The device pass (models/wavefront.py with inter_on) runs the motion
  search, the MC candidate races, the intra-vs-inter decisions, the
  transforms and the reconstruction of every full superblock.  The host
  then adopts the device recon, partition maps and per-block records
  (_install_wavefront), decides the partial-superblock band below the last
  full SB row from the device's band RD maps (_bake_band_decisions), codes
  the band blocks in a first (throwaway) pass with host MC, pushing every
  decision into the native BlockCache next to the device SBs' records, and
  replays everything through the C++ inter SB walker
  (encode_inter_sb_cached) in pass B, after the in-loop filters.
- The host inter path: every other frame, among them the pyramid and
  multi-reference frames of the default configuration (low_latency=False)
  and frames without a full superblock.  The ME map of each reference is
  K10 over the edge-padded reference (frame_me_map; none under 320x240,
  where the diamond search runs instead), the frame's interpolation filter
  comes from a subpel probe, and the block decisions (single-reference and
  compound candidates, the merge-to-64 and partition trials) are numpy on
  the host, coded by IntraFrameEncoder's host walk.  The filters are the
  host filter path: the deblock, CDEF on the device after it (K5, K6) and
  the loop-restoration decision with K8's frame mode.

A device failure raises on both paths: neither stands in for the other.
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.entropy import coeffs as cf
from rav1e_tpu_torch.models import mv_pred as mvp
from rav1e_tpu_torch.models.intra_frame import IntraFrameEncoder, scan_for
from rav1e_tpu_torch.ops import intra_np as ip
from rav1e_tpu_torch.ops import mc_np as mc
from rav1e_tpu_torch.ops import quantize_np as qz
from rav1e_tpu_torch.ops import transforms_np as tf

# YMode values (spec enum, after the 13 intra modes)
NEARESTMV = 13
NEARMV = 14
GLOBALMV = 15
NEWMV = 16

# compound modes (coded as inter_compound_mode = YMode - NEAREST_NEARESTMV)
NEAREST_NEARESTMV = 17
NEAR_NEARMV = 18
NEAREST_NEWMV = 19
NEW_NEARESTMV = 20
NEAR_NEWMV = 21
NEW_NEARMV = 22
GLOBAL_GLOBALMV = 23
NEW_NEWMV = 24


# spec Compound_Mode_Ctx_Map, rows by RefMvContext >> 1, columns by
# Min(NewMvContext, COMP_NEWMV_CTXS - 1)
_COMP_MODE_CTX_MAP = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4), (4, 4, 5, 6, 7))


def comp_mode_cdf_ctx(new_mv_context: int, ref_mv_context: int) -> int:
    """Context for the inter_compound_mode cdf row (spec: the compound
    arm of the mode context).  The JAX package's copy
    (rav1e_tpu/models/inter_frame.py:38) is a formula fitted to the cells
    it checked against libdav1d; it agrees with the table on every
    reachable cell but one: no close match and two far matches
    (NewMvContext 1, RefMvContext 2), where it gives 1 and the table 2,
    and libdav1d then misreads the compound mode."""
    return _COMP_MODE_CTX_MAP[ref_mv_context >> 1][min(new_mv_context, 4)]


# per-list decomposition of a compound mode (spec get_mode)
_COMP_MODE_LISTS = {
    NEAREST_NEARESTMV: (NEARESTMV, NEARESTMV),
    NEAR_NEARMV: (NEARMV, NEARMV),
    NEAREST_NEWMV: (NEARESTMV, NEWMV),
    NEW_NEARESTMV: (NEWMV, NEARESTMV),
    NEAR_NEWMV: (NEARMV, NEWMV),
    NEW_NEARMV: (NEWMV, NEARMV),
    GLOBAL_GLOBALMV: (GLOBALMV, GLOBALMV),
    NEW_NEWMV: (NEWMV, NEWMV),
}


def size_group(bw: int, bh: int) -> int:
    """spec Size_Group[bsize] (for the y_mode cdf in inter frames): the
    table follows the MIN dimension (rect blocks group with their shorter
    side's square)."""
    return max(0, min(3, int(np.log2(min(bw, bh))) - 2))


class InterFrameEncoder(IntraFrameEncoder):
    """Encodes one inter frame with single-reference or compound
    prediction per block, choosing among the given references (LAST and,
    in pyramid groups, GOLDEN/LAST2/BWDREF/ALTREF).  refs: {ref_id: [Y, U,
    V]} reconstruction planes at the REAL frame size (the decoder's refs),
    or a bare [Y, U, V] list meaning {LAST: planes}."""

    def __init__(self, width, height, q_idx, refs, bit_depth=8, adapt_cdf=True,
                 speed=6, use_native=True, init_cdf=None,
                 lf_levels=(0, 0, 0, 0), lf_sharpness=0, cdef_damping=0,
                 tile_cols_log2=0, tile_rows_log2=0, tune="psnr",
                 chroma_sampling=(1, 1), speed_settings=None, device="cuda"):
        super().__init__(width, height, q_idx, bit_depth=bit_depth,
                         adapt_cdf=adapt_cdf, speed=speed, use_native=use_native,
                         device_modes=None, init_cdf=init_cdf,
                         lf_levels=lf_levels, lf_sharpness=lf_sharpness,
                         cdef_damping=cdef_damping,
                         tile_cols_log2=tile_cols_log2,
                         tile_rows_log2=tile_rows_log2, tune=tune,
                         chroma_sampling=chroma_sampling,
                         speed_settings=speed_settings, device=device)
        if not isinstance(refs, dict):
            refs = {mvp.LAST_FRAME: refs}
        self.refs = {
            rid: [np.asarray(p, np.int32) for p in planes]
            for rid, planes in refs.items()
        }
        self.ref_ids = sorted(self.refs)
        # temporal side per ref (order-hint sign bias); set by the pipeline
        self.sign_bias = {rid: 0 for rid in self.ref_ids}
        # inter partition RD: NONE-vs-SPLIT trials at the 32 level; the
        # chosen (ref, mode, idx) replays at coding time with MVs
        # re-derived from the coding-time MV stack
        self.rdo_partition = speed <= 7
        self._pending_inter: dict = {}
        # compound prediction (reference_select=1): set by the pipeline
        # when the ref set spans both temporal sides
        self.reference_select = False
        self.comp_search = speed <= 8  # evaluate compound candidates in RD
        self.near_search = speed <= 7  # NEARMV / NEAR_NEARMV DRL candidates
        # restrictable candidate set
        self.comp_modes_allowed = (NEAREST_NEARESTMV, GLOBAL_GLOBALMV,
                                   NEW_NEWMV, NEAR_NEARMV, NEAREST_NEWMV,
                                   NEW_NEARESTMV)
        self.comp_block_count = 0  # compound blocks coded
        self.me_range = 16  # full-pel radius of the diamond search (px)
        # frame-level interpolation filter (signaled in the frame header),
        # chosen by the subpel probe (_choose_interp_filter) on the host
        # path; the device MC of the inter wavefront evaluates REGULAR
        self.interp_filter = mc.FILTER_REGULAR
        self.filter_search = speed <= 8
        self.use_satd_subpel = (speed_settings.use_satd_subpel
                                if speed_settings is not None else speed <= 8)

    def _pre_encode(self) -> None:
        self.grid = mvp.MiGrid(self.mi_rows, self.mi_cols)
        self._m64 = {}  # (x, y) -> cached merge-to-64 decision
        # the inter wavefront envelope: the whole coding datapath (ME + MC
        # + RD + transforms + recon) runs on the device for
        # single-LAST-reference 8-bit 4:2:0 lossy frames
        self.wf_inter = bool(
            self.device_modes and self.use_native and self.q > 0
            and self.bd == 8 and self._is420
            and not self.reference_select
            and self.ref_ids == [mvp.LAST_FRAME])
        self._band_rd = None
        self._me_maps = {}
        if self.wf_inter:
            # the pass computes its own ME map (_install_wavefront) and its
            # MC evaluates the REGULAR filter set only
            return
        self._compute_me_maps()
        if self.filter_search:
            with self.stats.stage("interp_probe"):
                self._choose_interp_filter()

    def _compute_me_maps(self) -> None:
        """The device full-pel ME map of each reference (frame_me_map, K10)
        for the host decision paths; none under 320x240, where
        _motion_search runs the diamond search instead."""
        if self._me_maps or self.out_w * self.out_h < 320 * 240:
            return
        from rav1e_tpu_torch.models.device_pipeline import frame_me_map

        with self.stats.stage("me_maps"):
            self._me_maps = {rid: frame_me_map(
                self.src[0], self._padded_ref(rid), 32, bit_depth=self.bd,
                device=self.device) for rid in self.ref_ids}

    def _padded_ref(self, rid: int) -> np.ndarray:
        """The reference's luma edge-padded to the source's (64-aligned)
        shape."""
        ref = self.refs[rid][0]
        pad = np.zeros_like(self.src[0])
        rh, rw = ref.shape
        pad[:rh, :rw] = ref
        pad[:rh, rw:] = ref[:, -1:]
        pad[rh:, :] = pad[rh - 1 : rh, :]
        return pad

    # -- inter wavefront (device datapath) ----------------------------------

    def _wf_capable(self) -> bool:
        return bool(getattr(self, "wf_inter", False)
                    and getattr(self, "wavefront_mesh", None) is None)

    def _wavefront_eligible(self) -> bool:
        # prepare() asks before _pre_encode has set wf_inter
        if not getattr(self, "wf_inter", False):
            return False
        from rav1e_tpu_torch.models.wavefront import geometry_for

        return geometry_for(self.coded_w, self.coded_h, self.w, self.h,
                            self.mi_cols, self.mi_rows,
                            tuple(self._tile_grid())) is not None

    def _launch_band_maps(self) -> None:
        """Inter frames decide their band from the pass's own band tail
        (_bake_band_decisions); the intra band maps are not launched."""
        self._band_maps = None

    def _encode_tiles(self):
        if self._wf_launched is None:
            if self.wf_inter:
                # in the envelope, but the geometry has no full superblock:
                # the host path, with the ME maps _pre_encode skipped (the
                # interp filter stays REGULAR, as in the JAX package)
                self.wf_inter = False
                self._compute_me_maps()
            with self.stats.stage("host_walk"):
                return super()._encode_tiles()
        try:
            with self.stats.stage("device_wait"):
                wf = self._wf_launched.collect()
        finally:
            self._wf_launched = None
        self._install_wavefront(wf)
        if self.seg_map is None:
            return self._encode_tiles_native(wf)
        # with a segmentation map the installed pass result feeds the host
        # walk, which codes the segment ids (rav1e_tpu/models/inter_frame.py
        # _encode_tiles)
        with self.stats.stage("host_walk"):
            return super()._encode_tiles()

    def _encode_tiles_native(self, wf):
        """Native two-pass flow for wavefront inter frames: pass A fills the
        BlockCache — device SBs through the C++ record walk, band SBs
        through the python decide path (throwaway symbols, records pushed
        from _block) — and pass B replays everything through the C++ inter
        SB walker (encode_inter_sb_cached), including MV-stack
        re-derivation against the shared mi grid."""
        import time as _time

        from rav1e_tpu_torch.ec.native import NativeMsacEncoder

        tiles = self._tile_grid()
        frame_cdf = self.cdf
        self._frame_init_cdf = frame_cdf
        self._nbc.cache_start()
        self.cdf = frame_cdf.copy()  # throwaway basis for pass-A symbols
        self._wf_push_cache = True
        _t0 = _time.perf_counter()
        run: list = []

        def _flush_run():
            if run:
                self._apply_wf_stats(self._nbc.cache_push_wavefront(wf, run))
                run.clear()

        try:
            for (sc0, sr0, sc1, sr1) in tiles:
                self.tx0, self.ty0 = sc0 * 64, sr0 * 64
                self.tx1 = min(sc1 * 64, self.coded_w)
                self.ty1 = min(sr1 * 64, self.coded_h)
                self._reset_tile_contexts()
                self.enc = NativeMsacEncoder()
                for sy in range(self.ty0, self.ty1, 64):
                    for sx in range(self.tx0, self.tx1, 64):
                        if wf.geom.device_sb[sy // 64, sx // 64]:
                            run.append((sy // 64, sx // 64))
                        else:
                            _flush_run()
                            self._partition(sx, sy, 64)
                _flush_run()
        finally:
            self._wf_push_cache = False
        self.stats.stage_seconds["cache_build"] += _time.perf_counter() - _t0
        self.cdf = frame_cdf
        if self.lrf:
            self._lrf_native = True
            self._prefilter_rec = [p.copy() for p in self.rec]
            return None  # bytes come from pass B in _emit_tiles_lr
        self._nbc.cache_rewind()
        self._lr_replay = True
        try:
            with self.stats.stage("entropy"):
                tile_datas = self._run_tiles_native(lr_emit=False)
        finally:
            self._lr_replay = False
        if len(tile_datas) == 1:
            return tile_datas[0]
        out = b""
        for i, td in enumerate(tile_datas):
            if i < len(tile_datas) - 1:
                out += (len(td) - 1).to_bytes(4, "little")
            out += td
        return out

    def _reset_tile_contexts(self) -> None:
        super()._reset_tile_contexts()
        if self.wf_inter:
            # the C++ pass-B walk rebuilds the mi grid from scratch; the
            # MV-stack scans never cross tile bounds so a whole-grid reset
            # per tile start is decode-exact
            self.grid = mvp.MiGrid(self.mi_rows, self.mi_cols)

    def _push_cache_record(self, x, y, bw, bh, mode, skip, tt_sym, mvr, mvc,
                           lv_y, lv_u, lv_v) -> None:
        """Append one band block's decision to the native BlockCache in the
        pass-A walk (device SBs ride the C++ record push instead)."""
        hdr = np.asarray([x, y, bw, bh, mode, int(skip), tt_sym, 0,
                          int(mvr), int(mvc), 0, 0, 0, 0, 0], np.int32)
        if skip:
            self._nbc.cache_push_raw(np.ascontiguousarray(hdr))
            return
        parts = [hdr, np.asarray(lv_y, np.int32).ravel(),
                 np.asarray(lv_u, np.int32).ravel(),
                 np.asarray(lv_v, np.int32).ravel()]
        self._nbc.cache_push_raw(
            np.ascontiguousarray(np.concatenate(parts)))

    def _install_wavefront(self, wf) -> None:
        """Adopt a collected inter wavefront pass: the device recon becomes
        the frame recon, the partition decisions become _rd_maps (with
        coverage masks so the band SBs take their decisions from the band
        tail), the ME map and band RD maps feed the band's decisions, and
        the device-resident recon feeds the filter chain."""
        g = wf.geom
        self.rec = wf.rec
        sm = np.zeros((self.h // 32, self.w // 32), bool)
        smap = wf.split_map
        sm[: smap.shape[0], : smap.shape[1]] = smap
        dev = g.device_sb
        n64 = np.zeros((self.h // 64, self.w // 64), bool)
        n64[dev] = wf.none64[g.sb_step[dev], g.sb_lane[dev]]
        cov64 = np.zeros_like(n64)
        cov64[: dev.shape[0], : dev.shape[1]] = dev
        cov32 = np.repeat(np.repeat(cov64, 2, 0), 2, 1)
        self._rd_maps = {"split32": sm, "none64": n64,
                         "cover32": cov32, "cover64": cov64}
        self._me_maps[mvp.LAST_FRAME] = np.asarray(wf.me_map)
        self._band_rd = {64: wf.band64, 32: wf.band32, 16: wf.band16}
        self._bake_band_decisions(dev, sm, n64, cov32, cov64)
        # device-resident recon planes (Y, U, V) for the filter chain
        self._wf_dev_out = wf.dev_out

    def _bake_band_decisions(self, dev, sm, n64, cov32, cov64) -> None:
        """Resolve every band (host-coded partial-SB) partition + MV from
        the device band RD maps, as split/none64 map entries + pending
        decisions.  After this the maps fully determine the partition tree
        of the interior blocks (both the python pass-A walk and the C++
        pass-B walker read them)."""
        from rav1e_tpu_torch.models.wavefront import _QOFF, _SOFF

        b64, b32, b16 = (self._band_rd[64], self._band_rd[32],
                         self._band_rd[16])
        lam = self.lam
        for r in range(dev.shape[0]):
            for c_ in range(dev.shape[1]):
                if dev[r, c_]:
                    continue
                x0, y0 = c_ * 64, r * 64
                merged = False
                if (y0 // 4 + 8) < self.mi_rows and \
                        (x0 // 4 + 8) < self.mi_cols:
                    merged = (float(b64["cost"][r, c_])
                              + lam * self._B64_BLOCK_BITS
                              < float(b32["cost"][r, c_].sum())
                              + lam * (4 * self._B64_BLOCK_BITS
                                       + self._B64_SPLIT_BITS))
                if merged:
                    n64[r, c_] = True
                    mvs = b64["mv"][r, c_]
                    self._pending_inter[(x0, y0, 64, 64)] = (
                        mvp.LAST_FRAME, -1, (int(mvs[0]), int(mvs[1])), 0)
                    cov64[r, c_] = True
                    cov32[2 * r : 2 * r + 2, 2 * c_ : 2 * c_ + 2] = True
                    continue
                for q in range(4):
                    qx, qy = x0 + _QOFF[q][1], y0 + _QOFF[q][0]
                    if not ((qy // 4 + 4) < self.mi_rows
                            and (qx // 4 + 4) < self.mi_cols):
                        continue  # edge 32: forced HORZ/VERT at code time
                    split = (float(b16["cost"][r, c_, q].sum()) + lam * 10.0
                             < float(b32["cost"][r, c_, q]) + lam * 2.0)
                    sm[qy // 32, qx // 32] = split
                    cov32[qy // 32, qx // 32] = True
                    if split:
                        for s in range(4):
                            mvs = b16["mv"][r, c_, q, s]
                            self._pending_inter[
                                (qx + _SOFF[s][1], qy + _SOFF[s][0],
                                 16, 16)] = (mvp.LAST_FRAME, -1,
                                             (int(mvs[0]), int(mvs[1])), 0)
                    else:
                        mvs = b32["mv"][r, c_, q]
                        self._pending_inter[(qx, qy, 32, 32)] = (
                            mvp.LAST_FRAME, -1,
                            (int(mvs[0]), int(mvs[1])), 0)
                cov64[r, c_] = True

    # bit-overhead estimates for the merge-to-64 RD compare: per-block
    # mode-info cost (skip + is_inter + mode + ref + drl) and the partition
    # signaling a split adds
    _B64_BLOCK_BITS = 11.0
    _B64_SPLIT_BITS = 4.0

    def _pick_mode_for_mv(self, mv: tuple, res) -> tuple:
        """Cheapest codable (ymode, ref_mv_idx) for a device-chosen MV
        given the coding-time stack (the decoder re-derives non-NEW MVs
        from the stack, so the mode choice is pure rate optimization)."""
        if mv == (0, 0):
            return GLOBALMV, 0
        if res.num_mv_found >= 1 and mv == tuple(res.stack[0]):
            return NEARESTMV, 0
        for di in (1, 2):
            if res.num_mv_found > di and mv == tuple(res.stack[di]):
                return NEARMV, di
        return NEWMV, 0

    def _choose_interp_filter(self) -> None:
        """Frame-level REGULAR/SMOOTH/SHARP selection: SATD-refine a
        sample of 16x16 blocks to quarter-pel (same steps as
        _motion_search), then compare each filter's SAD at the refined
        subpel MVs.  Fullpel MVs see no filter at all, so only subpel
        samples vote; REGULAR keeps ties."""
        rid = self.ref_ids[0]
        me_map = self._me_maps.get(rid)
        totals = {mc.FILTER_REGULAR: 0, mc.FILTER_SMOOTH: 0,
                  mc.FILTER_SHARP: 0}
        n_sub = 0
        bs = 16
        step = max(32, ((self.out_w // 8) // 32) * 32)  # <= 8 sample cols
        for y in range(0, self.out_h - bs, max(32, step)):
            for x in range(0, self.out_w - bs, step):
                if me_map is not None:
                    m = me_map[min(y // 32, me_map.shape[0] - 1)][
                        min(x // 32, me_map.shape[1] - 1)]
                    best = (int(m[0]), int(m[1]))
                else:
                    best = (0, 0)
                best_cost = self._satd(rid, x, y, bs, bs, best)
                for st in (4, 2):
                    trial = best
                    for dr, dc in ((-st, 0), (st, 0), (0, -st), (0, st)):
                        mv = (trial[0] + dr, trial[1] + dc)
                        s = self._satd(rid, x, y, bs, bs, mv)
                        if s < best_cost:
                            best, best_cost = mv, s
                if best[0] % 8 == 0 and best[1] % 8 == 0:
                    continue  # fullpel: filter-invariant
                n_sub += 1
                src = self.src[0][y : y + bs, x : x + bs].astype(np.int64)
                for f in totals:
                    pred = mc.put_single(
                        self.refs[rid][0], x, y, bs, bs, best[0], best[1],
                        0, 0, self.bd, ref_w=self.out_w, ref_h=self.out_h,
                        filter_x=f, filter_y=f)
                    totals[f] += int(np.abs(src - pred).sum())
        if n_sub < 4:
            return
        best_f = min(totals, key=lambda f: (totals[f], f != mc.FILTER_REGULAR))
        if totals[best_f] < totals[mc.FILTER_REGULAR]:
            self.interp_filter = best_f

    # -- prediction ----------------------------------------------------------

    def _plane_geom(self, plane: int) -> tuple:
        """(sub_x, sub_y, ref_w, ref_h) for a prediction plane."""
        if plane == 0:
            return 0, 0, self.out_w, self.out_h
        return (self.sub_x, self.sub_y,
                (self.out_w + self.sub_x) >> self.sub_x,
                (self.out_h + self.sub_y) >> self.sub_y)

    def _mc_pred(self, rid: int, plane: int, px: int, py: int, w: int,
                 h: int, mv) -> np.ndarray:
        sx, sy, rw, rh = self._plane_geom(plane)
        f = self.interp_filter
        return mc.put_single(self.refs[rid][plane], px, py, w, h, mv[0], mv[1],
                             sx, sy, self.bd, ref_w=rw, ref_h=rh,
                             filter_x=f, filter_y=f)

    def _mc_pred_comp(self, rids, plane, px, py, w, h, mv_pair) -> np.ndarray:
        """Averaged compound prediction (spec 7.11.3.1 COMPOUND_AVERAGE)."""
        sx, sy, rw, rh = self._plane_geom(plane)
        f = self.interp_filter
        p0, p1 = (
            mc.put_prep(self.refs[rid][plane], px, py, w, h, mv[0], mv[1],
                        sx, sy, self.bd, ref_w=rw, ref_h=rh,
                        filter_x=f, filter_y=f)
            for rid, mv in zip(rids, mv_pair)
        )
        return mc.avg_compound(p0, p1, self.bd)

    def _thin_thr1(self, tw: int, th: int) -> float:
        """RD threshold for level-1 AC coefficient thinning, in the shifted
        coefficient domain: keep a +-1 only when the distortion it removes
        (alpha*q*(2|x|-q) in pixel SSE) beats its rate cost lam*r."""
        alpha = tf.tx_alpha(min(tw, 32), min(th, 32), self.bd)
        q = float(self.ac_q)
        r = self._thin_rate_bits
        return (self.lam * r / (alpha * q) + q) / 2.0

    def _code_inter_tx(self, plane, px, py, tw, th, pred):
        src = self.src[plane][py : py + th, px : px + tw]
        resid = (src - pred).astype(np.int32)
        thr1 = self._thin_thr1(tw, th)
        if max(tw, th) <= 32:
            return tf.fdct_quant_native(resid, tf.DCT_DCT, self.dc_q,
                                        self.ac_q, self.bd, thr1=thr1)
        coeffs = tf.forward_transform(resid, tf.DCT_DCT, self.bd)
        we, he = min(tw, 32), min(th, 32)
        coeffs[he:, :] = 0
        coeffs[:, we:] = 0
        levels = qz.quantize(coeffs, self.dc_q, self.ac_q, tw, th)
        shift = qz.tx_scale(tw, th)
        mag = np.abs(coeffs.astype(np.int64)) << shift
        drop = (np.abs(levels) == 1) & (mag < thr1)
        drop.flat[0] = False
        levels = np.where(drop, 0, levels)
        dq = qz.dequantize(levels, self.dc_q, self.ac_q, tw, th, self.bd)
        return levels[:he, :we], dq

    # -- motion search -------------------------------------------------------

    def _sad(self, rid, px, py, w, h, mv) -> int:
        pred = self._mc_pred(rid, 0, px, py, w, h, mv)
        src = self.src[0][py : py + h, px : px + w]
        return int(np.abs(src - pred).sum())

    def _satd(self, rid, px, py, w, h, mv) -> int:
        from rav1e_tpu_torch.ops.dist_np import satd

        pred = self._mc_pred(rid, 0, px, py, w, h, mv)
        return satd(self.src[0][py : py + h, px : px + w], pred)

    def _motion_search(self, rid, x, y, bw, bh, stack) -> tuple:
        """Full-pel candidates (the reference's ME map + MV stack
        predictors; a full-pel diamond search where the frame has no ME
        map), then quarter-pel refinement.  Returns (mv, sad), 1/8-pel
        even values."""
        cands = {(0, 0)}
        for mv in stack[:2]:
            cands.add(((mv[0] + 4) & ~7, (mv[1] + 4) & ~7))
        me_map = self._me_maps.get(rid)
        if me_map is not None:
            m = me_map[min(y // 32, me_map.shape[0] - 1)][
                min(x // 32, me_map.shape[1] - 1)]
            cands.add((int(m[0]), int(m[1])))
        best, best_sad = (0, 0), None
        for mv in cands:
            s = self._sad(rid, x, y, bw, bh, mv)
            if best_sad is None or s < best_sad:
                best, best_sad = mv, s
        if me_map is None:
            # frames under 320x240 have no ME map: a host diamond search
            step = 8 * 8
            while step >= 8:
                improved = True
                while improved:
                    improved = False
                    for dr, dc in ((-step, 0), (step, 0), (0, -step),
                                   (0, step)):
                        mv = (best[0] + dr, best[1] + dc)
                        if abs(mv[0]) > self.me_range * 64 or \
                                abs(mv[1]) > self.me_range * 64:
                            continue
                        s = self._sad(rid, x, y, bw, bh, mv)
                        if s < best_sad:
                            best, best_sad = mv, s
                            improved = True
                step >>= 1
        # subpel refinement at half- then quarter-pel (even 1/8 units; one
        # diamond round per step), skipped when the full-pel match is
        # already near-perfect; candidates ranked by SATD
        if self.use_satd_subpel and best_sad > bw * bh:
            best_cost = self._satd(rid, x, y, bw, bh, best)
            for step in (4, 2):
                trial = best
                for dr, dc in ((-step, 0), (step, 0), (0, -step), (0, step)):
                    mv = (trial[0] + dr, trial[1] + dc)
                    s = self._satd(rid, x, y, bw, bh, mv)
                    if s < best_cost:
                        best, best_cost = mv, s
            best_sad = self._sad(rid, x, y, bw, bh, best)
        return best, best_sad

    # -- merge-to-64 and partition trials (host path) --------------------------
    #
    # Wavefront frames never reach them: _bake_band_decisions decides every
    # band superblock into the cover maps _partition reads first.

    def _tile_mi(self) -> tuple:
        return (self.ty0 // 4, self.tx0 // 4,
                min(self.ty1, self.mi_rows * 4) // 4,
                min(self.tx1, self.mi_cols * 4) // 4)

    def _merge64_ok(self, x: int, y: int, has_rows: bool,
                    has_cols: bool) -> bool:
        """RD-decide whether the whole 64x64 SB codes better as ONE inter
        block than as the forced 32x32 split.  The trial shares one
        motion-compensated prediction: cost64 = dist + lam*(txb rate +
        one block's mode-info bits) vs the split proxy = per-quadrant
        32-tx dist/rate off the same prediction + 4 blocks' mode-info and
        partition bits.  A quadrant whose own ME motion materially beats
        the shared MV vetoes the merge (a real split would recover it)."""
        if not (has_rows and has_cols):
            return False
        dec = self._decide_inter(x, y, 64, 64, self._tile_mi())
        rid, mode, mv, idx, res = dec
        if mode is None:
            return False
        comp = isinstance(rid, tuple)
        if comp:
            pred_y = self._mc_pred_comp(rid, 0, x, y, 64, 64, mv)
        else:
            pred_y = self._mc_pred(rid, 0, x, y, 64, 64, mv)
        src = self.src[0][y : y + 64, x : x + 64].astype(np.int64)
        # quadrant motion veto (single-ref only: the ME map is per-ref)
        if not comp and self._me_maps.get(rid) is not None:
            m = self._me_maps[rid]
            for qy in (0, 32):
                for qx in (0, 32):
                    r0 = min((y + qy) // 32, m.shape[0] - 1)
                    c0 = min((x + qx) // 32, m.shape[1] - 1)
                    own = (int(m[r0][c0][0]), int(m[r0][c0][1]))
                    if own == mv:
                        continue
                    pq = pred_y[qy : qy + 32, qx : qx + 32]
                    sq = src[qy : qy + 32, qx : qx + 32]
                    sad_shared = int(np.abs(sq - pq).sum())
                    sad_own = self._sad(rid, x + qx, y + qy, 32, 32, own)
                    if sad_own * 8 < sad_shared * 7 - 512:
                        return False
        # 64-tx trial
        lv_y, dq_y = self._code_inter_tx(0, x, y, 64, 64, pred_y)
        lim = (1 << self.bd) - 1
        if lv_y.any():
            resid64 = tf.inverse_transform_native(dq_y, tf.DCT_DCT, self.bd)
            coded = np.clip(pred_y + resid64, 0, lim)
            rate64 = self._trial_rate_txb(0, x, y, 64, 64, lv_y, 0)
        else:
            coded = pred_y
            rate64 = 1.0
        d64 = coded - src
        cost64 = float((d64 * d64).sum()) + self.lam * (
            rate64 + self._B64_BLOCK_BITS)
        # split proxy: 32-tx per quadrant off the same prediction
        cost_split = self.lam * (4 * self._B64_BLOCK_BITS
                                 + self._B64_SPLIT_BITS)
        for qy in (0, 32):
            for qx in (0, 32):
                pq = pred_y[qy : qy + 32, qx : qx + 32].astype(np.int32)
                lv, dq = self._code_inter_tx(0, x + qx, y + qy, 32, 32, pq)
                sq = src[qy : qy + 32, qx : qx + 32]
                if lv.any():
                    r32 = tf.inverse_transform_native(dq, tf.DCT_DCT, self.bd)
                    cq = np.clip(pq + r32, 0, lim)
                    cost_split += self.lam * self._trial_rate_txb(
                        0, x + qx, y + qy, 32, 32, lv, 0)
                else:
                    cq = pq
                dq_ = cq - sq
                cost_split += float((dq_ * dq_).sum())
                if cost_split >= cost64:
                    break
            if cost_split >= cost64:
                break
        if cost64 > cost_split:
            return False
        self._m64[(x, y)] = dec
        return True

    def _trial_inter(self, x, y, bw, bh):
        """Decide + transform one inter-frame block as a partition trial.
        Writes the trial reconstruction into self.rec (later siblings'
        predictions read it; the caller restores around the whole trial).
        Returns (dist_sse, rate_bits, decision) where decision carries only
        what survives to coding time: (rid, mode, mv, ref_mv_idx)."""
        cx, cy = x >> self.sub_x, y >> self.sub_y
        cw, ch = bw >> self.sub_x, bh >> self.sub_y
        rid, mode, mv, idx, res = self._decide_inter(x, y, bw, bh,
                                                     self._tile_mi())
        is_inter = mode is not None
        if is_inter:
            mcf = (self._mc_pred_comp if isinstance(rid, tuple)
                   else self._mc_pred)
            pred_y = mcf(rid, 0, x, y, bw, bh, mv)
            pred_u = mcf(rid, 1, cx, cy, cw, ch, mv)
            pred_v = mcf(rid, 2, cx, cy, cw, ch, mv)
            lv_y, dq_y = self._code_inter_tx(0, x, y, bw, bh, pred_y)
            lv_u, dq_u = self._code_inter_tx(1, cx, cy, cw, ch, pred_u)
            lv_v, dq_v = self._code_inter_tx(2, cx, cy, cw, ch, pred_v)
            tt_y = tf.DCT_DCT
        else:
            y_mode = self._choose_mode(x, y, bw, bh)
            pred_y, lv_y, dq_y, tt_y = self._code_plane_tx(0, x, y, bw, bh,
                                                           y_mode)
            pred_u, lv_u, dq_u, _ = self._code_plane_tx(1, cx, cy, cw, ch,
                                                        ip.DC_PRED)
            pred_v, lv_v, dq_v, _ = self._code_plane_tx(2, cx, cy, cw, ch,
                                                        ip.DC_PRED)
        lim = (1 << self.bd) - 1
        planes = ((0, (x, y, bw, bh, pred_y, lv_y, dq_y)),
                  (1, (cx, cy, cw, ch, pred_u, lv_u, dq_u)),
                  (2, (cx, cy, cw, ch, pred_v, lv_v, dq_v)))
        skip = is_inter and self._skip_wins(planes)
        if skip:
            lv_y = np.zeros_like(lv_y)
            lv_u = np.zeros_like(lv_u)
            lv_v = np.zeros_like(lv_v)
        else:
            skip = not (lv_y.any() or lv_u.any() or lv_v.any())
        dist = 0
        rate = self._B64_BLOCK_BITS
        for plane, (px, py, tw, th, pred, lv, dq, tt) in (
            (0, (x, y, bw, bh, pred_y, lv_y, dq_y, tt_y)),
            (1, (cx, cy, cw, ch, pred_u, lv_u, dq_u, tf.DCT_DCT)),
            (2, (cx, cy, cw, ch, pred_v, lv_v, dq_v, tf.DCT_DCT)),
        ):
            if skip or not lv.any():
                coded = np.clip(pred, 0, lim).astype(np.int32)
                if not skip:
                    rate += self._trial_rate_txb(plane, px, py, tw, th, lv, 0)
            else:
                resid = tf.inverse_transform_native(dq, tt, self.bd)
                coded = np.clip(pred + resid, 0, lim).astype(np.int32)
                rate += self._trial_rate_txb(plane, px, py, tw, th, lv, 0)
            src = self.src[plane][py : py + th, px : px + tw].astype(np.int64)
            d = coded.astype(np.int64) - src
            dist += int((d * d).sum())
            self.rec[plane][py : py + th, px : px + tw] = coded
        return dist, rate, (rid, mode, mv, idx)

    def _skip_wins(self, planes) -> bool:
        """Skip-vs-code RD of a decided inter block with some nonzero
        level: is the residual worth its rate?  planes: ((plane, (px, py,
        tw, th, pred, levels, dequantised)), ...) for Y, U, V."""
        if not any(lv.any() for _, (*_, lv, _dq) in planes):
            return False
        dist_code = 0
        dist_skip = 0
        rate = 0.0
        for plane, (px, py, tw, th, pred, lv, dq) in planes:
            src = self.src[plane][py : py + th, px : px + tw].astype(np.int64)
            resid = tf.inverse_transform_native(dq, tf.DCT_DCT, self.bd)
            coded = np.clip(pred + resid, 0, (1 << self.bd) - 1)
            d = coded - src
            dist_code += int((d * d).sum())
            d0 = pred.astype(np.int64) - src
            dist_skip += int((d0 * d0).sum())
            if lv.any():
                rate += self._trial_rate_txb(plane, px, py, tw, th, lv, 0)
        return dist_skip + self.lam * 2.0 < dist_code + self.lam * rate

    def _rd_part(self, x: int, y: int, size: int, cdf_row) -> int:
        """Inter partition RD at one interior square: NONE vs SPLIT(4x
        half), plus HORZ/VERT rect halves when non_square_partition is on.
        Trials do not touch the MV grid (coding replays decisions against
        the true stacks).  Reference: rdo_partition_decision (src/rdo.rs).
        Compound-capable (reference_select) frames take NONE, as in the
        JAX package (its mixed 16/32 grids desync libdav1d there)."""
        if self.reference_select:
            return self.P_NONE
        half = size // 2
        cx, cy = x >> self.sub_x, y >> self.sub_y
        ccw, cch = size >> self.sub_x, size >> self.sub_y
        saves = [
            self.rec[0][y : y + size, x : x + size].copy(),
            self.rec[1][cy : cy + cch, cx : cx + ccw].copy(),
            self.rec[2][cy : cy + cch, cx : cx + ccw].copy(),
        ]

        def restore():
            self.rec[0][y : y + size, x : x + size] = saves[0]
            self.rec[1][cy : cy + cch, cx : cx + ccw] = saves[1]
            self.rec[2][cy : cy + cch, cx : cx + ccw] = saves[2]

        lam = self.lam
        children = {
            self.P_NONE: ((0, 0, size, size),),
            self.P_SPLIT: ((0, 0, half, half), (half, 0, half, half),
                           (0, half, half, half), (half, half, half, half)),
            self.P_HORZ: ((0, 0, size, half), (0, half, size, half)),
            self.P_VERT: ((0, 0, half, size), (half, 0, half, size)),
        }
        best = None  # (cost, part, decs)
        for part in (self.P_NONE, self.P_SPLIT) + self._rect_arms(size):
            dist = 0.0
            rate = self._sym_bits(cdf_row[:11], part)
            decs = {}
            for (dx, dy, bw, bh) in children[part]:
                d, r, dec = self._trial_inter(x + dx, y + dy, bw, bh)
                decs[(x + dx, y + dy, bw, bh)] = dec
                dist += d
                rate += r
                if part == self.P_SPLIT:
                    rate += 2.0  # child partition NONE symbols ~2 bits
            restore()
            cost = dist + lam * rate
            if best is None or cost < best[0]:
                best = (cost, part, decs)
        _, part, decs = best
        self._pending_inter.update(decs)
        return part

    # -- block decisions ---------------------------------------------------------

    def _replay_decision(self, pend, x, y, bw, bh, tile):
        """Re-derive a pending decision against the coding-time MV stack
        (non-NEW components come from the stack, like the decoder's own
        derivation): a device decision (a bare MV, mode -1) takes the
        cheapest codable mode for that MV; a partition-trial decision
        keeps its mode.  Returns the _decide_inter tuple, or None when the
        stack no longer supports the trial's mode/idx."""
        rid, mode, mv, idx = pend
        if mode is None:
            return None, None, None, 0, None
        res = mvp.find_mv_stack(self.grid, y // 4, x // 4, bw // 4, bh // 4,
                                rid, tile=tile, sign_bias=self.sign_bias)
        if mode == -1:
            mode2, idx2 = self._pick_mode_for_mv(tuple(mv), res)
            return rid, mode2, tuple(mv), idx2, res
        if isinstance(rid, tuple):
            s0 = tuple(res.stack[0])
            if mode == NEAREST_NEARESTMV:
                if res.num_mv_found < 1:
                    return None
                out = s0
            elif mode == GLOBAL_GLOBALMV:
                out = ((0, 0), (0, 0))
            elif mode == NEAR_NEARMV:
                if res.num_mv_found <= idx:
                    return None
                out = tuple(res.stack[idx])
            elif mode == NEAREST_NEWMV:
                out = (s0[0], mv[1])
            elif mode == NEW_NEARESTMV:
                out = (mv[0], s0[1])
            elif mode == NEW_NEWMV:
                out = mv
            else:
                return None
            return rid, mode, out, idx, res
        if mode == GLOBALMV:
            return rid, mode, (0, 0), 0, res
        if mode == NEARESTMV:
            if res.num_mv_found < 1:
                return None
            return rid, mode, tuple(res.stack[0]), 0, res
        if mode == NEARMV:
            if res.num_mv_found <= idx:
                return None
            return rid, mode, tuple(res.stack[idx]), idx, res
        if mode == NEWMV:
            return rid, mode, mv, idx, res
        return None

    def _decide_inter(self, x, y, bw, bh, tile):
        """Pick (rid, ymode, mv, ref_mv_idx, stack_res) for the block over
        every available reference and, on reference_select frames, every
        (forward, backward) compound pair; rid None means intra, a tuple
        rid a compound pair."""
        if bw == 64:
            cached = self._m64.pop((x, y), None)
            if cached is not None:
                return cached
        mr, mc_ = y // 4, x // 4
        best = None  # (cost, rid, mode, mv, idx, res)
        singles = {}  # rid -> (mv_me, sad_me) for compound reuse
        for rid in self.ref_ids:
            res = mvp.find_mv_stack(self.grid, mr, mc_, bw // 4, bh // 4,
                                    rid, tile=tile, sign_bias=self.sign_bias)
            mv_me, sad_me = self._motion_search(rid, x, y, bw, bh, res.stack)
            singles[rid] = (mv_me, sad_me)
            sad_zero = (self._sad(rid, x, y, bw, bh, (0, 0))
                        if mv_me != (0, 0) else sad_me)
            nearest = tuple(res.stack[0])
            # rate-bias: GLOBALMV cheapest, NEAREST close, NEW pays MV bits;
            # non-LAST refs pay an extra ref-bit bias
            ref_bias = 0 if rid == mvp.LAST_FRAME else 2 * bw // 8
            options = [(sad_zero + ref_bias, GLOBALMV, (0, 0), 0)]
            if res.num_mv_found >= 1 and nearest != (0, 0):
                sad_near = self._sad(rid, x, y, bw, bh, nearest)
                options.append((sad_near + 2 + ref_bias, NEARESTMV, nearest, 0))
            if self.near_search:
                for di in (1, 2):
                    if res.num_mv_found <= di:
                        break
                    near = tuple(res.stack[di])
                    if near == nearest or near == (0, 0):
                        continue
                    sad_n = self._sad(rid, x, y, bw, bh, near)
                    options.append((sad_n + 3 + di + ref_bias, NEARMV, near,
                                    di))
            if mv_me != (0, 0) and mv_me != nearest:
                options.append((sad_me + 3 * bw // 8 + ref_bias, NEWMV, mv_me,
                                0))
            options.sort(key=lambda o: o[0])
            cost, mode, mv, idx = options[0]
            if best is None or cost < best[0]:
                best = (cost, rid, mode, mv, idx, res)

        # compound (bidir average): candidate (forward, backward) ref pairs;
        # the prediction is the mean of both MC predictions
        if self.reference_select and min(bw, bh) >= 8 and self.comp_search:
            fwds = [r for r in self.ref_ids if r <= mvp.GOLDEN_FRAME]
            bwds = [r for r in self.ref_ids if r >= mvp.BWDREF_FRAME]
            src = self.src[0][y : y + bh, x : x + bw]
            for fr in fwds:
                for br in bwds:
                    pair = (fr, br)
                    resc = mvp.find_mv_stack(
                        self.grid, mr, mc_, bw // 4, bh // 4, pair,
                        tile=tile, sign_bias=self.sign_bias)
                    zero2 = ((0, 0), (0, 0))
                    s0 = tuple(resc.stack[0])
                    mvf, mvb = singles[fr][0], singles[br][0]
                    cands = [(NEAREST_NEARESTMV, s0, 2, 0)]
                    if s0 != zero2:
                        cands.append((GLOBAL_GLOBALMV, zero2, 0, 0))
                    # NEAR pairs: deeper stack entries
                    if self.near_search:
                        for di in (1, 2):
                            if resc.num_mv_found <= di:
                                break
                            sd = tuple(resc.stack[di])
                            if sd != s0 and sd != zero2:
                                cands.append((NEAR_NEARMV, sd, 3 + di, di))
                    # mixed NEAREST/NEW pairs: one searched MV, one predicted
                    if (s0[0], mvb) != s0:
                        cands.append((NEAREST_NEWMV, (s0[0], mvb),
                                      3 * bw // 8, 0))
                    if (mvf, s0[1]) != s0:
                        cands.append((NEW_NEARESTMV, (mvf, s0[1]),
                                      3 * bw // 8, 0))
                    if (mvf, mvb) != s0:
                        cands.append((NEW_NEWMV, (mvf, mvb), 6 * bw // 8, 0))
                    comp_bias = 3 * bw // 8  # two refs + compound mode bits
                    for cmode, cmv, mbias, cidx in cands:
                        if cmode not in self.comp_modes_allowed:
                            continue
                        pred = self._mc_pred_comp(pair, 0, x, y, bw, bh, cmv)
                        sad = int(np.abs(src - pred).sum())
                        cost = sad + mbias + comp_bias
                        if cost < best[0]:
                            best = (cost, pair, cmode, cmv, cidx, resc)
        cost, rid, mode, mv, idx, res = best
        # intra fallback: DC prediction beats motion?
        rec = self.rec[0]
        ha, hl = self._have_above(y), self._have_left(x)
        above, left = ip.build_edges(rec, x, y, bw, bh, ha, hl, self.bd,
                                     max_x=self.mi_cols * 4 - 1,
                                     max_y=self.mi_rows * 4 - 1)
        pred_dc = ip.predict(ip.DC_PRED, above, left, bw, bh, ha, hl, 0,
                             self.bd)
        sad_dc = int(np.abs(self.src[0][y : y + bh, x : x + bw]
                            - pred_dc).sum())
        if sad_dc + 4 * bw < cost:
            return None, None, None, 0, None  # intra
        return rid, mode, mv, idx, res

    def _write_ref_bits(self, sym, rid, ctxs) -> None:
        """Single-reference ref_frame coding (spec read_ref_frames single
        path): p1 fwd/bwd, then p3/p4 (forward) or p2/p6 (backward)."""
        if rid in (mvp.LAST_FRAME, mvp.LAST2_FRAME, mvp.LAST3_FRAME,
                   mvp.GOLDEN_FRAME):
            sym(0, self.cdf.single_ref[ctxs[1]][0])  # p1: forward group
            sym(0 if rid in (mvp.LAST_FRAME, mvp.LAST2_FRAME) else 1,
                self.cdf.single_ref[ctxs[3]][2])  # p3
            if rid in (mvp.LAST_FRAME, mvp.LAST2_FRAME):
                sym(0 if rid == mvp.LAST_FRAME else 1,
                    self.cdf.single_ref[ctxs[4]][3])  # p4
            else:
                sym(0 if rid == mvp.LAST3_FRAME else 1,
                    self.cdf.single_ref[ctxs[5]][4])  # p5
        else:
            sym(1, self.cdf.single_ref[ctxs[1]][0])  # p1: backward group
            sym(0 if rid in (mvp.BWDREF_FRAME, mvp.ALTREF2_FRAME) else 1,
                self.cdf.single_ref[ctxs[2]][1])  # p2
            if rid in (mvp.BWDREF_FRAME, mvp.ALTREF2_FRAME):
                sym(0 if rid == mvp.BWDREF_FRAME else 1,
                    self.cdf.single_ref[ctxs[6]][5])  # p6

    # -- block coding --------------------------------------------------------

    def _block(self, x: int, y: int, bw: int, bh: int) -> None:
        """Decide, code, reconstruct one block of the host walk: a pending
        decision (a device band decision or a partition trial's) replayed
        against the coding-time MV stack, else the host decision.  On a
        wavefront frame's pass A the symbols are throwaway and the decision
        is pushed into the native BlockCache for pass B."""
        cx, cy = x >> self.sub_x, y >> self.sub_y
        cw, ch = bw >> self.sub_x, bh >> self.sub_y
        tile = self._tile_mi()
        pend = self._pending_inter.pop((x, y, bw, bh), None)
        rep = (self._replay_decision(pend, x, y, bw, bh, tile)
               if pend is not None else None)
        if rep is None:
            rep = self._decide_inter(x, y, bw, bh, tile)
        rid, mode, mv, ref_mv_idx, res = rep
        is_inter = mode is not None
        if is_inter:
            if isinstance(rid, tuple):
                self.comp_block_count += 1
                mcf = self._mc_pred_comp
            else:
                mcf = self._mc_pred
            pred_y = mcf(rid, 0, x, y, bw, bh, mv)
            pred_u = mcf(rid, 1, cx, cy, cw, ch, mv)
            pred_v = mcf(rid, 2, cx, cy, cw, ch, mv)
            y_mode = mode
            tt_y = tf.DCT_DCT
            lv_y, dq_y = self._code_inter_tx(0, x, y, bw, bh, pred_y)
            lv_u, dq_u = self._code_inter_tx(1, cx, cy, cw, ch, pred_u)
            lv_v, dq_v = self._code_inter_tx(2, cx, cy, cw, ch, pred_v)
        else:
            y_mode = self._choose_mode(x, y, bw, bh)
            pred_y, lv_y, dq_y, tt_y = self._code_plane_tx(0, x, y, bw, bh,
                                                           y_mode)
            pred_u, lv_u, dq_u, _ = self._code_plane_tx(1, cx, cy, cw, ch,
                                                        ip.DC_PRED)
            pred_v, lv_v, dq_v, _ = self._code_plane_tx(2, cx, cy, cw, ch,
                                                        ip.DC_PRED)
        skip = not (lv_y.any() or lv_u.any() or lv_v.any())
        if is_inter and not skip and self._skip_wins(
                ((0, (x, y, bw, bh, pred_y, lv_y, dq_y)),
                 (1, (cx, cy, cw, ch, pred_u, lv_u, dq_u)),
                 (2, (cx, cy, cw, ch, pred_v, lv_v, dq_v)))):
            skip = True
            lv_y = np.zeros_like(lv_y)
            lv_u = np.zeros_like(lv_u)
            lv_v = np.zeros_like(lv_v)

        self._code_inter_symbols(x, y, bw, bh, rid, mode, mv, ref_mv_idx,
                                 res, y_mode, tt_y, skip, lv_y, lv_u, lv_v)
        if skip:
            dq_y = np.zeros_like(dq_y)
            dq_u = np.zeros_like(dq_u)
            dq_v = np.zeros_like(dq_v)
        self._reconstruct(0, x, y, pred_y, dq_y, tx_type=tt_y)
        self._reconstruct(1, cx, cy, pred_u, dq_u)
        self._reconstruct(2, cx, cy, pred_v, dq_v)
        if getattr(self, "_wf_push_cache", False):
            # pass A of the native two-pass flow: append the decision for
            # the C++ pass-B walker (mode 13 = inter with the MV in the
            # header; band blocks are single-reference LAST)
            if is_inter:
                self._push_cache_record(x, y, bw, bh, 13, skip, 1,
                                        mv[0], mv[1], lv_y, lv_u, lv_v)
            else:
                self._push_cache_record(x, y, bw, bh, y_mode, skip,
                                        self.TX_SET2_SYM.get(tt_y, 1),
                                        0, 0, lv_y, lv_u, lv_v)

    def _code_inter_symbols(self, x, y, bw, bh, rid, mode, mv, ref_mv_idx,
                            res, y_mode, tt_y, skip, lv_y, lv_u, lv_v):
        """All symbol coding + context updates for one decided inter-frame
        block."""
        mc_, mr = x // 4, y // 4
        n4w, n4h = bw // 4, bh // 4
        sym = self.enc.symbol_adapt if self.adapt else self.enc.symbol
        cx, cy = x >> self.sub_x, y >> self.sub_y
        cw, ch = bw >> self.sub_x, bh >> self.sub_y
        tile = self._tile_mi()
        is_inter = mode is not None
        is_comp = is_inter and isinstance(rid, tuple)

        self.db_info.set_block(x, y, bw, bh, skip)

        # --- mode info ---
        # skip_mode_present == 0 -> no skip_mode symbol
        skip_ctx = int(self.above_skip[mc_] + self.left_skip[mr])
        sym(1 if skip else 0, self.cdf.skip[skip_ctx])
        # read_cdef sits between skip and is_inter on inter frames
        self._cdef_hook(x, y, skip)

        ii_ctx = mvp.intra_inter_ctx(self.grid, mr, mc_, tile=tile)
        sym(1 if is_inter else 0, self.cdf.intra_inter[ii_ctx])

        if is_inter:
            # ref frames (spec read_ref_frames): when the header signals
            # reference_select, blocks of at least 8x8 code a comp_mode
            # symbol first (0 = single reference)
            counts = mvp.neighbor_ref_counts(self.grid, mr, mc_, tile=tile)
            ctxs = mvp.single_ref_ctxs(counts)
            if self.reference_select and min(bw, bh) >= 8:
                cm_ctx = mvp.comp_mode_ctx(self.grid, mr, mc_, tile=tile)
                sym(1 if is_comp else 0, self.cdf.comp_mode[cm_ctx])
            if is_comp:
                # BIDIR pair: comp_ref_type then fwd/bwd ref trees (spec
                # read_ref_frames compound arm)
                fr, br = rid
                sym(1, self.cdf.comp_ref_type[
                    mvp.comp_ref_type_ctx(self.grid, mr, mc_, tile=tile)])
                bit0 = 0 if fr in (mvp.LAST_FRAME, mvp.LAST2_FRAME) else 1
                sym(bit0, self.cdf.comp_ref[ctxs[3]][0])
                if bit0 == 0:
                    sym(1 if fr == mvp.LAST2_FRAME else 0,
                        self.cdf.comp_ref[ctxs[4]][1])
                else:
                    sym(1 if fr == mvp.GOLDEN_FRAME else 0,
                        self.cdf.comp_ref[ctxs[5]][2])
                bbit = 1 if br == mvp.ALTREF_FRAME else 0
                sym(bbit, self.cdf.comp_bwd_ref[ctxs[2]][0])
                if not bbit:
                    sym(1 if br == mvp.ALTREF2_FRAME else 0,
                        self.cdf.comp_bwd_ref[ctxs[6]][1])
            else:
                self._write_ref_bits(sym, rid, ctxs)

            if is_comp:
                # compound mode: one 8-ary symbol replaces the new/zero/ref
                # binary tree
                cm8 = comp_mode_cdf_ctx(res.new_mv_context, res.ref_mv_context)
                sym(mode - NEAREST_NEARESTMV, self.cdf.inter_compound_mode[cm8])
                modes01 = _COMP_MODE_LISTS[mode]
                if mode == NEW_NEWMV:
                    self._write_drl(sym, res, ref_mv_idx, (0, 1))
                elif NEARMV in modes01:
                    self._write_drl(sym, res, ref_mv_idx, (1, 2))
                # assign_mv: a NEW component codes its residual against the
                # chosen stack entry's per-list predictor
                for i in (0, 1):
                    if modes01[i] == NEWMV:
                        pos = ref_mv_idx if res.num_mv_found > 1 else 0
                        pm = res.stack[pos][i]
                        self._encode_mv(mv[i][0] - pm[0], mv[i][1] - pm[1])
            else:
                # inter mode tree
                sym(0 if mode == NEWMV else 1,
                    self.cdf.newmv[res.new_mv_context])
                if mode != NEWMV:
                    sym(0 if mode == GLOBALMV else 1,
                        self.cdf.zeromv[res.zero_mv_context])
                    if mode != GLOBALMV:
                        sym(0 if mode == NEARESTMV else 1,
                            self.cdf.refmv[res.ref_mv_context])
                # drl index
                if mode == NEWMV:
                    self._write_drl(sym, res, ref_mv_idx, (0, 1))
                elif mode == NEARMV:
                    self._write_drl(sym, res, ref_mv_idx, (1, 2))
                if mode == NEWMV:
                    pred_mv = res.stack[ref_mv_idx]
                    self._encode_mv(mv[0] - pred_mv[0], mv[1] - pred_mv[1])
        else:
            # intra in inter frame: y_mode over size-group cdf
            sym(y_mode, self.cdf.y_mode[size_group(bw, bh)])
            if min(bw, bh) >= 8 and y_mode in ip.DIRECTIONAL_MODES:
                sym(0 + 3, self.cdf.angle_delta[y_mode - ip.V_PRED])
            cfl_allowed = 1 if max(bw, bh) <= 32 else 0
            uv_cdf = self.cdf.uv_mode[cfl_allowed][y_mode]
            nsyms = 14 if cfl_allowed else 13
            sym(ip.DC_PRED, uv_cdf[: nsyms + 1])

        # --- residual ---
        if not skip:
            self._residual_any(0, x, y, bw, bh, lv_y, y_mode, is_inter, tt_y)
            self._residual_any(1, cx, cy, cw, ch, lv_u, y_mode, is_inter)
            self._residual_any(2, cx, cy, cw, ch, lv_v, y_mode, is_inter)
        else:
            for p, (px, py, tw, th) in (
                (0, (x, y, bw, bh)),
                (1, (cx, cy, cw, ch)),
                (2, (cx, cy, cw, ch)),
            ):
                self._update_coef_ctx(p, px, py, tw, th, 0, 0)

        # --- neighbor state ---
        c1 = min(mc_ + n4w, self.mi_cols)
        r1 = min(mr + n4h, self.mi_rows)
        self.above_skip[mc_:c1] = 1 if skip else 0
        self.left_skip[mr:r1] = 1 if skip else 0
        # blockDecoded bookkeeping (spec 7.11.2): later blocks' intra edge
        # availability must see exactly what the decoder has decoded so far
        self.mi_coded[mr : mr + n4h, mc_ : mc_ + n4w] = 1
        if is_comp:
            self.grid.set_block(
                mr, mc_, n4w, n4h, rid[0], mv[0],
                is_newmv=(NEWMV in _COMP_MODE_LISTS[mode]),
                ref2=rid[1], mv2=mv[1])
        elif is_inter:
            self.grid.set_block(mr, mc_, n4w, n4h, rid, mv,
                                is_newmv=(mode == NEWMV))
        else:
            self.grid.set_block(mr, mc_, n4w, n4h, mvp.INTRA_FRAME)

    def _write_drl(self, sym, res, ref_mv_idx, idxs) -> None:
        """drl_mode symbols for the DRL positions idxs ((0, 1) after a NEW
        mode, (1, 2) after a NEAR mode)."""
        for idx in idxs:
            if res.num_mv_found > idx + 1:
                bit = 1 if ref_mv_idx != idx else 0
                sym(bit, self.cdf.drl[mvp.drl_ctx(res.weights, idx)])
                if not bit:
                    break

    def _residual_any(self, plane, px, py, tw, th, levels, y_mode, is_inter,
                      tx_type=tf.DCT_DCT):
        """Residual coding with inter/intra tx-type signaling."""
        if not is_inter:
            self._residual(plane, px, py, tw, th, levels,
                           y_mode if y_mode < 13 else 0, tx_type=tx_type)
            return
        we, he = min(tw, 32), min(th, 32)
        ptype = 1 if plane else 0
        txs_ctx = cf.tx_size_ctx(tw, th)
        scan = scan_for(we, he)
        tctx = self._txb_skip_ctx(plane, px, py, tw, th)
        dctx = self._dc_sign_ctx(plane, px, py, tw, th)
        tx_type_row = None
        if plane == 0 and self.q > 0 and max(tw, th) <= 32:
            # inter + reduced_tx_set: EXT_TX_SET_DCT_IDTX {IDTX, DCT}; always
            # DCT_DCT = symbol 1, cdf indexed by square-size class.  64-dim
            # transforms are EXT_TX_SET_DCTONLY: no tx_type symbol
            txsqr = min(3, int(np.log2(min(tw, th))) - 2)
            tx_type_row = self.cdf.inter_tx_type_set3[txsqr]
        cul, dc_cat = self.enc.encode_txb(
            levels, scan, ptype, cf.TX_CLASS_2D, tctx, dctx, self.cdf,
            txs_ctx, adapt=self.adapt, tx_type_row=tx_type_row, tx_type_sym=1,
        )
        self._update_coef_ctx(plane, px, py, tw, th, cul, dc_cat)

    # -- MV residual coding (spec read_mv mirrored) ---------------------------

    def _encode_mv(self, d_row: int, d_col: int) -> None:
        sym = self.enc.symbol_adapt if self.adapt else self.enc.symbol
        joint = (2 if d_row else 0) | (1 if d_col else 0)
        sym(joint, self.cdf.mv_joint[0])
        if d_row:
            self._encode_mv_component(0, d_row)
        if d_col:
            self._encode_mv_component(1, d_col)

    def _encode_mv_component(self, comp: int, v: int) -> None:
        """allow_high_precision_mv=0, force_integer_mv=0: v must be even."""
        assert v != 0 and v % 2 == 0, v
        sym = self.enc.symbol_adapt if self.adapt else self.enc.symbol
        sign = 1 if v < 0 else 0
        mag = abs(v)
        sym(sign, self.cdf.mv_sign[comp])
        z = mag - 1
        if z < 16:
            sym(0, self.cdf.mv_class[comp])
            int_bit = z >> 3
            fr = (z >> 1) & 3
            sym(int_bit, self.cdf.mv_class0[comp])
            sym(fr, self.cdf.mv_class0_fp[comp][int_bit])
            # hp not coded (allow_high_precision_mv == 0), inferred 1
        else:
            cls = int(np.log2(z)) - 3
            sym(cls, self.cdf.mv_class[comp])
            d = z - (16 << (cls - 1))
            int_part = d >> 3
            for i in range(cls):
                sym((int_part >> i) & 1, self.cdf.mv_bits[comp][i])
            fr = (d >> 1) & 3
            sym(fr, self.cdf.mv_fp[comp])
