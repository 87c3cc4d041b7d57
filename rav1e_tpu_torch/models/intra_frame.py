"""Key-frame (intra) encoder: partition tree, mode info, residual coding,
in-loop reconstruction.

Reference analog: src/encoder.rs encode_tile / write_block +
src/context/block_unit.rs, rebuilt around this framework's split:
device-batchable analysis (mode costs, transforms) feeds a host entropy
pass that mirrors the decoder's context state machine exactly.

This first slice: fixed partition to 32x32, per-block intra mode chosen by
SAD over {DC, V, H, SMOOTH, PAETH}, 4:2:0, single tile, CDF adaptation
optional (frame header signals disable_cdf_update accordingly).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from rav1e_tpu_torch.ec.msac import MsacEncoder
from rav1e_tpu_torch.entropy.cdf import CdfContext
from rav1e_tpu_torch.entropy import coeffs as cf
from rav1e_tpu_torch.ops import intra_np as ip
from rav1e_tpu_torch.ops import quantize_np as qz
from rav1e_tpu_torch.ops import transforms_np as tf

_TBL = np.load(__file__.rsplit("/", 2)[0] + "/ops/av1_tables.npz")

# partition context bytes (above, left) per block size, from the AV1 spec
# (verified against the libaom binary's partition_context_lookup)
# below this coded area CDEF after the host deblock search takes the
# sampled host search (_cdef_search) and the device apply, as the JAX
# package does (its upload overhead beat its win there on the TPU)
DEV_CDEF_MIN_AREA = 640 * 480

_PART_CTX = {4: (31, 31), 8: (30, 30), 16: (28, 28), 32: (24, 24), 64: (16, 16)}
_PART_CTX_RECT = {
    (4, 4): (31, 31), (4, 8): (31, 30), (8, 4): (30, 31), (8, 8): (30, 30),
    (8, 16): (30, 28), (16, 8): (28, 30), (16, 16): (28, 28),
    (16, 32): (28, 24), (32, 16): (24, 28), (32, 32): (24, 24),
    (32, 64): (24, 16), (64, 32): (16, 24), (64, 64): (16, 16),
}

PARTITION_NONE = 0
PARTITION_SPLIT = 3

# Intra_Mode_Context (spec): mode -> neighbor context bucket
INTRA_MODE_CTX = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)

UV_CFL = 13  # UV_CFL_PRED uv-mode symbol (spec 5.11.42)

_SKIP_CONTEXTS = ((1, 2, 2, 2, 3), (1, 4, 4, 4, 5), (1, 4, 4, 4, 5),
                  (1, 4, 4, 4, 5), (1, 4, 4, 4, 6))


_SCAN_CACHE: dict = {}


def scan_for(w: int, h: int, tx_class: int = cf.TX_CLASS_2D) -> np.ndarray:
    key = (w, h, tx_class)
    s = _SCAN_CACHE.get(key)
    if s is None:
        kind = {cf.TX_CLASS_2D: "diag", cf.TX_CLASS_HORIZ: "col", cf.TX_CLASS_VERT: "row"}[tx_class]
        s = np.ascontiguousarray(_TBL[f"scan_{kind}_{w}x{h}"], dtype=np.int32)
        _SCAN_CACHE[key] = s
    return s


@dataclass
class PlaneCtx:
    """Per-plane above/left coefficient contexts, in 4-sample units."""

    above_cul: np.ndarray
    left_cul: np.ndarray
    above_dc: np.ndarray
    left_dc: np.ndarray

    @classmethod
    def new(cls, w4: int, h4: int) -> "PlaneCtx":
        return cls(
            np.zeros(w4, np.int32), np.zeros(h4, np.int32),
            np.zeros(w4, np.int32), np.zeros(h4, np.int32),
        )


class IntraFrameEncoder:
    """Encodes one key frame; exposes recon planes for conformance checks."""

    def __init__(self, width: int, height: int, q_idx: int, bit_depth: int = 8,
                 adapt_cdf: bool = True, speed: int = 6, use_native: bool = True,
                 device_modes: bool | None = None, init_cdf=None,
                 lf_levels=(0, 0, 0, 0), lf_sharpness: int = 0,
                 cdef_damping: int = 0, tile_cols_log2: int = 0,
                 tile_rows_log2: int = 0, tune: str = "psnr",
                 seg_deltas: tuple = (), chroma_sampling: tuple = (1, 1),
                 speed_settings=None, device="cuda"):
        self.tune = tune
        # torch device of the device passes (wavefront, band maps, chain)
        self.device = device
        # chroma subsampling: (1,1)=4:2:0, (1,0)=4:2:2, (0,0)=4:4:4
        self.sub_x, self.sub_y = chroma_sampling
        self._is420 = chroma_sampling == (1, 1)
        # segmentation AQ: SEG_LVL_ALT_Q per segment (empty = disabled)
        self.seg_deltas = tuple(seg_deltas)
        self.tile_cols_log2 = tile_cols_log2
        self.tile_rows_log2 = tile_rows_log2
        self.init_cdf = init_cdf  # primary-ref CDF inheritance (None: defaults)
        self.lf_levels = tuple(lf_levels)
        self.lf_sharpness = lf_sharpness
        self.cdef_damping = cdef_damping  # 0: CDEF off; 3..6 per spec
        self.cdef_sb = None  # (bits, y_codes, uv_codes, idx_map) per-SB CDEF
        self._cdef_done = None  # per-SB "cdef_idx emitted" map (read_cdef)
        self.lrf = False  # loop restoration (Wiener, luma); set by pipeline
        self.use_native = use_native
        self.out_w = width
        self.out_h = height
        # the mi grid is 8-px aligned (spec MiCols = 2*((w+7)>>3)); pixels
        # beyond the real frame are coded but cropped at output.  Work
        # buffers are superblock-aligned because edge blocks may legally
        # overhang the mi grid (their transforms are coded in full).
        self.mi_cols = 2 * ((width + 7) >> 3)
        self.mi_rows = 2 * ((height + 7) >> 3)
        self.coded_w = self.mi_cols * 4
        self.coded_h = self.mi_rows * 4
        self.w = (self.coded_w + 63) & ~63
        self.h = (self.coded_h + 63) & ~63
        self.q = q_idx
        self.bd = bit_depth
        self.adapt = adapt_cdf
        self.speed = speed
        self.dc_q = qz.dc_q(q_idx, 0, bit_depth)
        self.ac_q = qz.ac_q(q_idx, 0, bit_depth)
        # RD lambda (SSE per bit) with the AV1 quantizer step ~ dc_q/8 in
        # pixel units.  Multiplier follows the reference (src/rate.rs
        # QuantizerParameters: lambda = ln2/6 * qstep^2); overridable for
        # calibration experiments via RAV1E_TPU_LAMBDA_MULT.
        import os as _os
        _lm = float(_os.environ.get("RAV1E_TPU_LAMBDA_MULT", "0.1155"))
        self.lam = _lm * (self.dc_q / 8.0) ** 2
        # approximate bits a lone +-1 AC coefficient costs (sign + base +
        # scan-position overhead); drives RD coefficient thinning
        self._thin_rate_bits = float(
            _os.environ.get("RAV1E_TPU_THIN_RATE", "4.0"))
        # per-feature toggles: honor an explicit SpeedSettings when given
        # (reference: speedsettings.rs fields), else derive from the preset
        ss = speed_settings
        if ss is not None:
            pmin, pmax = ss.partition_range
            # leaf sizes here are {16, 32}: RD split only when both sides
            # of the decision are inside the allowed partition range
            self.rdo_partition = (ss.speed <= 8 and pmin <= 16 and pmax >= 32)
            # 64x64 root blocks (PARTITION_NONE at the SB): intra device
            # wavefront trial; reference walks to BLOCK_64X64 in
            # rdo_partition_decision (src/rdo.rs)
            self.rdo_none64 = (self.rdo_partition and pmax >= 64
                               and type(self) is IntraFrameEncoder)
            # 8x8 leaves: thorough speeds only (host RD trials; the device
            # wavefront covers the 16/32 range)
            self.rdo_split8 = (ss.speed <= 3 and pmin <= 8
                               and type(self) is IntraFrameEncoder)
            # interior rectangular partitions (HORZ/VERT) in the host RD
            # path; reference: the non_square_partition preset gating
            # rdo_partition_decision's rect arms (src/rdo.rs)
            self.rect_parts = ss.non_square_partition and self.rdo_partition
            self.tx_type_search = ss.rdo_tx_decision
            self.fine_dir = ss.fine_directional_intra
            self.lf_search = ss.speed <= 5 and not ss.fast_deblock
            complex_pred = ss.prediction_modes != "simple"
            self.cfl_search = complex_pred and self._is420
            self.uv_search = complex_pred or ss.speed <= 7
            self.sgr_search = ss.speed <= 5
        else:
            self.rdo_partition = speed <= 8
            self.rdo_none64 = (self.rdo_partition
                               and type(self) is IntraFrameEncoder)
            self.rdo_split8 = (speed <= 3
                               and type(self) is IntraFrameEncoder)
            self.rect_parts = speed <= 3 and self.rdo_partition
            self.tx_type_search = speed <= 7  # reference: rdo_tx_decision
            self.sgr_search = speed <= 5  # reference: sgr_complexity preset
            # CFL chroma (reference: ComplexKeyframes prediction set);
            # the CFL AC path here is 4:2:0 only
            self.cfl_search = speed <= 5 and self._is420
            # uv-mode RD race beyond DC (reference: the chroma arm of
            # rdo_mode_decision runs at every speed; gated here like tx RD)
            self.uv_search = speed <= 7
            # D45/D67/D203 + angle deltas (reference: fine_directional_intra)
            self.fine_dir = speed <= 7
            # deblock level search vs from-q model (reference: fast_deblock)
            self.lf_search = speed <= 5
        self._scratch = None
        from rav1e_tpu_torch.utils.stats import EncoderStats

        self.stats = EncoderStats(frames=1)
        # device mode analysis: batched evaluation of all candidate
        # modes for all blocks in one pass; auto-on for larger frames
        if device_modes is None:
            device_modes = width * height >= 320 * 240
        self.device_modes = device_modes
        self._mode_maps = None

    def encode(self, planes: list) -> tuple:
        """planes: [Y, U, V] uint8/16 arrays at the REAL frame size.
        Returns (tile_bytes, recon) with recon cropped to the real size."""
        self.phase1(planes)
        return self._finish_encode()

    def phase1(self, planes: list) -> None:
        """Device-heavy phase: collect the wavefront output, build the
        block cache, and ENQUEUE the in-loop filter chain (no wait).
        Idempotent.  The orchestration runs phase1 for every frame of a
        batched launch back-to-back so all their device work queues ahead
        of any frame's host entropy pass (SURVEY 2.6 pipelining)."""
        if getattr(self, "_phase1_done", False):
            return
        if not getattr(self, "_prepared", False):
            with self.stats.stage("prepare"):
                self.prepare(planes)
        self._p1_data = self._encode_tiles()
        self._chain_launch = None
        # the device chain filters the recon of a wavefront pass (the JAX
        # package gates it on the pass's device-resident source,
        # filter_chain_jax.py:315); frames coded by the host walk take the
        # host filter path of _finish_encode
        if (getattr(self, "_wf_dev_out", None) is not None
                and not (self.lf_search and any(self.lf_levels))):
            from rav1e_tpu_torch.ops.filter_chain import launch_filter_chain

            with self.stats.stage("filters"):
                self._chain_launch = launch_filter_chain(self)
        self._phase1_done = True

    def _fire_prefetch(self) -> None:
        """Lookahead-overlap hook: enqueue the NEXT frame's device pass so
        it executes while this frame's host entropy pass runs (SURVEY 2.6
        lookahead pipelining).  Fired after THIS frame's last device use —
        enqueueing earlier would put the next wavefront ahead of this
        frame's filter chain in the device's queue."""
        cb = getattr(self, "_after_launch", None)
        if cb is not None:
            self._after_launch = None
            cb()

    def prepare(self, planes: list, launch: bool = True) -> None:
        """Frame setup + async device-pass launch: pad sources, init CDFs
        and per-frame maps, and enqueue the wavefront device encode (which
        returns immediately under JAX async dispatch).  launch=False does
        the host setup only — the caller attaches a (batched) wavefront
        handle to _wf_launched itself (pipeline.prefetch_key_frames)."""
        w, h, bd = self.w, self.h, self.bd
        # pad source planes to coded (mi-aligned) dims by edge replication
        self.src = []
        for i, p in enumerate(planes):
            cw = w if i == 0 else w >> self.sub_x
            ch = h if i == 0 else h >> self.sub_y
            a = np.zeros((ch, cw), np.int32)
            ph, pw = p.shape
            a[:ph, :pw] = p
            a[:ph, pw:] = p[:, -1:]
            a[ph:, :] = a[ph - 1 : ph, :]
            self.src.append(a)
        self.rec = [np.zeros_like(s) for s in self.src]
        self.cdf = (
            self.init_cdf.copy(reset_counters=True)
            if self.init_cdf is not None
            else CdfContext(self.q)
        )
        if self.use_native:
            from rav1e_tpu_torch.ec.native import NativeMsacEncoder

            self.enc = NativeMsacEncoder()
        else:
            self.enc = MsacEncoder()

        # neighbor context state.  Arrays are SB-padded (like the decoder's)
        # because edge blocks legally overhang the mi grid and their context
        # writes/reads extend past it.
        pc = self.w // 4
        pr = self.h // 4
        self.above_part = np.zeros(pc, np.int32)
        self.left_part = np.zeros(pr, np.int32)
        self.above_mode = np.zeros(pc, np.int32)  # DC default
        self.left_mode = np.zeros(pr, np.int32)
        self.above_skip = np.zeros(pc, np.int32)
        self.left_skip = np.zeros(pr, np.int32)
        # decoder blockDecoded analog (luma, 4px units): gates above-right /
        # below-left intra edge availability
        self.mi_coded = np.zeros((pr, pc), np.uint8)
        self.pctx = [
            PlaneCtx.new(pc, pr),
            PlaneCtx.new(pc >> self.sub_x, pr >> self.sub_y),
            PlaneCtx.new(pc >> self.sub_x, pr >> self.sub_y),
        ]

        self._rd_maps = None
        if (self.device_modes and not self._wavefront_eligible()
                and not self.rdo_split8
                and type(self) is IntraFrameEncoder):
            from rav1e_tpu_torch.models.device_pipeline import frame_rd_maps

            rd = frame_rd_maps(self.src[0], self.dc_q, self.ac_q, self.lam)
            self._rd_maps = rd
            self._mode_maps = {32: rd[32], 16: rd[16]}

        # psychovisual tune: per-32x32 lambda from the source activity
        # mask (reference analog: src/activity.rs DistortionScale)
        self._lam_map = None
        if self.tune == "psychovisual":
            from rav1e_tpu_torch.models.activity import lambda_map

            self._lam_map = lambda_map(self.src[0], self.lam, 32)
        # temporal-RDO importance scale from the lookahead (inter frames;
        # reference analog: compute_block_importances -> DistortionScale)
        imp = getattr(self, "_imp_scale", None)
        if imp is not None:
            base = (self._lam_map if self._lam_map is not None
                    else np.full(imp.shape, self.lam))
            h2 = min(base.shape[0], imp.shape[0])
            w2 = min(base.shape[1], imp.shape[1])
            m = np.full(base.shape, self.lam) if self._lam_map is None else base
            m = m.copy()
            m[:h2, :w2] = base[:h2, :w2] / imp[:h2, :w2]
            self._lam_map = m

        # segmentation AQ: 32x32-aligned segment map from the activity
        # mask quartiles (every leaf block lies inside one aligned 32x32,
        # so the whole block shares one segment id like the decoder's
        # per-block assignment).  Reference analog: src/segmentation.rs.
        self.seg_map = None
        if self.seg_deltas:
            from rav1e_tpu_torch.models.activity import activity_mask

            nseg = len(self.seg_deltas)
            act = activity_mask(self.src[0])
            h8, w8 = act.shape
            hb, wb = h8 // 4, w8 // 4
            a32 = act[: hb * 4, : wb * 4].reshape(hb, 4, wb, 4).mean(axis=(1, 3))
            qs = np.quantile(a32, np.linspace(0, 1, nseg + 1)[1:-1]) if nseg > 1 else []
            seg32 = np.digitize(a32, qs).astype(np.uint8)
            # mi granularity (SB-padded)
            self.seg_map = np.zeros((self.h // 4, self.w // 4), np.uint8)
            m = np.repeat(np.repeat(seg32, 8, 0), 8, 1)
            self.seg_map[: m.shape[0], : m.shape[1]] = m
            self.seg_last = nseg - 1
            self.seg_coded = np.zeros_like(self.seg_map)
            base_lam_q = self.ac_q
            self._seg_q = []
            self._seg_lam = []
            for d in self.seg_deltas:
                qi = int(np.clip(self.q + d, 1, 255))
                self._seg_q.append((qz.dc_q(qi, 0, self.bd),
                                    qz.ac_q(qi, 0, self.bd)))
                self._seg_lam.append(
                    self.lam * (self._seg_q[-1][0] / self.dc_q) ** 2)
            self._lam_map = None  # the segment lambdas subsume activity AQ

        from rav1e_tpu_torch.ops.deblock_np import DeblockInfo

        self.db_info = DeblockInfo(self.h // 4, self.w // 4)
        self._pre_encode()
        self._pending = {}
        self._recon_only = False
        self._lr_replay = False
        # pass-A decision caches for the two-pass LR flows: python-path
        # blocks must REPLAY their pass-A decisions in pass B rather than
        # re-decide — between the passes the recon has been deblocked/
        # CDEF'd/restored, so re-run predictions (and adapted-CDF rate
        # reads) can silently diverge from the recon the decoder builds.
        # This is the python mirror of the native BlockCache (rav1e analog:
        # WriterRecorder replay, src/ec.rs).
        self._py_cache: dict = {}
        self._split_cache: dict = {}
        # native per-block coder (C++ hot loop); keyframe leaf blocks and
        # the inter wavefront's cache/replay passes.  A library that cannot
        # be built or loaded raises: the Python walk is another encoder
        # path, not a stand-in for this one
        self._nbc = None
        if self.use_native and self._is420 and (
                type(self) is IntraFrameEncoder
                or getattr(self, "wf_inter", False)):
            from rav1e_tpu_torch.ec.native_block import block_coder_for

            self._nbc = block_coder_for(self)
            if self._nbc is None:
                raise RuntimeError(
                    "the native block coder (native/block_intra.cc) is "
                    "missing from the port's native library")
        self._wf_launched = None
        if launch and self._wf_capable() and self._wavefront_eligible():
            if getattr(self, "wavefront_mesh", None) is not None:
                raise NotImplementedError(
                    "tile-sharded wavefront: ROADMAP queue 1 item 11")
            from rav1e_tpu_torch.models.wavefront import launch_wavefront

            self._wf_launched = launch_wavefront(self, self._tile_grid())
        self._launch_band_maps()
        self._prepared = True

    def _launch_band_maps(self) -> None:
        """Async device RD maps for the edge band the wavefront does not
        cover (partial superblocks at the frame's bottom/right): the host
        block path consumes these as its mode/split decisions instead of
        running per-block python RD trials."""
        self._band_maps = None
        wf = getattr(self, "_wf_launched", None)
        if wf is None or getattr(self, "wavefront_mesh", None) is not None:
            return
        g = wf.geom
        host_sb = ~g.device_sb
        if not host_sb.any():
            return
        from rav1e_tpu_torch.models.device_pipeline import launch_band_rd_maps

        bands = []
        # bottom band: rows where EVERY SB is host (partial bottom
        # rows); right band: partial right columns above that
        rows_all = host_sb.all(axis=1)
        r0 = int(np.argmax(rows_all)) if rows_all.any() \
            else g.device_sb.shape[0]
        if rows_all.any():
            bands.append((r0 * 64, 0, self.src[0][r0 * 64 : self.h, :]))
        if r0 > 0:
            cols_any = host_sb[:r0].any(axis=0)
            if cols_any.any():
                c0 = int(np.argmax(cols_any))
                bands.append((0, c0 * 64,
                              self.src[0][: r0 * 64, c0 * 64 : self.w]))
        self._band_maps = [
            launch_band_rd_maps(b, self.dc_q, self.ac_q, self.lam, y0, x0,
                                device=self.device)
            for (y0, x0, b) in bands]

    def _finish_encode(self) -> tuple:
        data = self._p1_data
        chain_done = False
        if self._chain_launch is not None:
            from rav1e_tpu_torch.ops.filter_chain import collect_filter_chain

            try:
                with self.stats.stage("filters"):
                    chain_done = collect_filter_chain(self, self._chain_launch)
            finally:
                self._chain_launch = None
        if chain_done:
            data2 = self._finish_lr(data)
            return data2
        if self.lf_search and any(self.lf_levels):
            with self.stats.stage("deblock_search"):
                self.lf_levels = self._deblock_search()
        if any(self.lf_levels):
            from rav1e_tpu_torch.ops.deblock_np import deblock_frame

            with self.stats.stage("deblock_host"):
                deblock_frame(self.rec, self.db_info, self.lf_levels,
                              self.lf_sharpness, self.bd, self.coded_w,
                              self.coded_h, sub_x=self.sub_x,
                              sub_y=self.sub_y)
        if self.lrf:
            # LR stripe boundaries read the pre-CDEF (deblocked) rows
            self._deblock_copy = [p.copy() for p in self.rec]
        self.cdef_strengths = None
        self.cdef_sb = None
        self._dev_db = self._dev_cdef = None
        self._dev_db_c = self._dev_cdef_c = None
        if self.cdef_damping:
            self._cdef_host()
        return self._finish_lr(data)

    def _cdef_host(self) -> None:
        """CDEF after the host deblock: the search and apply on the device
        at 640x480 and up, else the sampled host search and the device
        apply with its strengths."""
        from rav1e_tpu_torch.ops import cdef

        with self.stats.stage("cdef_host"):
            if (self.device_modes
                    and self.coded_w * self.coded_h >= DEV_CDEF_MIN_AREA):
                (self.cdef_strengths, (self._dev_db, self._dev_cdef),
                 self.cdef_sb) = cdef.cdef_search_apply_device(
                    self.rec, self.src, self.db_info.skip, self.cdef_damping,
                    self.bd, self.coded_w, self.coded_h,
                    sb_lam=(self.lam if self.lrf else None),
                    device=self.device)
            else:
                self.cdef_strengths = self._cdef_search()
                y_s, uv_s = self.cdef_strengths
                cdef.cdef_frame_device(
                    self.rec, self.db_info.skip, y_s >> 2,
                    [0, 1, 2, 4][y_s & 3], uv_s >> 2, [0, 1, 2, 4][uv_s & 3],
                    self.cdef_damping, self.bd, self.coded_w, self.coded_h,
                    device=self.device)

    def _finish_lr(self, data):
        """Loop restoration + output crop (shared by the host filter path
        and the device filter chain)."""
        if self.lrf:
            with self.stats.stage("lrf"):
                with self.stats.stage("lr_decide"):
                    self._lr_decide()
                self._fire_prefetch()  # after this frame's last device use
                with self.stats.stage("lr_emit"):
                    data = self._emit_tiles_lr()
                with self.stats.stage("lr_apply"):
                    self._lr_apply()
        else:
            self._fire_prefetch()
        ch = (self.out_h + self.sub_y) >> self.sub_y
        cw = (self.out_w + self.sub_x) >> self.sub_x
        recon = [
            self.rec[0][: self.out_h, : self.out_w],
            self.rec[1][:ch, :cw],
            self.rec[2][:ch, :cw],
        ]
        return data, recon

    def _pre_encode(self) -> None:
        """Hook for subclasses (inter: mi-grid MV state init)."""

    def _set_block_q(self, mr: int, mc: int) -> None:
        """Per-block quantizer/lambda from the segment map (no-op when
        segmentation is off)."""
        if self.seg_map is None:
            return
        sid = int(self.seg_map[mr, mc])
        self.dc_q, self.ac_q = self._seg_q[sid]
        self.lam = self._seg_lam[sid]

    @staticmethod
    def _neg_interleave(x: int, ref: int, mx: int) -> int:
        """Encoder inverse of the spec's neg_deinterleave (5.11.38)."""
        if ref == 0:
            return x
        if ref >= mx - 1:
            return mx - 1 - x
        if 2 * ref < mx:
            if x <= 2 * ref:
                d = x - ref
                return 2 * (x - ref) - 1 if d > 0 else 2 * (ref - x)
            return x
        if abs(x - ref) <= mx - ref - 1 and ref - (mx - ref - 1) <= x:
            d = x - ref
            return 2 * (x - ref) - 1 if d > 0 else 2 * (ref - x)
        return mx - 1 - x

    def _seg_pred_ctx(self, mr: int, mc: int) -> tuple:
        """(pred, ctx) for the spatial segment-id symbol (coded neighbor
        ids equal the planned map)."""
        au = self._have_above(mr * 4)
        al = self._have_left(mc * 4)
        pu = int(self.seg_coded[mr - 1, mc]) if au else -1
        pl = int(self.seg_coded[mr, mc - 1]) if al else -1
        pul = int(self.seg_coded[mr - 1, mc - 1]) if (au and al) else -1
        if pul < 0:
            ctx = 0
        elif pul == pu and pul == pl:
            ctx = 2
        elif pul == pu or pul == pl or pu == pl:
            ctx = 1
        else:
            ctx = 0
        if pu == -1:
            pred = 0 if pl == -1 else pl
        elif pl == -1:
            pred = pu
        else:
            pred = pu if pul == pu else pl
        return pred, ctx

    def _seg_symbol_args(self, mr: int, mc: int) -> tuple:
        """(symbol value, ctx, nsyms) for this block's segment id."""
        sid = int(self.seg_map[mr, mc])
        pred, ctx = self._seg_pred_ctx(mr, mc)
        symv = self._neg_interleave(sid, pred, self.seg_last + 1)
        # the alphabet is always the full 8-segment cdf (the lastActive
        # bound limits values, not the coded alphabet)
        return symv, ctx, 8

    def _seg_after_block(self, mr, mc, bw, bh, skip) -> None:
        """Record the decoder-visible segment id over the block's mi
        region: the coded id, or the spatial prediction for skip blocks
        (read_segment_id early-out)."""
        if skip:
            pred, _ = self._seg_pred_ctx(mr, mc)
            sid = pred
        else:
            sid = int(self.seg_map[mr, mc])
        self.seg_coded[mr : mr + bh // 4, mc : mc + bw // 4] = sid

    def _write_segment_id(self, mr: int, mc: int) -> None:
        symv, ctx, nsyms = self._seg_symbol_args(mr, mc)
        symf = self.enc.symbol_adapt if self.adapt else self.enc.symbol
        symf(symv, self.cdf.segment_id[ctx][: nsyms + 1])

    def _lam_for(self, x: int, y: int) -> float:
        """Effective RD lambda at a block position (activity-scaled when
        tune=psychovisual; shared by the python and native block paths)."""
        if self._lam_map is None:
            return self.lam
        return float(self._lam_map[min(y // 32, self._lam_map.shape[0] - 1),
                                   min(x // 32, self._lam_map.shape[1] - 1)])

    def _deblock_search(self) -> tuple:
        """Luma-SSE search for the deblock filter level around the from-q
        model value (reference analog: deblock_filter_optimize,
        src/deblock.rs); chroma follows the luma choice."""
        from rav1e_tpu_torch.ops.deblock_np import deblock_frame

        base = self.lf_levels[0]
        cands = sorted({0, max(0, base - 2), max(0, base - 1), base,
                        min(63, base + 1), min(63, base + 2)})
        src = self.src[0][: self.out_h, : self.out_w].astype(np.int64)
        best = None
        for lv in cands:
            trial = [self.rec[0].copy(), self.rec[1], self.rec[2]]
            if lv:
                deblock_frame([trial[0], None, None], self.db_info,
                              (lv, lv, 0, 0), self.lf_sharpness, self.bd,
                              self.coded_w, self.coded_h, luma_only=True)
            sse = int(((trial[0][: self.out_h, : self.out_w] - src) ** 2).sum())
            if best is None or sse < best[0]:
                best = (sse, lv)
        lv = best[1]
        return (lv, lv, lv, lv)

    # -- tiling (reference analog: src/tiling/tiler.rs) -----------------------

    def _tile_grid(self) -> list:
        """Uniform tile spacing (spec 5.9.15): [(sb_c0, sb_r0, sb_c1, sb_r1)]
        in superblock units, raster order."""
        sb_cols = (self.coded_w + 63) >> 6
        sb_rows = (self.coded_h + 63) >> 6
        ncols = 1 << self.tile_cols_log2
        nrows = 1 << self.tile_rows_log2
        tw = (sb_cols + ncols - 1) >> self.tile_cols_log2
        th = (sb_rows + nrows - 1) >> self.tile_rows_log2
        tiles = []
        for r0 in range(0, sb_rows, th):
            for c0 in range(0, sb_cols, tw):
                tiles.append((c0, r0, min(c0 + tw, sb_cols), min(r0 + th, sb_rows)))
        return tiles

    def _reset_tile_contexts(self) -> None:
        """Clear the neighbor context state for the current tile's region
        (the decoder's clear_above/left at tile start)."""
        c0, r0 = self.tx0 // 4, self.ty0 // 4
        c1, r1 = self.tx1 // 4, self.ty1 // 4
        self.above_part[c0:c1] = 0
        self.left_part[r0:r1] = 0
        self.above_mode[c0:c1] = 0
        self.left_mode[r0:r1] = 0
        self.above_skip[c0:c1] = 0
        self.left_skip[r0:r1] = 0
        self.mi_coded[r0:r1, c0:c1] = 0
        if self.seg_map is not None:
            self.seg_coded[r0:r1, c0:c1] = 0
        for p, ctx in enumerate(self.pctx):
            sx = 0 if p == 0 else self.sub_x
            sy = 0 if p == 0 else self.sub_y
            pc0, pc1 = (self.tx0 >> sx) // 4, ((self.tx1 >> sx) + 3) // 4
            pr0, pr1 = (self.ty0 >> sy) // 4, ((self.ty1 >> sy) + 3) // 4
            ctx.above_cul[pc0:pc1] = 0
            ctx.left_cul[pr0:pr1] = 0
            ctx.above_dc[pc0:pc1] = 0
            ctx.left_dc[pr0:pr1] = 0

    def _cdef_reset(self) -> None:
        """Arm per-64x64 read_cdef tracking for an encode/replay sweep.
        Active only when the deferred entropy pass exists (the LRF
        two-pass flow) — per-SB cdef_idx can only be interleaved there."""
        if self.lrf and self.cdef_damping:
            nsby, nsbx = -(-self.coded_h // 64), -(-self.coded_w // 64)
            self._cdef_done = np.zeros((nsby, nsbx), bool)
        else:
            self._cdef_done = None

    def _cdef_hook(self, x: int, y: int, skip) -> None:
        """read_cdef position (spec 5.11.56): at the first non-skip block
        of each 64x64 unit, record a cdef anchor (recording pass) or write
        the cdef_idx literal (replay pass with per-SB CDEF chosen)."""
        if skip or self._cdef_done is None:
            return
        r, c = y // 64, x // 64
        if self._cdef_done[r, c]:
            return
        if self._lr_replay:
            sb = self.cdef_sb
            if sb is not None:
                self.enc.literal(int(sb[3][r, c]), sb[0])
            self._cdef_done[r, c] = True
        else:
            anchor = getattr(self.enc, "cdef_anchor", None)
            if anchor is not None:
                anchor(r, c)
                self._cdef_done[r, c] = True

    def _cdef_write(self, enc, sb_row: int, sb_col: int) -> None:
        """Recorder-replay callback for cdef anchors."""
        sb = self.cdef_sb
        if sb is not None:
            enc.literal(int(sb[3][sb_row, sb_col]), sb[0])

    def _run_tiles_native(self, lr_emit: bool) -> list:
        """One native encode sweep over all tiles from the current self.cdf
        basis.  With lr_emit, read_lr symbols are written at each SB anchor
        (the two-pass LR flow: pass A decides filters from a throwaway
        sweep, pass B re-encodes — bit-identical block symbols since CDF
        evolution per table is unchanged — with LR params interleaved)."""
        from rav1e_tpu_torch.ec.native import NativeMsacEncoder

        tiles = self._tile_grid()
        frame_cdf = self.cdf
        datas = []
        for idx, (sc0, sr0, sc1, sr1) in enumerate(tiles):
            self.tx0, self.ty0 = sc0 * 64, sr0 * 64
            self.tx1 = min(sc1 * 64, self.coded_w)
            self.ty1 = min(sr1 * 64, self.coded_h)
            if len(tiles) > 1:
                self.cdf = frame_cdf.copy()
            else:
                self.cdf = frame_cdf
            # always reset neighbor contexts: pass B must start from the
            # same fresh state pass A had (single-tile included)
            self._reset_tile_contexts()
            self.enc = NativeMsacEncoder()
            if lr_emit:
                self._lr_ref = [[3, -7, 15], [3, -7, 15]]
                self._lr_ref_c = {p: [[3, -7, 15], [3, -7, 15]]
                                  for p in (1, 2)}
                self._sgr_ref = [-32, 31]
            # replay pass: the whole SB (partition symbols + cached block
            # symbols) runs in C++; python only interleaves read_lr
            fast = (self._lr_replay and self._nbc is not None
                    and self._rd_maps is not None)
            self._cdef_reset()
            sb_info = self.cdef_sb if self._lr_replay else None
            for sy in range(self.ty0, self.ty1, 64):
                for sx in range(self.tx0, self.tx1, 64):
                    if lr_emit:
                        self._lr_write(self.enc, sy // 64, sx // 64)
                    if fast:
                        if sb_info is not None:
                            self._nbc.replay_sb(
                                sx, sy, sb_info[0],
                                int(sb_info[3][sy // 64, sx // 64]))
                        else:
                            self._nbc.replay_sb(sx, sy)
                    else:
                        self._partition(sx, sy, 64)
            datas.append(self.enc.done())
            if idx == 0:
                self.cdf_saved = self.cdf  # context_update_tile_id == 0
        self.cdf = self.cdf_saved
        return datas

    def _wf_capable(self) -> bool:
        """Whether this encoder can CONSUME a wavefront result (the intra
        flow needs the native block coder for the cache/replay passes;
        the inter subclass overrides with its own gate)."""
        return self._nbc is not None

    def _wavefront_eligible(self) -> bool:
        """Whether the device wavefront encode applies to this frame: the
        full-SB region is non-empty and the frame is in the wavefront
        pass's envelope (8-bit 4:2:0, lossy, native coder available)."""
        if not (self.device_modes and self.use_native and self.q > 0
                and self.bd == 8 and self._is420
                and type(self) is IntraFrameEncoder):
            return False
        from rav1e_tpu_torch.models.wavefront import geometry_for

        return geometry_for(self.coded_w, self.coded_h, self.w, self.h,
                            self.mi_cols, self.mi_rows,
                            tuple(self._tile_grid())) is not None

    def _push_device_sb(self, wf, r: int, c: int) -> None:
        """Serialize one device superblock's wavefront records into the
        native BlockCache (decode order) and mark its mi region decoded."""
        parts = []
        for (x, y, bw, bh, mode, skip, tt, ha, hl, au, av, delta, uv,
             lvy, lvu, lvv) in wf.sb_records(r, c):
            from rav1e_tpu_torch.utils.stats import SET2_SYMBOL_NAMES

            self.stats.record_block(mode, bw, bh, skip,
                                    SET2_SYMBOL_NAMES[tt], uv == UV_CFL)
            seg_symv = seg_ctx = seg_nsyms = 0
            if self.seg_map is not None:
                mr, mc = y // 4, x // 4
                seg_symv, seg_ctx, seg_nsyms = self._seg_symbol_args(mr, mc)
                self._seg_after_block(mr, mc, bw, bh, skip)
            parts.append(np.asarray(
                [x, y, bw, bh, mode, int(skip), tt, (ha << 1) | hl,
                 au, av, delta, seg_symv, seg_ctx, seg_nsyms, uv], np.int32))
            # deblock edge state now: the in-loop filters run before the
            # entropy pass B in the two-pass LR flow
            self.db_info.set_block(x, y, bw, bh, bool(skip))
            if not skip:
                parts.append(lvy.astype(np.int32).ravel())
                parts.append(lvu.astype(np.int32).ravel())
                parts.append(lvv.astype(np.int32).ravel())
        self._nbc.cache_push_raw(np.ascontiguousarray(np.concatenate(parts)))
        sy, sx = r * 64, c * 64
        self.mi_coded[sy // 4 : (sy + 64) // 4, sx // 4 : (sx + 64) // 4] = 1

    def _apply_wf_stats(self, st) -> None:
        """Fold the native cache-build's int64[26] stats vector into
        EncoderStats (bulk analog of per-block record_block calls)."""
        from rav1e_tpu_torch.utils.stats import MODE_NAMES, SET2_SYMBOL_NAMES

        s = self.stats
        for m in range(13):
            if st[m]:
                s.mode_counts[MODE_NAMES[m]] += int(st[m])
        for i, nm in ((13, "8x8"), (14, "16x16"), (15, "32x32"),
                      (20, "64x64")):
            if st[i]:
                s.bsize_counts[nm] += int(st[i])
        s.skip_blocks += int(st[16])
        s.cfl_blocks += int(st[17])
        # [21..25]: per-DTT4_IDTX-symbol counts (wavefront LUMA_TT order)
        for sym, nm in enumerate(SET2_SYMBOL_NAMES):
            if st[21 + sym]:
                s.tx_type_counts[nm] += int(st[21 + sym])
        if len(st) > 26 and st[26]:  # inter blocks (mode 13 records)
            s.mode_counts["INTER"] += int(st[26])
            s.tx_type_counts["DCT_DCT"] += int(st[26])
        s.blocks += int(st[19])

    def _encode_tiles_wavefront(self, wf):
        """Device wavefront flow: the coding datapath ran on device; here
        we (a) build the BlockCache in decode order — device SBs from the
        wavefront arrays, partial edge SBs through the native recon_only
        path — then (b) replay pass B (the adaptive entropy pass) through
        _run_tiles_native, sharing the two-pass LR machinery."""
        from rav1e_tpu_torch.ec.native import NativeMsacEncoder

        tiles = self._tile_grid()
        frame_cdf = self.cdf
        self._frame_init_cdf = frame_cdf
        self.rec = wf.rec  # device reconstruction (partial SBs filled below)
        sm = np.zeros((self.h // 32, self.w // 32), bool)
        smap = wf.split_map
        sm[: smap.shape[0], : smap.shape[1]] = smap
        self._rd_maps = {"split32": sm}
        smap16 = getattr(wf, "split16_map", None)
        if smap16 is not None and self.rdo_split8:
            sm16 = np.zeros((self.h // 16, self.w // 16), bool)
            sm16[: smap16.shape[0], : smap16.shape[1]] = smap16
            self._rd_maps["split16"] = sm16
        n64_full = getattr(wf, "none64_full", None)  # sharded facade
        n64_kb = getattr(wf, "none64", None)
        if n64_full is not None and getattr(self, "rdo_none64", False):
            n64 = np.zeros((self.h // 64, self.w // 64), bool)
            n64[: n64_full.shape[0], : n64_full.shape[1]] = n64_full
            self._rd_maps["none64"] = n64
        elif n64_kb is not None and getattr(self, "rdo_none64", False):
            g = wf.geom
            n64 = np.zeros((self.h // 64, self.w // 64), bool)
            dev = g.device_sb
            n64[dev] = n64_kb[g.sb_step[dev], g.sb_lane[dev]]
            self._rd_maps["none64"] = n64
        if getattr(self, "_band_maps", None):
            # edge-band device maps: mode + split decisions for the
            # partial SBs the host path codes (no python RD trials)
            # only HOST-path positions take band values: device SBs'
            # split decisions are the wavefront's (overwriting them
            # would desync the pass-A cache from the pass-B walk)
            dev = wf.geom.device_sb
            dev32 = np.zeros((self.h // 32, self.w // 32), bool)
            dev32[: dev.shape[0] * 2, : dev.shape[1] * 2] = np.repeat(
                np.repeat(dev, 2, 0), 2, 1)
            mm32 = np.zeros((self.h // 32, self.w // 32), np.int32)
            mm16 = np.zeros((self.h // 16, self.w // 16), np.int32)
            for bm in self._band_maps:
                m = bm.collect()
                yb, xb = bm.y0 // 32, bm.x0 // 32
                sp = m["split32"]
                ys = slice(yb, yb + sp.shape[0])
                xs = slice(xb, xb + sp.shape[1])
                sm[ys, xs] = np.where(dev32[ys, xs], sm[ys, xs], sp)
                m32 = m[32][0]
                mm32[ys, xs] = m32
                m16 = m[16][0]
                mm16[bm.y0 // 16 : bm.y0 // 16 + m16.shape[0],
                     bm.x0 // 16 : bm.x0 // 16 + m16.shape[1]] = m16
            self._mode_maps = {32: (mm32,), 16: (mm16,)}
            self._band_maps = None

        self._nbc.cache_start()
        self.cdf = frame_cdf.copy()  # throwaway basis for pass-A symbols
        self._recon_only = True
        import time as _time

        _t0 = _time.perf_counter()
        # fast path: contiguous runs of device SBs serialize through one
        # native call (C++ walks the raw packed device output); the
        # per-block Python loop remains only for segmentation frames
        # (running seg-id context) and any host-path partial SBs
        use_fast = (self.seg_map is None
                    and getattr(wf, "packed", None) is not None)
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
                            if use_fast:
                                run.append((sy // 64, sx // 64))
                            else:
                                self._push_device_sb(wf, sy // 64, sx // 64)
                        else:
                            _flush_run()
                            self._partition(sx, sy, 64)
                _flush_run()
        finally:
            self._recon_only = False
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

    def _encode_tiles(self):
        """Run the SB loops.  Without LR, returns the assembled tile bytes.
        With LR, either the native two-pass flow (pass A here, pass B in
        _emit_tiles_lr) or symbol capture by RecordingEncoders (rav1e's
        WriterRecorder analog) with emission deferred to _emit_tiles_lr.
        When the device wavefront pass applies, the whole decision/recon
        datapath has already run on device (models/wavefront.py) and only
        the entropy passes run here."""
        if self._nbc is not None and getattr(self, "_wf_launched", None) is not None:
            try:
                with self.stats.stage("device_wait"):
                    wf = self._wf_launched.collect()
            finally:
                self._wf_launched = None
            # device-resident recon planes (Y, U, V) for the filter chain
            self._wf_dev_out = wf.dev_out
            return self._encode_tiles_wavefront(wf)
        tiles = self._tile_grid()
        frame_cdf = self.cdf
        self._frame_init_cdf = frame_cdf
        self._lrf_native = (
            self.lrf and self._nbc is not None and self._rd_maps is not None
        )
        if self._lrf_native:
            self.cdf = frame_cdf.copy()  # throwaway basis for pass A
            self._recon_only = True  # native blocks skip symbols/contexts
            self._nbc.cache_start()  # store decisions+levels for pass B
            try:
                self._run_tiles_native(lr_emit=False)
            finally:
                self._recon_only = False
            # pre-filter recon snapshot: pass B python-path blocks (if any)
            # predict from this state, not the filtered frame
            self._prefilter_rec = [p.copy() for p in self.rec]
            return None  # bytes come from pass B (_emit_tiles_lr)
        tile_datas = []
        self._tile_recorders = []
        self._cdef_reset()
        for idx, (sc0, sr0, sc1, sr1) in enumerate(tiles):
            self.tx0, self.ty0 = sc0 * 64, sr0 * 64
            self.tx1 = min(sc1 * 64, self.coded_w)
            self.ty1 = min(sr1 * 64, self.coded_h)
            if self.lrf:
                from rav1e_tpu_torch.ec.recorder import RecordingEncoder

                self.enc = RecordingEncoder()
                self._tile_recorders.append(self.enc)
                if len(tiles) > 1:
                    self._reset_tile_contexts()
            elif len(tiles) > 1:
                self.cdf = frame_cdf.copy()
                if self.use_native:
                    from rav1e_tpu_torch.ec.native import NativeMsacEncoder

                    self.enc = NativeMsacEncoder()
                else:
                    self.enc = MsacEncoder()
                self._reset_tile_contexts()
            for sy in range(self.ty0, self.ty1, 64):
                for sx in range(self.tx0, self.tx1, 64):
                    if self.lrf:
                        self.enc.sb_anchor(sy // 64, sx // 64)
                    self._partition(sx, sy, 64)
            if not self.lrf:
                tile_datas.append(self.enc.done())
                if idx == 0:
                    self.cdf_saved = self.cdf  # context_update_tile_id == 0
        if self.lrf:
            self._tile_bounds = tiles
            return None  # emission deferred to _emit_tiles_lr
        self.cdf = getattr(self, "cdf_saved", self.cdf)
        if len(tile_datas) == 1:
            return tile_datas[0]
        out = b""
        for i, td in enumerate(tile_datas):
            if i < len(tile_datas) - 1:
                out += (len(td) - 1).to_bytes(4, "little")  # tile_size_minus_1
            out += td
        return out

    # -- loop restoration (reference analog: src/lrf.rs) ----------------------

    LR_UNIT = 64  # luma restoration unit size (lr_unit_shift = 0)

    # SGR parameter sets tried per unit (encoder choice; kept small on the
    # host path — reference analog: sgr_complexity Reduced)
    SGR_CANDIDATE_SETS = (4, 11)

    def _lr_decide(self) -> None:
        """Per-unit restoration decision (SWITCHABLE): none vs Wiener
        (one frame-level tap set, solved over the luma plane) vs SGRPROJ
        (per-unit projection weights over candidate parameter sets).

        With the SGR search (speed <= 5) every unit also tries its own
        Wiener taps (thorough mode) and the SGR parameter sets
        SGR_CANDIDATE_SETS, all on the host (lrf_np, sgr_np) but for the
        frame taps' trial filter (ops/lrf.py, K8 in frame mode); chroma
        takes _lr_decide_chroma.  Without it the decision is the device
        filter chain's fused LR stage (_lr_decide_fused)."""
        from rav1e_tpu_torch.ops import lrf
        from rav1e_tpu_torch.ops import lrf_np as lr
        from rav1e_tpu_torch.ops import sgr_np as sg

        self._lr_params = {}
        if not self.sgr_search and self._lr_decide_fused():
            return
        rows = lr.unit_ranges(self.LR_UNIT, self.out_h, shifted=True)
        cols = lr.unit_ranges(self.LR_UNIT, self.out_w)
        cdef_p = self.rec[0]
        # device filter chain may keep the deblocked plane device-resident
        # only (_dev_db); the host copy is None then
        db_p = (self._deblock_copy[0]
                if self._deblock_copy is not None else None)
        with self.stats.stage("lr_solve_y"):
            src_f = self.src[0][: self.out_h, : self.out_w].astype(np.float64)
            vt, ht = lr.solve_wiener(
                cdef_p[: self.out_h, : self.out_w].astype(np.float64), src_f
            )
        restored = None
        if vt != (0, 0, 0) or ht != (0, 0, 0):
            with self.stats.stage("lr_trial_y"):
                restored = lrf.wiener_filter_frame_device(
                    cdef_p, db_p, vt, ht, 64, self.bd, self.out_w, self.out_h,
                    dev_cdef=getattr(self, "_dev_cdef", None),
                    dev_db=getattr(self, "_dev_db", None),
                    device=self.device)
        # guided-pass outputs for the SGR candidate sets (whole frame; the
        # per-unit choice is only the set + projection weights)
        sgr_flt = {}
        if self.sgr_search:
            for si in self.SGR_CANDIDATE_SETS:
                sgr_flt[si] = sg.sgr_flt_frame(cdef_p, db_p, si, self.bd,
                                               self.out_w, self.out_h)
        # whole-plane squared-error maps once; the unit loop only slices
        src_i = self.src[0][: self.out_h, : self.out_w].astype(np.int64)
        d2_base = (cdef_p[: self.out_h, : self.out_w].astype(np.int64)
                   - src_i) ** 2
        d2_rest = None
        if restored is not None:
            d2_rest = (restored.astype(np.int64) - src_i) ** 2
        for ur, (y0, y1) in enumerate(rows):
            for uc, (x0, x1) in enumerate(cols):
                best = int(d2_base[y0:y1, x0:x1].sum())
                choice = None
                if restored is not None:
                    sse1 = int(d2_rest[y0:y1, x0:x1].sum()) + self.lam * 12
                    if sse1 < best:
                        best = sse1
                        choice = ("wiener", vt, ht, restored[y0:y1, x0:x1])
                if self.sgr_search or sgr_flt:
                    src = src_i[y0:y1, x0:x1]
                    base = cdef_p[y0:y1, x0:x1].astype(np.int64)
                if self.sgr_search:
                    # per-unit Wiener taps (thorough mode)
                    uvt, uht = lr.solve_wiener(base.astype(np.float64),
                                               src.astype(np.float64))
                    if (uvt, uht) != ((0, 0, 0), (0, 0, 0)) and (uvt, uht) != (vt, ht):
                        out = lr.wiener_filter_unit(
                            cdef_p, db_p, x0, y0, x1, y1, uvt, uht, 64,
                            self.bd, self.out_w, self.out_h)
                        ss = int(((out - src) ** 2).sum()) + self.lam * 30
                        if ss < best:
                            best = ss
                            choice = ("wiener", uvt, uht, out)
                for si, (f0, f1) in sgr_flt.items():
                    f0u = f0[y0:y1, x0:x1] if f0 is not None else None
                    f1u = f1[y0:y1, x0:x1] if f1 is not None else None
                    xqd = sg.solve_xqd(base, src, f0u, f1u, si)
                    out = sg.sgr_apply(base, f0u, f1u, xqd, si, self.bd)
                    ss = int(((out - src) ** 2).sum()) + self.lam * 18
                    if ss < best:
                        best = ss
                        choice = ("sgr", si, tuple(xqd), out)
                self._lr_params[(ur, uc)] = choice
        with self.stats.stage("lr_chroma"):
            self._lr_decide_chroma()

    def _lr_decide_fused(self) -> bool:
        """Fused device LR decision (speed-6 flow: none-vs-Wiener with
        frame-level taps, no SGR search), read from the filter chain's
        fused LR stage (ops/filter_chain.py: taps by K7, trials, unit
        choice and composition by K8).  A frame without that stage (the
        host filter path of host-coded frames) solves the tap sets on the
        host: all zero, every unit is RESTORE_NONE (True); else False, and
        _lr_decide's host per-unit path runs (K8 in frame mode)."""
        from rav1e_tpu_torch.ops import lrf_np as lr

        self._lr_chroma = {1: {}, 2: {}}
        self._lr_chroma_taps = {}
        self.lr_types = [1, 0, 0]
        chain_lr = getattr(self, "_chain_lr", None)
        if chain_lr is not None:
            # taps solved + trials + composition already ran inside the
            # device filter chain
            comp, choice, taps, en = chain_lr
            self._chain_lr = None
            rows = lr.unit_ranges(self.LR_UNIT, self.out_h, shifted=True)
            cols = lr.unit_ranges(self.LR_UNIT, self.out_w)
            vt, ht = tuple(int(t) for t in taps[0]), tuple(
                int(t) for t in taps[1])
            for ur, (y0, y1) in enumerate(rows):
                for uc, (x0, x1) in enumerate(cols):
                    if en[0] and choice[0][ur, uc]:
                        self._lr_params[(ur, uc)] = (
                            "wiener", vt, ht, comp[0][y0:y1, x0:x1])
                    else:
                        self._lr_params[(ur, uc)] = None
            cw = (self.out_w + 1) >> 1
            ch = (self.out_h + 1) >> 1
            rows_c = lr.unit_ranges(self.LR_UNIT >> 1, ch, shifted=True)
            cols_c = lr.unit_ranges(self.LR_UNIT >> 1, cw)
            for plane in (1, 2):
                if not (en[plane] and choice[plane].any()):
                    continue
                units = {}
                for ur, (y0, y1) in enumerate(rows_c):
                    for uc, (x0, x1) in enumerate(cols_c):
                        units[(ur, uc)] = (comp[plane][y0:y1, x0:x1]
                                           if choice[plane][ur, uc] else None)
                self._lr_chroma[plane] = units
                tr = taps[2 * plane], taps[2 * plane + 1]
                self._lr_chroma_taps[plane] = (
                    tuple(int(t) for t in tr[0]),
                    tuple(int(t) for t in tr[1]))
                self.lr_types[plane] = 2  # coded RESTORE_WIENER
            return True
        with self.stats.stage("lr_solve_y"):
            vt, ht = lr.solve_wiener(
                self.rec[0][: self.out_h, : self.out_w],
                self.src[0][: self.out_h, : self.out_w])
        taps_y = (vt, ht) if (vt, ht) != ((0, 0, 0), (0, 0, 0)) else None
        taps_c = {}
        cw = (self.out_w + 1) >> 1
        ch = (self.out_h + 1) >> 1
        if self._is420:
            for plane in (1, 2):
                vtc, htc = lr.solve_wiener(
                    self.rec[plane][:ch, :cw],
                    self.src[plane][:ch, :cw])
                vtc = (0, int(vtc[1]), int(vtc[2]))  # chroma outer tap is 0
                htc = (0, int(htc[1]), int(htc[2]))
                if (vtc, htc) != ((0, 0, 0), (0, 0, 0)):
                    taps_c[plane] = (vtc, htc)
        if taps_y is None and not taps_c:
            rows = lr.unit_ranges(self.LR_UNIT, self.out_h, shifted=True)
            cols = lr.unit_ranges(self.LR_UNIT, self.out_w)
            for ur in range(len(rows)):
                for uc in range(len(cols)):
                    self._lr_params[(ur, uc)] = None
            return True
        # the JAX package's separate device decision (lr_decide_device)
        # reads the chain's device planes, the chroma among them; a frame
        # without them (the host filter path keeps luma planes at most)
        # takes the host per-unit path, where that decision declines too
        if (getattr(self, "_dev_db_c", None) is None
                or getattr(self, "_dev_cdef_c", None) is None):
            return False
        raise NotImplementedError(
            "the loop-restoration decision from the device planes of a "
            "chain without its LR stage (lrf_jax.lr_decide_device): "
            "ROADMAP queue 1 item 10")

    def _lr_decide_chroma(self) -> None:
        """Chroma restoration (reference: src/lrf.rs restores all 3
        planes): frame-level Wiener taps per chroma plane (tap 0 is 0 by
        spec), RESTORE_WIENER plane type with a per-unit on/off bool.
        4:2:0 with lr_uv_shift=1: chroma units cover the same picture area
        as the luma units."""
        from rav1e_tpu_torch.ops import lrf
        from rav1e_tpu_torch.ops import lrf_np as lr

        self._lr_chroma = {1: {}, 2: {}}
        self._lr_chroma_taps = {}
        self.lr_types = [1, 0, 0]
        if not self._is420:
            return
        unit_c = self.LR_UNIT >> 1
        cw = (self.out_w + 1) >> 1
        ch = (self.out_h + 1) >> 1
        rows_c = lr.unit_ranges(unit_c, ch, shifted=True)
        cols_c = lr.unit_ranges(unit_c, cw)
        dev_db_c = getattr(self, "_dev_db_c", None)
        dev_cdef_c = getattr(self, "_dev_cdef_c", None)
        for plane in (1, 2):
            cdef_c = self.rec[plane]
            db_c = (self._deblock_copy[plane]
                    if self._deblock_copy is not None else None)
            src_i = self.src[plane][:ch, :cw].astype(np.int64)
            vtc, htc = lr.solve_wiener(
                cdef_c[:ch, :cw].astype(np.float64), src_i.astype(np.float64))
            vtc = (0, int(vtc[1]), int(vtc[2]))  # chroma outer tap is 0
            htc = (0, int(htc[1]), int(htc[2]))
            if vtc == (0, 0, 0) and htc == (0, 0, 0):
                continue
            # the trial filter on the device (K8 in frame mode)
            restored = lrf.wiener_filter_frame_device(
                cdef_c[:ch, :cw],
                db_c[:ch, :cw] if db_c is not None else None,
                vtc, htc, unit_c, self.bd, cw, ch,
                dev_cdef=(dev_cdef_c[plane - 1]
                          if dev_cdef_c is not None else None),
                dev_db=(dev_db_c[plane - 1]
                        if dev_db_c is not None else None),
                device=self.device)
            d2_base = (cdef_c[:ch, :cw].astype(np.int64) - src_i) ** 2
            d2_rest = (restored.astype(np.int64) - src_i) ** 2
            units = {}
            any_used = False
            for ur, (y0, y1) in enumerate(rows_c):
                for uc, (x0, x1) in enumerate(cols_c):
                    sse0 = int(d2_base[y0:y1, x0:x1].sum())
                    sse1 = int(d2_rest[y0:y1, x0:x1].sum()) + self.lam * 9
                    if sse1 < sse0:
                        units[(ur, uc)] = restored[y0:y1, x0:x1]
                        any_used = True
                    else:
                        units[(ur, uc)] = None
            if any_used:
                self._lr_chroma[plane] = units
                self._lr_chroma_taps[plane] = (vtc, htc)
                self.lr_types[plane] = 2  # coded RESTORE_WIENER

    def _lr_apply(self) -> None:
        from rav1e_tpu_torch.ops import lrf_np as lr

        rows = lr.unit_ranges(self.LR_UNIT, self.out_h, shifted=True)
        cols = lr.unit_ranges(self.LR_UNIT, self.out_w)
        for (ur, uc), p in self._lr_params.items():
            if p is None:
                continue
            y0, y1 = rows[ur]
            x0, x1 = cols[uc]
            self.rec[0][y0:y1, x0:x1] = p[3]
        unit_c = self.LR_UNIT >> 1
        cw = (self.out_w + 1) >> 1
        ch = (self.out_h + 1) >> 1
        for plane in (1, 2):
            if getattr(self, "lr_types", [1, 0, 0])[plane] != 2:
                continue
            rows_c = lr.unit_ranges(unit_c, ch, shifted=True)
            cols_c = lr.unit_ranges(unit_c, cw)
            for (ur, uc), out in self._lr_chroma[plane].items():
                if out is None:
                    continue
                y0, y1 = rows_c[ur]
                x0, x1 = cols_c[uc]
                self.rec[plane][y0:y1, x0:x1] = out

    def _lr_write(self, enc, sb_row: int, sb_col: int) -> None:
        """read_lr for one superblock (spec 5.11.57), luma SWITCHABLE frame
        restoration type (none / wiener / sgrproj per unit); planes 1/2 a
        per-unit flag and taps where the frame restores them."""
        from rav1e_tpu_torch.entropy import subexp as se
        from rav1e_tpu_torch.ops import lrf_np as lr
        from rav1e_tpu_torch.ops import sgr_np as sg

        unit = self.LR_UNIT
        n_rows = lr.count_units(unit, self.out_h)
        n_cols = lr.count_units(unit, self.out_w)
        r_mi, c_mi = sb_row * 16, sb_col * 16
        ur0 = (r_mi * 4 + unit - 1) // unit
        ur1 = min(n_rows, ((r_mi + 16) * 4 + unit - 1) // unit)
        uc0 = (c_mi * 4 + unit - 1) // unit
        uc1 = min(n_cols, ((c_mi + 16) * 4 + unit - 1) // unit)
        for ur in range(ur0, ur1):
            for uc in range(uc0, uc1):
                p = self._lr_params.get((ur, uc))
                kind = p[0] if p is not None else "none"
                sym = {"none": 0, "wiener": 1, "sgr": 2}[kind]
                enc.symbol_adapt(sym, self.cdf.switchable_restore[0])
                if kind == "wiener":
                    _, vt, ht, _ = p
                    for pass_i, taps in ((0, vt), (1, ht)):
                        for i in range(3):
                            se.write_signed_subexp_with_ref(
                                enc, int(taps[i]), lr.WIENER_TAPS_MIN[i],
                                lr.WIENER_TAPS_MAX[i] + 1, lr.WIENER_TAPS_K[i],
                                int(self._lr_ref[pass_i][i]))
                            self._lr_ref[pass_i][i] = int(taps[i])
                elif kind == "sgr":
                    _, si, xqd, _ = p
                    enc.literal(si, 4)
                    r0, r1 = sg.sgr_radii(si)
                    for i, radius in ((0, r0), (1, r1)):
                        if radius:
                            se.write_signed_subexp_with_ref(
                                enc, int(xqd[i]), sg.XQD_MIN[i],
                                sg.XQD_MAX[i] + 1, sg.SGRPROJ_PRJ_SUBEXP_K,
                                int(self._sgr_ref[i]))
                            self._sgr_ref[i] = int(xqd[i])
                        else:
                            # not coded; the decoder derives the value
                            # (0, or clip(128 - xqd0) for i == 1) and updates
                            # its reference with it — solve_xqd stores the
                            # same derived values in xqd
                            self._sgr_ref[i] = int(xqd[i])
        # chroma planes (RESTORE_WIENER): per-unit on/off bool + taps
        # (tap 0 implied zero for chroma; spec read_lr plane-major order)
        lr_types = getattr(self, "lr_types", [1, 0, 0])
        unit_c = unit >> 1
        cw = (self.out_w + 1) >> 1
        ch = (self.out_h + 1) >> 1
        for plane in (1, 2):
            if lr_types[plane] != 2:
                continue
            nr_c = lr.count_units(unit_c, ch)
            nc_c = lr.count_units(unit_c, cw)
            r_px, c_px = sb_row * 32, sb_col * 32
            ur0 = (r_px + unit_c - 1) // unit_c
            ur1 = min(nr_c, (r_px + 32 + unit_c - 1) // unit_c)
            uc0 = (c_px + unit_c - 1) // unit_c
            uc1 = min(nc_c, (c_px + 32 + unit_c - 1) // unit_c)
            for ur in range(ur0, ur1):
                for uc in range(uc0, uc1):
                    use = self._lr_chroma[plane].get((ur, uc)) is not None
                    enc.symbol_adapt(1 if use else 0,
                                     self.cdf.wiener_restore[0])
                    if not use:
                        continue
                    vt, ht = self._lr_chroma_taps[plane]
                    for pass_i, taps in ((0, vt), (1, ht)):
                        for i in (1, 2):
                            se.write_signed_subexp_with_ref(
                                enc, int(taps[i]), lr.WIENER_TAPS_MIN[i],
                                lr.WIENER_TAPS_MAX[i] + 1,
                                lr.WIENER_TAPS_K[i],
                                int(self._lr_ref_c[plane][pass_i][i]))
                            self._lr_ref_c[plane][pass_i][i] = int(taps[i])

    def _emit_tiles_lr(self) -> bytes:
        """Replay recorded tiles with read_lr symbols at SB anchors.  The
        recorded ops hold row views into _frame_init_cdf's arrays, so tile
        independence is achieved by restoring those arrays IN PLACE before
        each tile's replay (preserving object identity)."""
        if getattr(self, "_lrf_native", False):
            filtered = [p.copy() for p in self.rec]
            self.rec = self._prefilter_rec
            self.cdf = self._frame_init_cdf
            self._nbc.cache_rewind()
            self._lr_replay = True
            try:
                tile_datas = self._run_tiles_native(lr_emit=True)
            finally:
                self._lr_replay = False
            self.rec = filtered  # cached replay skips recon; restore filtered
            if len(tile_datas) == 1:
                return tile_datas[0]
            out = b""
            for i, td in enumerate(tile_datas):
                if i < len(tile_datas) - 1:
                    out += (len(td) - 1).to_bytes(4, "little")
                out += td
            return out
        frame_cdf = self._frame_init_cdf
        tile_datas = []
        multi = len(self._tile_recorders) > 1
        pristine = frame_cdf.copy() if multi else None
        saved = None
        for idx, rec in enumerate(self._tile_recorders):
            if multi and idx > 0:
                frame_cdf.restore_from(pristine)
            self.cdf = frame_cdf
            if self.use_native:
                from rav1e_tpu_torch.ec.native import NativeMsacEncoder

                enc = NativeMsacEncoder()
            else:
                enc = MsacEncoder()
            self._lr_ref = [list(lr_default) for lr_default in
                            ((3, -7, 15), (3, -7, 15))]
            self._lr_ref_c = {p: [[3, -7, 15], [3, -7, 15]] for p in (1, 2)}
            self._sgr_ref = [-32, 31]
            rec.replay(enc, self.cdf, lr_insert=self._lr_write,
                       cdef_insert=self._cdef_write)
            tile_datas.append(enc.done())
            if idx == 0:
                saved = frame_cdf.copy() if multi else frame_cdf
        self.cdf = saved
        self.cdf_saved = saved
        if len(tile_datas) == 1:
            return tile_datas[0]
        out = b""
        for i, td in enumerate(tile_datas):
            if i < len(tile_datas) - 1:
                out += (len(td) - 1).to_bytes(4, "little")
            out += td
        return out

    def _have_above(self, y: int, sub: int = 0) -> bool:
        return y > (self.ty0 >> sub)

    def _have_left(self, x: int, sub: int = 0) -> bool:
        return x > (self.tx0 >> sub)

    def _part_ctx(self, x: int, y: int, bsl: int) -> int:
        # bit position: deciding size 8/16/32/64/128 reads bit 0/1/2/3/4
        # (= bsl-1), verified against dav1d decode behavior
        mc, mr = x // 4, y // 4
        above = (int(self.above_part[mc]) >> (bsl - 1)) & 1
        left = (int(self.left_part[mr]) >> (bsl - 1)) & 1
        return left * 2 + above

    # partition type values (spec enum)
    P_NONE, P_HORZ, P_VERT, P_SPLIT = 0, 1, 2, 3
    P_HORZ_A, P_HORZ_B, P_VERT_A, P_VERT_B, P_HORZ_4, P_VERT_4 = 4, 5, 6, 7, 8, 9
    # partitions whose top edge is split at the midpoint (split_or_horz=1)
    _TOP_SPLIT_SET = (2, 3, 4, 6, 7, 9)
    # partitions whose left edge is split at the midpoint (split_or_vert=1)
    _LEFT_SPLIT_SET = (1, 3, 4, 5, 6, 8)

    @staticmethod
    def _gather_prob(cdf_row, pset, nsyms) -> int:
        """icdf[0] of the derived 2-symbol cdf: sum of set probabilities."""
        total = 0
        for p in pset:
            if p >= nsyms:
                continue
            hi = 32768 if p == 0 else int(cdf_row[p - 1])
            total += hi - int(cdf_row[p])
        return max(1, min(total, 32767))

    def _partition(self, x: int, y: int, size: int) -> None:
        mc, mr = x // 4, y // 4
        if mc >= self.mi_cols or mr >= self.mi_rows:
            return
        bsl = {8: 1, 16: 2, 32: 3, 64: 4}[size]
        part_rd = None
        half_mi = size // 8
        has_rows = (mr + half_mi) < self.mi_rows
        has_cols = (mc + half_mi) < self.mi_cols
        ctx = self._part_ctx(x, y, bsl)
        cdf_row = self.cdf.partition[(bsl - 1) * 4 + ctx]
        nsyms = 4 if size == 8 else 10
        sym = self.enc.symbol_adapt if self.adapt else self.enc.symbol
        if size > 32:
            # 64x64 leaves: the device wavefront's none64 map (intra) or
            # the subclass merge test (inter merge-to-64); reference:
            # rdo_partition_decision walking up to BLOCK_64X64 (src/rdo.rs).
            # A cover64 mask (inter wavefront) marks SBs whose decision is
            # final in the map — the host merge trial must not re-decide
            # (the device recon already assumed the mapped partition).
            none64 = False
            covered64 = False
            if size == 64 and has_rows and has_cols \
                    and self._rd_maps is not None:
                m = self._rd_maps.get("none64")
                none64 = m is not None and bool(m[y // 64][x // 64])
                cm = self._rd_maps.get("cover64")
                covered64 = cm is not None and bool(cm[y // 64][x // 64])
            want_split = not (size == 64
                              and (none64 or (not covered64
                                              and self._merge64_ok(
                                                  x, y, has_rows, has_cols))))
        elif size == 32 and self.rdo_partition and has_rows and has_cols:
            cov32 = (self._rd_maps.get("cover32")
                     if self._rd_maps is not None else None)
            if self._rd_maps is not None and (
                    cov32 is None or cov32[y // 32][x // 32]):
                part_rd = (self.P_SPLIT
                           if self._rd_maps["split32"][y // 32][x // 32]
                           else self.P_NONE)
            elif self._lr_replay and (x, y, 32) in self._split_cache:
                part_rd = int(self._split_cache[(x, y, 32)])
            elif self.use_native:
                part_rd = self._rd_part(x, y, 32, cdf_row)
                self._split_cache[(x, y, 32)] = part_rd
            else:
                part_rd = self.P_NONE
            want_split = part_rd == self.P_SPLIT
        elif size == 16 and self.rdo_split8 and has_rows and has_cols:
            if self._rd_maps is not None:
                sm16 = self._rd_maps.get("split16")
                part_rd = (self.P_SPLIT
                           if sm16 is not None and sm16[y // 16][x // 16]
                           else self.P_NONE)
            elif self._lr_replay and (x, y, 16) in self._split_cache:
                part_rd = int(self._split_cache[(x, y, 16)])
            elif self.use_native:
                part_rd = self._rd_part(x, y, 16, cdf_row)
                self._split_cache[(x, y, 16)] = part_rd
            else:
                part_rd = self.P_NONE
            want_split = part_rd == self.P_SPLIT
        else:
            want_split = False
        if has_rows and has_cols:
            if size <= 32 and part_rd is not None:
                part = part_rd
            else:
                part = self.P_SPLIT if want_split else self.P_NONE
            sym(part, cdf_row[: nsyms + 1])
        elif has_cols:
            # bottom edge: HORZ (top half) or SPLIT; bool with gathered cdf
            part = self.P_SPLIT if want_split else self.P_HORZ
            self.enc.gather_bool(1 if part == self.P_SPLIT else 0,
                                 cdf_row, self._TOP_SPLIT_SET, nsyms)
        elif has_rows:
            # 4:2:2: tall half-blocks at 16/32 map to BLOCK_INVALID chroma
            # (spec Subsampled_Size); a conformant encoder must SPLIT the
            # right-edge column instead of coding PARTITION_VERT there
            if (size in (16, 32) and self.sub_x == 1 and self.sub_y == 0):
                want_split = True
            part = self.P_SPLIT if want_split else self.P_VERT
            self.enc.gather_bool(1 if part == self.P_SPLIT else 0,
                                 cdf_row, self._LEFT_SPLIT_SET, nsyms)
        else:
            part = self.P_SPLIT  # implied, nothing coded

        half = size // 2
        if part == self.P_SPLIT:
            self._partition(x, y, half)
            self._partition(x + half, y, half)
            self._partition(x, y + half, half)
            self._partition(x + half, y + half, half)
            return
        if part == self.P_NONE:
            bw = bh = size
        elif part == self.P_HORZ:
            bw, bh = size, half
        else:  # P_VERT
            bw, bh = half, size
        self._block(x, y, bw, bh)
        if part == self.P_HORZ and (mr + half_mi) < self.mi_rows:
            self._block(x, y + half, bw, bh)
        if part == self.P_VERT and (mc + half_mi) < self.mi_cols:
            self._block(x + half, y, bw, bh)
        # partition context update over the full nominal region (clamped at
        # the mi grid, mirroring the decoder)
        ab, lf = _PART_CTX_RECT[(bw, bh)]
        n4 = size // 4
        self.above_part[x // 4 : min(x // 4 + n4, self.mi_cols)] = ab
        self.left_part[y // 4 : min(y // 4 + n4, self.mi_rows)] = lf

    def _merge64_ok(self, x: int, y: int, has_rows: bool,
                    has_cols: bool) -> bool:
        """Hook: return True to code the 64x64 region as ONE block instead
        of splitting.  Base intra encoder never merges (the wavefront/device
        analysis operates on the 32x32 grid)."""
        return False

    def _cdef_search(self) -> tuple:
        """Pick one (luma, chroma) CDEF strength pair for the frame
        (cdef_bits=0) by SSE vs source on sampled 8x8 blocks.
        Reference analog: rdo_loop_decision's CDEF strength search."""
        from rav1e_tpu_torch.ops import cdef_np as cd

        pad = 3
        w, h = self.coded_w, self.coded_h
        src_pad = []
        for p, plane in enumerate(self.rec):
            sx = 0 if p == 0 else self.sub_x
            sy = 0 if p == 0 else self.sub_y
            s = np.full(((h >> sy) + 2 * pad, (w >> sx) + 2 * pad),
                        cd.CDEF_VERY_LARGE, np.int32)
            s[pad : pad + (h >> sy), pad : pad + (w >> sx)] = plane[: h >> sy, : w >> sx]
            src_pad.append(s)
        # stratified sample of non-skip 8x8 blocks
        blocks = []
        for by in range(0, h, 8):
            for bx in range(0, w, 8):
                if not self.db_info.skip[by // 4 : by // 4 + 2, bx // 4 : bx // 4 + 2].all():
                    blocks.append((by, bx))
        if not blocks:
            return (0, 0)
        step = max(1, len(blocks) // 96)
        sample = blocks[::step]
        dirs = {}
        for by, bx in sample:
            dirs[(by, bx)] = cd.find_dir_block(
                src_pad[0][pad + by : pad + by + 8, pad + bx : pad + bx + 8], self.bd
            )

        damping = self.cdef_damping + (self.bd - 8)

        def sse_y(pri, sec):
            total = 0
            for by, bx in sample:
                d, var = dirs[(by, bx)]
                pa = cd.adjust_strength(pri << (self.bd - 8), var) if pri else 0
                if pa or sec:
                    out = cd.cdef_filter_block(
                        src_pad[0], by, bx, 8, 8, pa, sec << (self.bd - 8),
                        damping, d, self.bd, pad)
                else:
                    out = src_pad[0][pad + by : pad + by + 8, pad + bx : pad + bx + 8]
                ref = self.src[0][by : by + 8, bx : bx + 8]
                diff = out.astype(np.int64) - ref
                total += int((diff * diff).sum())
            return total

        def sse_uv(pri, sec):
            total = 0
            for by, bx in sample:
                d, _ = dirs[(by, bx)]
                cy, cx = by >> 1, bx >> 1
                for p in (1, 2):
                    if pri or sec:
                        out = cd.cdef_filter_block(
                            src_pad[p], cy, cx, 4, 4, pri << (self.bd - 8),
                            sec << (self.bd - 8), damping - 1, d,
                            self.bd, pad)
                    else:
                        out = src_pad[p][pad + cy : pad + cy + 4, pad + cx : pad + cx + 4]
                    ref = self.src[p][cy : cy + 4, cx : cx + 4]
                    diff = out.astype(np.int64) - ref
                    total += int((diff * diff).sum())
            return total

        best_y, best_cost = 0, None
        for pri in (0, 1, 2, 4):
            for sec in (0, 2):
                cost = sse_y(pri, sec)
                code = (pri << 2) | (3 if sec == 4 else sec)
                if best_cost is None or cost < best_cost:
                    best_y, best_cost = code, cost
        best_uv, best_cost = 0, None
        for pri in (0, 1, 2):
            for sec in (0,):
                cost = sse_uv(pri, sec)
                code = (pri << 2) | sec
                if best_cost is None or cost < best_cost:
                    best_uv, best_cost = code, cost
        return (best_y, best_uv)

    # -- RD partition decision -------------------------------------------------

    @staticmethod
    def _sym_bits(row, s: int) -> float:
        fl = 32768 if s == 0 else int(row[s - 1])
        fh = int(row[s])
        p = max(fl - fh, 1) / 32768.0
        return -np.log2(p)

    def _trial_rate_txb(self, plane, px, py, tw, th, levels, y_mode) -> float:
        """Rate of one txb in bits via scratch tokenization (no adaptation)."""
        if self._scratch is None:
            from rav1e_tpu_torch.ec.native import NativeMsacEncoder

            self._scratch = NativeMsacEncoder()
        enc = self._scratch
        we, he = min(tw, 32), min(th, 32)
        ptype = 1 if plane else 0
        txs_ctx = cf.tx_size_ctx(tw, th)
        scan = scan_for(we, he)
        tctx = self._txb_skip_ctx(plane, px, py, tw, th)
        dctx = self._dc_sign_ctx(plane, px, py, tw, th)
        tx_type_row = None
        if plane == 0 and max(tw, th) <= 16 and self.q > 0:
            txsqr = int(np.log2(min(tw, th))) - 2
            tx_type_row = self.cdf.intra_tx_type_set2[txsqr][y_mode]
        t0 = enc.tell_bits()
        enc.encode_txb(levels, scan, ptype, cf.TX_CLASS_2D, tctx, dctx,
                       self.cdf, txs_ctx, adapt=False,
                       tx_type_row=tx_type_row, tx_type_sym=1)
        return enc.tell_bits() - t0

    def _analyze_block(self, x: int, y: int, bw: int, bh: int):
        """Mode + transforms for one block; writes recon (caller restores if
        this is a discarded trial).  Returns (dist_sse, rate_bits, info);
        info carries the artifacts so the winning candidate is coded without
        recomputation."""
        mc, mr = x // 4, y // 4
        if self.seg_map is not None:
            self._set_block_q(mr, mc)
        y_mode = self._choose_mode(x, y, bw, bh)
        y_delta = self._choose_delta(x, y, bw, bh, y_mode)
        pred_y, lv_y, dq_y, tt_y = self._code_plane_tx(0, x, y, bw, bh,
                                                       y_mode, y_delta)
        cx, cy = x >> self.sub_x, y >> self.sub_y
        cw, ch = bw >> self.sub_x, bh >> self.sub_y
        # luma recon before chroma (CFL reads it); trial writes are
        # restored by the caller either way
        self._reconstruct(0, x, y, pred_y, dq_y, tx_type=tt_y)
        uv_mode, cfl_alphas, cu, cv = self._decide_chroma(x, y, bw, bh, y_mode)
        pred_u, lv_u, dq_u = cu
        pred_v, lv_v, dq_v = cv
        skip = not (lv_y.any() or lv_u.any() or lv_v.any())
        rate = 1.0  # skip flag ~1 bit
        above_ctx = INTRA_MODE_CTX[int(self.above_mode[mc])] if self._have_above(y) else 0
        left_ctx = INTRA_MODE_CTX[int(self.left_mode[mr])] if self._have_left(x) else 0
        rate += self._sym_bits(self.cdf.kf_y_mode[above_ctx][left_ctx], y_mode)
        if min(bw, bh) >= 8 and y_mode in ip.DIRECTIONAL_MODES:
            rate += self._sym_bits(self.cdf.angle_delta[y_mode - ip.V_PRED], 3)
        cfl_allowed = 1 if max(bw, bh) <= 32 else 0
        rate += self._sym_bits(self.cdf.uv_mode[cfl_allowed][y_mode],
                               13 if uv_mode == UV_CFL else uv_mode)
        if not skip:
            rate += self._trial_rate_txb(0, x, y, bw, bh, lv_y, y_mode)
            rate += self._trial_rate_txb(1, cx, cy, cw, ch, lv_u, y_mode)
            rate += self._trial_rate_txb(2, cx, cy, cw, ch, lv_v, y_mode)
            dq_set = (dq_y, dq_u, dq_v)
        else:
            dq_set = (np.zeros_like(dq_y), np.zeros_like(dq_u), np.zeros_like(dq_v))
        # reconstruct (temporarily if trial)
        tt_uv = self._uv_tx_type(uv_mode, cw, ch)
        self._reconstruct(0, x, y, pred_y, dq_set[0], tx_type=tt_y)
        self._reconstruct(1, cx, cy, pred_u, dq_set[1], tx_type=tt_uv)
        self._reconstruct(2, cx, cy, pred_v, dq_set[2], tx_type=tt_uv)
        self.mi_coded[mr : mr + bh // 4, mc : mc + bw // 4] = 1
        dist = 0
        for plane, (px, py, tw, th) in ((0, (x, y, bw, bh)), (1, (cx, cy, cw, ch)), (2, (cx, cy, cw, ch))):
            d = self.rec[plane][py : py + th, px : px + tw].astype(np.int64) - \
                self.src[plane][py : py + th, px : px + tw]
            dist += int((d * d).sum())
        info = {
            "mode": y_mode,
            "skip": skip,
            "tt_y": tt_y,
            "uv_mode": uv_mode,
            "cfl_alphas": cfl_alphas,
            "y_delta": y_delta,
            "planes": ((pred_y, lv_y, dq_set[0]), (pred_u, lv_u, dq_set[1]), (pred_v, lv_v, dq_set[2])),
        }
        return dist, rate, info

    def _rect_arms(self, size: int) -> tuple:
        """Which rect partition arms to trial at an interior square.
        VERT (tall halves) is off for 4:2:2: Subsampled_Size maps tall
        16/32 halves to BLOCK_INVALID chroma there (same rule the
        right-edge column handles in _partition)."""
        if not getattr(self, "rect_parts", False):
            return ()
        arms = [self.P_HORZ]
        if not (self.sub_x == 1 and self.sub_y == 0):
            arms.append(self.P_VERT)
        return tuple(arms)

    def _rd_part(self, x: int, y: int, size: int, cdf_row) -> int:
        """Partition RD at one interior square: NONE vs SPLIT(4x half),
        plus HORZ/VERT (2 rect halves) when non_square_partition is on.
        Pick by SSE + lambda*bits; returns the chosen PartitionType.
        Reference analog: rdo_partition_decision (src/rdo.rs) incl. its
        rect arms; used for 32 and (at thorough speeds) 16."""
        half = size // 2
        cx, cy = x >> self.sub_x, y >> self.sub_y
        ccw, cch = size >> self.sub_x, size >> self.sub_y
        mr, mc = y // 4, x // 4
        n4 = size // 4
        saves = [
            self.rec[0][y : y + size, x : x + size].copy(),
            self.rec[1][cy : cy + cch, cx : cx + ccw].copy(),
            self.rec[2][cy : cy + cch, cx : cx + ccw].copy(),
            self.mi_coded[mr : mr + n4, mc : mc + n4].copy(),
        ]

        def restore():
            self.rec[0][y : y + size, x : x + size] = saves[0]
            self.rec[1][cy : cy + cch, cx : cx + ccw] = saves[1]
            self.rec[2][cy : cy + cch, cx : cx + ccw] = saves[2]
            self.mi_coded[mr : mr + n4, mc : mc + n4] = saves[3]

        lam = self._lam_for(x, y)
        _CHILDREN = {
            self.P_NONE: ((0, 0, size, size),),
            self.P_SPLIT: ((0, 0, half, half), (half, 0, half, half),
                           (0, half, half, half), (half, half, half, half)),
            self.P_HORZ: ((0, 0, size, half), (0, half, size, half)),
            self.P_VERT: ((0, 0, half, size), (half, 0, half, size)),
        }
        best = None  # (cost, part, infos)
        for part in (self.P_NONE, self.P_SPLIT) + self._rect_arms(size):
            dist = 0.0
            rate = self._sym_bits(cdf_row[:11], part)
            infos = {}
            for (dx, dy, bw, bh) in _CHILDREN[part]:
                # recursive 16->8 exploration happens through _partition's
                # own consult; here each child is tried as a leaf
                d, r, info = self._analyze_block(x + dx, y + dy, bw, bh)
                infos[(x + dx, y + dy)] = info
                dist += d
                rate += r
                if part == self.P_SPLIT:
                    rate += 2.0  # child partition NONE symbols ~2 bits
            cost = dist + lam * rate
            restore()
            if best is None or cost < best[0]:
                best = (cost, part, infos)
        _, part, infos = best
        self._pending.update(infos)
        return part

    # -- leaf block ----------------------------------------------------------

    def _choose_mode(self, x: int, y: int, bw: int, bh: int):
        """SAD-based intra mode choice over cheap candidates.  Uses the
        device mode map when available (source-edge approximation),
        falling back to the exact recon-edge host loop."""
        if self._mode_maps is not None:
            # rect frame-edge blocks (16x8 at the bottom row etc.) read
            # the map of their CONTAINING square — the analysis covered
            # that area (source edge-padded), and the choice is advisory
            n = max(bw, bh)
            m = self._mode_maps.get(n)
            if m is not None and x % n == 0 and y % n == 0:
                return int(m[0][y // n][x // n])
        rec = self.rec[0]
        have_above = self._have_above(y)
        have_left = self._have_left(x)
        n_tr, n_bl = self._edge_avail(x, y, bw, bh)
        above, left = ip.build_edges(rec, x, y, bw, bh, have_above, have_left, self.bd,
                                     n_top_right=n_tr, n_bottom_left=n_bl,
                                     max_x=self.mi_cols * 4 - 1, max_y=self.mi_rows * 4 - 1)
        src = self.src[0][y : y + bh, x : x + bw]
        if self.speed >= 9:
            candidates = (ip.DC_PRED, ip.V_PRED, ip.H_PRED, ip.SMOOTH_PRED, ip.PAETH_PRED)
        elif self.fine_dir:
            candidates = (
                ip.DC_PRED, ip.V_PRED, ip.H_PRED, ip.SMOOTH_PRED,
                ip.SMOOTH_V_PRED, ip.SMOOTH_H_PRED, ip.PAETH_PRED,
                ip.D135_PRED, ip.D113_PRED, ip.D157_PRED,
                ip.D45_PRED, ip.D67_PRED, ip.D203_PRED,
            )
        else:
            candidates = (
                ip.DC_PRED, ip.V_PRED, ip.H_PRED, ip.SMOOTH_PRED,
                ip.SMOOTH_V_PRED, ip.SMOOTH_H_PRED, ip.PAETH_PRED,
                ip.D135_PRED, ip.D113_PRED, ip.D157_PRED,
            )
        from rav1e_tpu_torch.ops.dist_np import satd

        # SATD prefilter, not SAD: the Hadamard energy compaction separates
        # structured (rate-expensive) from noise-like (cheap) residuals
        # that plain SAD cannot (src/rdo.rs uses SATD for mode prefilters)
        ranked = []
        for mode in candidates:
            pred = ip.predict(mode, above, left, bw, bh, have_above, have_left, 0, self.bd)
            ranked.append((satd(src, pred), mode))
        ranked.sort()
        if self.q <= 0 or self.speed >= 9:
            return ranked[0][1]
        # trial tx-domain RD over the top SATD candidates (mode + angle
        # delta), the host analog of rdo_mode_decision (src/rdo.rs):
        # measured ~0.8 dB at matched rate over a pure-SATD pick on
        # gradient content
        lam = self._lam_for(x, y)
        best = None
        for _, mode in ranked[:3]:
            if mode in ip.DIRECTIONAL_MODES and min(bw, bh) >= 8 and self.fine_dir:
                deltas = range(-3, 4)
            else:
                deltas = (0,)
            dbest = None
            for d in deltas:
                pred = ip.predict(mode, above, left, bw, bh, have_above,
                                  have_left, d, self.bd)
                c = satd(src, pred)
                if dbest is None or c < dbest[0]:
                    dbest = (c, d, pred)
            _, d, pred = dbest
            resid = (src - pred).astype(np.int32)
            if max(bw, bh) <= 32:
                lv, dq = tf.fdct_quant_native(resid, tf.DCT_DCT, self.dc_q,
                                              self.ac_q, self.bd)
            else:
                co = tf.forward_transform(resid, tf.DCT_DCT, self.bd)
                co[32:, :] = 0
                co[:, 32:] = 0
                lv = qz.quantize(co, self.dc_q, self.ac_q, bw, bh)
                dq = qz.dequantize(lv, self.dc_q, self.ac_q, bw, bh, self.bd)
            r = tf.inverse_transform_native(dq, tf.DCT_DCT, self.bd)
            dd = resid.astype(np.int64) - r
            alv = np.abs(lv)
            rate = 1.45 * int((alv > 0).sum()) + 0.95 * float(
                np.log2(1.0 + alv).sum())
            cost = float((dd * dd).sum()) + lam * rate
            if best is None or cost < best[0]:
                best = (cost, mode, d)
        self._mode_rd_delta = (x, y, bw, bh, best[1], best[2])
        return best[1]

    def _choose_delta(self, x: int, y: int, bw: int, bh: int, mode: int) -> int:
        """Angle-delta search for a directional base mode: SAD over the
        spec-exact edges (mirrored in the C block path)."""
        if (not self.fine_dir or mode not in ip.DIRECTIONAL_MODES
                or min(bw, bh) < 8):
            return 0
        cached = getattr(self, "_mode_rd_delta", None)
        if cached is not None and cached[:4] == (x, y, bw, bh) \
                and cached[4] == mode:
            return cached[5]
        have_above = self._have_above(y)
        have_left = self._have_left(x)
        n_tr, n_bl = self._edge_avail(x, y, bw, bh)
        above, left = ip.build_edges(self.rec[0], x, y, bw, bh, have_above,
                                     have_left, self.bd,
                                     n_top_right=n_tr, n_bottom_left=n_bl,
                                     max_x=self.mi_cols * 4 - 1,
                                     max_y=self.mi_rows * 4 - 1)
        src = self.src[0][y : y + bh, x : x + bw]
        from rav1e_tpu_torch.ops.dist_np import satd

        best_d, best_cost = 0, None
        for d in range(-3, 4):
            pred = ip.predict(mode, above, left, bw, bh, have_above,
                              have_left, d, self.bd)
            cost = satd(src, pred)
            if best_cost is None or cost < best_cost:
                best_d, best_cost = d, cost
        return best_d

    def _block(self, x: int, y: int, bw: int, bh: int) -> None:
        mc, mr = x // 4, y // 4
        n4w, n4h = bw // 4, bh // 4
        sym = self.enc.symbol_adapt if self.adapt else self.enc.symbol
        cx, cy = x >> self.sub_x, y >> self.sub_y
        cw, ch = bw >> self.sub_x, bh >> self.sub_y
        uv_mode = ip.DC_PRED
        cfl_alphas = (0, 0)
        if self.seg_map is not None:
            self._set_block_q(mr, mc)

        replay_info = (self._py_cache.get((x, y, bw, bh))
                       if self._lr_replay else None)
        use_native_block = (self._nbc is not None and not self._pending
                            and replay_info is None
                            and hasattr(self.enc, "_e"))
        if use_native_block:
            if self._lr_replay and self._nbc.cache_peek(x, y, bw, bh):
                # pass B of the two-pass LR flow: symbols from the pass-A
                # cache (incl. the segment id), no prediction/transform
                # repeat
                cb, ci = 0, -1
                if self.cdef_sb is not None and self._cdef_done is not None:
                    sr, sc = y // 64, x // 64
                    if not self._cdef_done[sr, sc]:
                        cb = self.cdef_sb[0]
                        ci = int(self.cdef_sb[3][sr, sc])
                skip, _ = self._nbc.replay_block(x, y, bw, bh, cb, ci)
                if ci >= 0 and not skip:
                    self._cdef_done[sr, sc] = True
                if self.seg_map is not None:
                    self._seg_after_block(mr, mc, bw, bh, skip)
                self.db_info.set_block(x, y, bw, bh, skip)
                # keep the blockDecoded analog in step for any python-path
                # blocks later in pass B
                self.mi_coded[mr : mr + n4h, mc : mc + n4w] = 1
                return
            from rav1e_tpu_torch.ec.native_block import NATIVE_MODES

            y_mode = self._choose_mode(x, y, bw, bh)
            if y_mode in NATIVE_MODES:
                seg = (0, 0, 0)
                if self.seg_map is not None:
                    seg = self._seg_symbol_args(mr, mc)
                skip, ntt = self._nbc.encode_block(
                    x, y, bw, bh, y_mode,
                    self._have_above(y), self._have_left(x),
                    recon_only=self._recon_only, seg=seg)
                if self.seg_map is not None:
                    self._seg_after_block(mr, mc, bw, bh, skip)
                self.db_info.set_block(x, y, bw, bh, skip)
                from rav1e_tpu_torch.utils.stats import TX_TYPE_NAMES

                self.stats.record_block(y_mode, bw, bh, skip,
                                        TX_TYPE_NAMES[ntt], False)
                return

        info = self._pending.pop((x, y), None)
        if info is not None and info["planes"][0][0].shape == (bh, bw):
            # RD-trial cache: reuse only the DECISIONS and recompute the
            # prediction/levels from the live recon.  The trial's stored
            # planes can be stale: the real partition recursion may have
            # re-split an earlier sibling (frame-edge or 4:2:2 forced
            # splits), changing the neighbor pixels this block's
            # prediction reads — coding the stale prediction would make
            # the encoder recon diverge from the decoder's.
            y_mode = info["mode"]
            tt_y = info.get("tt_y", tf.DCT_DCT)
            uv_mode = info.get("uv_mode", ip.DC_PRED)
            cfl_alphas = info.get("cfl_alphas", (0, 0))
            y_delta = info.get("y_delta", 0)
            (pred_y, lv_y, dq_y), (pred_u, lv_u, dq_u), \
                (pred_v, lv_v, dq_v), skip = self._code_block_fixed(
                    x, y, bw, bh, y_mode, y_delta, tt_y, uv_mode, cfl_alphas)
        elif replay_info is not None:
            # pass B of a two-pass flow: replay the pass-A artifacts
            # verbatim (the recon has been filtered since; recomputing
            # could diverge — pass A is authoritative)
            info = self._py_cache.pop((x, y, bw, bh))
            y_mode = info["mode"]
            (pred_y, lv_y, dq_y), (pred_u, lv_u, dq_u), (pred_v, lv_v, dq_v) = info["planes"]
            skip = info["skip"]
            tt_y = info.get("tt_y", tf.DCT_DCT)
            uv_mode = info.get("uv_mode", ip.DC_PRED)
            cfl_alphas = info.get("cfl_alphas", (0, 0))
            y_delta = info.get("y_delta", 0)
        else:
            y_mode = self._choose_mode(x, y, bw, bh)
            y_delta = self._choose_delta(x, y, bw, bh, y_mode)
            # transform + quantize first (skip flag needs the answer)
            pred_y, lv_y, dq_y, tt_y = self._code_plane_tx(0, x, y, bw, bh,
                                                           y_mode, y_delta)
            # reconstruct luma now: CFL reads it.  (All-zero levels imply
            # all-zero dequant, so the later skip path reconstructs the
            # same samples.)
            self._reconstruct(0, x, y, pred_y, dq_y, tx_type=tt_y)
            uv_mode, cfl_alphas, cu, cv = self._decide_chroma(x, y, bw, bh, y_mode)
            pred_u, lv_u, dq_u = cu
            pred_v, lv_v, dq_v = cv
            skip = not (lv_y.any() or lv_u.any() or lv_v.any())
        if not self._lr_replay:
            self._py_cache[(x, y, bw, bh)] = {
                "mode": y_mode, "skip": skip, "tt_y": tt_y,
                "uv_mode": uv_mode, "cfl_alphas": cfl_alphas,
                "y_delta": y_delta,
                "planes": ((pred_y, lv_y, dq_y), (pred_u, lv_u, dq_u),
                           (pred_v, lv_v, dq_v)),
            }

        self.db_info.set_block(x, y, bw, bh, skip)

        # --- mode info ---
        skip_ctx = int(self.above_skip[mc] + self.left_skip[mr])
        sym(1 if skip else 0, self.cdf.skip[skip_ctx])
        # intra segment id follows skip (SegIdPreSkip == 0) and is omitted
        # (predicted) for skip blocks
        if self.seg_map is not None:
            if not skip:
                self._write_segment_id(mr, mc)
            self._seg_after_block(mr, mc, bw, bh, skip)
        self._cdef_hook(x, y, skip)

        above_ctx = INTRA_MODE_CTX[int(self.above_mode[mc])] if self._have_above(y) else 0
        left_ctx = INTRA_MODE_CTX[int(self.left_mode[mr])] if self._have_left(x) else 0
        sym(y_mode, self.cdf.kf_y_mode[above_ctx][left_ctx])
        # angle delta for directional modes at bsize >= 8x8 (delta always 0
        # until fine directional search lands)
        if min(bw, bh) >= 8 and y_mode in ip.DIRECTIONAL_MODES:
            sym(y_delta + 3, self.cdf.angle_delta[y_mode - ip.V_PRED])

        # uv mode: cfl allowed for blocks <= 32x32; CFL codes symbol 13
        # followed by the joint sign + per-plane alpha indices
        cfl_allowed = 1 if max(bw, bh) <= 32 else 0
        uv_cdf = self.cdf.uv_mode[cfl_allowed][y_mode]
        nsyms = 14 if cfl_allowed else 13
        uv_sym = 13 if uv_mode == UV_CFL else uv_mode
        sym(uv_sym, uv_cdf[: nsyms + 1])
        if uv_mode == UV_CFL:
            au, av = cfl_alphas
            su = 0 if au == 0 else (1 if au < 0 else 2)
            sv = 0 if av == 0 else (1 if av < 0 else 2)
            sym(su * 3 + sv - 1, self.cdf.cfl_sign[0])
            if su:
                sym(abs(au) - 1,
                    self.cdf.cfl_alpha[(1 if su == 2 else 0) * 3 + sv])
            if sv:
                sym(abs(av) - 1,
                    self.cdf.cfl_alpha[(1 if sv == 2 else 0) * 3 + su])
        elif min(bw, bh) >= 8 and uv_mode in ip.DIRECTIONAL_MODES:
            sym(0 + 3, self.cdf.angle_delta[uv_mode - ip.V_PRED])

        # --- residual ---
        if not skip:
            self._residual(0, x, y, bw, bh, lv_y, y_mode, tx_type=tt_y)
            self._residual(1, cx, cy, cw, ch, lv_u)
            self._residual(2, cx, cy, cw, ch, lv_v)
        else:
            for p, (px, py, tw, th) in (
                (0, (x, y, bw, bh)),
                (1, (cx, cy, cw, ch)),
                (2, (cx, cy, cw, ch)),
            ):
                self._update_coef_ctx(p, px, py, tw, th, 0, 0)
            dq_y = np.zeros_like(dq_y)
            dq_u = np.zeros_like(dq_u)
            dq_v = np.zeros_like(dq_v)

        # --- reconstruct (pass B replays symbols only: self.rec already
        # holds the final filtered recon) ---
        if not self._lr_replay:
            tt_uv = self._uv_tx_type(uv_mode, cw, ch)
            self._reconstruct(0, x, y, pred_y, dq_y, tx_type=tt_y)
            self._reconstruct(1, cx, cy, pred_u, dq_u, tx_type=tt_uv)
            self._reconstruct(2, cx, cy, pred_v, dq_v, tx_type=tt_uv)

        # --- neighbor state (writes clamp at the mi grid) ---
        c1 = min(mc + n4w, self.mi_cols)
        r1 = min(mr + n4h, self.mi_rows)
        self.above_mode[mc:c1] = y_mode
        self.left_mode[mr:r1] = y_mode
        self.above_skip[mc:c1] = 1 if skip else 0
        self.left_skip[mr:r1] = 1 if skip else 0
        self.mi_coded[mr : mr + n4h, mc : mc + n4w] = 1
        from rav1e_tpu_torch.utils.stats import TX_TYPE_NAMES

        self.stats.record_block(y_mode, bw, bh, bool(skip),
                                TX_TYPE_NAMES[tt_y], uv_mode == UV_CFL)

    def _code_block_fixed(self, x: int, y: int, bw: int, bh: int,
                          y_mode: int, y_delta: int, tt_y: int,
                          uv_mode: int, cfl_alphas: tuple):
        """Predict + transform all three planes with FIXED decisions
        against the live recon (no RD loops).  Used when replaying an
        RD-trial's decisions at real coding time."""
        cx, cy = x >> self.sub_x, y >> self.sub_y
        cw, ch = bw >> self.sub_x, bh >> self.sub_y
        rec = self.rec[0]
        ha, hl = self._have_above(y), self._have_left(x)
        n_tr = n_bl = 0
        if y_mode in ip.DIRECTIONAL_MODES:
            n_tr, n_bl = self._edge_avail(x, y, bw, bh)
        above, left = ip.build_edges(rec, x, y, bw, bh, ha, hl, self.bd,
                                     n_top_right=n_tr, n_bottom_left=n_bl,
                                     max_x=self.mi_cols * 4 - 1,
                                     max_y=self.mi_rows * 4 - 1)
        pred_y = ip.predict(y_mode, above, left, bw, bh, ha, hl, y_delta,
                            self.bd)
        resid = (self.src[0][y : y + bh, x : x + bw] - pred_y).astype(np.int32)
        if max(bw, bh) <= 32:
            lv_y, dq_y = tf.fdct_quant_native(resid, tt_y, self.dc_q,
                                              self.ac_q, self.bd)
        else:
            coeffs = tf.forward_transform(resid, tt_y, self.bd)
            we, he = min(bw, 32), min(bh, 32)
            coeffs[he:, :] = 0
            coeffs[:, we:] = 0
            lv_full = qz.quantize(coeffs, self.dc_q, self.ac_q, bw, bh)
            dq_y = qz.dequantize(lv_full, self.dc_q, self.ac_q, bw, bh, self.bd)
            lv_y = lv_full[:he, :we]
        # luma recon now: CFL reads it
        self._reconstruct(0, x, y, pred_y, dq_y, tx_type=tt_y)

        tt_uv = self._uv_tx_type(uv_mode, cw, ch)
        chroma_mode = ip.DC_PRED if uv_mode == UV_CFL else uv_mode
        outs = []
        ac = None
        if uv_mode == UV_CFL and (cfl_alphas[0] or cfl_alphas[1]):
            ac = ip.cfl_ac_420(self.rec[0][y : y + bh, x : x + bw])
        for i, plane in enumerate((1, 2)):
            pr, lvp, dqp, _ = self._code_plane_tx(plane, cx, cy, cw, ch,
                                                  chroma_mode)
            alpha = cfl_alphas[i] if uv_mode == UV_CFL else 0
            if alpha and ac is not None:
                pr = ip.cfl_predict(pr, ac, alpha, self.bd)
                rc = (self.src[plane][cy : cy + ch, cx : cx + cw]
                      - pr).astype(np.int32)
                lvp, dqp = tf.fdct_quant_native(rc, tf.DCT_DCT, self.dc_q,
                                                self.ac_q, self.bd)
            outs.append((pr, lvp, dqp))
        (pred_u, lv_u, dq_u), (pred_v, lv_v, dq_v) = outs
        skip = not (lv_y.any() or lv_u.any() or lv_v.any())
        return ((pred_y, lv_y, dq_y), (pred_u, lv_u, dq_u),
                (pred_v, lv_v, dq_v), skip)

    def _plane_rd_cost(self, resid, lv, dq, lam=None,
                       tx_type: int = tf.DCT_DCT) -> float:
        """dist + lam*rate for one coded plane txb (the same coarse model
        as the luma tx-type search; mirrored exactly in the C block path)."""
        rec = tf.inverse_transform_native(dq, tx_type, self.bd)
        d = resid.astype(np.int64) - rec
        dist = float((d * d).sum())
        alv = np.abs(lv)
        rate = 1.45 * int((alv > 0).sum()) + 0.95 * float(np.log2(1.0 + alv).sum())
        return dist + (self.lam if lam is None else lam) * rate

    # uv-mode RD candidates beyond DC: modes whose prediction reads only
    # the standard above row / left column (no above-right or bottom-left
    # extension), so the encoder-side edge build is decoder-exact without
    # simulating the chroma blockDecoded map.  Reference: rdo_mode_decision's
    # chroma loop evaluates all uv modes (src/rdo.rs).
    UV_RD_MODES = (ip.V_PRED, ip.H_PRED, ip.D135_PRED, ip.D113_PRED,
                   ip.D157_PRED, ip.SMOOTH_PRED, ip.SMOOTH_V_PRED,
                   ip.SMOOTH_H_PRED, ip.PAETH_PRED)

    def _decide_chroma(self, x: int, y: int, bw: int, bh: int, y_mode: int):
        """Chroma mode decision: uv-mode RD race (DC + directional/smooth
        candidates) then CFL (chroma-from-luma, spec 7.11.5).  Returns
        (uv_mode, (alpha_u, alpha_v), (pred,lv,dq) for U and V).  Reads the
        block's already-reconstructed luma."""
        blam = self._lam_for(x, y)
        cx, cy = x >> self.sub_x, y >> self.sub_y
        cw, ch = bw >> self.sub_x, bh >> self.sub_y
        pu = self._code_plane_tx(1, cx, cy, cw, ch, ip.DC_PRED)
        pv = self._code_plane_tx(2, cx, cy, cw, ch, ip.DC_PRED)
        du, dv = pu[:3], pv[:3]
        if getattr(self, "uv_search", False) and self.q > 0:
            cfl_allowed = 1 if max(bw, bh) <= 32 else 0
            uv_row = self.cdf.uv_mode[cfl_allowed][y_mode]
            use_delta = min(bw, bh) >= 8

            def mode_cost(m, cu_, cv_):
                r = self._sym_bits(uv_row, m)
                if use_delta and m in ip.DIRECTIONAL_MODES:
                    r += self._sym_bits(self.cdf.angle_delta[m - ip.V_PRED], 3)
                c = blam * r
                for plane, (pred, lv, dq) in ((1, cu_), (2, cv_)):
                    src = self.src[plane][cy : cy + ch, cx : cx + cw]
                    c += self._plane_rd_cost((src - pred).astype(np.int32),
                                             lv, dq, blam,
                                             self._uv_tx_type(m, cw, ch))
                return c

            best = (mode_cost(ip.DC_PRED, du, dv), ip.DC_PRED, du, dv)
            for m in self.UV_RD_MODES:
                cu_ = self._code_plane_tx(1, cx, cy, cw, ch, m)[:3]
                cv_ = self._code_plane_tx(2, cx, cy, cw, ch, m)[:3]
                c = mode_cost(m, cu_, cv_)
                if c < best[0]:
                    best = (c, m, cu_, cv_)
            _, uv_best, du, dv = best
            if uv_best != ip.DC_PRED:
                # CFL competes against DC predictions only (its alpha fit
                # is anchored on the DC predictor); a directional winner
                # here already beat DC including the mode-symbol rate
                return uv_best, (0, 0), du, dv
        if not (self.cfl_search and self.q > 0 and max(bw, bh) <= 32):
            return ip.DC_PRED, (0, 0), du, dv
        ac = ip.cfl_ac_420(self.rec[0][y : y + bh, x : x + bw])
        a_den = int((ac.astype(np.int64) ** 2).sum())
        alphas = [0, 0]
        cost_dc = 0.0
        cost_cfl = 0.0
        cands = [du, dv]
        for i, (plane, dcand) in enumerate(((1, du), (2, dv))):
            pred_dc, lv_dc, dq_dc = dcand
            src = self.src[plane][cy : cy + ch, cx : cx + cw]
            resid0 = (src - pred_dc).astype(np.int32)
            alpha = 0
            if a_den:
                alpha = int(np.clip(np.round(
                    64.0 * float((resid0.astype(np.int64) * ac).sum()) / a_den),
                    -16, 16))
            c_dc = self._plane_rd_cost(resid0, lv_dc, dq_dc, blam)
            cost_dc += c_dc
            if alpha == 0:
                cost_cfl += c_dc
                continue
            pred_cfl = ip.cfl_predict(pred_dc, ac, alpha, self.bd)
            resid_c = (src - pred_cfl).astype(np.int32)
            lv_c, dq_c = tf.fdct_quant_native(resid_c, tf.DCT_DCT, self.dc_q,
                                              self.ac_q, self.bd)
            cost_cfl += self._plane_rd_cost(resid_c, lv_c, dq_c, blam)
            alphas[i] = alpha
            cands[i] = (pred_cfl, lv_c, dq_c)
        if alphas == [0, 0]:
            return ip.DC_PRED, (0, 0), du, dv
        # mode-level symbol rate (uv mode + sign + alpha indices)
        uv_row = self.cdf.uv_mode[1][y_mode]
        au, av = alphas
        su = 0 if au == 0 else (1 if au < 0 else 2)
        sv = 0 if av == 0 else (1 if av < 0 else 2)
        rate_dc = self._sym_bits(uv_row, ip.DC_PRED)
        rate_cfl = self._sym_bits(uv_row, UV_CFL)
        rate_cfl += self._sym_bits(self.cdf.cfl_sign[0], su * 3 + sv - 1)
        if su:
            rate_cfl += self._sym_bits(
                self.cdf.cfl_alpha[(1 if su == 2 else 0) * 3 + sv], abs(au) - 1)
        if sv:
            rate_cfl += self._sym_bits(
                self.cdf.cfl_alpha[(1 if sv == 2 else 0) * 3 + su], abs(av) - 1)
        if cost_cfl + blam * rate_cfl < cost_dc + blam * rate_dc:
            return UV_CFL, (au, av), cands[0], cands[1]
        return ip.DC_PRED, (0, 0), du, dv

    def _edge_avail(self, px: int, py: int, tw: int, th: int) -> tuple:
        """(n_top_right, n_bottom_left) per the decoder's blockDecoded map
        (spec 7.11.2 haveAboveRight / haveBelowLeft): the mi right of the
        top-right corner / below the bottom-left corner must already be
        coded (luma only; the map is reset per tile)."""
        tr = 0
        bl = 0
        mcr = (px + tw) // 4
        if (py > self.ty0 and px + tw < self.tx1
                and self.mi_coded[(py - 1) // 4, mcr]):
            # the top-right segment is one block WIDTH long (and the
            # bottom-left one block HEIGHT) — dav1d's ipred_prepare
            # convention; equal for squares, distinct for rect blocks
            tr = tw
        if (px > self.tx0 and py + th < self.ty1
                and self.mi_coded[(py + th) // 4, (px - 1) // 4]):
            bl = th
        return tr, bl

    def _code_plane_tx(self, plane: int, px: int, py: int, tw: int, th: int,
                       mode: int, angle_delta: int = 0):
        """Predict + forward transform + quantize one tx block.
        Returns (pred, levels2d(eff), dequant(full))."""
        rec = self.rec[plane]
        sx = 0 if plane == 0 else self.sub_x
        sy = 0 if plane == 0 else self.sub_y
        have_above = self._have_above(py, sy)
        have_left = self._have_left(px, sx)
        n_tr = n_bl = 0
        if plane == 0 and mode in ip.DIRECTIONAL_MODES:
            n_tr, n_bl = self._edge_avail(px, py, tw, th)
        above, left = ip.build_edges(rec, px, py, tw, th, have_above, have_left, self.bd,
                                     n_top_right=n_tr, n_bottom_left=n_bl,
                                     max_x=(self.mi_cols * 4 >> sx) - 1,
                                     max_y=(self.mi_rows * 4 >> sy) - 1)
        pred = ip.predict(mode, above, left, tw, th, have_above, have_left,
                          angle_delta, self.bd)
        src = self.src[plane][py : py + th, px : px + tw]
        resid = (src - pred).astype(np.int32)
        if (plane == 0 and max(tw, th) <= 16 and self.q > 0
                and self.tx_type_search):
            # intra tx-type RD over the full DTT4_IDTX set (the coded set
            # under reduced_tx_set=1; reference: rdo_tx_size_type's type
            # loop, src/rdo.rs): mixed ADST/DCT catch residuals that ramp
            # along one axis only; IDTX wins on noise-like residuals
            best = None
            for tt in self.TX_SET2_SYM:
                lv, dq = tf.fdct_quant_native(resid, tt, self.dc_q,
                                              self.ac_q, self.bd)
                rec = tf.inverse_transform_native(dq, tt, self.bd)
                d = resid.astype(np.int64) - rec
                dist = float((d * d).sum())
                alv = np.abs(lv)
                rate = 1.45 * int((alv > 0).sum()) + 0.95 * float(
                    np.log2(1.0 + alv).sum())
                cost = dist + self._lam_for(px, py) * rate
                if best is None or cost < best[0]:
                    best = (cost, tt, lv, dq)
            _, tt, levels, dq = best
            return pred, levels, dq, tt
        if max(tw, th) <= 32:
            # chroma tx type is not coded: the decoder derives it from the
            # uv mode (spec 5.11.47 compute_tx_type, Mode_To_Txfm_Type)
            tt = self._uv_tx_type(mode, tw, th) if plane else tf.DCT_DCT
            levels, dq = tf.fdct_quant_native(resid, tt, self.dc_q,
                                              self.ac_q, self.bd)
            return pred, levels, dq, tt
        coeffs = tf.forward_transform(resid, tf.DCT_DCT, self.bd)
        we, he = min(tw, 32), min(th, 32)
        coeffs[he:, :] = 0
        coeffs[:, we:] = 0
        levels = qz.quantize(coeffs, self.dc_q, self.ac_q, tw, th)
        dq = qz.dequantize(levels, self.dc_q, self.ac_q, tw, th, self.bd)
        return pred, levels[:he, :we], dq, tf.DCT_DCT

    # symbol index within the intra EXT_TX_SET_DTT4_IDTX set (spec
    # av1_ext_tx_inv ordering: IDTX, DCT, ADST_ADST, ADST_DCT, DCT_ADST)
    TX_SET2_SYM = {tf.DCT_DCT: 1, tf.ADST_ADST: 2, tf.ADST_DCT: 3,
                   tf.DCT_ADST: 4, tf.IDTX: 0}

    # spec Mode_To_Txfm_Type (5.11.47 compute_tx_type): the chroma tx type
    # the decoder derives from the uv mode; index 13 = UV_CFL
    MODE_TO_TXFM = (tf.DCT_DCT, tf.ADST_DCT, tf.DCT_ADST, tf.DCT_DCT,
                    tf.ADST_ADST, tf.ADST_DCT, tf.DCT_ADST, tf.DCT_ADST,
                    tf.ADST_DCT, tf.ADST_ADST, tf.ADST_DCT, tf.DCT_ADST,
                    tf.ADST_ADST, tf.DCT_DCT)

    def _uv_tx_type(self, uv_mode: int, cw: int, ch: int) -> int:
        """Chroma tx type the decoder will derive (never coded): the
        Mode_To_Txfm table, clamped to DCT when the tx square-up exceeds
        16 (the DTT4_IDTX set only covers sqr-up <= 16) or at lossless."""
        if self.q == 0 or max(cw, ch) > 16:
            return tf.DCT_DCT
        return self.MODE_TO_TXFM[min(uv_mode, 13)]

    def _residual(self, plane: int, px: int, py: int, tw: int, th: int, levels,
                  y_mode: int = 0, tx_type: int = tf.DCT_DCT) -> None:
        we, he = min(tw, 32), min(th, 32)
        ptype = 1 if plane else 0
        txs_ctx = cf.tx_size_ctx(tw, th)
        scan = scan_for(we, he)
        tctx = self._txb_skip_ctx(plane, px, py, tw, th)
        dctx = self._dc_sign_ctx(plane, px, py, tw, th)
        tx_type_row = None
        tts = 1
        if plane == 0 and max(tw, th) <= 16 and self.q > 0:
            # tx sqr-up <= 16x16: intra tx set DTT4_IDTX (reduced_tx_set=1)
            txsqr = int(np.log2(min(tw, th))) - 2
            tx_type_row = self.cdf.intra_tx_type_set2[txsqr][y_mode]
            tts = self.TX_SET2_SYM[tx_type]

        if self.use_native:
            cul, dc_cat = self.enc.encode_txb(
                levels, scan, ptype, cf.TX_CLASS_2D, tctx, dctx, self.cdf,
                txs_ctx, adapt=self.adapt, tx_type_row=tx_type_row, tx_type_sym=tts,
            )
        else:
            tx_type_fn = None
            if tx_type_row is not None:
                sym = self.enc.symbol_adapt if self.adapt else self.enc.symbol
                row = tx_type_row

                def tx_type_fn():
                    sym(tts, row)

            cul, dc_cat = cf.encode_txb(
                self.enc, self.cdf, levels, scan, ptype, txs_ctx,
                cf.TX_CLASS_2D, tctx, dctx, adapt=self.adapt, tx_type_fn=tx_type_fn,
            )
        self._update_coef_ctx(plane, px, py, tw, th, cul, dc_cat)

    def _txb_skip_ctx(self, plane: int, px: int, py: int, tw: int, th: int) -> int:
        # bring-up: tx size == block size for luma -> ctx 0
        if plane == 0:
            return 0
        ctx = self.pctx[plane]
        u = 4
        a = ctx.above_cul[px // u : (px + tw) // u]
        l = ctx.left_cul[py // u : (py + th) // u]
        return 7 + int(a.any()) + int(l.any())

    def _dc_sign_ctx(self, plane: int, px: int, py: int, tw: int, th: int) -> int:
        ctx = self.pctx[plane]
        u = 4
        a = ctx.above_dc[px // u : (px + tw) // u]
        l = ctx.left_dc[py // u : (py + th) // u]
        s = int((a == 2).sum() + (l == 2).sum()) - int((a == 1).sum() + (l == 1).sum())
        return 0 if s == 0 else (2 if s > 0 else 1)

    def _update_coef_ctx(self, plane, px, py, tw, th, cul, dc_cat) -> None:
        # writes clamp at the mi grid (decoder keeps the beyond-frame region
        # at its neutral init value); reads beyond the grid see neutral 0
        ctx = self.pctx[plane]
        sx = 0 if plane == 0 else self.sub_x
        sy = 0 if plane == 0 else self.sub_y
        max_c = (self.mi_cols * 4 >> sx) // 4
        max_r = (self.mi_rows * 4 >> sy) // 4
        u = 4
        c1 = min((px + tw) // u, max_c)
        r1 = min((py + th) // u, max_r)
        ctx.above_cul[px // u : c1] = cul
        ctx.left_cul[py // u : r1] = cul
        ctx.above_dc[px // u : c1] = dc_cat
        ctx.left_dc[py // u : r1] = dc_cat

    def _reconstruct(self, plane, px, py, pred, dq, tx_type: int = tf.DCT_DCT) -> None:
        resid = tf.inverse_transform_native(dq, tx_type, self.bd)
        out = np.clip(pred + resid, 0, (1 << self.bd) - 1)
        self.rec[plane][py : py + pred.shape[0], px : px + pred.shape[1]] = out
