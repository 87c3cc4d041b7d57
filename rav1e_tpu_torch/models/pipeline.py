"""Frame encoder pipeline: per-frame orchestration of device analysis,
entropy coding and OBU packaging.

Reference analog: the encode_frame path of src/encoder.rs.
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.models.intra_frame import IntraFrameEncoder
from rav1e_tpu_torch.obu.headers import (
    INTER_FRAME,
    PRIMARY_REF_NONE,
    SWITCH_FRAME,
    FrameParams,
    Sequence,
    temporal_delimiter,
    write_frame_obu,
    write_sequence_header_obu,
)


class FrameEncoder:
    def __init__(self, enc_config, device="cuda"):
        self.cfg = enc_config
        self.device = device
        # profile selection (spec A.2): 0 = 4:2:0 8/10-bit, 1 = 4:4:4
        # 8/10-bit, 2 = 4:2:2 any depth or 12-bit anything
        ss = tuple(enc_config.chroma_sampling)
        if enc_config.bit_depth == 12 or ss == (1, 0):
            profile = 2
        elif ss == (0, 0):
            profile = 1
        else:
            profile = 0
        self.seq = Sequence(
            profile=profile,
            width=enc_config.width,
            height=enc_config.height,
            bit_depth=enc_config.bit_depth,
            subsampling_x=enc_config.chroma_sampling[0],
            subsampling_y=enc_config.chroma_sampling[1],
            # the CDEF search/filter geometry here is 4:2:0; other
            # samplings encode without CDEF for now
            enable_cdef=enc_config.speed_settings.cdef and ss == (1, 1),
            enable_restoration=enc_config.speed_settings.lrf,
            still_picture=enc_config.still_picture,
        )
        self.frame_count = 0
        from rav1e_tpu_torch.utils.stats import EncoderStats

        self.stats = EncoderStats()  # aggregated over all frames
        self.last_recon = None  # decoder-visible LAST reference planes
        self.ref_cdf = None  # end-of-frame adapted CDFs saved in ref slot 0
        # reference slot state: slot -> {"recon", "hint", "cdf"}
        self.slots = {}
        self.recon_by_input = {}  # input frameno -> recon (display mapping)
        self.base_slot = 0
        def log2i(n):
            k = 0
            while (1 << k) < max(1, n):
                k += 1
            return k
        self.tile_cols_log2 = log2i(enc_config.tile_cols)
        self.tile_rows_log2 = log2i(enc_config.tile_rows)

    def lf_levels_for(self, q_idx: int) -> tuple:
        """Deblock filter level from quantizer (reference analog: the
        from-q level model used at fast speeds, src/deblock.rs)."""
        from rav1e_tpu_torch.ops import quantize_np as qz

        q = qz.ac_q(q_idx, 0, self.cfg.bit_depth) >> (self.cfg.bit_depth - 8)
        lvl = int(np.clip((q * 20723 + 1015158 + (1 << 17)) >> 18, 0, 63))
        return (lvl, lvl, lvl, lvl)

    def frame_type_for(self, frameno: int) -> str:
        kf_int = self.cfg.max_key_frame_interval or 240
        if self.last_recon is None or (frameno % kf_int) == 0:
            return "key"
        return "inter"

    def encode_frame(self, frame, frameno: int, q_idx: int | None = None,
                     ftype: str | None = None) -> tuple:
        """Returns (packet_bytes, frame_type)."""
        if ftype is None:
            ftype = self.frame_type_for(frameno)
        elif ftype == "inter" and self.last_recon is None:
            ftype = "key"
        if ftype == "key":
            return self.encode_key_frame(frame, q_idx), "key"
        # S-frames on the configured cadence (low-latency streams):
        # error-resilient inter frames refreshing every slot, so a decoder
        # can join the stream here (reference: switch_frame_interval)
        sw = self.cfg.switch_frame_interval
        switch = bool(sw) and self.frame_count % sw == 0
        return self.encode_inter_frame(frame, q_idx, switch=switch), "inter"

    def cdef_damping_for(self, q_idx: int) -> int:
        if not self.seq.enable_cdef:
            return 0
        return 3 + (q_idx >> 6)

    # lookahead-overlap hook set by the Context: called right after this
    # frame's device pass is enqueued, so the next frame's pass can queue
    # behind it and execute during this frame's host entropy work
    prefetch_hook = None
    # double buffer: the NEXT batch, launched while the current one drains
    _prefetched_next = None

    def _build_key_encoder(self, q: int) -> IntraFrameEncoder:
        lf = self.lf_levels_for(q)
        damping = self.cdef_damping_for(q)
        seg = ((-8, -3, 2, 7) if getattr(self.cfg, "segmentation_aq", False)
               else ())
        fe = IntraFrameEncoder(
            self.cfg.width,
            self.cfg.height,
            q_idx=q,
            seg_deltas=seg,
            bit_depth=self.cfg.bit_depth,
            adapt_cdf=True,
            speed=self.cfg.speed_settings.speed,
            speed_settings=self.cfg.speed_settings,
            lf_levels=lf,
            cdef_damping=damping,
            tile_cols_log2=self.tile_cols_log2,
            tile_rows_log2=self.tile_rows_log2,
            tune=getattr(self.cfg, "tune", "psnr"),
            chroma_sampling=tuple(self.cfg.chroma_sampling),
            device=self.device,
        )
        fe.lrf = self.seq.enable_restoration
        return fe

    def prefetch_key_frame(self, frame, q_idx: int | None = None) -> None:
        """Prepare the next key frame's encoder and enqueue its device
        pass (async); encode_key_frame picks it up when the frame's turn
        comes.  Only valid when the quantizer is already known (CQ)."""
        q = self.cfg.quantizer if q_idx is None else q_idx
        fe = self._build_key_encoder(q)
        fe.prepare([p.window() for p in frame.planes])
        self._prefetched = (frame, q, fe)

    def prefetch_key_frames(self, frames, q_idx: int | None = None,
                            into_next: bool = False) -> None:
        """Batched lookahead: prepare N key-frame encoders and enqueue ONE
        batched wavefront pass over all of them (F*B lanes — see
        wavefront.launch_wavefront_batch).  Falls back to a single-frame
        prefetch when the batch is ineligible.  With into_next the batch
        lands in the _prefetched_next slot (double buffering: launched
        while the PREVIOUS batch's host entropy work drains, so its device
        compute overlaps instead of stalling the next pickup)."""
        if len(frames) < 2:
            if into_next:
                return
            return self.prefetch_key_frame(frames[0], q_idx)
        q = self.cfg.quantizer if q_idx is None else q_idx
        fes = []
        for fr in frames:
            fe = self._build_key_encoder(q)
            fe.prepare([p.window() for p in fr.planes], launch=False)
            fes.append(fe)
        batch = None
        if all(fe._nbc is not None and fe._wavefront_eligible()
               for fe in fes):
            from rav1e_tpu_torch.models.wavefront import launch_wavefront_batch

            batch = launch_wavefront_batch(fes, fes[0]._tile_grid())
        if batch is None:
            if into_next:
                return
            self._prefetched = None
            return self.prefetch_key_frame(frames[0], q_idx)
        for f, fe in enumerate(fes):
            fe._wf_launched = batch.slot(f)
            fe._launch_band_maps()
        plist = [(fr, q, fe) for fr, fe in zip(frames, fes)]
        if into_next:
            self._prefetched_next = plist
        else:
            self._prefetched_list = plist

    def encode_key_frame(self, frame, q_idx: int | None = None) -> bytes:
        q = self.cfg.quantizer if q_idx is None else q_idx
        pre = getattr(self, "_prefetched", None)
        plist = getattr(self, "_prefetched_list", None)
        if not plist and getattr(self, "_prefetched_next", None):
            # promote the double-buffered next batch (its wavefront has
            # been computing on-device while the last batch's host
            # entropy work ran)
            plist = self._prefetched_list = self._prefetched_next
            self._prefetched_next = None
        if plist:
            # eager phase1 across the whole batch: every frame's cache
            # build + filter-chain ENQUEUE happens before any frame's
            # host entropy pass, keeping the device's queue full
            for (fr_, _q_, fe_) in plist:
                fe_.phase1([p.window() for p in fr_.planes])
            # the whole batch's device work is now enqueued: launch the
            # NEXT batch's wavefront behind it so the device computes it
            # while this batch's host entropy passes run
            if (self.prefetch_hook is not None
                    and getattr(self, "_prefetched_next", None) is None):
                self.prefetch_hook()
        batch_tail = True  # last frame of its batch (or unbatched)
        if plist:
            head = plist.pop(0)
            if not plist:
                self._prefetched_list = None
            else:
                batch_tail = False
            if head[0] is frame and head[1] == q:
                pre = head
            else:  # out-of-order pickup: drop the stale batches
                self._prefetched_list = None
                self._prefetched_next = None
                pre = None
        if pre is not None and pre[0] is frame and pre[1] == q:
            fe = pre[2]
            self._prefetched = None
        else:
            fe = self._build_key_encoder(q)
        damping = fe.cdef_damping
        # the NEXT batch's wavefront enqueues only after the LAST frame of
        # the current batch has enqueued its filter/LR device work —
        # firing it earlier puts the tail frames' small device calls
        # behind the next batch's big compute in the device's queue
        fe._after_launch = self.prefetch_hook if batch_tail else None
        planes = [p.window() for p in frame.planes]
        tile, recon = fe.encode(planes)
        self.stats.merge(fe.stats)
        self.last_recon = recon
        self.ref_cdf = fe.cdf
        hint = self.frame_count & 0x7F
        for s_ in range(8):
            self.slots[s_] = {"recon": recon, "hint": hint, "cdf": fe.cdf}

        fp = FrameParams(
            base_q_idx=q,
            disable_cdf_update=False,
            order_hint=hint,
            loop_filter_levels=fe.lf_levels,
            tile_cols_log2=self.tile_cols_log2,
            tile_rows_log2=self.tile_rows_log2,
            seg_deltas=fe.seg_deltas,
        )
        if fe.cdef_strengths is not None:
            fp.cdef_damping = damping
            sb = getattr(fe, "cdef_sb", None)
            if sb is not None:
                fp.cdef_bits, fp.cdef_y_strengths, fp.cdef_uv_strengths = \
                    sb[0], sb[1], sb[2]
            else:
                fp.cdef_bits = 0
                fp.cdef_y_strengths = (fe.cdef_strengths[0],)
                fp.cdef_uv_strengths = (fe.cdef_strengths[1],)
        if fe.lrf:
            # SWITCHABLE luma; chroma planes RESTORE_WIENER when engaged
            fp.frame_restoration_type = tuple(getattr(fe, "lr_types",
                                                      (1, 0, 0)))
            fp.lr_unit_shift = 0
            fp.lr_uv_shift = 1 if any(
                t for t in fp.frame_restoration_type[1:]) else 0
        out = temporal_delimiter()
        out += write_sequence_header_obu(self.seq)
        out += write_frame_obu(self.seq, fp, tile)
        self.frame_count += 1
        return out

    def encode_inter_frame(self, frame, q_idx: int | None = None,
                           switch: bool = False) -> bytes:
        """Low-latency P frame: LAST = slot 0, refresh all slots."""
        return self.encode_inter(
            frame,
            q_idx=q_idx,
            order_hint=self.frame_count & 0x7F,
            ref_slots={1: 0},
            show_frame=True,
            refresh_flags=0xFF,
            switch=switch,
        )

    def encode_inter(self, frame, q_idx, order_hint, ref_slots: dict,
                     show_frame: bool, refresh_flags: int,
                     imp_scale=None, switch: bool = False) -> bytes:
        """General inter frame.  ref_slots: {ref_id: slot} for the refs the
        block search may use (1=LAST, 2=LAST2, 4=GOLDEN, 5=BWDREF,
        7=ALTREF); LAST doubles as the primary ref (CDF inheritance)."""
        from rav1e_tpu_torch.models import mv_pred as mvp
        from rav1e_tpu_torch.models.inter_frame import InterFrameEncoder

        q = self.cfg.quantizer if q_idx is None else q_idx
        q = int(np.clip(q, 1, 255))
        lf = self.lf_levels_for(q)
        damping = self.cdef_damping_for(q)
        last_slot = ref_slots[mvp.LAST_FRAME]
        refs = {rid: self.slots[s_]["recon"] for rid, s_ in ref_slots.items()}
        fe = InterFrameEncoder(
            self.cfg.width,
            self.cfg.height,
            q_idx=q,
            refs=refs,
            bit_depth=self.cfg.bit_depth,
            adapt_cdf=True,
            speed=self.cfg.speed_settings.speed,
            speed_settings=self.cfg.speed_settings,
            init_cdf=(None if (self.cfg.error_resilient or switch)
                      else self.slots[last_slot]["cdf"]),
            lf_levels=lf,
            cdef_damping=damping,
            tile_cols_log2=self.tile_cols_log2,
            tile_rows_log2=self.tile_rows_log2,
            tune=getattr(self.cfg, "tune", "psnr"),
            chroma_sampling=tuple(self.cfg.chroma_sampling),
            device=self.device,
        )
        fe.lrf = self.seq.enable_restoration
        fe._imp_scale = imp_scale

        def rel_dist(a, b):  # 7-bit order-hint wraparound compare
            return ((a - b + 64) & 127) - 64

        fe.sign_bias = {
            rid: 1 if rel_dist(self.slots[s_]["hint"], order_hint & 0x7F) > 0
            else 0
            for rid, s_ in ref_slots.items()
        }
        # compound prediction needs refs on both temporal sides
        fe.reference_select = len(set(fe.sign_bias.values())) > 1
        planes = [p.window() for p in frame.planes]
        tile, recon = fe.encode(planes)
        self.stats.merge(fe.stats)
        self.last_recon = recon
        self.ref_cdf = fe.cdf

        # ref name -> slot map for the header (unused names point at LAST)
        idx = [last_slot] * 7
        for rid, s_ in ref_slots.items():
            idx[rid - 1] = s_
        fp = FrameParams(
            frame_type=SWITCH_FRAME if switch else INTER_FRAME,
            show_frame=show_frame,
            showable_frame=not show_frame,
            base_q_idx=q,
            disable_cdf_update=False,
            order_hint=order_hint & 0x7F,
            loop_filter_levels=fe.lf_levels,
            interp_filter=fe.interp_filter,
            tile_cols_log2=self.tile_cols_log2,
            tile_rows_log2=self.tile_rows_log2,
            refresh_frame_flags=refresh_flags,
            ref_frame_idx=tuple(idx),
            error_resilient=self.cfg.error_resilient or switch,
            ref_order_hints=tuple(
                self.slots.get(i, {"hint": 0})["hint"] for i in range(8)
            ),
            # CDFs (and filter deltas) inherit from LAST = ref_frame_idx[0];
            # error-resilient frames must reset to defaults instead
            primary_ref_frame=(PRIMARY_REF_NONE
                               if (self.cfg.error_resilient or switch) else 0),
            reference_select=fe.reference_select,
        )
        if fe.cdef_strengths is not None:
            fp.cdef_damping = damping
            sb = getattr(fe, "cdef_sb", None)
            if sb is not None:
                fp.cdef_bits, fp.cdef_y_strengths, fp.cdef_uv_strengths = \
                    sb[0], sb[1], sb[2]
            else:
                fp.cdef_bits = 0
                fp.cdef_y_strengths = (fe.cdef_strengths[0],)
                fp.cdef_uv_strengths = (fe.cdef_strengths[1],)
        if fe.lrf:
            # SWITCHABLE luma; chroma planes RESTORE_WIENER when engaged
            fp.frame_restoration_type = tuple(getattr(fe, "lr_types",
                                                      (1, 0, 0)))
            fp.lr_unit_shift = 0
            fp.lr_uv_shift = 1 if any(
                t for t in fp.frame_restoration_type[1:]) else 0
        out = temporal_delimiter()
        out += write_frame_obu(self.seq, fp, tile)
        for s_ in range(8):
            if refresh_flags & (1 << s_):
                self.slots[s_] = {"recon": recon, "hint": order_hint & 0x7F,
                                  "cdf": fe.cdf}
        self.frame_count += 1
        return out

    def show_existing(self, slot: int) -> bytes:
        """A temporal unit that displays an already-decoded reference."""
        from rav1e_tpu_torch.obu.headers import write_show_existing_obu

        return temporal_delimiter() + write_show_existing_obu(slot)
