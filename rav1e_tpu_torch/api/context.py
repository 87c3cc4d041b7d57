"""Public encode context: the send_frame / receive_packet state machine.

Reference analog: src/api/context.rs + src/api/internal.rs (ContextInner).
The semantics replicated here (EncoderStatus protocol, flush via
send_frame(None), packet reordering) are the ones the reference's API tests
assert.  Internals: per-frame device passes batched over superblocks on a
CUDA device (PyTorch and hand-written kernels), host entropy tail.
"""

from __future__ import annotations

import enum

import numpy as np
from collections import deque
from dataclasses import dataclass

from rav1e_tpu_torch.api.config import EncoderConfig


class EncoderStatus(enum.Enum):
    NEED_MORE_DATA = "need_more_data"
    ENOUGH_DATA = "enough_data"
    ENCODED = "encoded"
    LIMIT_REACHED = "limit_reached"
    NOT_READY = "not_ready"
    FAILURE = "failure"


class EncoderError(Exception):
    def __init__(self, status: EncoderStatus):
        self.status = status
        super().__init__(status.value)


@dataclass
class Packet:
    data: bytes
    input_frameno: int
    frame_type: str  # "key" | "inter"
    opaque: object = None
    # whether this temporal unit displays a frame (False for the no-show
    # frames of a pyramid group; their display comes via show_existing)
    shows: bool = True

    def __repr__(self) -> str:
        return (
            f"Packet(frame {self.input_frameno}, {self.frame_type}, {len(self.data)} bytes)"
        )


class Context:
    """Frame in -> packet out.  Single-pass CQ for now; the orchestration
    ring (lookahead, scenechange, rate control, GOP pyramid) attaches here
    as it lands (see SURVEY.md section 2.2).

    With threads > 1 and enc.tile_cols > 1 the key frames take the tile
    route (parallel/tiles.py) over a mesh of min(threads, tile_cols)
    shards: on the first min(threads, tile_cols, GPUs) GPUs when the
    device is "cuda" and several are visible, else all on this Context's
    device (parallel/mesh.py slots_for)."""

    GROUP = 4  # pyramid sub-GOP length (reference: InterConfig group_input_len)

    def __init__(self, enc: EncoderConfig, threads: int = 0,
                 device="cuda"):
        if enc.quantizer == 0 and not enc.bitrate and enc.rc_stats is None:
            # constant quantizer 0 codes every key frame lossless (rate
            # control never picks q 0)
            raise NotImplementedError(
                "lossless coding (quantizer 0): the 4x4 Walsh-Hadamard "
                "transform a lossless frame is decoded with is not coded "
                "yet, so its stream would not decode to the recon "
                "(ROADMAP fault F6)")
        self.enc = enc
        self.threads = threads
        self.device = device
        self.frame_q: deque = deque()
        self.input_frameno = 0
        self.frames_processed = 0
        self.flushing = False
        self.limit: int | None = None
        self._encoder = None  # lazy: models.pipeline.FrameEncoder
        self._pending: list = []  # reordered packets awaiting delivery
        self._ftype_q: deque = deque()  # frame types aligned with frame_q
        self._sc = None
        # lookahead keyframe planning: the newest queued frame's scene
        # score awaiting forward validation (resolved when the NEXT frame
        # arrives, or with no forward data at flush).  Reference analog:
        # compute_keyframe_placement over the lookahead window.
        self._sc_pending: float | None = None
        # every frame is a forced keyframe at interval 1: scene analysis
        # would spend host time deciding nothing
        if (not enc.speed_settings.no_scene_detection
                and enc.max_key_frame_interval != 1):
            from rav1e_tpu_torch.api.scenechange import SceneChangeDetector

            self._sc = SceneChangeDetector(
                bit_depth=enc.bit_depth,
                min_len=enc.min_key_frame_interval,
                max_len=enc.max_key_frame_interval,
                fast=enc.speed_settings.fast_scene_detection,
            )

    # -- API ---------------------------------------------------------------

    @property
    def _lookahead_depth(self) -> int:
        """Frames buffered before encoding starts (reference analog:
        rdo_lookahead_frames driving ContextInner's lookahead queue)."""
        return max(1, min(self.enc.rdo_lookahead_frames, 64))

    def send_frame(self, frame) -> None:
        """frame: utils.Frame, or None to begin flushing."""
        if frame is None:
            self.flushing = True
            return
        if self.flushing:
            raise EncoderError(EncoderStatus.ENOUGH_DATA)
        # backpressure (reference: "The encoder received more frames than
        # its internal limit allows"): the lookahead queue is bounded
        if len(self.frame_q) >= self._lookahead_depth + self.GROUP + 1:
            raise EncoderError(EncoderStatus.ENOUGH_DATA)
        # scene analysis with deferred resolution: score the frame now,
        # decide its type once the NEXT frame's score validates it (flash
        # suppression, reference bwd/fwd model)
        if self._sc is not None:
            score = self._sc.analyze_score(frame.planes[0].window())
            self._resolve_sc_pending(next_score=score)
            self.frame_q.append((self.input_frameno, frame))
            self._ftype_q.append("inter")  # provisional until resolved
            self._sc_pending = score
        else:
            kf = self.enc.max_key_frame_interval or 240
            ftype = "key" if self.input_frameno % kf == 0 else "inter"
            self.frame_q.append((self.input_frameno, frame))
            self._ftype_q.append(ftype)
        self.input_frameno += 1

    def _resolve_sc_pending(self, next_score) -> None:
        """Resolve the newest queued frame's provisional type against the
        following frame's change score (None = end of stream)."""
        if self._sc_pending is None or not self._ftype_q:
            return
        score = self._sc_pending
        self._sc_pending = None
        is_key = self._sc.resolve(score, next_score)
        self._ftype_q[-1] = "key" if is_key else "inter"
        self._sc.commit(score, is_key)

    def receive_packet(self) -> Packet:
        if self._pending:
            self.frames_processed += 1
            return self._pending.pop(0)
        if not self.frame_q:
            if self.flushing:
                raise EncoderError(EncoderStatus.LIMIT_REACHED)
            raise EncoderError(EncoderStatus.NEED_MORE_DATA)
        # lookahead discipline: hold encoding until the queue is deep
        # enough for ahead-of-encode keyframe/GOP planning (or flushing)
        if not self.flushing and len(self.frame_q) < self._lookahead_depth:
            raise EncoderError(EncoderStatus.NEED_MORE_DATA)
        # the newest frame's type may still await forward validation; it
        # must resolve before it can be scheduled (flush: no forward data;
        # depth-1 queues: the pending frame IS the head)
        if self._sc_pending is not None and (self.flushing
                                             or len(self._ftype_q) == 1):
            self._resolve_sc_pending(None)
        self._init_encoder()
        # two-pass replays pass-1 frame types 1:1, so it runs low-latency
        if self.enc.low_latency or self._tp_alloc is not None:
            frameno, frame = self.frame_q.popleft()
            ftype = self._ftype_q.popleft()
            packet = self._encode_frame(frameno, frame, ftype)
            self.frames_processed += 1
            return packet
        # pyramid scheduling: keyframes go alone; inter runs in sub-GOPs
        if self._ftype_q[0] == "key":
            frameno, frame = self.frame_q.popleft()
            self._ftype_q.popleft()
            packet = self._encode_frame(frameno, frame, "key")
            self.frames_processed += 1
            return packet
        # count consecutive inter frames at the head; a still-unresolved
        # tail frame (awaiting forward validation) is not schedulable yet
        n_avail = len(self._ftype_q)
        if self._sc_pending is not None and not self.flushing:
            n_avail -= 1
        n_run = 0
        for i, t in enumerate(self._ftype_q):
            if i >= n_avail or t == "key":
                break
            n_run += 1
        boundary = n_run < n_avail  # a key follows the run
        if n_run >= self.GROUP or boundary or self.flushing:
            group = []
            for _ in range(min(n_run, self.GROUP)):
                group.append(self.frame_q.popleft())
                self._ftype_q.popleft()
            self._encode_group(group)
            self.frames_processed += 1
            return self._pending.pop(0)
        raise EncoderError(EncoderStatus.NEED_MORE_DATA)

    def flush(self) -> None:
        self.send_frame(None)

    def container_sequence_header(self) -> bytes:
        from rav1e_tpu_torch.obu.headers import write_sequence_header_obu

        return write_sequence_header_obu(self._sequence())

    # -- internal ----------------------------------------------------------

    def _sequence(self):
        from rav1e_tpu_torch.obu.headers import Sequence

        return Sequence(
            width=self.enc.width,
            height=self.enc.height,
            bit_depth=self.enc.bit_depth,
            subsampling_x=self.enc.chroma_sampling[0],
            subsampling_y=self.enc.chroma_sampling[1],
            still_picture=self.enc.still_picture,
        )

    def _init_encoder(self) -> None:
        if self._encoder is not None:
            return
        if True:
            from rav1e_tpu_torch.models.pipeline import FrameEncoder

            self._encoder = FrameEncoder(self.enc, device=self.device)
            self._encoder.prefetch_hook = self._maybe_prefetch_next
            # the tile route (reference analog: the rayon tile pool):
            # engaged when the config asks for both threads and tile
            # columns.  The JAX package also needs as many devices, since a
            # TPU batches tiles only over a mesh axis; on a GPU the tile
            # columns are a batch axis of each slot's device, so one GPU
            # takes them all and several share them
            if self.threads > 1 and self.enc.tile_cols > 1:
                import torch

                from rav1e_tpu_torch.parallel.mesh import make_mesh, slots_for

                n = min(self.threads, self.enc.tile_cols)
                count = (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0)
                self._encoder.wavefront_mesh = make_mesh(
                    n, devices=slots_for(self.device, n, count))
            if self.enc.bitrate > 0:
                from rav1e_tpu_torch.api.rate import RCState

                num, den = self.enc.time_base
                self._rc = RCState(
                    width=self.enc.width,
                    height=self.enc.height,
                    bit_depth=self.enc.bit_depth,
                    target_bitrate=self.enc.bitrate,
                    fps=den / num,
                    reservoir_frame_delay=self.enc.reservoir_frame_delay,
                    min_q=max(1, self.enc.min_quantizer),
                )
                # GOP-shard resume (api/resume.py): restore the reservoir
                # snapshot taken at the previous shard boundary so a
                # resumed ABR encode continues with the same rate state
                seed = getattr(self, "_rc_seed", None)
                if seed:
                    for k, v in seed.items():
                        if hasattr(self._rc, k):
                            setattr(self._rc, k, v)
            else:
                self._rc = None
            from rav1e_tpu_torch.api.rate import (
                RCState,
                TwoPassAllocator,
                TwoPassWriter,
                parse_twopass,
            )

            qstep_rc = self._rc
            if qstep_rc is None:
                qstep_rc = RCState(width=self.enc.width, height=self.enc.height,
                                   bit_depth=self.enc.bit_depth,
                                   target_bitrate=0, fps=30.0)
            self._tp_writer = TwoPassWriter(qstep_rc._qstep_table)
            self._tp_alloc = None
            if self.enc.rc_stats is not None:
                if self._rc is None:
                    raise EncoderError(EncoderStatus.FAILURE)
                metrics = parse_twopass(self.enc.rc_stats)
                self._tp_alloc = TwoPassAllocator(metrics, self._rc)

    def _maybe_prefetch_next(self) -> None:
        """Lookahead overlap: enqueue the next queued key frame's device
        pass while the current frame's host entropy pass runs.  Only when
        its quantizer is already known (constant-q, no rate control)."""
        if self._rc is not None or self._tp_alloc is not None:
            return
        if not self.frame_q:
            return
        if getattr(self._encoder, "_prefetched", None) is not None:
            return
        if getattr(self._encoder, "_prefetched_next", None):
            return
        # consecutive queued key frames batch into ONE device pass (the
        # wavefront scan alone underfills the card); F=4 as in the JAX
        # package, so the eager phase1 amortizes each batch's exposed wall
        # time over four frames' host entropy work.
        F = 4
        plist = getattr(self._encoder, "_prefetched_list", None)
        if plist:
            # a batch is in flight: double-buffer the batch AFTER it (the
            # in-flight frames are still queued — skip them by identity)
            inflight = {id(fr) for (fr, _q, _fe) in plist}
            frames = []
            for i, t in enumerate(self._ftype_q):
                if i >= len(self.frame_q):
                    break
                fr = self.frame_q[i][1]
                if id(fr) in inflight:
                    continue
                if t != "key" or len(frames) >= F:
                    break
                frames.append(fr)
            if len(frames) >= 2:
                self._encoder.prefetch_key_frames(frames, into_next=True)
            return
        if self._ftype_q[0] != "key":
            return
        n_run = 0
        for t in self._ftype_q:
            if t != "key" or n_run >= F:
                break
            n_run += 1
        if n_run >= 2:
            self._encoder.prefetch_key_frames(
                [self.frame_q[i][1] for i in range(n_run)])
        else:
            self._encoder.prefetch_key_frame(self.frame_q[0][1])

    def _encode_frame(self, frameno: int, frame, ftype: str) -> Packet:
        """Single-frame (key or low-latency P) encode."""
        if self._tp_alloc is not None:
            # pass 2: frame types and targets come from the pass-1 metrics
            ftype = self._tp_alloc.metrics[
                min(frameno, len(self._tp_alloc.metrics) - 1)
            ].frame_type
            q_idx = self._tp_alloc.select_qi()
            data, ftype = self._encoder.encode_frame(frame, frameno, q_idx, ftype)
            self._tp_alloc.update(len(data) * 8)
        else:
            q_idx = None
            if self._rc is not None:
                q_idx = self._rc.select_qi(ftype)
            data, ftype = self._encoder.encode_frame(frame, frameno, q_idx, ftype)
            if self._rc is not None:
                self._rc.update(ftype, q_idx, len(data) * 8)
        self._tp_writer.record(ftype, q_idx if q_idx is not None else self.enc.quantizer,
                               len(data) * 8)
        self._encoder.recon_by_input[frameno] = self._encoder.last_recon
        self._encoder.base_slot = 0
        self._encoder.prev_base_slot = None
        return Packet(data=data, input_frameno=frameno, frame_type=ftype)

    def _encode_group(self, group: list) -> None:
        """Pyramid sub-GOP (display-order inter frames): the group's last
        frame is coded first (no-show ALT ref), the midpoint second (no-show
        BWD ref), the leaves shown in display order with show_existing
        temporal units releasing the held frames.  Reference analog:
        InterConfig's reorder pyramid (src/api/internal.rs)."""
        from rav1e_tpu_torch.models import mv_pred as mvp

        enc = self._encoder
        base = getattr(enc, "base_slot", 0)
        prev_base = getattr(enc, "prev_base_slot", None)
        # slots 0..3 rotate for the pyramid anchors (keeping the previous
        # group's base alive one extra group as LAST2); slot 7 is pinned to
        # the most recent key frame and serves as GOLDEN (reference analog:
        # the GOLDEN/LAST2 slot management in src/api/internal.rs)
        alt_slot = (base + 1) % 4
        mid_slot = (base + 2) % 4
        GOLD = 7

        def _hint(s_):
            return enc.slots.get(s_, {"hint": -1})["hint"]

        multiref = self.enc.speed_settings.multiref

        def widen(refs):
            """Extend a ref set with GOLDEN / LAST2 when multiref is on
            and the slots hold genuinely distinct frames; with multiref
            off, collapse to LAST only (reference SpeedSettings)."""
            if not multiref:
                return {mvp.LAST_FRAME: refs[mvp.LAST_FRAME]}
            used = {_hint(s_) for s_ in refs.values()}
            if _hint(GOLD) >= 0 and _hint(GOLD) not in used:
                refs[mvp.GOLDEN_FRAME] = GOLD
                used.add(_hint(GOLD))
            if (prev_base is not None and mvp.LAST2_FRAME not in refs
                    and _hint(prev_base) not in used):
                refs[mvp.LAST2_FRAME] = prev_base
            return refs

        n = len(group)
        if self._rc is not None:
            q0 = self._rc.select_qi("inter")
        else:
            q0 = self.enc.quantizer
        total_bits = 0

        def emit(frameno, data, shows):
            self._pending.append(Packet(data=data, input_frameno=frameno,
                                        frame_type="inter", shows=shows))

        def record(frameno, data, q):
            nonlocal total_bits
            total_bits += len(data) * 8
            self._tp_writer.record("inter", q, len(data) * 8)
            enc.recon_by_input[frameno] = enc.last_recon

        # temporal RDO: importance grids over the group's display chain
        # (reference analog: compute_block_importances); blocks that later
        # frames reference heavily get scale > 1 -> lower lambda
        imp_scales = [None] * n
        if n >= 2 and self.enc.speed_settings.speed <= 7:
            try:
                from rav1e_tpu_torch.models.lookahead import (
                    importance_scale_map, intra_cost_estimate,
                    propagate_importance)

                lumas = [np.asarray(
                    f.planes[0].data[: f.planes[0].h, : f.planes[0].w],
                    np.int32) for _, f in group]
                grids = propagate_importance(lumas)
                for i in range(n):
                    ic = intra_cost_estimate(lumas[i])
                    g = grids[i]
                    h2 = min(ic.shape[0], g.shape[0])
                    w2 = min(ic.shape[1], g.shape[1])
                    imp_scales[i] = importance_scale_map(
                        g[:h2, :w2], ic[:h2, :w2], 32)
            except Exception:
                import logging

                logging.getLogger("rav1e_tpu_torch").warning(
                    "lookahead importance unavailable", exc_info=True)

        alt_no, alt_frame = group[-1]
        if n == 1:
            q = q0
            data = enc.encode_inter(alt_frame, q, alt_no,
                                    widen({mvp.LAST_FRAME: base}),
                                    show_frame=True, refresh_flags=1 << alt_slot)
            emit(alt_no, data, True)
            record(alt_no, data, q)
            enc.prev_base_slot = base
            enc.base_slot = alt_slot
        else:
            from rav1e_tpu_torch.api.rate import RCState as _RC

            q_alt, q_mid_v, q_leaf_v = _RC.group_qis(
                q0, max(1, self.enc.min_quantizer), 255)
            data = enc.encode_inter(alt_frame, q_alt, alt_no,
                                    widen({mvp.LAST_FRAME: base}),
                                    show_frame=False, refresh_flags=1 << alt_slot,
                                    imp_scale=imp_scales[n - 1])
            emit(alt_no, data, False)
            record(alt_no, data, q_alt)
            mid_i = (n - 1) // 2 if n >= 3 else None
            if mid_i is not None:
                mid_no, mid_frame = group[mid_i]
                q_mid = q_mid_v
                data = enc.encode_inter(
                    mid_frame, q_mid, mid_no,
                    widen({mvp.LAST_FRAME: base, mvp.ALTREF_FRAME: alt_slot}),
                    show_frame=False, refresh_flags=1 << mid_slot,
                    imp_scale=imp_scales[mid_i])
                emit(mid_no, data, False)
                record(mid_no, data, q_mid)
            q_leaf = q_leaf_v
            for i in range(n - 1):
                frameno, frame = group[i]
                if mid_i is not None and i == mid_i:
                    se = enc.show_existing(mid_slot)
                    emit(frameno, se, True)
                    continue
                refs = {mvp.ALTREF_FRAME: alt_slot}
                if mid_i is not None and i < mid_i:
                    refs[mvp.LAST_FRAME] = base
                    refs[mvp.BWDREF_FRAME] = mid_slot
                elif mid_i is not None:
                    refs[mvp.LAST_FRAME] = mid_slot
                    refs[mvp.LAST2_FRAME] = base  # display anchor 2 back
                else:
                    refs[mvp.LAST_FRAME] = base
                refs = widen(refs)
                data = enc.encode_inter(frame, q_leaf, frameno, refs,
                                        show_frame=True, refresh_flags=0,
                                        imp_scale=imp_scales[i])
                emit(frameno, data, True)
                record(frameno, data, q_leaf)
            emit(alt_no, enc.show_existing(alt_slot), True)
            enc.prev_base_slot = base
            enc.base_slot = alt_slot
        if self._rc is not None:
            self._rc.update_group("inter", n, total_bits)

    # -- two-pass API (reference analog: twopass_out / rc summary) ----------

    @property
    def stats(self):
        """Aggregated EncoderStats (block-mode / tx counts, per-stage
        wall time) over every frame encoded so far — the reference's
        EncoderStats + -v summary analog."""
        from rav1e_tpu_torch.utils.stats import EncoderStats

        if self._encoder is None:
            return EncoderStats()
        return self._encoder.stats

    def twopass_out(self) -> bytes:
        """Per-frame pass-1 records accumulated since the last call."""
        return self._tp_writer.out() if self._encoder else b""

    def twopass_summary(self) -> bytes:
        """Summary header to prepend to the stats file after pass 1."""
        if self._encoder is None:
            return b""
        return self._tp_writer.summary()
