"""GOP-shard checkpoint/resume and per-segment failure retry.

The reference encoder is deterministic but restartable only from scratch
(its only cross-run state is the two-pass stats file; see SURVEY.md section
5 "Checkpoint / resume").  For long encodes that is not enough: a
preempted job must resume at a keyframe boundary and a transient device
failure must not kill the whole encode.  This module adds both as a
driver layer over the public Context API — no reference analog, new design:

- every keyframe starts a SEGMENT (independently decodable: the keyframe
  resets references and CDFs);
- each completed segment is persisted as a shard file plus an atomically
  updated JSON manifest carrying the frame range and the rate-control
  reservoir snapshot;
- on restart, completed segments are skipped (the scene detector is
  re-fed the skipped frames so later keyframe placement is identical),
  the RC state is restored, and encoding continues into new shards;
- a segment whose encode raises is retried on a fresh Context seeded from
  the same keyframe (per-GOP retry — the multi-host elastic-recovery
  analog flagged in SURVEY section 5).

Copy of rav1e_tpu/api/resume.py; each segment's Context runs on the
Config's device.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from rav1e_tpu_torch.api.config import Config
from rav1e_tpu_torch.api.context import EncoderError


class ShardedEncodeSession:
    """Drive an encode with per-segment shards under `workdir`.

    frame_source: callable(index) -> Frame or None (None = end of clip).
    Frames must be reproducible by index across restarts (file-backed
    sources are; live captures are not).
    """

    MANIFEST = "manifest.json"

    def __init__(self, cfg: Config, workdir, frame_source, retries: int = 1):
        self.cfg = cfg
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.source = frame_source
        self.retries = retries
        self.segments: list = []  # manifest entries, completed only
        self._load_manifest()

    # -- manifest ----------------------------------------------------------

    def _manifest_path(self) -> Path:
        return self.workdir / self.MANIFEST

    def _load_manifest(self) -> None:
        p = self._manifest_path()
        if p.exists():
            m = json.loads(p.read_text())
            self.segments = m.get("segments", [])

    def _save_manifest(self) -> None:
        tmp = self._manifest_path().with_suffix(".tmp")
        tmp.write_text(json.dumps({"segments": self.segments}, indent=1))
        os.replace(tmp, self._manifest_path())

    def _shard_path(self, seg_index: int) -> Path:
        return self.workdir / f"shard_{seg_index:05d}.obu"

    @property
    def frames_done(self) -> int:
        return sum(s["n_frames"] for s in self.segments)

    # -- segment planning ----------------------------------------------------

    def _plan_segments(self):
        """Walk the clip once, classifying each frame exactly like Context
        does (same scene detector, same intervals), and yield
        (first_frame, [frames...]) per keyframe segment."""
        enc = self.cfg.enc
        sc = None
        if (not enc.speed_settings.no_scene_detection
                and enc.max_key_frame_interval != 1):
            from rav1e_tpu_torch.api.scenechange import SceneChangeDetector

            sc = SceneChangeDetector(
                bit_depth=enc.bit_depth,
                min_len=enc.min_key_frame_interval,
                max_len=enc.max_key_frame_interval,
                fast=enc.speed_settings.fast_scene_detection,
            )
        i = 0
        seg_start = 0
        seg: list = []
        while True:
            frame = self.source(i)
            if frame is None:
                if seg:
                    yield seg_start, seg
                return
            if sc is not None:
                cut = sc.analyze(frame.planes[0].window())
                is_key = i == 0 or cut
            else:
                kf = enc.max_key_frame_interval or 240
                is_key = i % kf == 0
            if is_key and seg:
                yield seg_start, seg
                seg = []
                seg_start = i
            seg.append(frame)
            i += 1

    # -- encode ----------------------------------------------------------------

    def _encode_segment(self, frames) -> tuple:
        """Encode one keyframe segment on a fresh Context.  Returns
        (packet bytes list, rc_state dict or None)."""
        ctx = self.cfg.new_context()
        # seed the RC reservoir from the previous shard boundary (the
        # context consumes this in _init_encoder when bitrate mode is on)
        if self.segments:
            rc = self.segments[-1].get("rc_state")
            if rc is not None:
                ctx._rc_seed = rc
        pkts = []
        for f in frames:
            ctx.send_frame(f)
            while True:
                try:
                    pkts.append(ctx.receive_packet())
                except EncoderError:
                    break
        ctx.flush()
        while True:
            try:
                pkts.append(ctx.receive_packet())
            except EncoderError:
                break
        rc_state = None
        rc = getattr(ctx, "_rc", None)
        if rc is not None:
            rc_state = {k: v for k, v in vars(rc).items()
                        if isinstance(v, (int, float))}
        return pkts, rc_state

    def run(self) -> int:
        """Encode all remaining segments; returns the number of segments
        encoded in this invocation (0 when already complete)."""
        done = len(self.segments)
        encoded = 0
        for si, (first, frames) in enumerate(self._plan_segments()):
            if si < done:
                continue  # completed in a previous run
            last_err = None
            for attempt in range(self.retries + 1):
                try:
                    pkts, rc_state = self._encode_segment(frames)
                    break
                except Exception as e:  # per-GOP retry on a fresh Context
                    last_err = e
                    pkts = None
            if pkts is None:
                raise RuntimeError(
                    f"segment {si} (frame {first}) failed after "
                    f"{self.retries + 1} attempts") from last_err
            blob = b"".join(p.data for p in pkts)
            shard = self._shard_path(si)
            tmp = shard.with_suffix(".tmp")
            tmp.write_bytes(blob)
            os.replace(tmp, shard)
            self.segments.append({
                "index": si,
                "first_frame": first,
                "n_frames": len(frames),
                "n_packets": len(pkts),
                "packet_sizes": [len(p.data) for p in pkts],
                "packet_framenos": [first + p.input_frameno for p in pkts],
                "packet_shows": [bool(p.shows) for p in pkts],
                "bytes": len(blob),
                "rc_state": rc_state,
            })
            self._save_manifest()
            encoded += 1
        return encoded

    def assemble(self) -> bytes:
        """Concatenate all shards into one elementary stream."""
        out = b""
        for s in self.segments:
            out += self._shard_path(s["index"]).read_bytes()
        return out

    def packets(self) -> list:
        """Re-packetize the shards from the manifest's per-packet sizes
        (each packet is a self-contained temporal unit)."""
        pkts = []
        for s in self.segments:
            blob = self._shard_path(s["index"]).read_bytes()
            o = 0
            for n in s["packet_sizes"]:
                pkts.append(blob[o : o + n])
                o += n
        return pkts

    def packet_framenos(self) -> list:
        """Frame numbers aligned with packets() (for container muxing)."""
        out = []
        for s in self.segments:
            out.extend(s.get("packet_framenos",
                             range(s["first_frame"],
                                   s["first_frame"] + s["n_packets"])))
        return out
