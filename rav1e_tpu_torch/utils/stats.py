"""Encoder observability: per-frame block-mode/transform statistics and
per-stage wall-time breakdown.

Reference analog: rav1e's EncoderStats (per-frame counts of block modes
and txfm types, aggregated into the CLI -v summary) plus the hawktracer
stage instrumentation behind its `tracing` feature (SURVEY.md section 5).
Here the stage timers double as the profiling surface the device pipeline
is tuned with (device pass / transfers / entropy / filters)."""

from __future__ import annotations

import time
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field

MODE_NAMES = ("DC", "V", "H", "D45", "D135", "D113", "D157", "D203", "D67",
              "SMOOTH", "SMOOTH_V", "SMOOTH_H", "PAETH")

# transforms_np tx-type id -> display name (spec enum order)
TX_TYPE_NAMES = ("DCT_DCT", "ADST_DCT", "DCT_ADST", "ADST_ADST",
                 "FLIPADST_DCT", "DCT_FLIPADST", "FLIPADST_FLIPADST",
                 "ADST_FLIPADST", "FLIPADST_ADST", "IDTX", "V_DCT", "H_DCT",
                 "V_ADST", "H_ADST", "V_FLIPADST", "H_FLIPADST")
# DTT4_IDTX (reduced set 2) symbol -> display name, the convention the
# device wavefront records use (wavefront.LUMA_TT order)
SET2_SYMBOL_NAMES = ("IDTX", "DCT_DCT", "ADST_ADST", "ADST_DCT", "DCT_ADST")


@dataclass
class EncoderStats:
    """Per-frame (or aggregated) encode statistics."""

    frames: int = 0
    blocks: int = 0
    skip_blocks: int = 0
    mode_counts: Counter = field(default_factory=Counter)
    bsize_counts: Counter = field(default_factory=Counter)
    tx_type_counts: Counter = field(default_factory=Counter)
    cfl_blocks: int = 0
    stage_seconds: Counter = field(default_factory=Counter)
    # key frames by the route that coded them: "tiles" (the pass over the
    # tile columns), "single" (the single-device pass) or "host" (the
    # host walk)
    key_routes: Counter = field(default_factory=Counter)

    def record_block(self, mode: int, bw: int, bh: int, skip: bool,
                     tx_name: str, cfl: bool) -> None:
        self.blocks += 1
        self.skip_blocks += int(skip)
        self.mode_counts[MODE_NAMES[mode] if mode < 13 else "INTER"] += 1
        self.bsize_counts[f"{bw}x{bh}"] += 1
        self.tx_type_counts[tx_name] += 1
        self.cfl_blocks += int(cfl)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] += time.perf_counter() - t0

    def merge(self, other: "EncoderStats") -> None:
        self.frames += other.frames
        self.blocks += other.blocks
        self.skip_blocks += other.skip_blocks
        self.cfl_blocks += other.cfl_blocks
        self.mode_counts.update(other.mode_counts)
        self.bsize_counts.update(other.bsize_counts)
        self.tx_type_counts.update(other.tx_type_counts)
        self.stage_seconds.update(other.stage_seconds)
        self.key_routes.update(other.key_routes)

    def summary(self) -> str:
        lines = []
        lines.append(f"frames: {self.frames}  blocks: {self.blocks}  "
                     f"skip: {self.skip_blocks}  cfl: {self.cfl_blocks}")
        if self.blocks:
            top = ", ".join(f"{k}:{v}" for k, v in
                            self.mode_counts.most_common(6))
            lines.append(f"modes: {top}")
            bs = ", ".join(f"{k}:{v}" for k, v in
                           sorted(self.bsize_counts.items()))
            lines.append(f"block sizes: {bs}")
            tx = ", ".join(f"{k}:{v}" for k, v in
                           sorted(self.tx_type_counts.items()))
            lines.append(f"tx types: {tx}")
        if self.stage_seconds:
            st = ", ".join(f"{k}:{v * 1000:.0f}ms" for k, v in
                           sorted(self.stage_seconds.items(),
                                  key=lambda x: -x[1]))
            lines.append(f"stages: {st}")
        return "\n".join(lines)
