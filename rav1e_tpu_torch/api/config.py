"""Encoder configuration (reference analog: src/api/config/*).

Mirrors the reference's Config -> EncoderConfig -> SpeedSettings hierarchy
and its validate() semantics, adapted to this framework's device-first design
(device batch sizes, mesh shape, etc. live here too).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


class InvalidConfig(ValueError):
    pass


@dataclass
class SpeedSettings:
    """Quality/speed trade-offs (reference: src/api/config/speedsettings.rs).

    Field set mirrors the reference's 0.5-era SpeedSettings; defaults here
    follow from_preset() at the given speed.
    """

    speed: int = 6
    partition_range: tuple = (8, 64)  # min/max partition size
    multiref: bool = True
    fast_deblock: bool = False
    reduced_tx_set: bool = False
    # NOTE: the reference's encode_bottomup / tx_domain_distortion /
    # tx_domain_rate fields are intentionally absent: this encoder's
    # device wavefront always measures tx-domain distortion for the mode
    # race and pixel-domain for the final tx choice, and bottom-up
    # partitioning is not implemented.  Fields that change no behavior
    # are not exposed.
    rdo_tx_decision: bool = True
    prediction_modes: str = "simple"  # simple | complex_keyframes | complex_all
    include_near_mvs: bool = False
    no_scene_detection: bool = False
    fast_scene_detection: bool = False
    cdef: bool = True
    lrf: bool = False
    use_satd_subpel: bool = True
    non_square_partition: bool = False
    segmentation: str = "full"
    fine_directional_intra: bool = False

    @classmethod
    def from_preset(cls, speed: int) -> "SpeedSettings":
        if not 0 <= speed <= 10:
            raise InvalidConfig(f"speed must be 0..=10, got {speed}")
        s = cls(speed=speed)
        s.multiref = speed <= 7
        # truthful range: 4x4 leaves are not implemented, so the minimum
        # is 8 at every speed (the reference opens 4x4 at speed <= 1)
        s.partition_range = (8, 64) if speed <= 8 else (32, 64)
        s.reduced_tx_set = speed >= 8
        s.rdo_tx_decision = speed <= 7
        s.prediction_modes = (
            "complex_all" if speed <= 1 else "complex_keyframes" if speed <= 5 else "simple"
        )
        s.include_near_mvs = speed <= 3
        s.fast_scene_detection = speed >= 9
        s.lrf = speed <= 6
        s.cdef = True
        s.use_satd_subpel = speed <= 8
        s.non_square_partition = speed <= 3
        s.fine_directional_intra = speed <= 7
        return s


@dataclass
class EncoderConfig:
    """Reference analog: EncoderConfig (src/api/config/encoder.rs)."""

    width: int = 640
    height: int = 480
    bit_depth: int = 8
    chroma_sampling: tuple = (1, 1)  # (ss_x, ss_y); 4:2:0 default
    chroma_sample_position: int = 0
    time_base: tuple = (1, 30)
    still_picture: bool = False
    quantizer: int = 100
    min_quantizer: int = 0
    bitrate: int = 0
    tune: str = "psychovisual"
    segmentation_aq: bool = False  # activity-driven per-segment delta-q
    tile_cols: int = 0
    tile_rows: int = 0
    tiles: int = 0
    min_key_frame_interval: int = 12
    max_key_frame_interval: int = 240
    switch_frame_interval: int = 0
    low_latency: bool = False
    error_resilient: bool = False
    rdo_lookahead_frames: int = 40
    reservoir_frame_delay: int = 24  # bit-reservoir horizon (frames)
    # two-pass: pass-1 stats blob (summary + per-frame records) for pass 2
    rc_stats: bytes | None = None
    speed_settings: SpeedSettings = field(
        default_factory=lambda: SpeedSettings.from_preset(6)
    )

    @classmethod
    def with_speed_preset(cls, speed: int) -> "EncoderConfig":
        return cls(speed_settings=SpeedSettings.from_preset(speed))

    def validate(self) -> None:
        if self.width < 16 or self.width > 65535 or self.height < 16 or self.height > 65535:
            raise InvalidConfig(f"invalid dimensions {self.width}x{self.height}")
        if self.bit_depth not in (8, 10, 12):
            raise InvalidConfig(f"bit depth {self.bit_depth} unsupported")
        if not 0 <= self.quantizer <= 255:
            raise InvalidConfig("quantizer must be 0..=255")
        if self.max_key_frame_interval < self.min_key_frame_interval:
            raise InvalidConfig("max keyframe interval < min")
        if tuple(self.chroma_sampling) not in ((1, 1), (0, 0), (1, 0)):
            raise InvalidConfig(
                "chroma sampling must be 4:2:0, 4:2:2 or 4:4:4")
        if self.switch_frame_interval and not self.low_latency:
            raise InvalidConfig("switch frames require low latency mode")


@dataclass
class Config:
    """Reference analog: Config (src/api/config/mod.rs).

    threads: the reference's rayon pool size; here the number of shards
    the key frames' tile columns are spread over (0 = single-device
    encode).  With threads > 1 and enc.tile_cols > 1 key frames take the
    tile route (parallel/tiles.py): min(threads, tile_cols) shards, laid
    over the first min(threads, tile_cols, GPUs) GPUs where device is
    "cuda" and several are visible, else all on this Config's one device;
    the tile columns of a slot are a batch axis of its one wavefront
    pass.  Its envelope: at least 2 tile columns of equal
    superblock width, width and height multiples of 64, one tile row;
    other frames take the single-device pass.  Its bytes equal the
    single-device encode's, except with the psychovisual lambda map or
    segmentation on (ROADMAP F8)."""

    enc: EncoderConfig = field(default_factory=EncoderConfig)
    threads: int = 0
    # torch device of the encoder's device passes: the GPU unless the
    # caller asks for "cpu" (the plain PyTorch versions of the kernels)
    device: str = "cuda"

    def __post_init__(self):
        import torch

        if self.device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Config(device={self.device!r}) needs a CUDA device and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch versions")

    def new_context(self):
        from rav1e_tpu_torch.api.context import Context

        self.enc.validate()
        return Context(replace(self.enc), threads=self.threads,
                       device=self.device)
