"""C-style API facade.

Reference analog: src/capi.rs — the 36 exported rav1e_* symbols.  This
module mirrors their names, argument order and status-code semantics as a
flat function API over opaque handles, so C-API-shaped callers (cffi /
ctypes bridges, language bindings) port mechanically.  Functions return
negative status codes instead of raising, like the C API.

Copy of rav1e_tpu/capi.py.  A config carries the torch device of its
contexts (`rav1e_config_default(device="cpu")` for the kernels' plain
versions; the GPU otherwise).  As in the JAX package there is no
`threads` key, so a C API context never takes the tile route: tile_cols
and tile_rows give a single-device tiled encode.
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.api.config import Config, EncoderConfig, InvalidConfig, SpeedSettings
from rav1e_tpu_torch.api.context import EncoderError, EncoderStatus
from rav1e_tpu_torch.utils.frame import Frame

# rav1e.h status codes
RA_ENCODER_STATUS_SUCCESS = 0
RA_ENCODER_STATUS_NEED_MORE_DATA = 1
RA_ENCODER_STATUS_ENOUGH_DATA = 2
RA_ENCODER_STATUS_LIMIT_REACHED = 3
RA_ENCODER_STATUS_ENCODED = 4
RA_ENCODER_STATUS_FAILURE = -1

_STATUS_MAP = {
    EncoderStatus.NEED_MORE_DATA: RA_ENCODER_STATUS_NEED_MORE_DATA,
    EncoderStatus.LIMIT_REACHED: RA_ENCODER_STATUS_LIMIT_REACHED,
    EncoderStatus.ENOUGH_DATA: RA_ENCODER_STATUS_ENOUGH_DATA,
    EncoderStatus.FAILURE: RA_ENCODER_STATUS_FAILURE,
}

_STATUS_STR = {
    RA_ENCODER_STATUS_SUCCESS: "success",
    RA_ENCODER_STATUS_NEED_MORE_DATA: "need more data",
    RA_ENCODER_STATUS_ENOUGH_DATA: "enough data",
    RA_ENCODER_STATUS_LIMIT_REACHED: "limit reached",
    RA_ENCODER_STATUS_ENCODED: "encoded",
    RA_ENCODER_STATUS_FAILURE: "failure",
}


class _CConfig:
    def __init__(self, device="cuda"):
        self.enc = EncoderConfig()
        self.device = device
        self.last_status = RA_ENCODER_STATUS_SUCCESS


class _CContext:
    def __init__(self, ctx):
        self.ctx = ctx
        self.last_status = RA_ENCODER_STATUS_SUCCESS
        self.pending_packet = None


# -- config -----------------------------------------------------------------

def rav1e_config_default(device="cuda") -> _CConfig:
    return _CConfig(device)


def rav1e_config_parse(cfg: _CConfig, key: str, value: str) -> int:
    """String-keyed option parse (rav1e_config_parse)."""
    try:
        if key == "speed":
            cfg.enc.speed_settings = SpeedSettings.from_preset(int(value))
        elif key == "key_frame_interval":
            cfg.enc.max_key_frame_interval = int(value)
        elif key == "min_key_frame_interval":
            cfg.enc.min_key_frame_interval = int(value)
        elif key == "switch_frame_interval":
            cfg.enc.switch_frame_interval = int(value)
        elif key == "low_latency":
            cfg.enc.low_latency = value in ("1", "true")
        elif key == "still_picture":
            cfg.enc.still_picture = value in ("1", "true")
        elif key == "tune":
            cfg.enc.tune = value
        elif key in ("width", "height", "quantizer", "min_quantizer",
                     "bitrate", "rdo_lookahead_frames", "tile_cols",
                     "tile_rows", "tiles", "reservoir_frame_delay",
                     "key_frame_interval", "min_key_frame_interval",
                     "switch_frame_interval"):
            if key == "key_frame_interval":
                key = "max_key_frame_interval"
            setattr(cfg.enc, key, int(value))
        else:
            return RA_ENCODER_STATUS_FAILURE
        return RA_ENCODER_STATUS_SUCCESS
    except (ValueError, InvalidConfig):
        return RA_ENCODER_STATUS_FAILURE


def rav1e_config_parse_int(cfg: _CConfig, key: str, value: int) -> int:
    return rav1e_config_parse(cfg, key, str(value))


def rav1e_config_set_time_base(cfg: _CConfig, num: int, den: int) -> None:
    cfg.enc.time_base = (num, den)


def rav1e_config_set_pixel_format(cfg: _CConfig, bit_depth: int,
                                  chroma_sampling: tuple,
                                  chroma_sample_position: int,
                                  color_range: int) -> int:
    if bit_depth not in (8, 10, 12):
        return RA_ENCODER_STATUS_FAILURE
    cfg.enc.bit_depth = bit_depth
    cfg.enc.chroma_sampling = tuple(chroma_sampling)
    cfg.enc.chroma_sample_position = chroma_sample_position
    return RA_ENCODER_STATUS_SUCCESS


def rav1e_config_unref(cfg: _CConfig) -> None:
    pass  # GC-managed


# -- context ----------------------------------------------------------------

def rav1e_context_new(cfg: _CConfig):
    try:
        return _CContext(Config(enc=cfg.enc, device=cfg.device).new_context())
    except InvalidConfig:
        return None


def rav1e_context_unref(ctx: _CContext) -> None:
    pass


def rav1e_frame_new(ctx: _CContext) -> Frame:
    e = ctx.ctx.enc
    return Frame.new(e.width, e.height, e.bit_depth, e.chroma_sampling)


def rav1e_frame_fill_plane(frame: Frame, plane_idx: int, data,
                           stride: int | None = None) -> None:
    p = frame.planes[plane_idx]
    a = np.asarray(data).reshape(p.h, -1)
    p.data[: p.h, : p.w] = a[:, : p.w]


def rav1e_frame_extract_plane(frame: Frame, plane_idx: int):
    p = frame.planes[plane_idx]
    return p.data[: p.h, : p.w].copy()


def rav1e_frame_unref(frame) -> None:
    pass


def rav1e_send_frame(ctx: _CContext, frame) -> int:
    """frame=None flushes (like sending NULL)."""
    try:
        if frame is None:
            ctx.ctx.flush()
        else:
            ctx.ctx.send_frame(frame)
        ctx.last_status = RA_ENCODER_STATUS_SUCCESS
    except EncoderError as e:
        ctx.last_status = _STATUS_MAP.get(e.status, RA_ENCODER_STATUS_FAILURE)
    return ctx.last_status


def rav1e_receive_packet(ctx: _CContext):
    """(status, packet-or-None)."""
    try:
        pkt = ctx.ctx.receive_packet()
        ctx.last_status = RA_ENCODER_STATUS_SUCCESS
        return RA_ENCODER_STATUS_SUCCESS, pkt
    except EncoderError as e:
        ctx.last_status = _STATUS_MAP.get(e.status, RA_ENCODER_STATUS_FAILURE)
        return ctx.last_status, None


def rav1e_last_status(ctx: _CContext) -> int:
    return ctx.last_status


def rav1e_status_to_str(status: int) -> str:
    return _STATUS_STR.get(status, "unknown")


def rav1e_container_sequence_header(ctx: _CContext) -> bytes:
    return ctx.ctx.container_sequence_header()


def rav1e_packet_unref(pkt) -> None:
    pass


def rav1e_data_unref(data) -> None:
    pass


# -- two-pass ---------------------------------------------------------------

def rav1e_twopass_out(ctx: _CContext) -> bytes:
    return ctx.ctx.twopass_out()


def rav1e_twopass_bytes_needed(ctx: _CContext) -> int:
    from rav1e_tpu_torch.api.rate import FRAME_REC_SIZE, SUMMARY_SIZE

    return SUMMARY_SIZE + FRAME_REC_SIZE


def rav1e_twopass_summary(ctx: _CContext) -> bytes:
    """Pass-1 summary header (prepend to the concatenated twopass_out
    records to form the pass-2 stats blob)."""
    return ctx.ctx.twopass_summary()


def rav1e_config_set_rc_summary(cfg, data: bytes) -> int:
    """Install pass-1 stats for a pass-2 encode (validates the blob;
    reference: rav1e_config_set_rc_summary + rc_send_pass_data)."""
    from rav1e_tpu_torch.api.rate import TwoPassError, parse_twopass

    try:
        parse_twopass(bytes(data))
    except TwoPassError:
        return RA_ENCODER_STATUS_FAILURE
    cfg.enc.rc_stats = bytes(data)
    return 0


def rav1e_rc_summary_size() -> int:
    from rav1e_tpu_torch.api.rate import SUMMARY_SIZE

    return SUMMARY_SIZE


def rav1e_rc_send_pass_data(cfg, data: bytes) -> int:
    return rav1e_config_set_rc_summary(cfg, data)


def rav1e_rc_receive_pass_data(ctx: _CContext) -> bytes:
    """Summary + all records accumulated so far (pass-1 side)."""
    return ctx.ctx.twopass_summary() + ctx.ctx.twopass_out()


def rav1e_rc_second_pass_data_required(ctx: _CContext) -> int:
    """0 when the context already has its pass-1 stats (they are
    installed whole via the config in this implementation)."""
    return 0 if getattr(ctx.ctx.enc, "rc_stats", None) else 1


def rav1e_version_short() -> str:
    return "0.1.0"


def rav1e_version_full() -> str:
    return "rav1e-tpu-torch 0.1.0 (pytorch/cuda build)"
