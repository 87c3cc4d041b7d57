"""The port's API surfaces against the JAX package, on the CPU.

- Config(threads=T) with tile_cols=T: the Context engages the tile route
  on its one device, and in a key + P-frame GOP only the key frame takes
  it (the P frames keep the inter wavefront);
- the channel API (api/channel.py), the C API facade (capi.py: tile
  columns through rav1e_config_parse; the two-pass surface) and the
  GOP-shard checkpoint/resume (api/resume.py: resume after a kill,
  per-segment retry, the rate-control state in the manifest), each on the
  clips of tests/test_api_analogs.py and tests/test_resume.py: the port
  writes the JAX package's bytes, and its streams decode to the frames.
  These clips are under 320x240, so both packages code them on the host
  walk and no substitution is needed.
"""

import importlib

import numpy as np
import pytest
import torch

from rav1e_tpu_torch.utils import dav1d_oracle as dav1d
from rav1e_tpu_torch.utils.content import make_planes
from tests.test_torch_tiles_route import (_decodes_to, _encode, _jax_taps,
                                          _port, _same)

# one intra-op thread: the suite runs several test processes side by
# side on the CPU
torch.set_num_threads(1)

PKGS = ("rav1e_tpu", "rav1e_tpu_torch")


# -- Config(threads) ------------------------------------------------------------


def test_context_engages_the_route_on_one_device():
    """threads=8 with tile_cols=4 at 512x256: a mesh of min(8, 4) shards,
    all on the Context's device, and the key frame on the route.  On the
    CPU the route runs the kernels' plain versions, so `wavefront_tiles`
    (the route's frames on the card) counts nothing while the stats count
    the key frame; threads=0 takes the single-device pass."""
    from rav1e_tpu_torch import kernels

    kernels.reset_counts()
    frames = make_planes(512, 256, 1, seed=3)
    out = _port(frames, 8, 4)
    mesh = out["ctx"]._encoder.wavefront_mesh
    assert mesh.size == 4
    assert set(mesh.devices) == {torch.device("cpu")}
    assert out["routes"] == {"tiles": 1}
    assert kernels.COUNTS["wavefront_tiles"] == 0
    single = _port(frames, 0, 4)
    assert getattr(single["ctx"]._encoder, "wavefront_mesh", None) is None
    assert single["routes"] == {"single": 1}
    _same(out, single)


def test_gop_inter_frames_keep_the_inter_wavefront(monkeypatch):
    """1 key + 2 P frames at 384x256 with 2 tile columns and threads=2:
    the key frame on the route, both P frames on the inter wavefront with
    no mesh (in both packages); given the JAX fdct and chain taps, the
    JAX package's bytes; with its own, a stream that decodes to its
    recon.  (Its key frame's bytes need not be the single-device
    encode's: below 640x480 the host filter path's sampled CDEF search may
    pick other strengths than the chain's, ROADMAP F9.)"""
    from rav1e_tpu_torch.ops import lrf as tlr

    frames = make_planes(384, 256, 3)
    chains = []
    jout = _encode("rav1e_tpu", frames, 2, 2, every_key=False, chains=chains)
    assert [i[0] for i in jout["inter"]] == [True, True]
    assert all(i[1] is None for i in jout["inter"])
    with monkeypatch.context() as m:
        m.setattr(tlr, "wiener_solve_plain", _jax_taps(chains))
        mine = _port(frames, 2, 2, jax_fdct=True, monkeypatch=monkeypatch,
                     every_key=False)
    assert mine["routes"] == {"tiles": 1}
    assert [i[0] for i in mine["inter"]] == [True, True]
    assert all(i[1] is None for i in mine["inter"])
    _same(mine, jout)
    own = _port(frames, 2, 2, every_key=False)
    _decodes_to(own["data"], own["recon"])


# -- the channel and the C API (tests/test_api_analogs.py) ---------------------


def _frames(pkg, n, w=64, h=64):
    Fr = importlib.import_module(pkg + ".utils.frame")
    out = []
    for t in range(n):
        y = ((np.add.outer(np.arange(h), np.arange(w)) + 3 * t) % 220).astype(
            np.uint8)
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 136, np.uint8)
        out.append(Fr.Frame.from_planes(y, u, v))
    return out


def _pkg_kw(pkg):
    return {"device": "cpu"} if pkg == "rav1e_tpu_torch" else {}


def test_channel_api():
    """4 frames through new_channel: the JAX package's packets, decoding
    to 4 pictures."""
    out = {}
    for pkg in PKGS:
        ch = importlib.import_module(pkg + ".api.channel")
        C = importlib.import_module(pkg + ".api.config")
        cfg = C.Config(enc=C.EncoderConfig(width=64, height=64, quantizer=120,
                                           low_latency=True), **_pkg_kw(pkg))
        tx, rx = ch.new_channel(cfg)
        for f in _frames(pkg, 4):
            tx.send(f)
        tx.close()
        out[pkg] = [p.data for p in rx]
    assert len(out["rav1e_tpu_torch"]) == 4
    assert out["rav1e_tpu_torch"] == out["rav1e_tpu"]
    assert len(dav1d.decode_stream(out["rav1e_tpu_torch"])) == 4


def _capi_encode(pkg, n, keys, stats=None):
    capi = importlib.import_module(pkg + ".capi")
    cfg = capi.rav1e_config_default(**_pkg_kw(pkg))
    for k, v in keys:
        assert capi.rav1e_config_parse(cfg, k, v) == 0, k
    if stats is not None:
        assert capi.rav1e_config_set_rc_summary(cfg, stats) == 0
    ctx = capi.rav1e_context_new(cfg)
    assert ctx is not None
    w = int(dict(keys)["width"])
    pkts = []
    for f in _frames(pkg, n, w=w):
        assert capi.rav1e_send_frame(ctx, f) == 0
        while True:
            st, pkt = capi.rav1e_receive_packet(ctx)
            if st != 0:
                assert st == capi.RA_ENCODER_STATUS_NEED_MORE_DATA
                break
            pkts.append(pkt)
    capi.rav1e_send_frame(ctx, None)  # flush
    while True:
        st, pkt = capi.rav1e_receive_packet(ctx)
        if st != 0:
            break
        pkts.append(pkt)
    return capi, ctx, [p.data for p in pkts]


def test_capi_roundtrip_with_tile_columns():
    """The C API with tile_cols=2 parsed from a string (128x64, so two
    superblock columns): the JAX package's bytes, two tiles a frame, a
    stream that decodes; a bogus key fails; there is no threads key, so
    the context takes the single-device tiled encode."""
    keys = (("width", "128"), ("height", "64"), ("quantizer", "120"),
            ("low_latency", "1"), ("tile_cols", "2"))
    out = {}
    for pkg in PKGS:
        capi, ctx, data = _capi_encode(pkg, 3, keys)
        out[pkg] = data
        assert capi.rav1e_config_parse(capi.rav1e_config_default(),
                                       "threads", "2") < 0
        assert capi.rav1e_config_parse(capi.rav1e_config_default(),
                                       "bogus_key", "1") < 0
        hdr = capi.rav1e_container_sequence_header(ctx)
        assert isinstance(hdr, bytes) and hdr
        assert capi.rav1e_status_to_str(0) == "success"
    assert ctx.ctx._encoder.tile_cols_log2 == 1
    assert getattr(ctx.ctx._encoder, "wavefront_mesh", None) is None
    assert len(out["rav1e_tpu_torch"]) == 3
    assert out["rav1e_tpu_torch"] == out["rav1e_tpu"]
    assert len(dav1d.decode_stream(out["rav1e_tpu_torch"])) == 3


def test_capi_twopass_roundtrip():
    """The two-pass surface: pass-1 stats out, corrupt stats refused, pass
    2 with the stats installed; both passes write the JAX package's
    bytes and stats."""
    keys = (("width", "64"), ("height", "64"), ("bitrate", "150000"),
            ("low_latency", "1"), ("rdo_lookahead_frames", "1"))
    out = {}
    for pkg in PKGS:
        capi, ctx1, data1 = _capi_encode(pkg, 4, keys)
        stats = capi.rav1e_rc_receive_pass_data(ctx1)
        assert len(stats) > capi.rav1e_rc_summary_size()
        bad = capi.rav1e_config_default(**_pkg_kw(pkg))
        assert capi.rav1e_config_set_rc_summary(bad, b"XX" + stats[2:]) != 0
        _, ctx2, data2 = _capi_encode(pkg, 4, keys, stats)
        assert capi.rav1e_rc_second_pass_data_required(ctx2) == 0
        assert len(data2) == 4
        out[pkg] = (data1, stats, data2)
    assert out["rav1e_tpu_torch"] == out["rav1e_tpu"]


# -- GOP-shard checkpoint/resume (tests/test_resume.py) -------------------------


def _clip(pkg, n=9, w=96, h=64, cuts=(3, 6)):
    """tests/test_resume.py's clip: hard scene cuts at the given frames."""
    Fr = importlib.import_module(pkg + ".utils.frame")
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    scene = 0
    for t in range(n):
        if t in cuts:
            scene += 1
        y = np.clip((xx * (scene + 1) + yy + 2 * t) % 256
                    + rng.integers(-8, 8, (h, w)), 0, 255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 100 + 40 * scene, np.uint8)
        v = np.full((h // 2, w // 2), 160 - 30 * scene, np.uint8)
        frames.append(Fr.Frame.from_planes(y, u, v))
    return frames


def _session(pkg, workdir, frames, retries=1, **kw):
    C = importlib.import_module(pkg + ".api.config")
    R = importlib.import_module(pkg + ".api.resume")
    args = dict(width=96, height=64, quantizer=120, low_latency=True,
                min_key_frame_interval=1,
                speed_settings=C.SpeedSettings.from_preset(8))
    args.update(kw)
    cfg = C.Config(enc=C.EncoderConfig(**args), **_pkg_kw(pkg))
    return R.ShardedEncodeSession(
        cfg, workdir, lambda i: frames[i] if i < len(frames) else None,
        retries=retries)


def _interrupted(pkg, workdir, frames, monkeypatch, **kw):
    """A session stopped after its first segment (the second raises with
    no retry left), then resumed by a fresh session over the same
    workdir; returns the resumed session."""
    R = importlib.import_module(pkg + ".api.resume")
    orig = R.ShardedEncodeSession._encode_segment

    def failing(self, seg_frames):
        if len(self.segments) == 1:
            raise RuntimeError("injected device failure")
        return orig(self, seg_frames)

    s = _session(pkg, workdir, frames, retries=0, **kw)
    with monkeypatch.context() as m:
        m.setattr(R.ShardedEncodeSession, "_encode_segment", failing)
        with pytest.raises(RuntimeError):
            s.run()
    assert len(s.segments) == 1  # the first shard persisted
    s2 = _session(pkg, workdir, frames, **kw)
    assert len(s2.segments) == 1  # the manifest picked up
    s2.run()
    return s2


def test_resume_after_kill_byte_identical(tmp_path, monkeypatch):
    """An uninterrupted sharded encode and one killed after its first
    segment and resumed write the same stream, the JAX package's, which
    decodes to every frame."""
    out = {}
    for pkg in PKGS:
        frames = _clip(pkg)
        full = _session(pkg, tmp_path / pkg / "full", frames)
        assert full.run() >= 2
        resumed = _interrupted(pkg, tmp_path / pkg / "part", frames,
                               monkeypatch)
        assert resumed.assemble() == full.assemble()
        out[pkg] = resumed.packets()
    assert out["rav1e_tpu_torch"] == out["rav1e_tpu"]
    assert len(dav1d.decode_stream(out["rav1e_tpu_torch"])) == 9


def test_segment_retry_recovers(tmp_path, monkeypatch):
    """A segment whose first attempt raises is retried on a fresh Context
    and the stream equals the failure-free one, the JAX package's."""
    out = {}
    for pkg in PKGS:
        R = importlib.import_module(pkg + ".api.resume")
        frames = _clip(pkg, n=5, cuts=(2,))
        ref = _session(pkg, tmp_path / pkg / "ref", frames)
        ref.run()
        calls = {"n": 0}
        orig = R.ShardedEncodeSession._encode_segment

        def flaky(self, seg_frames):
            calls["n"] += 1
            if calls["n"] == 2:  # the first segment's retry succeeds
                raise RuntimeError("transient")
            return orig(self, seg_frames)

        with monkeypatch.context() as m:
            m.setattr(R.ShardedEncodeSession, "_encode_segment", flaky)
            s = _session(pkg, tmp_path / pkg / "flaky", frames, retries=1)
            s.run()
        assert s.assemble() == ref.assemble()
        out[pkg] = s.assemble()
    assert out["rav1e_tpu_torch"] == out["rav1e_tpu"]


def test_bitrate_rc_state_carried(tmp_path, monkeypatch):
    """At a target bitrate each segment's manifest entry holds the
    rate-control state, and a resumed encode equals the uninterrupted
    one: the JAX package's stream and manifest states."""
    out = {}
    for pkg in PKGS:
        frames = _clip(pkg, n=9, cuts=(3, 6))
        kw = dict(quantizer=255, bitrate=400_000)
        s = _session(pkg, tmp_path / pkg / "abr", frames, **kw)
        s.run()
        assert len(s.segments) >= 2
        assert s.segments[0]["rc_state"], "RC snapshot missing from manifest"
        resumed = _interrupted(pkg, tmp_path / pkg / "abr2", frames,
                               monkeypatch, **kw)
        assert resumed.assemble() == s.assemble()
        out[pkg] = (s.assemble(), [g["rc_state"] for g in s.segments])
    assert out["rav1e_tpu_torch"] == out["rav1e_tpu"]
