"""The port's speed presets 0-3 against the JAX package, on the CPU.

At speed <= 3 (SpeedSettings.from_preset(p), p in 0..3) a key frame's
wavefront pass adds the 8x8 level: every 16x16 leaf also runs four 8x8
leaves in z-order from the same pre-leaf context (an 8x8 luma leaf with
its 4x4 chroma, CFL from the 8x8 luma) and keeps NONE or SPLIT by RD.
Everything else is the speed-5 key frame's path: CFL, the host deblock
search, CDEF outside the chain, the host loop-restoration search.  The
key frame's pass flags and host filter flags are the same at presets 0-3,
so preset 3 (and preset 2 for partial edge superblocks) stands for all
four.

The JAX package's split8 pass compiles for about two minutes on the
CPU, so it runs once, in a module fixture: a 320x240 preset-3 key frame
(one partial superblock row, so host band superblocks sit next to 8x8
device leaves) whose left half is flat 8x8 patches and right half the
bench texture.  Given the JAX fdct, the port's pass emits the JAX pass's
records and recon and the encode the JAX package's bytes; with its own
fdct its stream decodes to its recon.  Under 320x240 no pass runs
(device_modes is off), so a 192x128 preset-3 GOP at EncoderConfig()'s
defaults holds the host RD at 16 and the rectangular partitions against
the JAX package with no compile.  The port's CLI (`python -m
rav1e_tpu_torch`) is the slice's second entry point.
"""

import contextlib
import importlib
import io
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu_torch.ops import transforms as tt
from rav1e_tpu_torch.utils import dav1d_oracle as dav1d
from rav1e_tpu_torch.utils.content import make_planes, make_planes_split8

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

W, H = 320, 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _encode(pkg: str, planes, speed: int = 3, size=(W, H), **cfg_kw):
    """Encode `planes` as key frames (bench.py's keyframe configuration:
    low latency, quantizer 100) at SpeedSettings.from_preset(speed).
    Returns (packet bytes, recon planes per frame, per frame a dict of
    the wavefront launch (build_pass args, upload, geometry arrays,
    outputs, all numpy), the WavefrontResult and the pre-filter planes)."""
    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    Fr = importlib.import_module(pkg + ".utils.frame")
    wf = importlib.import_module(pkg + ".models.wavefront")
    IF = importlib.import_module(pkg + ".models.intra_frame")
    w, h = size
    cfg = C.Config(enc=C.EncoderConfig(
        width=w, height=h, quantizer=100, min_key_frame_interval=1,
        max_key_frame_interval=1, rdo_lookahead_frames=8, low_latency=True,
        speed_settings=C.SpeedSettings.from_preset(speed)), **cfg_kw)
    frames = []
    orig_pass = wf.build_pass
    orig_tiles = IF.IntraFrameEncoder._encode_tiles_wavefront
    orig_finish = IF.IntraFrameEncoder._finish_encode

    def spy(*args, **kw):
        fn = orig_pass(*args, **kw)

        def call(up, *dev):
            out = fn(up, *dev)
            frames.append({"launch": (
                args, np.asarray(up).copy(),
                [np.asarray(d).copy() for d in dev],
                [np.asarray(o).copy() for o in out])})
            return out
        return call

    def tiles(fe, res):
        fe._t_wf = res
        return orig_tiles(fe, res)

    def finish(fe):
        hh, ww = fe.coded_h, fe.coded_w
        pre = [fe.rec[0][:hh, :ww].copy(),
               fe.rec[1][: hh >> 1, : ww >> 1].copy(),
               fe.rec[2][: hh >> 1, : ww >> 1].copy()]
        out = orig_finish(fe)
        if getattr(fe, "_t_wf", None) is not None:
            rec = next(f for f in frames if "wf" not in f)
            rec.update(wf=fe._t_wf, pre=pre, fe=fe)
        return out

    wf.build_pass = spy
    IF.IntraFrameEncoder._encode_tiles_wavefront = tiles
    IF.IntraFrameEncoder._finish_encode = finish
    try:
        ctx = cfg.new_context()
        pkts = []

        def drain():
            while True:
                try:
                    pkts.append(ctx.receive_packet())
                except X.EncoderError as e:
                    if e.status in (X.EncoderStatus.NEED_MORE_DATA,
                                    X.EncoderStatus.LIMIT_REACHED):
                        return
                    raise

        for y, u, v in planes:
            ctx.send_frame(Fr.Frame.from_planes(y, u, v))
            drain()
        ctx.flush()
        drain()
    finally:
        wf.build_pass = orig_pass
        IF.IntraFrameEncoder._encode_tiles_wavefront = orig_tiles
        IF.IntraFrameEncoder._finish_encode = orig_finish
    recon = [ctx._encoder.recon_by_input[i] for i in range(len(planes))]
    return [p.data for p in pkts], recon, frames


_fdct_jit = jax.jit(tj.fdct_batch)


def _jax_fdct(resid, Fv, FhT):
    """The JAX package's fdct_batch, as a drop-in for tt.fdct_plain."""
    return torch.from_numpy(np.array(_fdct_jit(
        jnp.asarray(resid.numpy()), jnp.asarray(Fv.numpy()),
        jnp.asarray(FhT.numpy()))))


def _pass_out(launch):
    """(records (K, 4, B, 1688) int16, recon [Y, U, V] uint8) of either
    package's pass launch: the JAX pass packs int8 records, the recon
    planes and escape flags into its first output and carries the int16
    records in its second; the port returns them apart."""
    args, _up, _dev, out = launch
    if len(out) == 4:
        return out[0], out[1:]
    Hp, Wp, K, B = args[:4]
    vec, p16 = out
    o = K * 4 * B * p16.shape[-1]
    nY, nC = Hp * Wp, (Hp >> 1) * (Wp >> 1)
    return p16, [vec[o : o + nY].reshape(Hp, Wp),
                 vec[o + nY : o + nY + nC].reshape(Hp >> 1, Wp >> 1),
                 vec[o + nY + nC : o + nY + 2 * nC].reshape(Hp >> 1, Wp >> 1)]


def _assert_decodes(data, recon):
    dec = dav1d.decode_stream(data)
    assert len(dec) == len(recon)
    for f, r in enumerate(recon):
        for p in range(3):
            rp = np.asarray(r[p])
            assert np.array_equal(dec[f][p][: rp.shape[0], : rp.shape[1]],
                                  rp.astype(np.uint8)), (f, p)


@pytest.fixture(scope="module")
def planes():
    return make_planes_split8(W, H, 1)


@pytest.fixture(scope="module")
def jax_run(planes):
    return _encode("rav1e_tpu", planes)


@pytest.fixture(scope="module")
def port_jax_fdct_run(planes):
    mp = pytest.MonkeyPatch()
    mp.setattr(tt, "fdct_plain", _jax_fdct)
    try:
        return _encode("rav1e_tpu_torch", planes, device="cpu")
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_run(planes):
    return _encode("rav1e_tpu_torch", planes, device="cpu")


# -- the configuration --------------------------------------------------------


def _key_encoder(pkg: str, preset: int):
    C = importlib.import_module(pkg + ".api.config")
    IF = importlib.import_module(pkg + ".models.intra_frame")
    ss = C.SpeedSettings.from_preset(preset)
    CD = importlib.import_module(pkg + ".entropy.cdf")
    kw = {} if pkg == "rav1e_tpu" else {"device": "cpu"}
    fe = IF.IntraFrameEncoder(W, H, q_idx=100, speed=preset,
                              speed_settings=ss, **kw)
    fe.cdf = CD.CdfContext(100)  # as prepare() sets it for a key frame
    return fe


def test_key_frame_flags_same_at_presets_0_to_3():
    """A key frame's pass flags (wavefront._pass_flags) and host filter
    flags are the same at presets 0, 1, 2 and 3, with the 8x8 level on;
    preset 4 turns it off."""
    from rav1e_tpu_torch.models import wavefront as twf

    host = ("lf_search", "sgr_search", "rdo_split8", "rect_parts",
            "rdo_partition", "rdo_none64", "cfl_search", "uv_search")
    seen = set()
    for p in range(4):
        fe = _key_encoder("rav1e_tpu_torch", p)
        seen.add((twf._pass_flags(fe), tuple(getattr(fe, k) for k in host)))
    assert len(seen) == 1
    flags, hflags = seen.pop()
    assert flags[6] is True and all(hflags[:4])
    assert twf._pass_flags(_key_encoder("rav1e_tpu_torch", 4))[6] is False


def test_mode_bit_params_match_jax_at_preset3():
    """The one parameter vector that crosses packages (the partition bits
    at 32, 16 (with the four 8x8 NONE symbols) and 64, and the chroma
    tables) equals the JAX package's at preset 3."""
    import rav1e_tpu.models.wavefront as jwf
    from rav1e_tpu_torch.models import wavefront as twf

    mine = twf._mode_bit_params(_key_encoder("rav1e_tpu_torch", 3))
    ref = jwf._mode_bit_params(_key_encoder("rav1e_tpu", 3))
    assert mine.dtype == ref.dtype == np.float32
    assert np.array_equal(mine, ref)


# -- the 8x8 level of the pass ------------------------------------------------


def test_split8_pass_matches_jax_given_its_fdct(jax_run, port_jax_fdct_run):
    """With the JAX fdct the port's split8 pass is fed the JAX pass's
    upload and emits its records and recon; the split maps are the same
    and hold both split and unsplit 16x16s."""
    (j,), (t,) = jax_run[2], port_jax_fdct_run[2]
    jargs, jup, jdev, _ = j["launch"]
    targs, tup, tdev, _ = t["launch"]
    assert tuple(targs) == tuple(jargs) and targs[12] is True  # split8 on
    assert np.array_equal(tup, jup)
    for a, b in zip(tdev, jdev):
        assert np.array_equal(a, b)
    rec16, rec = _pass_out(t["launch"])
    ref16, ref = _pass_out(j["launch"])
    assert rec16.shape == ref16.shape == (targs[2], 4, targs[3], 1688)
    assert np.array_equal(rec16, ref16)
    for p in range(3):
        assert np.array_equal(rec[p], ref[p]), p
    sm, jsm = t["wf"].split16_map, j["wf"].split16_map
    assert np.array_equal(sm, jsm)
    dev16 = np.repeat(np.repeat(t["wf"].geom.device_sb, 4, 0), 4, 1)
    assert sm.any() and (dev16 & ~sm & np.repeat(np.repeat(
        t["wf"].split_map, 2, 0), 2, 1)).any()


def test_split8_stream_matches_jax_given_its_fdct(jax_run, port_jax_fdct_run):
    """The whole preset-3 encode (the split8 pass, the band superblocks'
    host coding beside it, the host deblock search, CDEF and the LR
    search) with the JAX fdct writes the JAX package's bytes and recon,
    and the stream decodes to it."""
    data, recon, _ = port_jax_fdct_run
    jdata, jrecon, _ = jax_run
    assert data == jdata
    for p in range(3):
        assert np.array_equal(np.asarray(recon[0][p]),
                              np.asarray(jrecon[0][p])), p
    _assert_decodes(data, recon)


def test_split8_own_stream_decodes(port_run, jax_run):
    """With its own fdct the port's preset-3 stream, 8x8 leaves chosen,
    decodes to its recon, within 1% of the JAX package's size."""
    data, recon, (f,) = port_run
    assert f["wf"].split16_map.any()
    _assert_decodes(data, recon)
    jbytes = len(jax_run[0][0])
    assert abs(len(data[0]) - jbytes) <= 0.01 * jbytes


def test_split8_partial_superblocks_decode():
    """8x8 device leaves beside the partial right superblock column
    (330x250, coded 336x256; preset 2, the JAX package's
    test_wavefront.py:95 case), through the port alone, decode to the
    recon."""
    data, recon, (f,) = _encode("rav1e_tpu_torch",
                                make_planes(330, 250, 1, seed=12),
                                speed=2, size=(330, 250), device="cpu")
    assert f["wf"].split16_map.any()
    geom = f["wf"].geom
    assert geom.device_sb[:, :-1].all() and not geom.device_sb[:, -1].any()
    _assert_decodes(data, recon)


def _old_block_avail(geom, r, c):
    """recon_check._block_avail before the 8x8 entries: 32 and 16 only."""
    from rav1e_tpu_torch.utils import recon_check as rc

    k, li = geom.sb_step[r, c], geom.sb_lane[r, c]
    out = {}
    for q in range(4):
        qy, qx = r * 64 + rc._QOFF[q][0], c * 64 + rc._QOFF[q][1]
        out[(qx, qy, 32)] = tuple(geom.avail[k, li, q, 0, 2:4])
        for s in range(4):
            out[(qx + rc._SOFF[s][1], qy + rc._SOFF[s][0], 16)] = tuple(
                geom.avail[k, li, q, 1 + s, 2:4])
    return out


def test_recon_check_rederives_8x8_leaves(port_run, monkeypatch):
    """Every device superblock of the preset-3 frame re-derives from its
    records with the numpy oracles, 8x8 leaves with a top-right edge among
    them; with the map of 32 and 16 blocks alone (an 8x8 leaf read as
    having no top-right or bottom-left edge) some superblock does not."""
    from rav1e_tpu_torch.utils import recon_check as rc

    (f,) = port_run[2]
    wf, pre, fe = f["wf"], f["pre"], f["fe"]
    sbs = [(int(r), int(c)) for r, c in np.argwhere(wf.geom.device_sb)]
    edged = 0
    for r, c in sbs:
        assert rc.rederive_sb(wf, pre, r, c, fe.dc_q, fe.ac_q), (r, c)
        av = rc._block_avail(wf.geom, r, c)
        edged += sum(b[2] == 8 and av[(b[0], b[1], 8)] != (0, 0)
                     for b in wf.sb_records(r, c))
    assert edged > 0
    monkeypatch.setattr(rc, "_block_avail", _old_block_avail)
    assert not all(rc.rederive_sb(wf, pre, r, c, fe.dc_q, fe.ac_q)
                   for r, c in sbs)


# -- a preset-3 GOP under 320x240 (no pass) -----------------------------------


def _encode_gop(pkg: str, **cfg_kw):
    """1 key + 4 frames of 192x128 bench content at EncoderConfig()'s
    defaults (low_latency=False, an 8-frame lookahead) and preset 3.
    Returns (packet bytes, recon planes per input frame)."""
    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    Fr = importlib.import_module(pkg + ".utils.frame")
    ctx = C.Config(enc=C.EncoderConfig(
        width=192, height=128, quantizer=100, rdo_lookahead_frames=8,
        speed_settings=C.SpeedSettings.from_preset(3)), **cfg_kw).new_context()
    pkts = []

    def drain():
        while True:
            try:
                pkts.append(ctx.receive_packet())
            except X.EncoderError as e:
                if e.status in (X.EncoderStatus.NEED_MORE_DATA,
                                X.EncoderStatus.LIMIT_REACHED):
                    return
                raise

    for y, u, v in make_planes(192, 128, 5):
        ctx.send_frame(Fr.Frame.from_planes(y, u, v))
        drain()
    ctx.flush()
    drain()
    return ([p.data for p in pkts],
            [ctx._encoder.recon_by_input[i] for i in range(5)])


def test_gop_preset3_matches_jax(monkeypatch):
    """A preset-3 GOP under 320x240: the host RD at 16 under rdo_split8 and
    the rectangular partitions on the key frame, the host inter path on
    the rest.  With the JAX package's compound-mode context and extra MV
    search (ROADMAP F3, F4) substituted, the port writes the JAX
    package's bytes and recon; its own stream decodes to its recon."""
    from rav1e_tpu.models import inter_frame as jif
    from rav1e_tpu.models import mv_pred as jmvp
    from rav1e_tpu_torch.models import inter_frame as tif
    from rav1e_tpu_torch.models import mv_pred as tmvp

    jdata, jrecon = _encode_gop("rav1e_tpu")
    own, own_recon = _encode_gop("rav1e_tpu_torch", device="cpu")
    _assert_decodes(own, own_recon)
    monkeypatch.setattr(tif, "comp_mode_cdf_ctx", jif.comp_mode_cdf_ctx)
    monkeypatch.setattr(tmvp, "find_mv_stack", jmvp.find_mv_stack)
    data, recon = _encode_gop("rav1e_tpu_torch", device="cpu")
    assert len(data) == len(jdata)
    for i, (mine, theirs) in enumerate(zip(data, jdata)):
        assert mine == theirs, i
    for f in range(5):
        for p in range(3):
            assert np.array_equal(np.asarray(recon[f][p]),
                                  np.asarray(jrecon[f][p])), (f, p)


# -- the CLI ------------------------------------------------------------------


def _write_y4m(path, planes, w, h):
    from rav1e_tpu_torch.utils.frame import (Frame, write_y4m_frame,
                                             write_y4m_header)

    with open(path, "wb") as fh:
        write_y4m_header(fh, w, h)
        for p in planes:
            write_y4m_frame(fh, Frame.from_planes(*p))


def test_cli_round_trip(tmp_path):
    """`python -m rav1e_tpu_torch in.y4m -o out.ivf -s 3 --device cpu
    --psnr --reconstruction rec.y4m` on 3 frames of 192x128: the IVF
    decodes to the reconstruction y4m, and the PSNR it prints is the JAX
    package's frame_psnr of those planes against the source."""
    from rav1e_tpu.utils.metrics import frame_psnr
    from rav1e_tpu_torch.__main__ import main
    from rav1e_tpu_torch.obu.ivf import read_ivf
    from rav1e_tpu_torch.utils.frame import read_y4m

    w, h = 192, 128
    planes = make_planes(w, h, 3)
    src, ivf, rec = (str(tmp_path / n) for n in ("in.y4m", "out.ivf",
                                                  "rec.y4m"))
    _write_y4m(src, planes, w, h)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main([src, "-o", ivf, "-s", "3", "--device", "cpu", "--psnr",
                     "--reconstruction", rec]) == 0
    with open(rec, "rb") as fh:
        meta, frames = read_y4m(fh)
        recon = [[p.window().copy() for p in f.planes] for f in frames]
    assert (meta["width"], meta["height"], len(recon)) == (w, h, 3)
    with open(ivf, "rb") as fh:
        _assert_decodes([pkt for _pts, pkt in read_ivf(fh)], recon)
    psnr = [frame_psnr(r, [p.astype(np.int32) for p in s])["combined"]
            for r, s in zip(recon, planes)]
    printed = float(re.search(r"PSNR avg ([0-9.]+) dB", err.getvalue())[1])
    assert printed == float(f"{np.mean(psnr):.2f}")


def test_cli_refuses_shard_dir(tmp_path):
    """--shard-dir needs api/resume.py, not ported yet: NotImplementedError
    naming its ROADMAP item."""
    from rav1e_tpu_torch.__main__ import main

    with pytest.raises(NotImplementedError, match="item 13"):
        main([str(tmp_path / "in.y4m"), "-o", str(tmp_path / "o.ivf"),
              "--device", "cpu", "--shard-dir", str(tmp_path)])


def test_cli_needs_a_card_unless_cpu(tmp_path):
    """Without --device cpu the CLI runs on the card: with no card it
    stops with an error and writes no stream (no move to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = str(tmp_path / "in.y4m")
    _write_y4m(src, make_planes(64, 64, 1), 64, 64)
    r = subprocess.run([sys.executable, "-m", "rav1e_tpu_torch", src, "-o",
                        str(tmp_path / "o.ivf")], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert not (tmp_path / "o.ivf").exists()
