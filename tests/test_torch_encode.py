"""The port's keyframe slices against the JAX package, on the CPU.

The workload is bench.py's keyframe workload: every frame a key frame,
low latency, speed 6, quantizer 100, at its defaults (CDEF and loop
restoration on) and with both filters off.  At 320x240 (= 3*64 + 48 rows)
it takes the same path as 1080p: the wavefront pass over the full
superblocks, the band RD maps for the partial bottom row, the host block
coder and the filter chain (deblock, then CDEF search and apply and the
fused Wiener LR at the defaults).

The JAX package runs once, in a module fixture (its pass compiles for
most of a minute on the CPU).  The port's forward transform may round a
coefficient within an ulp of .5 the other way (fp32 sums in another
order), which changes a decision and so the records from there on.  So:

- with the JAX package's fdct substituted, the port's pass emits records
  and recon identical to the JAX pass, and its stream is byte-identical:
  every other difference is ruled out;
- with its own fdct, the port's pass differs from the JAX one by at most
  1 in any coefficient, keeps at least SB_SHARE of the superblock
  records identical, and its stream decodes with libdav1d to exactly the
  port's own recon.

At the defaults the Wiener taps are another such seam: the JAX chain
solves them in f32, the port from exact sums in float64, so a tap may
round the other way at a .5 tie.  With the JAX fdct and the JAX tap solve
substituted (the JAX chain's taps, checked to be solved for the same CDEF
output) the stream is byte-identical; with its own, it decodes to the
port's recon.  The JAX default run is a second module fixture of
NF_DEFAULT frames: its wavefront pass is the one the first fixture
compiled (the pass cache is per process), only its filter chain compiles
anew.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rav1e_tpu.models.wavefront as jwf
import rav1e_tpu_torch.models.wavefront as twf
from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu_torch import params
from rav1e_tpu_torch.ops import transforms as tt
from rav1e_tpu_torch.utils import dav1d_oracle as dav1d
from rav1e_tpu_torch.utils.content import make_planes

# one intra-op thread: the suite runs several test processes side by
# side on the CPU, and torch's default (a thread a core in each) makes
# them contend
torch.set_num_threads(1)

W, H, NF = 320, 240, 2
# frames of the encodes at the defaults: every frame is a key frame coded
# alone, so one takes the whole path (the JAX one compiles its chain)
NF_DEFAULT = 1
# share of superblock records of the port's own pass that must equal the
# JAX pass's; the rest follow a coefficient rounded the other way
SB_SHARE = 0.5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _encode(pkg: str, capture: list | None = None, filters: bool = False,
            nf: int = NF, **cfg_kw):
    """Encode nf keyframes of the bench content, with CDEF and LR off or
    (filters) at bench.py's defaults.  Returns (packet bytes, recon planes
    per frame).  With `capture`, every wavefront launch is recorded as
    (build_pass args, upload, geometry arrays, outputs) in numpy."""
    import importlib

    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    Fr = importlib.import_module(pkg + ".utils.frame")
    wf = importlib.import_module(pkg + ".models.wavefront")
    ss = C.SpeedSettings.from_preset(6)
    if not filters:
        ss.cdef = False
        ss.lrf = False
    cfg = C.Config(enc=C.EncoderConfig(
        width=W, height=H, quantizer=100, min_key_frame_interval=1,
        max_key_frame_interval=1, rdo_lookahead_frames=8, low_latency=True,
        speed_settings=ss), **cfg_kw)
    orig = wf.build_pass

    def spy(*args, **kw):
        fn = orig(*args, **kw)

        def call(up, *dev):
            out = fn(up, *dev)
            capture.append((args, np.asarray(up).copy(),
                            [np.asarray(d).copy() for d in dev],
                            [np.asarray(o).copy() for o in out]))
            return out
        return call

    if capture is not None:
        wf.build_pass = spy
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

        for y, u, v in make_planes(W, H, nf):
            ctx.send_frame(Fr.Frame.from_planes(y, u, v))
            drain()
        ctx.flush()
        drain()
    finally:
        wf.build_pass = orig
    recon = [ctx._encoder.recon_by_input[i] for i in range(nf)]
    return [p.data for p in pkts], recon


_fdct_jit = jax.jit(tj.fdct_batch)


def _jax_fdct(resid, Fv, FhT):
    """The JAX package's fdct_batch, as a drop-in for tt.fdct_plain."""
    return torch.from_numpy(np.array(_fdct_jit(
        jnp.asarray(resid.numpy()), jnp.asarray(Fv.numpy()),
        jnp.asarray(FhT.numpy()))))


@pytest.fixture(scope="module")
def jax_run():
    launches = []
    data, recon = _encode("rav1e_tpu", capture=launches)
    return data, recon, launches


@pytest.fixture(scope="module")
def port_run():
    return _encode("rav1e_tpu_torch", device="cpu")


def _jax_pass_out(args, out):
    """(records (K, 4, B, 1688) int16, recon [Y, U, V] uint8) of a JAX
    pass launch: the packed vector holds int8 records, the recon planes
    and escape flags; the int16 records ride the second output."""
    Hp, Wp, K, B = args[:4]
    vec, p16 = out
    o = K * 4 * B * jwf.rec_width(False)
    nY, nC = Hp * Wp, (Hp >> 1) * (Wp >> 1)
    rec = [vec[o : o + nY].reshape(Hp, Wp),
           vec[o + nY : o + nY + nC].reshape(Hp >> 1, Wp >> 1),
           vec[o + nY + nC : o + nY + 2 * nC].reshape(Hp >> 1, Wp >> 1)]
    return p16, rec


def _port_pass(args, upload, dev):
    """The port's pass fed the JAX pass's upload vector and geometry."""
    names = ("sbr", "sbc", "valid", "avail", "avail8", "allow")
    t = params.from_reference({"upload": upload, **dict(zip(names, dev))})
    fn = twf.build_pass(*args, device="cpu")
    rec16, y, u, v = fn(t["upload"], *(t[k] for k in names))
    return rec16.numpy(), [y.numpy(), u.numpy(), v.numpy()]


def test_jax_reference_takes_the_slice_path(jax_run):
    _data, _recon, launches = jax_run
    assert len(launches) == NF
    for args, *_ in launches:
        # keyframe flags of the slice: tx race, fine directions, uv race,
        # 64x64 root trial on; CFL, 8x8 split and inter off
        assert args[4:8] == (8, False, True, True)
        assert args[11:] == (True, False, True, True, False)


def test_wavefront_pass_matches_jax_given_its_fdct(jax_run, monkeypatch):
    """Fed the JAX pass's upload vector, and the JAX fdct in place of its
    own, the port's pass emits identical records and recon."""
    monkeypatch.setattr(tt, "fdct_plain", _jax_fdct)
    for args, upload, dev, out in jax_run[2]:
        rec16, rec = _port_pass(args, upload, dev)
        ref16, ref = _jax_pass_out(args, out)
        assert rec16.shape == ref16.shape == (args[2], 4, args[3], 1688)
        assert np.array_equal(rec16, ref16)
        for p in range(3):
            assert np.array_equal(rec[p], ref[p]), p


def test_wavefront_pass_own_fdct(jax_run, monkeypatch):
    """With its own fdct the port's pass differs from the JAX pass only
    through coefficients rounded the other way (|delta| = 1), and keeps at
    least SB_SHARE of the superblock records identical."""
    seen = {"max": 0, "ties": 0}
    own = tt.fdct_plain

    def both(resid, Fv, FhT):
        mine = own(resid, Fv, FhT)
        d = (mine - _jax_fdct(resid, Fv, FhT)).abs()
        seen["max"] = max(seen["max"], int(d.max()))
        seen["ties"] += int((d > 0).sum())
        return mine

    monkeypatch.setattr(tt, "fdct_plain", both)
    same = total = 0
    for args, upload, dev, out in jax_run[2]:
        rec16, _rec = _port_pass(args, upload, dev)
        ref16, _ = _jax_pass_out(args, out)
        valid = dev[2]  # (K, B) lanes holding a superblock
        eq = (rec16 == ref16).all(axis=(1, 3))  # (K, B)
        same += int(eq[valid].sum())
        total += int(valid.sum())
    assert seen["max"] <= 1
    if same < total:
        assert seen["ties"] > 0
    assert same >= SB_SHARE * total, (same, total)


def test_stream_matches_jax_given_its_fdct(jax_run, monkeypatch):
    """The whole encode (pass, band maps, host coder, deblock chain) of
    the port with the JAX fdct writes the JAX package's bytes."""
    monkeypatch.setattr(tt, "fdct_plain", _jax_fdct)
    data, recon = _encode("rav1e_tpu_torch", device="cpu")
    jdata, jrecon, _ = jax_run
    assert data == jdata
    for f in range(NF):
        for p in range(3):
            assert np.array_equal(np.asarray(recon[f][p]),
                                  np.asarray(jrecon[f][p])), (f, p)


def test_stream_decodes_to_recon(port_run, jax_run):
    """The port's own stream passes libdav1d conformance (decode == recon)
    through the port's oracle, one picture per frame; its size stays
    within 1% of the JAX package's."""
    data, recon = port_run
    assert len(data) == NF
    dec = dav1d.decode_stream(data)
    assert len(dec) == NF
    for f in range(NF):
        for p in range(3):
            r = np.asarray(recon[f][p])
            assert np.array_equal(dec[f][p][: r.shape[0], : r.shape[1]],
                                  r.astype(np.uint8)), (f, p)
    jbytes = sum(len(d) for d in jax_run[0])
    assert abs(sum(len(d) for d in data) - jbytes) <= 0.01 * jbytes


# -- bench.py's defaults: CDEF and loop restoration on --------------------------


@pytest.fixture(scope="module")
def jax_default_run():
    """The JAX package at the defaults: (packets, recon, and per frame the
    fused chain's taps and en with the CDEF output they were solved
    for)."""
    from rav1e_tpu.ops import filter_chain_jax as jfc

    chains = []
    orig = jfc.collect_filter_chain

    def spy(fe, handle):
        done = orig(fe, handle)
        chains.append((np.asarray(fe._chain_lr[2]), np.asarray(fe._chain_lr[3]),
                       [p.copy() for p in fe.rec]))
        return done

    jfc.collect_filter_chain = spy
    try:
        data, recon = _encode("rav1e_tpu", filters=True, nf=NF_DEFAULT)
    finally:
        jfc.collect_filter_chain = orig
    return data, recon, chains


def _jax_taps(chains):
    """A stand-in for K7's plain version that returns, frame by frame, the
    JAX chain's taps (filter_chain_jax._wiener_solve_dev's, with its
    chroma outer-tap and en rule) after checking that it is asked to solve
    for the JAX chain's CDEF output: on equal inputs the JAX solve gives
    those taps."""
    frames = iter(chains)

    def solve(ds, ss):
        taps, en, rec = next(frames)
        for p, d in enumerate(ds):
            assert np.array_equal(d.numpy(),
                                  rec[p][: d.shape[0], : d.shape[1]]), p
        return (torch.from_numpy(taps.astype(np.int32)),
                torch.from_numpy(en.astype(np.int32)))
    return solve


@pytest.fixture(scope="module")
def port_default_run():
    return _encode("rav1e_tpu_torch", filters=True, nf=NF_DEFAULT,
                   device="cpu")


def test_default_stream_decodes_to_recon(port_default_run, port_run):
    """At the defaults the port's own stream (its fdct, its tap solve)
    decodes with libdav1d to exactly its recon, and the filters changed
    the recon (CDEF and LR ran)."""
    data, recon = port_default_run
    dec = dav1d.decode_stream(data)
    assert len(dec) == NF_DEFAULT
    for f in range(NF_DEFAULT):
        for p in range(3):
            r = np.asarray(recon[f][p])
            assert np.array_equal(dec[f][p][: r.shape[0], : r.shape[1]],
                                  r.astype(np.uint8)), (f, p)
    off = port_run[1]
    assert not np.array_equal(np.asarray(recon[0][0]), np.asarray(off[0][0]))


def test_default_stream_matches_jax_given_its_fdct_and_solve(
        jax_default_run, monkeypatch):
    """With the JAX fdct and the JAX chain's taps substituted, the port's
    stream at the defaults (wavefront, band maps, deblock, CDEF search and
    apply, fused LR, the two-pass entropy coder with read_lr and cdef_idx)
    is byte-identical to the JAX package's, and so is its recon."""
    from rav1e_tpu_torch.ops import lrf as tlr

    jdata, jrecon, chains = jax_default_run
    monkeypatch.setattr(tt, "fdct_plain", _jax_fdct)
    monkeypatch.setattr(tlr, "wiener_solve_plain", _jax_taps(chains))
    data, recon = _encode("rav1e_tpu_torch", filters=True, nf=NF_DEFAULT,
                          device="cpu")
    assert len(chains) == NF_DEFAULT
    assert data == jdata
    for f in range(NF_DEFAULT):
        for p in range(3):
            assert np.array_equal(np.asarray(recon[f][p]),
                                  np.asarray(jrecon[f][p])), (f, p)


def test_small_default_stream_decodes_to_recon():
    """A 64x64 frame, below the wavefront's envelope, at the defaults: the
    host block coder records its symbols, the chain filters the uploaded
    recon, and the recorded tiles replay with read_lr (_emit_tiles_lr's
    recorder arm); libdav1d decodes the stream to the recon."""
    from rav1e_tpu_torch import Config, EncoderConfig, SpeedSettings
    from rav1e_tpu_torch.api.context import EncoderError
    from rav1e_tpu_torch.utils.content import make_frames

    ctx = Config(enc=EncoderConfig(
        width=64, height=64, quantizer=100, min_key_frame_interval=1,
        max_key_frame_interval=1, low_latency=True,
        speed_settings=SpeedSettings.from_preset(6)),
        device="cpu").new_context()
    frames = make_frames(64, 64, 2)
    for f in frames:
        ctx.send_frame(f)
    ctx.flush()
    data = []
    with pytest.raises(EncoderError):
        while True:
            data.append(ctx.receive_packet().data)
    dec = dav1d.decode_stream(data)
    assert len(dec) == len(frames)
    for f in range(len(frames)):
        recon = ctx._encoder.recon_by_input[f]
        for p in range(3):
            r = np.asarray(recon[p])
            assert np.array_equal(dec[f][p][: r.shape[0], : r.shape[1]],
                                  r.astype(np.uint8)), (f, p)


def test_batched_pass_matches_single():
    """The F-frame batched launch (planes stacked, F*B lanes) gives every
    frame the records and recon of its own single-frame launch."""
    from rav1e_tpu_torch.models.intra_frame import IntraFrameEncoder

    fes = []
    for y, u, v in make_planes(W, H, 2, seed=3):
        fe = IntraFrameEncoder(W, H, q_idx=100, device="cpu")
        fe.prepare([y.astype(np.int32), u.astype(np.int32),
                    v.astype(np.int32)], launch=False)
        fes.append(fe)
    batch = twf.launch_wavefront_batch(fes, fes[0]._tile_grid())
    assert batch is not None
    for f, fe in enumerate(fes):
        single = twf.launch_wavefront(fe, fe._tile_grid()).collect()
        got = batch.slot(f).collect()
        # lanes without a superblock hold scratch that is never read
        valid = single.geom.valid
        assert valid.sum() < valid.size
        assert np.array_equal(got.packed.transpose(0, 2, 1, 3)[valid],
                              single.packed.transpose(0, 2, 1, 3)[valid]), f
        for p in range(3):
            assert np.array_equal(got.rec[p], single.rec[p]), (f, p)


def test_config_needs_a_card_unless_cpu():
    from rav1e_tpu_torch import Config

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Config()
    assert Config(device="cpu").device == "cpu"


def test_port_imports_no_jax():
    """Importing the port (its CLI, metrics, tile route, resume, channel
    and C API too) and encoding a 64x64
    key frame, then a 320x240 key frame and an inter frame (the inter
    wavefront path), loads neither jax nor any module of the JAX package
    (a fresh interpreter: this test process has JAX loaded already)."""
    code = (
        "import sys\n"
        "from rav1e_tpu_torch import Config, EncoderConfig, SpeedSettings\n"
        "import rav1e_tpu_torch.__main__, rav1e_tpu_torch.utils.metrics\n"
        "import rav1e_tpu_torch.parallel.tiles, rav1e_tpu_torch.capi\n"
        "import rav1e_tpu_torch.api.resume, rav1e_tpu_torch.api.channel\n"
        "from rav1e_tpu_torch.utils.content import make_frames\n"
        "ss = SpeedSettings.from_preset(6)\n"
        "ss.cdef = ss.lrf = False\n"
        "ctx = Config(enc=EncoderConfig(width=64, height=64, quantizer=100,"
        " low_latency=True, speed_settings=ss), device='cpu').new_context()\n"
        "ctx.send_frame(make_frames(64, 64, 1)[0])\n"
        "ctx.flush()\n"
        "assert len(ctx.receive_packet().data) > 0\n"
        "ctx = Config(enc=EncoderConfig(width=320, height=240, quantizer=100,"
        " low_latency=True, speed_settings=ss), device='cpu').new_context()\n"
        "for f in make_frames(320, 240, 2):\n"
        "    ctx.send_frame(f)\n"
        "ctx.flush()\n"
        "types = [ctx.receive_packet().frame_type for _ in range(2)]\n"
        "assert types == ['key', 'inter'], types\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rav1e_tpu' or m.startswith('rav1e_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")
