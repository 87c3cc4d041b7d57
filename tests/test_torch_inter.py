"""The port's P-frame slice against the JAX package, on the CPU.

The workload is bench.py's mixed GOP: a key frame, then inter frames, low
latency, speed 6, quantizer 100 at its defaults (CDEF and loop
restoration on).  At 320x240 (= 3*64 + 48 rows) the inter frames take the
path they take at 1080p: the inter wavefront over the full superblocks
(in-pass motion search, MC candidate races with level-1 thinning, the
intra-vs-inter race), the band tail that decides the partial bottom row,
the host block coder with host MC, and the filter chain.

The JAX package runs once, in a module fixture: 1 key + 2 inter frames
through Config -> Context, its wavefront launches (the keyframe pass and
the inter pass, compiled once each) and its filter chain's Wiener taps
recorded.  As in tests/test_torch_encode.py, the port's forward transform
may round a coefficient within an ulp of .5 the other way, and its Wiener
taps come from exact sums where the JAX chain sums f32; with the JAX fdct
and the JAX taps substituted, the inter pass's records, recon and band-tail
MVs are identical and the stream is byte-identical.  The remaining f32
seams of this slice (the race's dist/rate sums in another order, log2 of
the rate model; the skip-vs-code SSE, exact here) show as band-tail costs
within COST_RTOL of the JAX pass's.

Each kernel of the slice is held against the JAX function through its
plain version: K9 (MC) against mc_jax and mc_np, K10 (motion search)
against the jitted me_fullpel, K2 with thinning against the JAX
fdct -> quantize -> thin -> dequantize composition.
"""

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

W, H, NF = 320, 240, 3  # 1 key + 2 inter frames
COST_RTOL = 1e-5
SEED = 20261017


def _encode(pkg: str, launches: list | None = None,
            chains: list | None = None, **cfg_kw):
    """Encode NF frames of the bench content in bench.py's mixed-GOP
    configuration.  Returns (packet bytes, frame types, recon planes per
    frame).  With `launches`, every wavefront launch is recorded as
    (build_pass args, upload, geometry arrays, outputs) in numpy; with
    `chains` (the JAX package), every filter chain's (taps, en, the CDEF
    output they were solved for)."""
    import importlib

    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    Fr = importlib.import_module(pkg + ".utils.frame")
    wf = importlib.import_module(pkg + ".models.wavefront")
    cfg = C.Config(enc=C.EncoderConfig(
        width=W, height=H, quantizer=100, max_key_frame_interval=240,
        rdo_lookahead_frames=8, low_latency=True,
        speed_settings=C.SpeedSettings.from_preset(6)), **cfg_kw)
    undo = []
    if launches is not None:
        orig = wf.build_pass

        def spy(*args, **kw):
            fn = orig(*args, **kw)

            def call(up, *dev):
                out = fn(up, *dev)
                launches.append((args, np.asarray(up).copy(),
                                 [np.asarray(d).copy() for d in dev],
                                 [np.asarray(o).copy() for o in out]))
                return out
            return call

        wf.build_pass = spy
        undo.append((wf, "build_pass", orig))
    if chains is not None:
        from rav1e_tpu.ops import filter_chain_jax as jfc

        orig_c = jfc.collect_filter_chain

        def cspy(fe, handle):
            done = orig_c(fe, handle)
            chains.append((np.asarray(fe._chain_lr[2]),
                           np.asarray(fe._chain_lr[3]),
                           [p.copy() for p in fe.rec]))
            return done

        jfc.collect_filter_chain = cspy
        undo.append((jfc, "collect_filter_chain", orig_c))
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

        for y, u, v in make_planes(W, H, NF):
            ctx.send_frame(Fr.Frame.from_planes(y, u, v))
            drain()
        ctx.flush()
        drain()
    finally:
        for mod, name, orig in undo:
            setattr(mod, name, orig)
    recon = [ctx._encoder.recon_by_input[i] for i in range(NF)]
    return [p.data for p in pkts], [p.frame_type for p in pkts], recon


_fdct_jit = jax.jit(tj.fdct_batch)


def _jax_fdct(resid, Fv, FhT):
    """The JAX package's fdct_batch, as a drop-in for tt.fdct_plain."""
    return torch.from_numpy(np.array(_fdct_jit(
        jnp.asarray(resid.numpy()), jnp.asarray(Fv.numpy()),
        jnp.asarray(FhT.numpy()))))


def _jax_taps(chains):
    """A stand-in for K7's plain version returning, frame by frame, the
    JAX chain's taps after checking it is asked to solve for the JAX
    chain's CDEF output (test_torch_encode._jax_taps)."""
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
def jax_run():
    launches, chains = [], []
    data, types, recon = _encode("rav1e_tpu", launches=launches,
                                 chains=chains)
    return data, types, recon, launches, chains


# -- K9: MC ------------------------------------------------------------------------


@pytest.mark.parametrize("n,sub", [(64, 0), (32, 0), (16, 0), (32, 1),
                                   (16, 1), (8, 1)])
def test_mc_plain_matches_jax_and_numpy(n, sub):
    """K9's plain version against mc_jax.put_single_batch (every block)
    and mc_np.put_single (a sample): every residue of the MV mod 16 in
    each axis (all 16 chroma phases, every luma phase), blocks at the
    frame's edges, MVs at +-MV_LIMIT.  Identical."""
    from rav1e_tpu.ops import mc_jax as mj
    from rav1e_tpu_torch.ops import mc, mc_np

    rng = np.random.default_rng(SEED + n + sub)
    rh, rw = 150 >> sub, 200 >> sub  # real plane, not 64-aligned
    ref = rng.integers(0, 256, (rh, rw)).astype(np.int32)
    B = 272
    hp, wp = (rh + 63) & ~63, (rw + 63) & ~63
    px = rng.integers(0, wp // n, B) * n
    py = rng.integers(0, hp // n, B) * n
    px[:4], py[:4] = (0, wp - n, 0, wp - n), (0, 0, hp - n, hp - n)
    lim = mc.MV_LIMIT
    mv = rng.integers(-lim, lim + 1, (B, 2))
    mv[:8] = [(lim, lim), (-lim, -lim), (lim, -lim), (-lim, lim)] * 2
    k = np.arange(B - 8)
    mv[8:, 0] = np.clip((mv[8:, 0] & ~15) + (k // 16) % 16, -lim, lim)
    mv[8:, 1] = np.clip((mv[8:, 1] & ~15) + k % 16, -lim, lim)
    want = mj.put_single_batch(ref, np.stack([px, py], 1), mv, n, n, sub,
                               sub, 8, 0, margin=mc.MC_MARGIN)
    # put_single_batch pads to the 64-aligned plane plus 64
    pad = mc.pad_ref_plane(ref, mc.MC_MARGIN, hp + 64, wp + 64)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    got = mc.mc_block_batch(torch.as_tensor(pad.astype(np.uint8)),
                            mc.MC_MARGIN, t(px), t(py), t(mv[:, 0]),
                            t(mv[:, 1]), n, n, sub, sub).numpy()
    assert np.array_equal(got, want)
    for i in list(range(8)) + list(rng.choice(np.arange(8, B), 24, False)):
        ref_np = mc_np.put_single(ref, int(px[i]), int(py[i]), n, n,
                                  int(mv[i, 0]), int(mv[i, 1]), sub, sub, 8)
        assert np.array_equal(got[i], ref_np), (i, mv[i])


def test_mc_plain_asserts_the_window_stays_inside():
    """A window past the padded plane is a caller's fault, not a clamp."""
    from rav1e_tpu_torch.ops import mc

    pad = torch.zeros((64 + 2 * mc.MC_MARGIN, 64 + 2 * mc.MC_MARGIN),
                      dtype=torch.uint8)
    t = lambda v: torch.as_tensor([v], dtype=torch.int32)
    with pytest.raises(AssertionError, match="leaves the padded plane"):
        mc.mc_block_batch(pad, mc.MC_MARGIN, t(0), t(48), t(8 * 46), t(0),
                          16, 16, 0, 0)


# -- K10: full-pel motion search -----------------------------------------------------


@pytest.mark.parametrize("kind", ["shifted", "flat"])
def test_me_plain_matches_jax(kind):
    """K10's plain version against the jitted device_pipeline.me_fullpel
    at 256x128: a reference shifted by a known offset plus noise, and a
    flat reference where every offset ties (the first minimum wins).  MVs
    identical."""
    from rav1e_tpu.models.device_pipeline import me_fullpel as jme
    from rav1e_tpu_torch.models import device_pipeline as dp

    rng = np.random.default_rng(SEED + len(kind))
    h, w = 128, 256
    base = rng.integers(0, 256, (h + 64, w + 64))
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    src = base[32 : 32 + h, 32 : 32 + w]
    if kind == "flat":
        ref = np.full((h, w), 77)
    else:
        ref = np.clip(base[32 - 5 : 32 - 5 + h, 32 + 11 : 32 + 11 + w]
                      + rng.integers(-3, 4, (h, w)), 0, 255)
    want = np.asarray(jme(jnp.asarray(src, jnp.int32),
                          jnp.asarray(ref, jnp.int32), 32))
    got = dp.me_fullpel(torch.as_tensor(src.astype(np.uint8)),
                        torch.as_tensor(ref.astype(np.uint8)), 32).numpy()
    assert np.array_equal(got, want)
    if kind == "flat":  # every offset ties: the first one, (-32, -32) + (-2, -2)
        assert (got == -34).all()
    else:
        assert (got[1:-1, 1:-1] == (5, -11)).all()


# -- K2 with the inter race's level-1 thinning ---------------------------------------


@pytest.mark.parametrize("n", [16, 32, 64])
def test_fwd_txq_thin_plain_matches_jax(n, monkeypatch):
    """fwd_txq with per-block thinning thresholds against the JAX
    composition of the race (wavefront.py:437-446): fdct_batch, quantize,
    the drop of |level| == 1 off DC where float(|cf| << shift) < thr1,
    dequantize.  Levels and dequantised values identical given the JAX
    fdct; dist and rate within 1e-6 relative."""
    from rav1e_tpu_torch.ops import transforms_np as tn
    from rav1e_tpu_torch.ops.quantize_np import tx_scale

    monkeypatch.setattr(tt, "fdct_plain", _jax_fdct)
    rng = np.random.default_rng(SEED + 3 * n)
    m = min(n, 32)
    Fv, FhT = tt.fwd_mats(tn.DCT_DCT, n, n)
    Fv, FhT = Fv[:m], FhT[:, :m]
    B = 96
    resid = rng.integers(-30, 31, (B, n, n)).astype(np.int32)
    qdc = np.full(B, 116, np.int32)
    qac = rng.integers(100, 200, B).astype(np.int32)
    lam = rng.uniform(300, 2000, B).astype(np.float32)
    shift = tx_scale(n, n)
    alpha = tn.tx_alpha(m, m, 8)
    thr_j = (jnp.asarray(lam) * 4.0 / (alpha * jnp.asarray(qac).astype(
        jnp.float32)) + jnp.asarray(qac)) / 2.0
    cf = tj.fdct_batch(jnp.asarray(resid), jnp.asarray(Fv), jnp.asarray(FhT))
    lv = tj.quantize(cf, jnp.asarray(qdc), jnp.asarray(qac), shift)
    mag = jnp.abs(cf) << shift
    drop = (jnp.abs(lv) == 1) & (mag.astype(jnp.float32) < thr_j[:, None, None])
    drop = drop.at[:, 0, 0].set(False)
    lv = jnp.where(drop, 0, lv)
    dq = tj.dequantize(lv, jnp.asarray(qdc), jnp.asarray(qac), shift, 8)
    qerr = ((cf - dq) << shift).astype(jnp.float32)
    a = jnp.abs(lv).astype(jnp.float32)
    rate_j = (tt.RATE_NZ * (a > 0).sum((-1, -2)).astype(jnp.float32)
              + tt.RATE_MAG * jnp.log2(1.0 + a).sum((-1, -2)))
    thr = (torch.as_tensor(lam) * 4.0
           / (alpha * torch.as_tensor(qac).to(torch.float32))
           + torch.as_tensor(qac)) / 2.0
    assert np.array_equal(thr.numpy(), np.asarray(thr_j))
    got = tt.fwd_txq(torch.as_tensor(resid), torch.as_tensor(Fv[None]),
                     torch.as_tensor(FhT[None]), torch.as_tensor(qdc),
                     torch.as_tensor(qac), shift, thr=thr)
    assert int(drop.sum()) > 0
    assert np.array_equal(got[0].numpy(), np.asarray(lv))
    assert np.array_equal(got[1].numpy(), np.asarray(dq))
    np.testing.assert_allclose(got[2].numpy(),
                               np.asarray((qerr * qerr).sum((-1, -2))),
                               rtol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(rate_j), rtol=1e-6)


# -- the inter pass ----------------------------------------------------------------


def _jax_pass_out(args, out):
    """(records int16, recon [Y, U, V], band tail) of a JAX inter pass
    launch: the packed vector holds int8 records, the recon planes, escape
    flags and the band tail; the int16 records ride the second output."""
    Hp, Wp, K, B = args[:4]
    vec, p16 = out
    o = K * 4 * B * jwf.rec_width(True)
    nY, nC = Hp * Wp, (Hp >> 1) * (Wp >> 1)
    rec = [vec[o : o + nY].reshape(Hp, Wp),
           vec[o + nY : o + nY + nC].reshape(Hp >> 1, Wp >> 1),
           vec[o + nY + nC : o + nY + 2 * nC].reshape(Hp >> 1, Wp >> 1)]
    t = o + nY + 2 * nC + B
    R, C = Hp // 64, Wp // 64
    tail = []
    for shape, dt in (((Hp // 32, Wp // 32, 2), np.int16),
                      ((R, C), np.float32), ((R, C, 2), np.int16),
                      ((R, C, 4), np.float32), ((R, C, 4, 2), np.int16),
                      ((R, C, 4, 4), np.float32),
                      ((R, C, 4, 4, 2), np.int16)):
        nb = int(np.prod(shape)) * np.dtype(dt).itemsize
        tail.append(vec[t : t + nb].view(dt).reshape(shape))
        t += nb
    assert t == vec.size
    return p16, rec, tail


def test_inter_pass_matches_jax_given_its_fdct(jax_run, monkeypatch):
    """Fed the JAX inter pass's upload vector (the port's own layout:
    pack_upload + _inter_upload) and the JAX fdct, the port's inter pass
    emits identical records (1772 words a lane), recon and band-tail ME
    map and MVs; the band-tail costs agree within COST_RTOL."""
    monkeypatch.setattr(tt, "fdct_plain", _jax_fdct)
    names = ("sbr", "sbc", "valid", "avail", "avail8", "allow")
    inter = [ln for ln in jax_run[3] if ln[0][15]]
    assert len(inter) == NF - 1
    for args, upload, dev, out in inter:
        t = params.from_reference({"upload": upload, **dict(zip(names, dev))})
        fn = twf.build_pass(*args, device="cpu")
        rec16, y, u, v, tail = fn(t["upload"], *(t[k] for k in names))
        ref16, ref, ref_tail = _jax_pass_out(args, out)
        assert rec16.shape == ref16.shape == (args[2], 4, args[3], 1772)
        assert np.array_equal(rec16.numpy(), ref16)
        for p, plane in enumerate((y, u, v)):
            assert np.array_equal(plane.numpy(), ref[p]), p
        for i, (mine, theirs) in enumerate(zip(tail, ref_tail)):
            mine = mine.numpy()
            if theirs.dtype == np.int16:  # ME map and MVs
                assert np.array_equal(mine, theirs), i
            else:
                np.testing.assert_allclose(mine, theirs, rtol=COST_RTOL)
        # inter blocks were chosen, with motion
        modes = rec16.numpy()[..., 1]
        assert (modes == 13).any()


# -- whole streams -----------------------------------------------------------------


def test_stream_matches_jax_given_its_fdct_and_solve(jax_run, monkeypatch):
    """1 key + 2 inter frames through Config -> Context, the port with the
    JAX fdct and the JAX chain's taps: the JAX package's bytes and recon."""
    from rav1e_tpu_torch.ops import lrf as tlr

    jdata, jtypes, jrecon, _launches, chains = jax_run
    assert jtypes == ["key"] + ["inter"] * (NF - 1)
    monkeypatch.setattr(tt, "fdct_plain", _jax_fdct)
    monkeypatch.setattr(tlr, "wiener_solve_plain", _jax_taps(chains))
    data, types, recon = _encode("rav1e_tpu_torch", device="cpu")
    assert types == jtypes
    assert data == jdata
    for f in range(NF):
        for p in range(3):
            assert np.array_equal(np.asarray(recon[f][p]),
                                  np.asarray(jrecon[f][p])), (f, p)


def _decodes_to(data, recon):
    dec = dav1d.decode_stream(data)
    assert len(dec) == len(recon)
    for f, r in enumerate(recon):
        for p in range(3):
            rp = np.asarray(r[p])
            assert np.array_equal(dec[f][p][: rp.shape[0], : rp.shape[1]],
                                  rp.astype(np.uint8)), (f, p)


def test_streams_decode_to_recon(jax_run):
    """The port's own stream (its fdct, its tap solve) decodes with
    libdav1d, through the port's oracle, to exactly its recon; so does the
    JAX package's stream to the JAX package's recon (the reference is
    sound at this size)."""
    from rav1e_tpu_torch import kernels

    kernels.reset_counts()
    data, types, recon = _encode("rav1e_tpu_torch", device="cpu")
    assert types == ["key"] + ["inter"] * (NF - 1)
    _decodes_to(data, recon)
    _decodes_to(jax_run[0], jax_run[2])
    # CPU tensors run the plain versions: nothing was launched
    assert not any(kernels.COUNTS.values())


# -- what the path must not do --------------------------------------------------------


def test_native_coder_failure_raises(monkeypatch):
    """A native block coder that cannot be built or loaded raises from the
    encoder; the Python block walk does not stand in for it."""
    from rav1e_tpu_torch.ec import native_block
    from rav1e_tpu_torch.models.intra_frame import IntraFrameEncoder

    planes = [p.astype(np.int32) for p in make_planes(W, H, 1)[0]]

    def broken(fe):
        raise OSError("libmsac.so: cannot open shared object file")

    monkeypatch.setattr(native_block, "block_coder_for", broken)
    with pytest.raises(OSError, match="libmsac"):
        IntraFrameEncoder(W, H, q_idx=100, device="cpu").prepare(
            planes, launch=False)
    monkeypatch.setattr(native_block, "block_coder_for", lambda fe: None)
    with pytest.raises(RuntimeError, match="native block coder"):
        IntraFrameEncoder(W, H, q_idx=100, device="cpu").prepare(
            planes, launch=False)


def test_references_beyond_last_raise():
    """An inter frame with LAST and ALTREF on both temporal sides (the
    pyramid's inner frames) encodes on the host inter path with
    reference_select and compound blocks, and the stream decodes to its
    recon.  At 192x128 nothing runs a wavefront: the hidden ALTREF and the
    inner frame both take the host path, with the diamond search (no ME
    map under 320x240).  The name is kept from when this raised."""
    from rav1e_tpu_torch import EncoderConfig
    from rav1e_tpu_torch.models import inter_frame as tif
    from rav1e_tpu_torch.models.pipeline import FrameEncoder
    from rav1e_tpu_torch.utils.content import make_frames

    w, h = 192, 128
    fes = []
    orig = tif.InterFrameEncoder._finish_encode

    def spy(fe):
        fes.append(fe)
        return orig(fe)

    tif.InterFrameEncoder._finish_encode = spy
    try:
        enc = FrameEncoder(EncoderConfig(width=w, height=h), device="cpu")
        frames = make_frames(w, h, 3)
        data = [enc.encode_key_frame(frames[0], 100)]
        key_recon = enc.last_recon
        # the ALTREF: hidden, LAST only, into slot 1
        data.append(enc.encode_inter(frames[2], 100, 2, {1: 0},
                                     show_frame=False, refresh_flags=1 << 1))
        data.append(enc.encode_inter(frames[1], 100, 1, {1: 0, 7: 1},
                                     show_frame=True, refresh_flags=0))
    finally:
        tif.InterFrameEncoder._finish_encode = orig
    alt, mid = fes
    assert not alt.wf_inter and not alt.reference_select
    assert not mid.wf_inter and mid.ref_ids == [1, 7]
    assert mid.reference_select and mid.sign_bias == {1: 0, 7: 1}
    assert mid.comp_block_count > 0
    assert mid._me_maps == {}
    _decodes_to(data, [key_recon, enc.last_recon])
