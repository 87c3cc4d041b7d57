"""The port's speed-5 slice against the JAX package, on the CPU.

At speed 5 (SpeedSettings.from_preset(5)) a key frame differs from speed 6
in three flags: the wavefront pass tries chroma-from-luma (CFL) against
DC, the deblock levels come from the host level search, and loop
restoration runs the host search (per-unit Wiener taps and the SGR sets
4 and 11).  With the deblock search the device filter chain does not run:
the host deblocks, the CDEF search and apply run outside the chain
(cdef_search_apply_device at 640x480 and up, else the sampled host search
and cdef_frame_device), and the Wiener trial filter runs on the device
(wiener_filter_frame_device, K8 in frame mode).

Each module with a kernel is held against its JAX counterpart on seeded
inputs: CFL (K11's plain version), the CDEF search and apply and the
fixed-strength apply (K5, K6), the whole-frame Wiener filter (K8 in frame
mode) and the port's copy of sgr_np.  The slice as a whole: 1 key + 1
inter frame of 320x240 content whose chroma follows its luma (so CFL
wins blocks) is byte-identical to the JAX package's stream given the JAX
fdct, and decodes to its recon; so does the port's own stream, bench
content at speed 5, and the chain's SGR route (speed 5 with
fast_deblock).

CFL's alpha is the one seam left: JAX sums res * ac and ac^2 in f32 in
XLA's order, the port exactly, rounding each sum to f32 once.  They can
round apart only where an f32 sum exceeds 2^24 or the quotient lies at a
.5 tie; the test counts such alphas on random blocks and allows no other
difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import cdef_jax as jcd
from rav1e_tpu.ops import intra_jax as jij
from rav1e_tpu.ops import lrf_jax as jlr
from rav1e_tpu.ops import sgr_np as jsg
from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu_torch.ops import cdef as tcd
from rav1e_tpu_torch.ops import intra as tij
from rav1e_tpu_torch.ops import lrf as tlr
from rav1e_tpu_torch.ops import lrf_np as tlnp
from rav1e_tpu_torch.ops import sgr_np as tsg
from rav1e_tpu_torch.ops import transforms as tt
from rav1e_tpu_torch.utils import dav1d_oracle as dav1d
from rav1e_tpu_torch.utils.content import make_planes, make_planes_cfl

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

SEED = 20261017
W, H = 320, 240


# -- K11 cfl ----------------------------------------------------------------------


def _jax_cfl(luma, dc, src):
    """The JAX package's CFL arm (wavefront.py:709-717 with intra_jax's
    cfl_ac_420_batch and cfl_predict_batch) on (B, n, n) luma and (B, 2,
    n/2, n/2) DC predictions and sources."""
    ac = jij.cfl_ac_420_batch(jnp.asarray(luma))
    a_den = (ac.astype(jnp.float32) ** 2).sum((-1, -2))
    alphas, preds = [], []
    for p in range(2):
        res = jnp.asarray(src[:, p] - dc[:, p])
        num = (res.astype(jnp.float32) * ac).sum((-1, -2))
        af = jnp.round(64.0 * num / jnp.maximum(a_den, 1.0))
        a = jnp.where(a_den > 0, jnp.clip(af, -16, 16), 0.0).astype(jnp.int32)
        alphas.append(np.asarray(a))
        preds.append(np.asarray(jij.cfl_predict_batch(
            jnp.asarray(dc[:, p]), ac, a, 8)))
    return np.stack(alphas, 1), np.stack(preds, 1)


def _cfl_case(kind, n, rng, B=512):
    n2 = n // 2
    luma = rng.integers(0, 256, (B, n, n))
    if kind == "flat":
        luma[: B // 2] = luma[: B // 2, :1, :1]  # sum(ac^2) == 0
    src = rng.integers(0, 256, (B, 2, n2, n2))
    dc = rng.integers(0, 256, (B, 2, 1, 1)).repeat(n2, 2).repeat(n2, 3)
    if kind == "clip":
        # chroma residual many times the luma AC: alpha clips at +-16
        ac = np.asarray(jij.cfl_ac_420_batch(jnp.asarray(luma)))
        sign = rng.choice([-1, 1], (B, 2, 1, 1))
        src = dc + sign * ac[:, None] // 2
    return luma.astype(np.int32), dc.astype(np.int32), src.astype(np.int32)


def _quotients(luma, dc, src):
    """The exact (float64 of exact sums) 64 * sum(res * ac) / sum(ac^2)."""
    ac = np.asarray(jij.cfl_ac_420_batch(jnp.asarray(luma))).astype(np.int64)
    den = (ac * ac).sum((-1, -2))[:, None]
    num = ((src - dc).astype(np.int64) * ac[:, None]).sum((-1, -2))
    return 64.0 * num / np.maximum(den, 1), den


@pytest.mark.parametrize("kind", ["random", "flat", "clip"])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_cfl_plain_matches_jax(n, kind):
    """K11's plain version against cfl_ac_420_batch, the JAX alpha fit
    and cfl_predict_batch: alphas equal except where the JAX f32 sums can
    round apart (the exact quotient within 2^-16 relative of a .5 tie,
    or a sum of ac^2 above 2^24 and the quotient within 1e-3 of a tie),
    and there only by 1; predictions equal wherever the alphas are; the
    residual is src - pred."""
    rng = np.random.default_rng(SEED + n + len(kind))
    luma, dc, src = _cfl_case(kind, n, rng)
    alpha, pred, resid = (t.numpy() for t in tij.cfl_plain(
        torch.from_numpy(luma), torch.from_numpy(dc), torch.from_numpy(src)))
    ja, jp = _jax_cfl(luma, dc, src)
    assert np.array_equal(resid, src - pred)
    q, den = _quotients(luma, dc, src)
    tie = np.abs(np.abs(q - np.floor(q)) - 0.5)
    near = (tie <= np.abs(q) * 2.0 ** -16) | ((den > 2 ** 24) & (tie < 1e-3))
    diff = alpha != ja
    assert not (diff & ~near).any()
    assert np.abs(alpha - ja).max() <= 1
    same = ~diff
    assert np.array_equal(pred[same], jp[same])
    print(f"cfl n={n} {kind}: {int(diff.sum())} of {diff.size} alphas "
          f"differ (at f32 ties)")
    if kind == "flat":
        assert (alpha[: len(alpha) // 2] == 0).all()
        assert np.array_equal(pred[: len(pred) // 2], dc[: len(dc) // 2])
    if kind == "clip":
        assert (np.abs(alpha) == 16).mean() > 0.9


# -- CDEF outside the chain (K5, K6) ----------------------------------------------


def _planes(rng, w, h):
    """A source of smooth (y, u, v) waves, deblocked-like int32 planes of
    it with noise (which CDEF takes off), and a per-mi skip map with
    skipped regions."""
    yy, xx = np.mgrid[0:h, 0:w]
    src = [128 + 50 * np.sin(xx / 7.0) * np.cos(yy / 11.0)]
    for k in (5.0, 6.0):
        src.append(128 + 40 * np.sin(xx[::2, ::2] / k + yy[::2, ::2] / 9.0))
    src = [p.astype(np.int32) for p in src]
    # noise from none to strong across the superblock columns, so that
    # superblocks want different strengths
    rec = []
    for p in src:
        amp = np.linspace(0, 24, p.shape[1]).astype(np.int64)[None, :] + 1
        noise = rng.integers(-(1 << 20), 1 << 20, p.shape) % amp - amp // 2
        rec.append(np.clip(p + noise, 0, 255).astype(np.int32))
    skip = rng.random((h // 4, w // 4)) < 0.2
    skip[: h // 16, : w // 8] = True  # a region with no coded block
    return rec, src, skip


@pytest.mark.parametrize("sb_lam", [None, 0.5])
def test_cdef_search_apply_device_matches_jax(sb_lam):
    """cdef_search_apply_device at 640x480 (the encoder's route from
    DEV_CDEF_MIN_AREA up): strengths, the per-superblock index map and
    the three filtered planes identical to the JAX package's."""
    w, h = 640, 480
    rec, src, skip = _planes(np.random.default_rng(SEED), w, h)
    jrec = [p.copy() for p in rec]
    jst, _jdev, jsb = jcd.cdef_search_apply_device(
        jrec, src, skip, 4, 8, w, h, sb_lam=sb_lam)
    trec = [p.copy() for p in rec]
    st, (db_y, cd_y), sb = tcd.cdef_search_apply_device(
        trec, src, skip, 4, 8, w, h, sb_lam=sb_lam, device="cpu")
    assert st == jst
    assert (sb is None) == (jsb is None)
    if sb is not None:
        assert sb[:3] == jsb[:3]
        assert np.array_equal(sb[3], jsb[3])
    if sb_lam is not None:
        assert sb is not None  # the per-SB mode won at this lambda
    for p in range(3):
        assert np.array_equal(trec[p], jrec[p]), p
    assert not np.array_equal(trec[0], rec[0])
    assert np.array_equal(db_y.numpy(), rec[0])
    assert np.array_equal(cd_y.numpy(), trec[0])


@pytest.mark.parametrize("strengths", [(2, 2, 1, 0), (4, 0, 2, 0),
                                       (1, 2, 0, 0), (0, 0, 2, 0)])
def test_cdef_frame_device_matches_jax(strengths):
    """cdef_frame_device (the small-frame route after _cdef_search) with
    fixed strengths, including luma/chroma pairs no single candidate pair
    joins, identical to the JAX package's."""
    rec, _src, skip = _planes(np.random.default_rng(SEED + 1), W, H)
    jrec = [p.copy() for p in rec]
    jcd.cdef_frame_device(jrec, skip, *strengths, 4, 8, W, H)
    trec = [p.copy() for p in rec]
    tcd.cdef_frame_device(trec, skip, *strengths, 4, 8, W, H, device="cpu")
    for p in range(3):
        assert np.array_equal(trec[p], jrec[p]), p
    assert not all(np.array_equal(trec[p], rec[p]) for p in range(3))


# -- the whole-frame Wiener filter (K8 frame mode) --------------------------------


@pytest.mark.parametrize("stripe", [64, 32])
def test_wiener_filter_frame_device_matches_jax(stripe):
    """wiener_filter_frame_device (K8 in frame mode) at stripes 64 (luma)
    and 32 (chroma) identical to the JAX package's and to lrf_np's."""
    rng = np.random.default_rng(SEED + stripe)
    w, h = (W, H) if stripe == 64 else (W // 2, H // 2)
    cd = rng.integers(0, 256, (h, w)).astype(np.int32)
    db = np.clip(cd + rng.integers(-20, 21, cd.shape), 0, 255).astype(np.int32)
    vt, ht = (3, -9, 21), (-2, 5, 12)
    if stripe == 32:
        vt, ht = (0,) + vt[1:], (0,) + ht[1:]
    got = tlr.wiener_filter_frame_device(cd, db, vt, ht, stripe, 8, w, h,
                                         device="cpu")
    ref = jlr.wiener_filter_frame_device(cd, db, vt, ht, stripe, 8, w, h)
    assert got.shape == (h, w)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, tlnp.wiener_filter_frame(cd, db, vt, ht,
                                                        stripe, 8, w, h))
    # the device-resident planes (the CDEF pass's luma) give the same
    dev = tlr.wiener_filter_frame_device(
        None, None, vt, ht, stripe, 8, w, h, dev_cdef=torch.from_numpy(cd),
        dev_db=torch.from_numpy(db), device="cpu")
    assert np.array_equal(dev, got)


# -- sgr_np ---------------------------------------------------------------------------


@pytest.mark.parametrize("si", [4, 11, 14])
def test_sgr_np_matches_jax(si):
    """The port's copy of sgr_np against the JAX package's: the guided
    filter outputs of a whole frame, the projection solve and the apply
    of one unit."""
    rng = np.random.default_rng(SEED + si)
    w, h = 128, 96
    cd = rng.integers(0, 256, (h, w)).astype(np.int32)
    db = np.clip(cd + rng.integers(-10, 11, cd.shape), 0, 255).astype(np.int32)
    src = np.clip(cd + rng.integers(-15, 16, cd.shape), 0, 255).astype(np.int64)
    got = tsg.sgr_flt_frame(cd, db, si, 8, w, h)
    ref = jsg.sgr_flt_frame(cd, db, si, 8, w, h)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert np.array_equal(g, r)
    f0, f1 = (None if f is None else f[:64, :64] for f in got)
    base = cd[:64, :64].astype(np.int64)
    xqd = tsg.solve_xqd(base, src[:64, :64], f0, f1, si)
    assert list(xqd) == list(jsg.solve_xqd(base, src[:64, :64], f0, f1, si))
    assert np.array_equal(tsg.sgr_apply(base, f0, f1, xqd, si, 8),
                          jsg.sgr_apply(base, f0, f1, xqd, si, 8))


# -- the slice: 1 key + 1 inter frame at speed 5 ----------------------------------


def _encode(pkg: str, planes, nf: int, fast_deblock: bool = False,
            **cfg_kw):
    """Encode nf frames of `planes` at speed 5 in bench.py's mixed
    configuration (a key frame, then low-latency inter frames).  Returns
    (packet bytes, recon planes per frame, the encoder's stats)."""
    import importlib

    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    Fr = importlib.import_module(pkg + ".utils.frame")
    ss = C.SpeedSettings.from_preset(5)
    ss.fast_deblock = fast_deblock
    ctx = C.Config(enc=C.EncoderConfig(
        width=W, height=H, quantizer=100, max_key_frame_interval=240,
        rdo_lookahead_frames=8, low_latency=True, speed_settings=ss),
        **cfg_kw).new_context()
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

    for y, u, v in planes[:nf]:
        ctx.send_frame(Fr.Frame.from_planes(y, u, v))
        drain()
    ctx.flush()
    drain()
    assert [p.frame_type for p in pkts] == ["key"] + ["inter"] * (nf - 1)
    recon = [ctx._encoder.recon_by_input[i] for i in range(nf)]
    return [p.data for p in pkts], recon, ctx._encoder.stats


_fdct_jit = jax.jit(tj.fdct_batch)


def _jax_fdct(resid, Fv, FhT):
    """The JAX package's fdct_batch, as a drop-in for tt.fdct_plain."""
    return torch.from_numpy(np.array(_fdct_jit(
        jnp.asarray(resid.numpy()), jnp.asarray(Fv.numpy()),
        jnp.asarray(FhT.numpy()))))


def _assert_decodes(data, recon):
    dec = dav1d.decode_stream(data)
    assert len(dec) == len(recon)
    for f, r in enumerate(recon):
        for p in range(3):
            rp = np.asarray(r[p])
            assert np.array_equal(dec[f][p][: rp.shape[0], : rp.shape[1]],
                                  rp.astype(np.uint8)), (f, p)


@pytest.fixture(scope="module")
def cfl_planes():
    return make_planes_cfl(W, H, 2)


@pytest.fixture(scope="module")
def jax_run(cfl_planes):
    return _encode("rav1e_tpu", cfl_planes, 2)


def test_speed5_stream_matches_jax_given_its_fdct(jax_run, cfl_planes,
                                                  monkeypatch):
    """1 key + 1 inter frame at speed 5 (CFL in the keyframe pass, the
    host deblock search, _cdef_search + cdef_frame_device at 320x240, the
    host LR search with SGR and per-unit taps, the inter pass): with the
    JAX fdct the port writes the JAX package's bytes and recon, CFL won
    blocks in both, and both streams decode to their recon."""
    jdata, jrecon, jstats = jax_run
    monkeypatch.setattr(tt, "fdct_plain", _jax_fdct)
    data, recon, stats = _encode("rav1e_tpu_torch", cfl_planes, 2,
                                 device="cpu")
    assert stats.cfl_blocks == jstats.cfl_blocks > 0
    assert data == jdata
    for f in range(2):
        for p in range(3):
            assert np.array_equal(np.asarray(recon[f][p]),
                                  np.asarray(jrecon[f][p])), (f, p)
    _assert_decodes(jdata, jrecon)
    _assert_decodes(data, recon)


def test_speed5_own_stream_decodes_to_recon():
    """The port's own stream (its fdct) at speed 5 on bench content, 1
    key + 1 inter frame, decodes to its recon; loop restoration chose
    SGR units (sgr_np's output decodes exactly)."""
    from rav1e_tpu_torch.models import intra_frame

    seen = []
    orig = intra_frame.IntraFrameEncoder._lr_apply

    def spy(fe):
        seen.append(dict(fe._lr_params))
        return orig(fe)

    intra_frame.IntraFrameEncoder._lr_apply = spy
    try:
        data, recon, _st = _encode("rav1e_tpu_torch", make_planes(W, H, 2), 2,
                                   device="cpu")
    finally:
        intra_frame.IntraFrameEncoder._lr_apply = orig
    _assert_decodes(data, recon)
    kinds = [v[0] for params in seen for v in params.values() if v]
    print("luma LR units:", {k: kinds.count(k) for k in set(kinds)})
    assert "sgr" in kinds


def test_speed5_chain_sgr_route_decodes_to_recon():
    """Speed 5 with fast_deblock: no deblock search, so the device chain
    runs deblock and CDEF, skips its fused LR and hands the deblocked
    planes to the host LR search (filter_chain_jax.py:327, :360); the
    stream decodes to its recon."""
    from rav1e_tpu_torch.ops import filter_chain

    handles = []
    orig = filter_chain.launch_filter_chain

    def spy(fe):
        h = orig(fe)
        handles.append(h)
        return h

    filter_chain.launch_filter_chain = spy
    try:
        data, recon, _st = _encode("rav1e_tpu_torch", make_planes(W, H, 1), 1,
                                   fast_deblock=True, device="cpu")
    finally:
        filter_chain.launch_filter_chain = orig
    assert len(handles) == 1
    assert handles[0]["lr"] is None and handles[0]["db"] is not None
    _assert_decodes(data, recon)
