"""The port above 8 bits (10- and 12-bit 4:2:0) and at 8-bit lossless,
against the JAX package, on the CPU.

These frames cannot take the wavefront (it is 8-bit and lossy), so:
- an intra frame of 320x240 and up takes frame_rd_maps (K1 and K2's
  float-floor variant over the whole luma plane) and the host walk;
- inter frames take the host inter path, its ME maps K10 through
  frame_me_map on 16-bit planes;
- every frame takes the host filter path: CDEF through the bd > 8 arm of
  cdef_search_apply_device from 640x480 up, else cdef_frame_device (K5,
  K6 with the strengths shifted by bd - 8 and the damping grown by it),
  and the Wiener trial filter at bd (K8's frame mode).

The same numpy inputs, from one seed, go through the port's plain
versions and through the JAX functions:
- frame_rd_maps: modes, split32 and nnz identical except where two costs
  lie within RD_TIE of each other (counted, at most RD_TIE_SHARE of the
  blocks); costs to rtol 1e-4 (the two fp32 transforms sum in other
  orders).
- the CDEF search sums its SSE exactly in int64, the JAX one in f32 (no
  longer exact above 8 bits): a superblock's choice may differ only where
  its two candidates' exact costs lie within f32 rounding (counted).
- cdef_frame_device, the Wiener frame filter and frame_me_map: identical.
- whole encodes through Config -> Context (the lossless key frame through
  FrameEncoder: the port's Context refuses quantizer 0, ROADMAP F6):
  byte-identical to rav1e_tpu's.
  The 10-bit GOP reaches the two cells where the JAX package writes what
  libdav1d misreads (ROADMAP F3, F4): the port follows the spec there, so
  it matches the JAX bytes with those two functions of the JAX package
  substituted, and its own stream decodes to its recon.

The small JAX search and filter programs run op by op (eagerly), as in
tests/test_torch_filters.py, to avoid their compiles.
"""

import hashlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.models import device_pipeline as jdp
from rav1e_tpu.ops import cdef_jax as jcd
from rav1e_tpu.ops import lrf_jax as jlr
from rav1e_tpu_torch.models import device_pipeline as tdp
from rav1e_tpu_torch.ops import cdef as tcd
from rav1e_tpu_torch.ops import lrf as tlr
from rav1e_tpu_torch.ops import lrf_np as tlnp
from rav1e_tpu_torch.ops import quantize_np as tqz
from rav1e_tpu_torch.ops import transforms as tt
from rav1e_tpu_torch.utils import dav1d_oracle as dav1d
from rav1e_tpu_torch.utils.content import make_frames, make_planes

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

SEED = 20261017
RD_TIE = 1e-5  # relative gap of two RD costs that fp32 order may flip
RD_TIE_SHARE = 0.005
LAM_MULT = 0.1155  # intra_frame's RD lambda: LAM_MULT * (dc_q / 8)^2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hbd(rng, p, bd):
    """An 8-bit plane at bd bits: shifted, low bits random."""
    s = bd - 8
    return (np.asarray(p, np.int64) << s) + rng.integers(0, 1 << s, p.shape)


# -- frame_rd_maps ------------------------------------------------------------------


def _costs(y, n, q, lam):
    """The port's plain (modes, by, bx) RD cost table of rd_analysis."""
    blocks, stack = tdp.predict_all(y, n)
    Fv, FhT = tdp._fwd_mats(n, y.device)
    dist, rate, _nnz = tt.fwd_rd_float_plain(blocks[None] - stack, Fv, FhT,
                                             q[0], q[1], 1 if n == 32 else 0)
    return (dist * tdp.DIST_SCALE[n] + lam * (rate + 6.0)).numpy()


@pytest.mark.parametrize("bd,q_idx", [(8, 0), (10, 100), (12, 100)])
def test_frame_rd_maps_matches_jax(bd, q_idx):
    """frame_rd_maps over a 320x256 bench luma plane at 8-bit lossless
    (q 0), 10 and 12 bits against the JAX package's: modes, nnz and
    split32 identical but at counted near-ties, costs to rtol 1e-4."""
    y = make_planes(320, 256, 1, seed=SEED, bit_depth=bd)[0][0]
    y = y.astype(np.int32)
    dc_q, ac_q = tqz.dc_q(q_idx, 0, bd), tqz.ac_q(q_idx, 0, bd)
    lam = LAM_MULT * (dc_q / 8.0) ** 2
    want = jdp.frame_rd_maps(y, dc_q, ac_q, lam)
    got = tdp.frame_rd_maps(y, dc_q, ac_q, lam, device="cpu")
    ties = blocks = 0
    for n in (32, 16):
        (m, c, z), (jm, jc, jz) = got[n], want[n]
        assert m.dtype == np.int32 and c.dtype == np.float32
        assert m.shape == jm.shape == (256 // n, 320 // n)
        np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-4)
        table = np.sort(_costs(_t(y), n, (dc_q, ac_q),
                               torch.tensor(lam, dtype=torch.float32)), 0)
        near = (table[1] - table[0]) <= RD_TIE * table[0]
        differ = (m != np.asarray(jm)) | (z != np.asarray(jz))
        assert not (differ & ~near).any(), n
        ties += int(differ.sum())
        blocks += m.size
    c32, c16 = got[32][1], got[16][1]
    gap = np.abs(c16.reshape(8, 2, 10, 2).sum((1, 3)) + lam * 6.0 - c32)
    differ = got["split32"] != want["split32"]
    assert not (differ & (gap > 1e-4 * np.abs(c32))).any()
    ties += int(differ.sum())
    print(f"frame_rd_maps bd {bd} q {q_idx}: {ties} of {blocks} at ties")
    assert ties <= RD_TIE_SHARE * blocks
    # the split map decides something at every bit depth
    assert 0 < got["split32"].sum() < got["split32"].size or bd == 8


# -- CDEF above 8 bits (K5, K6) -------------------------------------------------------


def _cdef_planes(rng, w, h, bd, kind):
    """(rec, src, skip) at bd bits: smooth waves with noise that CDEF
    takes off (as tests/test_torch_speed5.py makes them), or maximum
    contrast: 0 and (1 << bd) - 1 in 8x8 blocks and in single samples,
    whose superblock SSE exceeds 2^31."""
    yy, xx = np.mgrid[0:h, 0:w]
    mx = (1 << bd) - 1
    src = [128 + 50 * np.sin(xx / 7.0) * np.cos(yy / 11.0)]
    for k in (5.0, 6.0):
        src.append(128 + 40 * np.sin(xx[::2, ::2] / k + yy[::2, ::2] / 9.0))
    src = [_hbd(rng, p.astype(np.int64), bd) for p in src]
    rec = []
    for p in src:
        amp = (np.linspace(0, 24, p.shape[1]).astype(np.int64)[None, :] + 1
               << (bd - 8))
        noise = rng.integers(-(1 << 20), 1 << 20, p.shape) % amp - amp // 2
        rec.append(np.clip(p + noise, 0, mx))
    if kind == "contrast":
        for i, p in enumerate(rec):
            hh, ww = p.shape
            blk = 8 >> (i > 0)
            cb = ((np.arange(hh)[:, None] // blk + np.arange(ww) // blk) % 2)
            lone = rng.random(p.shape) < 0.3
            p[:, : ww // 2] = np.where(lone, rng.integers(0, 2, p.shape) * mx,
                                       cb * mx)[:, : ww // 2]
            src[i][:, : ww // 2] = (mx - p)[:, : ww // 2]
    skip = rng.random((h // 4, w // 4)) < 0.2
    skip[: h // 16, : w // 8] = True  # a region with no coded block
    return ([p.astype(np.int32) for p in rec],
            [p.astype(np.int32) for p in src], skip)


@pytest.mark.parametrize("kind", ["waves", "contrast"])
@pytest.mark.parametrize("bd", [10, 12])
def test_cdef_search_apply_device_hbd_matches_jax(bd, kind):
    """cdef_search_apply_device at 256x128 (called directly: the function
    has no area gate) at 10 and 12 bits against the JAX search program of
    cdef_jax.py:234: strengths, the index map and the filtered planes
    identical, a superblock's choice different only where the JAX f32
    costs of its two candidates lie within f32 rounding."""
    w, h, sb_lam = 256, 128, 0.5
    rec, src, skip = _cdef_planes(np.random.default_rng(SEED + bd), w, h,
                                  bd, kind)
    kern = jcd._make_search_kernel(bd, w, h).__wrapped__
    j = kern(*(jnp.asarray(a.astype(np.uint16)) for a in (*rec, *src)),
             jnp.asarray(skip), np.float32(sb_lam), damping=4)
    jst, jsb = jcd._sb_result(bool(j[0]), int(j[1]),
                              np.asarray(j[2]).astype(np.int32))
    trec = [p.copy() for p in rec]
    st, (db_y, cd_y), sb = tcd.cdef_search_apply_device(
        trec, src, skip, 4, bd, w, h, sb_lam=sb_lam, device="cpu")
    # the exact per-SB costs the port decided on
    y, u, v = (_t(p) for p in rec)
    dirs, var = tcd.cdef_dir(y, bd)
    sse = tcd.cdef_filter(y, u, v, *(_t(p) for p in src), dirs, var,
                          tcd.active_blocks(_t(skip), h, w), 4 + bd - 8,
                          tcd.SEARCH, None, bd)
    cost = (sse[:8] + sse[8:][list(tcd.PAIR_UV_IDX)]).numpy()
    if kind == "contrast":
        assert cost.max() > 2 ** 31  # an int32 sum would overflow
    jidx = np.asarray(j[2])
    ties = 0
    if st != jst or (sb is None) != (jsb is None):
        # the frame-level choice itself: its two candidates' frame costs
        # within f32 rounding of the f32 sum over the superblocks
        fc = cost.sum((1, 2))
        a, b = fc[tcd.Y_CANDIDATES.index(_pair(st))], fc[int(j[1])]
        assert abs(a - b) <= 2 ** -23 * max(a, b) * cost[0].size * 2
        ties = 1
    elif sb is not None:
        idx = sb[3]
        for r, c in zip(*np.nonzero(idx != jidx)):
            a, b = cost[idx[r, c], r, c], cost[jidx[r, c], r, c]
            assert abs(a - b) <= 2 ** -23 * max(a, b) * 64, (r, c, a, b)
            ties += 1
    print(f"cdef search bd {bd} {kind}: {ties} choices at f32 ties")
    if not ties:
        for p, ref in enumerate(j[3:]):
            assert np.array_equal(trec[p], np.asarray(ref)), p
    assert not np.array_equal(trec[0], rec[0])
    assert np.array_equal(db_y.numpy(), rec[0])
    assert np.array_equal(cd_y.numpy(), trec[0])
    assert all(int(p.max()) < 1 << bd for p in trec)


def _pair(strengths):
    """The (pri, sec) luma candidate of a frame-level strength code."""
    y = strengths[0]
    return (y >> 2, 4 if (y & 3) == 3 else y & 3)


@pytest.mark.parametrize("strengths", [(4, 2, 2, 0), (1, 2, 2, 0)])
@pytest.mark.parametrize("bd", [10, 12])
def test_cdef_frame_device_hbd_matches_jax(bd, strengths):
    """cdef_frame_device (the route under 640x480) at 10 and 12 bits with
    fixed strengths, one luma/chroma pair that a candidate pair joins and
    one that none does, identical to the JAX program of cdef_jax.py:133,
    also on maximum-contrast planes."""
    w, h = 256, 128
    rng = np.random.default_rng(SEED + bd + strengths[0])
    for kind in ("waves", "contrast"):
        rec, _src, skip = _cdef_planes(rng, w, h, bd, kind)
        kern = jcd._make_kernel(bd, w, h).__wrapped__
        j = kern(*(jnp.asarray(p.astype(np.uint16)) for p in rec),
                 jnp.asarray(skip), *strengths, damping=4)
        trec = [p.copy() for p in rec]
        tcd.cdef_frame_device(trec, skip, *strengths, 4, bd, w, h,
                              device="cpu")
        for p in range(3):
            assert np.array_equal(trec[p], np.asarray(j[p])), (kind, p)
        assert not all(np.array_equal(trec[p], rec[p]) for p in range(3))


# -- the Wiener frame filter (K8 frame mode) ------------------------------------------


@pytest.mark.parametrize("stripe", [64, 32])
@pytest.mark.parametrize("bd", [10, 12])
def test_wiener_filter_frame_device_hbd_matches_jax(bd, stripe):
    """wiener_filter_frame_device at 10 and 12 bits (the rounding of
    lrf_jax.py:50-55), stripes 64 (luma) and 32 (chroma), identical to
    the JAX package's and to lrf_np's, on planes reaching both ends of
    the range."""
    rng = np.random.default_rng(SEED + bd + stripe)
    w, h = (320, 240) if stripe == 64 else (160, 120)
    mx = (1 << bd) - 1
    cd = rng.integers(0, mx + 1, (h, w)).astype(np.int32)
    cd[:16] = np.where(rng.random((16, w)) < 0.5, 0, mx)
    db = np.clip(cd + rng.integers(-80, 81, cd.shape), 0, mx).astype(np.int32)
    vt, ht = (3, -9, 21), (-2, 5, 12)
    if stripe == 32:
        vt, ht = (0,) + vt[1:], (0,) + ht[1:]
    got = tlr.wiener_filter_frame_device(cd, db, vt, ht, stripe, bd, w, h,
                                         device="cpu")
    ref = jlr.wiener_filter_frame_device(cd, db, vt, ht, stripe, bd, w, h)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, tlnp.wiener_filter_frame(cd, db, vt, ht,
                                                        stripe, bd, w, h))
    assert got.max() == mx and got.min() == 0


# -- frame_me_map on 16-bit planes (K10) ----------------------------------------------


@pytest.mark.parametrize("kind", ["flat", "noisy"])
def test_frame_me_map_10bit_matches_jax(kind):
    """frame_me_map at 10 bits over a 320x256 source and an edge-padded
    320x240 reference, flat (every offset ties) and noisy content shifted
    by a known motion: identical to the JAX package's."""
    rng = np.random.default_rng(SEED + 7 + len(kind))
    h, w, rh = 256, 320, 240
    base = rng.integers(0, 1024, (h + 64, w + 64))
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    src = base[32 : 32 + h, 32 : 32 + w].astype(np.int32)
    if kind == "flat":
        ref = np.full((rh, w), 700, np.int32)
        ref[:, 200:] = 701
    else:
        ref = np.clip(base[32 - 3 : 32 - 3 + rh, 32 + 6 : 32 + 6 + w]
                      + rng.integers(-16, 17, (rh, w)), 0, 1023)
    pad = np.zeros_like(src)
    pad[:rh] = ref
    pad[rh:] = pad[rh - 1 : rh]
    want = np.asarray(jdp.frame_me_map(src, pad, 32))
    got = tdp.frame_me_map(src, pad, 32, bit_depth=10, device="cpu")
    assert np.array_equal(got, want)
    if kind == "noisy":
        assert (got[:-1] == (8 * 3, -8 * 6)).all(-1).mean() > 0.85


# -- whole encodes through Config -> Context -------------------------------------------

FIELDS = ("wf_inter", "ref_ids", "reference_select", "comp_block_count",
          "interp_filter", "lr_types")


def _encode(pkg, w, h, nf, bd, quantizer=100, **cfg_kw):
    """Encode nf frames of bd-bit bench content at EncoderConfig()'s
    defaults.  Returns (packets, per-inter-frame FIELDS, recon planes per
    input frame, the number of frame_rd_maps calls)."""
    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    IF = importlib.import_module(pkg + ".models.inter_frame")
    DP = importlib.import_module(pkg + ".models.device_pipeline")
    cfg = C.Config(enc=C.EncoderConfig(width=w, height=h,
                                       quantizer=quantizer,
                                       rdo_lookahead_frames=8, bit_depth=bd),
                   **cfg_kw)
    info, rd_calls = [], []
    orig_f, orig_rd = IF.InterFrameEncoder._finish_encode, DP.frame_rd_maps

    def fspy(fe):
        out = orig_f(fe)
        info.append({k: getattr(fe, k) for k in FIELDS})
        info[-1]["lr_types"] = list(info[-1]["lr_types"])
        return out

    def rdspy(*a, **k):
        rd_calls.append(a[0].shape)
        return orig_rd(*a, **k)

    IF.InterFrameEncoder._finish_encode = fspy
    DP.frame_rd_maps = rdspy
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

        for f in make_frames(w, h, nf, bit_depth=bd):
            ctx.send_frame(f)
            drain()
        ctx.flush()
        drain()
    finally:
        IF.InterFrameEncoder._finish_encode = orig_f
        DP.frame_rd_maps = orig_rd
    recon = [ctx._encoder.recon_by_input[i] for i in range(nf)]
    return [p.data for p in pkts], info, recon, len(rd_calls)


def _decodes_to(data, recon, bd):
    dec = dav1d.decode_stream(data)
    assert len(dec) == len(recon)
    for f, r in enumerate(recon):
        for p in range(3):
            rp = np.asarray(r[p])
            d = dec[f][p]
            assert d.dtype == (np.uint8 if bd == 8 else np.uint16)
            assert np.array_equal(d[: rp.shape[0], : rp.shape[1]], rp), (f, p)


@pytest.fixture(scope="module")
def jax_gop10():
    return _encode("rav1e_tpu", 320, 240, 5, 10)


def test_gop_10bit_matches_jax(jax_gop10, monkeypatch):
    """1 key + 4 inter frames of 10-bit 320x240 content at the defaults:
    the key frame on frame_rd_maps and the host walk, the pyramid's inner
    frames on the host inter path with compound blocks.  With the JAX
    package's compound-mode context and extra MV search (F3, F4)
    substituted, the port writes the JAX package's bytes, with the same
    per-frame paths and decisions and the same recon."""
    from rav1e_tpu.models import inter_frame as jif
    from rav1e_tpu.models import mv_pred as jmvp
    from rav1e_tpu_torch.models import inter_frame as tif
    from rav1e_tpu_torch.models import mv_pred as tmvp

    jdata, jinfo, jrecon, jrd = jax_gop10
    monkeypatch.setattr(tif, "comp_mode_cdf_ctx", jif.comp_mode_cdf_ctx)
    monkeypatch.setattr(tmvp, "find_mv_stack", jmvp.find_mv_stack)
    data, info, recon, rd = _encode("rav1e_tpu_torch", 320, 240, 5, 10,
                                    device="cpu")
    assert rd == jrd == 1
    assert info == jinfo
    assert not any(f["wf_inter"] for f in info)
    assert any(f["comp_block_count"] > 0 for f in info)
    assert len(data) == len(jdata) == 7  # and two show_existing_frame
    for i, (mine, theirs) in enumerate(zip(data, jdata)):
        assert mine == theirs, i
    for f in range(5):
        for p in range(3):
            assert np.array_equal(np.asarray(recon[f][p]),
                                  np.asarray(jrecon[f][p])), (f, p)


def test_gop_10bit_own_stream_decodes_to_recon(jax_gop10):
    """The port's own 10-bit stream (the spec's compound-mode context and
    extra MV search) decodes with libdav1d to its recon, frame for frame
    and by the 16-bit digests chip_smoke.py writes; on CPU tensors the
    wrappers counted nothing."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    kernels.reset_counts()
    data, info, recon, _rd = _encode("rav1e_tpu_torch", 320, 240, 5, 10,
                                     device="cpu")
    assert [f["ref_ids"] for f in info] == [f["ref_ids"]
                                            for f in jax_gop10[1]]
    _decodes_to(data, recon, 10)
    dec = dav1d.decode_stream(data)
    assert [recon_digest(d, 10) for d in dec] == [recon_digest(r, 10)
                                                  for r in recon]
    assert not any(kernels.COUNTS.values())


def test_key_inter_12bit_matches_jax():
    """A 12-bit (profile 2) 192x128 key + inter pair: the host key path
    (under 320x240), the sampled CDEF search with cdef_frame_device,
    the Wiener trial at 12 bits; byte-identical to the JAX package's and
    decoding to the recon."""
    jdata, jinfo, jrecon, _ = _encode("rav1e_tpu", 192, 128, 2, 12)
    data, info, recon, rd = _encode("rav1e_tpu_torch", 192, 128, 2, 12,
                                    device="cpu")
    assert rd == 0 and info == jinfo
    assert data == jdata
    _decodes_to(data, recon, 12)


def _lossless_key_frame(pkg, **kw):
    """An 8-bit 320x240 key frame at quantizer 0 through the package's
    FrameEncoder (the port's Context refuses lossless coding, ROADMAP
    F6).  Returns (packet, recon planes, the number of frame_rd_maps
    calls)."""
    C = importlib.import_module(pkg + ".api.config")
    P = importlib.import_module(pkg + ".models.pipeline")
    DP = importlib.import_module(pkg + ".models.device_pipeline")
    fe = P.FrameEncoder(C.EncoderConfig(width=320, height=240, quantizer=0,
                                        rdo_lookahead_frames=8), **kw)
    calls, orig = [], DP.frame_rd_maps

    def rdspy(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    DP.frame_rd_maps = rdspy
    try:
        data = fe.encode_key_frame(make_frames(320, 240, 1)[0])
    finally:
        DP.frame_rd_maps = orig
    return data, fe.last_recon, len(calls)


def test_lossless_key_frame_matches_jax():
    """An 8-bit lossless (quantizer 0) 320x240 key frame: off the
    wavefront, frame_rd_maps at q 0 and the host walk, no loop filter;
    byte-identical to the JAX package's.  (Neither package codes the
    lossless transform, the 4x4 Walsh-Hadamard, so neither stream decodes
    to its recon: ROADMAP F6.  The route is driven below the Context,
    which refuses quantizer 0 in the port.)"""
    jdata, jrecon, jrd = _lossless_key_frame("rav1e_tpu")
    data, recon, rd = _lossless_key_frame("rav1e_tpu_torch", device="cpu")
    assert rd == jrd == 1
    assert data == jdata
    for p in range(3):
        assert np.array_equal(np.asarray(recon[p]), np.asarray(jrecon[p])), p


def test_context_refuses_lossless():
    """A constant-quantizer-0 encode would write lossless key frames that
    do not decode to the recon (ROADMAP F6), so the port's Context raises
    and names the fault; under rate control (q >= 1) it does not."""
    from rav1e_tpu_torch.api.config import Config, EncoderConfig

    enc = EncoderConfig(width=320, height=240, quantizer=0)
    with pytest.raises(NotImplementedError, match="F6"):
        Config(enc=enc, device="cpu").new_context()
    enc = EncoderConfig(width=320, height=240, quantizer=0, bitrate=500_000)
    Config(enc=enc, device="cpu").new_context()


# -- content and digests ------------------------------------------------------------


def test_make_planes_high_bit_depth():
    """Bench content at 10 and 12 bits is the 8-bit content shifted, its
    low bits random, as uint16; the 8-bit content is what it always was
    (its digest)."""
    h = hashlib.sha256()
    for f in make_planes(96, 64, 3):
        for p in f:
            h.update(p.tobytes())
    assert h.hexdigest() == ("eecf6c103137c15ed7c6814d0e104b03729a8b0609e4"
                             "edb201dd7d7e89b86a72")
    base = make_planes(96, 64, 1)[0]
    for bd in (10, 12):
        planes = make_planes(96, 64, 1, bit_depth=bd)[0]
        for p, b in zip(planes, base):
            assert p.dtype == np.uint16 and int(p.max()) < 1 << bd
            assert np.array_equal(p >> (bd - 8), b)
        f = make_frames(96, 64, 1, bit_depth=bd)[0]
        assert f.bit_depth == bd


def test_recon_digest_hashes_16_bit_samples():
    """recon_digest above 8 bits hashes the samples as uint16: two 10-bit
    frames that agree in their low 8 bits differ, and out-of-range
    samples raise."""
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    a = [np.full((4, 4), 300), np.zeros((2, 2)), np.zeros((2, 2))]
    b = [np.full((4, 4), 300 + 256), a[1], a[2]]
    assert recon_digest(a, 10) != recon_digest(b, 10)
    assert recon_digest(a[1:], 8) != recon_digest(a[1:], 10)
    with pytest.raises(ValueError):
        recon_digest(a, 8)


# -- the stripe rule at the plane's last row (ROADMAP F7) ----------------------------


def test_stripe_rule_clamps_to_the_plane_first():
    """Where a loop-restoration stripe ends at the plane's last row (luma
    height 248: stripes end at 56 + 64k), the taps below it read that row
    of the CDEF output, as the spec's get_source_sample clamps the row
    before its stripe test; the JAX package's rule reads the deblocked
    row there.  Everywhere else the two rules agree."""
    from rav1e_tpu.ops import lrf_np as jlnp

    for stripe, h in ((64, 248), (32, 124), (64, 240), (32, 120)):
        for y in range(h):
            for t in range(-3, 4):
                mine = tlnp._stripe_source(None, None, y, t, stripe, h)
                theirs = jlnp._stripe_source(None, None, y, t, stripe, h)
                at_end = (h + (stripe >> 3)) % stripe == 0 and y + t >= h
                assert mine == ((h - 1, False) if at_end else theirs), (
                    stripe, h, y, t)


def test_key_frame_stripe_at_plane_end_decodes():
    """A 10-bit 320x248 key frame with CDEF and loop restoration (the luma
    plane ends where a stripe does, as 1080 does) decodes to its recon."""
    data, _i, recon, _rd = _encode("rav1e_tpu_torch", 320, 248, 1, 10,
                                   device="cpu")
    _decodes_to(data, recon, 10)


def test_chain_stripe_at_plane_end_decodes(monkeypatch):
    """An 8-bit 320x248 key frame at bench.py's keyframe configuration
    (speed 6: the wavefront pass, then the device filter chain, here
    their plain versions), whose luma plane ends where a stripe does and
    whose bottom row of restoration units takes Wiener: the chain's
    stripe rule (ROADMAP F7, K8's chain mode) decodes to the recon."""
    from rav1e_tpu_torch.api.config import Config, EncoderConfig
    from rav1e_tpu_torch.api.context import EncoderError
    from rav1e_tpu_torch.models.intra_frame import IntraFrameEncoder
    from rav1e_tpu_torch.ops import filter_chain
    from rav1e_tpu_torch.utils.frame import Frame

    w, h = 320, 248
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(5)
    y = 128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0) + rng.normal(0, 6,
                                                                   (h, w))
    _y, u, v = make_planes(w, h, 1)[0]
    frame = Frame.from_planes(np.clip(y, 0, 255).astype(np.uint8), u, v)
    chains, fes = [], []
    orig_chain = filter_chain.launch_filter_chain
    orig_finish = IntraFrameEncoder._finish_encode
    monkeypatch.setattr(filter_chain, "launch_filter_chain",
                        lambda fe: chains.append(fe) or orig_chain(fe))
    monkeypatch.setattr(IntraFrameEncoder, "_finish_encode",
                        lambda fe: fes.append(fe) or orig_finish(fe))
    cfg = Config(enc=EncoderConfig(
        width=w, height=h, quantizer=100, min_key_frame_interval=1,
        max_key_frame_interval=1, rdo_lookahead_frames=8, low_latency=True),
        device="cpu")
    ctx = cfg.new_context()
    ctx.send_frame(frame)
    ctx.flush()
    data = []
    while True:
        try:
            data.append(ctx.receive_packet().data)
        except EncoderError:
            break
    assert len(chains) == 1 and fes == chains
    units = fes[0]._lr_params
    last = max(ur for ur, _uc in units)
    assert sum(1 for (ur, _uc), p in units.items()
               if ur == last and p is not None and p[0] == "wiener") > 0
    _decodes_to(data, [ctx._encoder.recon_by_input[0]], 8)
