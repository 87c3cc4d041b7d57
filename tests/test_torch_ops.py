"""The port's device ops against the JAX package, on the CPU.

Each kernel of rav1e_tpu_torch (K1 intra_pred, K2 fwd_txq, K3 inv_txfm,
K4 deblock) has a plain PyTorch version that its wrapper runs for CPU
tensors.  These tests feed the same numpy inputs, made from one seed, to
that plain version and to the JAX function it replaces, run on the CPU as
the JAX package's own tests run it:

- K1, K3 and K4 are normative and must be identical.
- K2's forward transform is an fp32 product rounded half to even; the two
  frameworks sum in different orders, so a coefficient within an ulp of
  .5 may round the other way.  Levels and dequantised values must be
  identical wherever the integer coefficients agree, every coefficient
  may differ by at most 1, and at most FDCT_TIE_SHARE of them may differ.

The band RD maps and the deblock-only filter chain are checked whole
(CDEF and LR: tests/test_torch_filters.py).
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.models import device_pipeline as jdp
from rav1e_tpu.ops import deblock_jax as jdb
from rav1e_tpu.ops import deblock_np as jdnp
from rav1e_tpu.ops import intra_jax as ij
from rav1e_tpu.ops import quantize_np as jqz
from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu.ops import transforms_np as jtn
from rav1e_tpu_torch.models import device_pipeline as tdp
from rav1e_tpu_torch.ops import deblock as tdb
from rav1e_tpu_torch.ops import intra as ti
from rav1e_tpu_torch.ops import transforms as tt

# one intra-op thread: the suite runs several test processes side by
# side on the CPU, and torch's default (a thread a core in each) makes
# them contend
torch.set_num_threads(1)

SEED = 20261016
# share of forward-transform coefficients allowed to round differently
# between fp32 sum orders (each by exactly 1)
FDCT_TIE_SHARE = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edges(rng, B, n):
    above = rng.integers(0, 256, (B, 2 * n + 1)).astype(np.int32)
    left = rng.integers(0, 256, (B, 2 * n + 1)).astype(np.int32)
    left[:, 0] = above[:, 0]
    ha = rng.random(B) < 0.7
    hl = rng.random(B) < 0.7
    return above, left, ha, hl


# -- K1 intra_pred ------------------------------------------------------------


@jax.jit
def _jax_full_n(above, left, ha, hl):
    n = (above.shape[1] - 1) // 2
    return (ij.predict_dirs(above, left, n),
            ij.dc_predict(above, left, n, n, ha, hl),
            ij.predict_stack(above, left, n, n, ha, hl))


def _jax_full(above, left, n, ha, hl):
    return _jax_full_n(above, left, ha, hl)


@jax.jit
def _jax_stack_n(above, left, ha, hl):
    n = (above.shape[1] - 1) // 2
    return ij.predict_stack(above, left, n, n, ha, hl)


def _jax_stack(above, left, n, ha, hl):
    return _jax_stack_n(above, left, ha, hl)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_intra_full_set_matches_jax(n):
    """DC, the 56 directional variants and SMOOTH*/PAETH (the luma leaf's
    channel set; n = 8 the 8x8 leaf at speed <= 3) equal dc_predict,
    predict_dirs and the stack's non-directional predictions."""
    rng = np.random.default_rng(SEED + n)
    above, left, ha, hl = _edges(rng, 5, n)
    got = ti.intra_pred(_t(above), _t(left), _t(ha), _t(hl), n, True).numpy()
    assert got.shape == (5, ti.N_FULL, n, n)
    dirs, dc, stack = (np.asarray(v) for v in
                       _jax_full(above, left, n, ha, hl))
    assert np.array_equal(got[:, 0], dc)
    assert np.array_equal(got[:, 1:57].reshape(5, 8, 7, n, n), dirs)
    assert np.array_equal(got[:, 57:61], stack[:, 9:13])


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_intra_nondir_set_matches_jax(n):
    """DC, V, H, SMOOTH*, PAETH (the chroma race and the 64x64 root
    trial's channel set; n = 4 the chroma of an 8x8 leaf)."""
    rng = np.random.default_rng(SEED + 100 + n)
    above, left, ha, hl = _edges(rng, 4, n)
    got = ti.intra_pred(_t(above), _t(left), _t(ha), _t(hl), n, False).numpy()
    stack = np.asarray(_jax_stack(above, left, n, ha, hl))
    assert np.array_equal(got, stack[:, [0, 1, 2, 9, 10, 11, 12]])


@pytest.mark.parametrize("n", [16, 32])
def test_predict_all_matches_jax(n):
    """Source-edge predictions of the band maps (_predict_all)."""
    rng = np.random.default_rng(SEED + 200 + n)
    y = rng.integers(0, 256, (64, 128)).astype(np.int32)
    jb, jp = jax.jit(jdp._predict_all, static_argnums=1)(jnp.asarray(y), n)
    tb, tp = tdp.predict_all(_t(y), n)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("n", [16, 32])
def test_predict_all_zone2_index_clamp_never_engages(n):
    """_predict_all clips its zone-2 edge indices to [0, n]; for the taps a
    sample actually uses the clip must be a no-op, or the port's full edge
    vector (which reads past n) would differ."""
    rr = np.arange(n)[:, None]
    cc = np.arange(n)[None, :]
    for ang in (135, 113, 157):
        dx = int(jdp._DR[180 - ang])
        dy = int(jdp._DR[ang - 90])
        bx = ((cc << 6) - (rr + 1) * dx) >> 6
        by = ((rr << 6) - (cc + 1) * dy) >> 6
        use_a = bx >= -1
        ia = np.stack([1 + bx, 2 + bx])[:, use_a]
        il = np.stack([1 + by, 2 + by])[:, ~use_a]
        assert ia.min() >= 0 and ia.max() <= n, ang
        assert il.min() >= 0 and il.max() <= n, ang


# -- K2 fwd_txq ---------------------------------------------------------------

_TYPES5 = (jtn.DCT_DCT, jtn.ADST_ADST, jtn.ADST_DCT, jtn.DCT_ADST, jtn.IDTX)


def _resid(rng, B, n):
    """Residuals with structure (ramps) and noise, like mode-race inputs."""
    yy, xx = np.mgrid[0:n, 0:n]
    slope = rng.integers(-6, 7, (B, 2, 1, 1))
    base = slope[:, 0] * yy + slope[:, 1] * xx + rng.integers(-60, 60, (B, 1, 1))
    noise = rng.integers(-20, 21, (B, n, n))
    return np.clip(base + noise, -255, 255).astype(np.int32)


@partial(jax.jit, static_argnums=5)
def _jax_txq_jit(resid, Fv, FhT, qdc, qac, shift):
    cf = tj.fdct_batch(resid, Fv, FhT)
    lv = tj.quantize(cf, qdc, qac, shift)
    dq = tj.dequantize(lv, qdc, qac, shift, 8)
    qerr = ((cf - dq) << shift).astype(jnp.float32)
    a = jnp.abs(lv).astype(jnp.float32)
    rate = (tt.RATE_NZ * (a > 0).sum((-1, -2)).astype(jnp.float32)
            + tt.RATE_MAG * jnp.log2(1.0 + a).sum((-1, -2)))
    return cf, lv, dq, (qerr * qerr).sum((-1, -2)), rate


def _jax_txq(resid, Fv, FhT, qdc, qac, shift):
    """The JAX chain the wavefront runs: fdct_batch, quantize, dequantize,
    the tx-domain SSE and coeff_rate (one block per type group)."""
    return tuple(np.asarray(v) for v in _jax_txq_jit(
        *(jnp.asarray(a) for a in (resid, Fv, FhT, qdc, qac)), shift))


@pytest.mark.parametrize("n,types", [(4, _TYPES5), (8, _TYPES5),
                                     (16, _TYPES5), (32, (jtn.DCT_DCT,)),
                                     (64, (jtn.DCT_DCT,))])
def test_fwd_txq_matches_jax(n, types):
    rng = np.random.default_rng(SEED + 300 + n)
    B = 48
    resid = _resid(rng, B, n)
    qi = rng.integers(40, 220, B)
    qdc = np.asarray([jqz.dc_q(int(q)) for q in qi], np.int32)
    qac = np.asarray([jqz.ac_q(int(q)) for q in qi], np.int32)
    shift = jqz.tx_scale(n, n)
    m = min(n, 32)  # TX_64X64 codes its top-left 32x32
    mats = [tt.fwd_mats(t, n, n) for t in types]
    Fv = np.stack([a[:m, :] for a, _ in mats])
    FhT = np.stack([b[:, :m] for _, b in mats])
    tidx = rng.integers(0, len(types), B).astype(np.int32)
    lv, dq, dist, rate = (v.numpy() for v in tt.fwd_txq(
        _t(resid), _t(Fv), _t(FhT), _t(qdc), _t(qac), shift, tidx=_t(tidx)))
    assert lv.shape == dq.shape == (B, m, m)
    cf_port = tt.fdct_plain(_t(resid), _t(Fv[tidx]), _t(FhT[tidx])).numpy()
    ref = [None] * B
    for t in range(len(types)):
        sel = np.nonzero(tidx == t)[0]
        if sel.size:
            out = _jax_txq(resid[sel], Fv[t], FhT[t], qdc[sel], qac[sel],
                           shift)
            for j, b in enumerate(sel):
                ref[b] = tuple(o[j] for o in out)
    cf_j, lv_j, dq_j, dist_j, rate_j = (np.stack([r[i] for r in ref])
                                        for i in range(5))
    ties = cf_port != cf_j
    assert np.abs(cf_port - cf_j).max() <= 1
    assert ties.mean() <= FDCT_TIE_SHARE
    assert np.array_equal(lv[~ties], lv_j[~ties])
    assert np.array_equal(dq[~ties], dq_j[~ties])
    clean = ~ties.any(axis=(1, 2))
    np.testing.assert_allclose(dist[clean], dist_j[clean], rtol=1e-5)
    np.testing.assert_allclose(rate[clean], rate_j[clean], rtol=1e-5)


@pytest.mark.parametrize("n", [16, 32])
def test_rd_analysis_matches_jax(n):
    """K2's float-floor variant (through the band maps' rd_analysis):
    modes and nnz identical, costs to fp32 sum-order precision."""
    rng = np.random.default_rng(SEED + 400 + n)
    yy, xx = np.mgrid[0:64, 0:128]
    y = np.clip((xx * 2 + yy) % 256 + rng.integers(-12, 12, (64, 128)),
                0, 255).astype(np.int32)
    q = (jqz.dc_q(100), jqz.ac_q(100))
    lam = 812.5
    jm, jc, jn = (np.asarray(v) for v in
                  jdp.rd_analysis(jnp.asarray(y), n, q, lam))
    tm, tc, tn = (v.numpy() for v in tdp.rd_analysis(
        _t(y), n, q, torch.tensor(lam, dtype=torch.float32)))
    assert np.array_equal(tm, jm)
    assert np.array_equal(tn, jn)
    np.testing.assert_allclose(tc, jc, rtol=1e-5)


def test_band_maps_match_jax():
    """The packed band maps (mode per 32 and 16 block, split map) of a
    64 x 320 band equal the JAX package's."""
    rng = np.random.default_rng(SEED + 500)
    yy, xx = np.mgrid[0:64, 0:320]
    y = np.clip((xx + 3 * yy) % 256 + rng.integers(-10, 10, (64, 320)),
                0, 255).astype(np.int32)
    dc_q, ac_q, lam = jqz.dc_q(100), jqz.ac_q(100), 812.5
    ref = np.asarray(jdp._band_maps_packed(jnp.asarray(y), (dc_q, ac_q), lam))
    h = tdp.launch_band_rd_maps(y, dc_q, ac_q, lam, 176, 0, device="cpu")
    got = h.collect()
    assert (h.y0, h.x0) == (176, 0)
    assert np.array_equal(np.concatenate([got[32][0].ravel(),
                                          got[16][0].ravel(),
                                          got["split32"].ravel()]), ref)


# -- K3 inv_txfm ----------------------------------------------------------------

_inv_jit = jax.jit(tj.inv_txfm, static_argnums=(1, 2))


@pytest.mark.parametrize("n,tx", [(n, t) for n in (4, 8, 16) for t in _TYPES5]
                         + [(32, jtn.DCT_DCT), (32, jtn.IDTX),
                            (64, jtn.DCT_DCT)])
def test_inv_txfm_matches_jax(n, tx):
    rng = np.random.default_rng(SEED + 600 + 17 * n + tx)
    x = rng.integers(-(1 << 15), 1 << 15, (6, n, n)).astype(np.int32)
    if n == 64:
        x[..., 32:, :] = 0
        x[..., :, 32:] = 0
    got = tt.inv_txfm(_t(x), tx).numpy()
    assert np.array_equal(got, np.asarray(_inv_jit(jnp.asarray(x), tx, 8)))
    assert np.array_equal(got[0], jtn.inverse_transform(x[0], tx, 8))


def test_inv_txfm_per_block_types():
    """One call with a tx type per block (the luma and uv races) equals a
    call per type."""
    rng = np.random.default_rng(SEED + 700)
    x = rng.integers(-4000, 4000, (3, 5, 16, 16)).astype(np.int32)
    types = np.broadcast_to(np.asarray(_TYPES5, np.int32), (3, 5))
    got = tt.inv_txfm(_t(x), _t(types.copy())).numpy()
    for k, t in enumerate(_TYPES5):
        assert np.array_equal(got[:, k],
                              np.asarray(_inv_jit(jnp.asarray(x[:, k]), t, 8)))


# -- K4 deblock -----------------------------------------------------------------


def _tiling(rng, h, w):
    """DeblockInfo of a random partition: each 64x64 superblock in blocks
    of one size from {8, 16, 32, 64} (tx size = block size), random skip."""
    info = jdnp.DeblockInfo(h // 4, w // 4)
    for sy in range(0, h, 64):
        for sx in range(0, w, 64):
            bs = int(rng.choice([8, 16, 32, 64]))
            for y in range(sy, sy + 64, bs):
                for x in range(sx, sx + 64, bs):
                    info.set_block(x, y, bs, bs, bool(rng.random() < 0.3))
    return info


def _blocky(rng, h, w):
    """Piecewise-flat content with mild noise, so the flat/flat2 (8- and
    14-tap) paths engage as well as the 4-tap one."""
    base = np.repeat(np.repeat(rng.integers(60, 200, (h // 8, w // 8)), 8, 0),
                     8, 1)
    noisy = rng.random((h, w)) < 0.2
    return np.clip(base + noisy * rng.integers(-2, 3, (h, w)), 0,
                   255).astype(np.int32)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 8))
def _jax_pass_dir(img, lim, bl, th, plane_idx, tx, bp, sk, s):
    hh, ww = img.shape
    return jdb._pass_dir(jnp, img, lim, bl, th, 8, plane_idx, ww, hh, tx, bp,
                         sk, s, s)


@pytest.mark.parametrize("plane_idx", [0, 1])
def test_deblock_pass_matches_jax(plane_idx):
    rng = np.random.default_rng(SEED + 800 + plane_idx)
    H, W = 128, 192
    info = _tiling(rng, H, W)
    s = 0 if plane_idx == 0 else 1
    h, w = H >> s, W >> s
    img = _blocky(rng, h, w)
    lim, bl, th = (int(v) for v in jdnp.thresholds(36, 0, 8))
    maps = ((info.txw >> s, info.bx >> s, info.skip),
            ((info.txh >> s).T, (info.by >> s).T, info.skip.T))
    for d, (tx, bp, sk) in enumerate(maps):
        src = img if d == 0 else img.T.copy()
        hh, ww = src.shape
        ref = np.asarray(_jax_pass_dir(jnp.asarray(src), lim, bl, th,
                                       plane_idx, jnp.asarray(tx),
                                       jnp.asarray(bp), jnp.asarray(sk), s))
        got = tdb.deblock_pass(_t(src), lim, bl, th, plane_idx, _t(tx),
                               _t(bp), _t(sk), s, s).numpy()
        assert np.array_equal(got, ref), d
        assert not np.array_equal(got, src), d  # the pass filtered


def test_deblock_plane_matches_numpy_oracle():
    rng = np.random.default_rng(SEED + 900)
    H, W = 128, 192
    info = _tiling(rng, H, W)
    img = _blocky(rng, H, W)
    ref = img.copy()
    jdnp.deblock_plane(ref, info, 0, (30, 22, 0, 0), 0, 0, 0, 8, W, H)
    lv = lambda lvl: tuple(int(v) for v in jdnp.thresholds(lvl, 0, 8)) + (1,)
    got = tdb.deblock_plane(_t(img), *(_t(a) for a in (info.txw, info.txh,
                                                         info.bx, info.by,
                                                         info.skip)),
                            0, 0, 0, lv(30), lv(22)).numpy()
    assert np.array_equal(got, ref)


# -- the deblock-only filter chain ------------------------------------------------


class _Stage:
    def stage(self, _name):
        import contextlib

        return contextlib.nullcontext()


def _chain_frame(rng, coded_w, coded_h):
    """An encoder-shaped stand-in: SB-padded recon planes, deblock maps and
    the frame's filter levels (the speed-6 level model at q 100)."""
    Hp, Wp = -(-coded_h // 64) * 64, -(-coded_w // 64) * 64
    rec = [_blocky(rng, Hp, Wp), _blocky(rng, Hp >> 1, Wp >> 1),
           _blocky(rng, Hp >> 1, Wp >> 1)]
    return dict(h=Hp, w=Wp, coded_h=coded_h, coded_w=coded_w, bd=8,
                _is420=True, rec=rec, db_info=_tiling(rng, Hp, Wp),
                lf_levels=(18, 14, 10, 9), lf_sharpness=0, cdef_damping=0,
                lrf=False, q=100, lam=812.5, stats=_Stage())


def test_filter_chain_matches_jax():
    """launch/collect of the deblock-only chain on a 320x240 frame: the
    port's planes equal the JAX chain's, and the resident-recon splice (the
    device SBs from the wavefront's output, the host-coded bottom stripe
    from fe.rec) gives the same planes as uploading the whole recon."""
    from rav1e_tpu.ops import filter_chain_jax as jfc
    from rav1e_tpu_torch.ops import filter_chain as tfc

    rng = np.random.default_rng(SEED + 1000)
    base = _chain_frame(rng, 320, 240)
    src_dev = jnp.zeros(base["h"] * base["w"] * 3 // 2, jnp.uint8)
    jfe = SimpleNamespace(**base, _src_dev=src_dev)
    jfe.rec = [p.copy() for p in base["rec"]]
    jfc.collect_filter_chain(jfe, jfc.launch_filter_chain(jfe))

    tfe = SimpleNamespace(**base, device="cpu", _wf_dev_out=None)
    tfe.rec = [p.copy() for p in base["rec"]]
    assert tfc.collect_filter_chain(tfe, tfc.launch_filter_chain(tfe))
    for p in range(3):
        assert np.array_equal(tfe.rec[p], jfe.rec[p]), p
    assert not np.array_equal(tfe.rec[0], base["rec"][0])

    # resident splice: device planes hold the SB region only (garbage
    # below it), the host stripe comes from fe.rec
    dev = [_t(p.copy()).to(torch.uint8) for p in base["rec"]]
    for p, d in enumerate(dev):
        d[(192 >> (p > 0)):] = 7
    rfe = SimpleNamespace(**base, device="cpu", _wf_dev_out=dev)
    rfe.rec = [p.copy() for p in base["rec"]]
    tfc.collect_filter_chain(rfe, tfc.launch_filter_chain(rfe))
    for p in range(3):
        assert np.array_equal(rfe.rec[p], jfe.rec[p]), p


@pytest.mark.parametrize("kind", ["restores", "clean"])
def test_chainless_lr_decide_matches_jax_per_unit_params(kind):
    """The loop-restoration decision of a frame the device chain did not
    filter (the host filter path of host-coded inter frames, speed 6, no
    SGR search): the host tap solves, then the per-unit Wiener trial with
    K8 in frame mode.  The port's _lr_decide gives the JAX package's
    per-unit params (kind, taps, restored samples), chroma units, chroma
    taps and LR types; a recon equal to its source solves all-zero taps
    and leaves every unit RESTORE_NONE."""
    from rav1e_tpu.models.intra_frame import IntraFrameEncoder as JEnc
    from rav1e_tpu_torch.models.intra_frame import IntraFrameEncoder as TEnc

    rng = np.random.default_rng(SEED + 1414)
    w, h = 192, 128
    planes = [_blocky(rng, h, w), _blocky(rng, h >> 1, w >> 1),
              _blocky(rng, h >> 1, w >> 1)]
    if kind == "restores":
        # a blurred, noisy "decoded" frame the Wiener taps can sharpen
        rec = [np.clip((p + np.roll(p, 1, 0) + np.roll(p, 1, 1)) // 3
                       + rng.integers(-2, 3, p.shape), 0, 255)
               for p in planes]
    else:
        rec = [p.copy() for p in planes]
    encs = []
    for cls, kw in ((JEnc, {}), (TEnc, {"device": "cpu"})):
        enc = cls(w, h, q_idx=100, cdef_damping=4, **kw)
        enc.lrf = True
        enc.prepare([p.copy() for p in planes], launch=False)
        enc.rec = [p.astype(np.int32).copy() for p in rec]
        enc._deblock_copy = [p.astype(np.int32).copy() for p in rec]
        enc._chain_lr = None
        enc._lr_decide()
        encs.append(enc)
    jenc, tenc = encs
    assert not tenc.sgr_search
    assert tenc.lr_types == jenc.lr_types
    assert tenc._lr_params.keys() == jenc._lr_params.keys()
    for key, jp in jenc._lr_params.items():
        tp = tenc._lr_params[key]
        if jp is None:
            assert tp is None, key
            continue
        assert tp[:3] == jp[:3], key
        assert np.array_equal(np.asarray(tp[3]), np.asarray(jp[3])), key
    assert tenc._lr_chroma_taps == jenc._lr_chroma_taps
    for plane in (1, 2):
        jc, tc = jenc._lr_chroma[plane], tenc._lr_chroma[plane]
        assert tc.keys() == jc.keys()
        for key, ju in jc.items():
            assert (tc[key] is None) == (ju is None), (plane, key)
            if ju is not None:
                assert np.array_equal(tc[key], ju), (plane, key)
    used = [p for p in tenc._lr_params.values() if p is not None]
    if kind == "restores":
        assert used and used[0][0] == "wiener"
    else:
        assert not used and tenc.lr_types == [1, 0, 0]


def test_filter_chain_sgr_route_and_host_filter_prepare():
    """With the SGR search the chain runs without its fused LR stage and
    hands back the deblocked planes for the host search; a speed-5 frame
    (CDEF and LR after the host deblock level search) prepares."""
    from rav1e_tpu_torch.models.intra_frame import IntraFrameEncoder
    from rav1e_tpu_torch.ops import filter_chain as tfc

    base = _chain_frame(np.random.default_rng(SEED), 128, 128)
    fe = SimpleNamespace(**{**base, "lrf": True, "sgr_search": True},
                         device="cpu", _wf_dev_out=None)
    handle = tfc.launch_filter_chain(fe)
    assert handle["lr"] is None
    assert [d.shape for d in handle["db"]] == [(128, 128), (64, 64), (64, 64)]

    planes = [np.full((64, 64), 128), np.full((32, 32), 128),
              np.full((32, 32), 128)]
    for lrf in (False, True):
        enc = IntraFrameEncoder(64, 64, q_idx=100, speed=5, cdef_damping=4,
                                lf_levels=(9, 9, 9, 9), device="cpu")
        enc.lrf = lrf
        assert enc.lf_search
        enc.prepare(planes)
        assert enc._prepared


# -- constants ------------------------------------------------------------------


def test_constants_match_jax():
    """The port's own copies of the encoder's constants (forward matrices,
    smooth weights, dr_intra_derivative, default CDFs, the mode-bit tail of
    the upload vector) equal the JAX package's, as tensors."""
    from rav1e_tpu.entropy.cdf import CdfContext as JaxCdf
    from rav1e_tpu.models import wavefront as jwf
    from rav1e_tpu.ops import intra_np as jip
    from rav1e_tpu_torch import params
    from rav1e_tpu_torch.entropy.cdf import CdfContext as PortCdf
    from rav1e_tpu_torch.models import wavefront as twf

    ref = {"sm_weights": np.asarray(jip._SM_W, np.int32),
           "dr_intra_derivative": np.asarray(jip._DR, np.int32)}
    for name, t in params._TYPES.items():
        for n in ((4, 8, 16, 32, 64) if t == jtn.DCT_DCT else (4, 8, 16)):
            ref[f"fwd_{name}_{n}"] = np.stack(tj.fwd_mats(t, n, n))
    cdf = JaxCdf(100)
    for name in ("kf_y_mode", "uv_mode", "partition", "cfl_alpha",
                 "angle_delta"):
        ref[f"cdf_{name}"] = np.asarray(getattr(cdf, name))
    want = params.from_reference(ref)
    got = params.from_reference(params.port_constants())
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    bits = params.from_reference({
        "jax": jwf._mode_bit_params(SimpleNamespace(cdf=JaxCdf(100))),
        "port": twf._mode_bit_params(SimpleNamespace(cdf=PortCdf(100)))})
    assert bits["port"].shape == (300,)
    assert torch.equal(bits["port"], bits["jax"])


# -- the wrappers on a card ---------------------------------------------------


def test_wrappers_count_no_cpu_launch():
    """On CPU tensors the wrappers run the plain versions: no kernel is
    built or launched, and no launch is counted."""
    from rav1e_tpu_torch import kernels

    kernels.reset_counts()
    rng = np.random.default_rng(SEED)
    above, left, ha, hl = _edges(rng, 2, 16)
    ti.intra_pred(_t(above), _t(left), _t(ha), _t(hl), 16, True)
    tt.inv_txfm(_t(rng.integers(-99, 99, (2, 8, 8)).astype(np.int32)), 0)
    assert set(kernels.KERNELS) <= set(kernels.COUNTS)
    assert not any(kernels.COUNTS.values()), kernels.COUNTS
