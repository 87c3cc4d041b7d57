"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and nvcc: each builds its kernel from
rav1e_tpu_torch/csrc, launches it on CUDA tensors and holds the result
against the plain version on the same inputs (identical for intra_pred,
inv_txfm, deblock, cdef_dir, cdef_filter, wiener_solve, wiener_lr, also
in frame mode, mc_pred, me_fullpel, also through frame_me_map, and cfl,
the four of the leaves also at the speed-3 pass's 8x8 and 4x4 shapes,
and above 8 bits cdef_dir, cdef_filter, wiener_lr in frame mode and
me_fullpel on uint16 planes; frame_rd_maps by its tie rule;
fwd_txq, with and without the inter race's thinning, within its
rounding-tie share), and the paths that drive them (among them the tile
route of Config(threads=4) with 4 tile columns, also over 2 slots, and
the sharded deblock at 8 and 10 bits).  Without a card they
skip.  On a machine without JAX (the tests' conftest imports
it) run them as

    python -m pytest --noconftest tests/test_torch_chip.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SEED = 20261016


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _edges(rng, B, n, dev):
    above = rng.integers(0, 256, (B, 2 * n + 1)).astype(np.int32)
    left = rng.integers(0, 256, (B, 2 * n + 1)).astype(np.int32)
    left[:, 0] = above[:, 0]
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(above), t(left), t(rng.random(B) < 0.7),
            t(rng.random(B) < 0.7))


@pytest.mark.parametrize("n,full", [(16, True), (32, True), (8, False),
                                    (64, False), (8, True), (4, False)])
def test_intra_pred_kernel(n, full):
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import intra

    dev = _card()
    a, l_, ha, hl = _edges(np.random.default_rng(SEED + n), 60, n, dev)
    before = kernels.COUNTS["intra_pred"]
    got = intra.intra_pred(a, l_, ha, hl, n, full)
    assert kernels.COUNTS["intra_pred"] == before + 1
    ref = intra.intra_pred_plain(a, l_, ha, hl, n, full)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_fwd_txq_kernel(n):
    from rav1e_tpu_torch.ops import transforms as tt
    from rav1e_tpu_torch.ops import transforms_np as tn

    dev = _card()
    rng = np.random.default_rng(SEED + n)
    m = min(n, 32)
    types = (tn.DCT_DCT, tn.ADST_ADST, tn.ADST_DCT, tn.DCT_ADST,
             tn.IDTX) if n <= 16 else (tn.DCT_DCT,)
    mats = [tt.fwd_mats(t, n, n) for t in types]
    Fv = torch.as_tensor(np.stack([a[:m] for a, _ in mats]), device=dev)
    FhT = torch.as_tensor(np.stack([b[:, :m] for _, b in mats]), device=dev)
    B = 240
    resid = torch.as_tensor(rng.integers(-120, 121, (B, n, n)), device=dev,
                            dtype=torch.int32)
    qdc = torch.full((B,), 116, dtype=torch.int32, device=dev)
    qac = torch.full((B,), 140, dtype=torch.int32, device=dev)
    tidx = torch.as_tensor(rng.integers(0, len(types), B), device=dev,
                           dtype=torch.int32)
    shift = {4: 0, 8: 0, 16: 0, 32: 1, 64: 2}[n]
    lv, dq, dist, rate = tt.fwd_txq(resid, Fv, FhT, qdc, qac, shift,
                                    tidx=tidx)
    rl, rdq, rdist, rrate = tt.fwd_txq_plain(resid, Fv, FhT, tidx, qdc, qac,
                                             shift)
    bad = (lv != rl) | (dq != rdq)
    assert (lv - rl).abs().max() <= 1
    assert bad.float().mean() <= 1e-3
    clean = ~bad.flatten(1).any(1)
    assert torch.allclose(rate[clean], rrate[clean], rtol=1e-4)
    if m == n:  # the float-floor variant (band maps) runs square DCTs
        d1, r1, z1 = tt.fwd_rd_float(resid, Fv[0], FhT[0], 116, 140, shift)
        d2, r2, z2 = tt.fwd_rd_float_plain(resid, Fv[0], FhT[0], 116, 140,
                                           shift)
        assert (z1 == z2).float().mean() >= 0.98


@pytest.mark.parametrize("n,tx", [(8, 0), (8, 3), (16, 1), (16, 2), (16, 9),
                                  (32, 0), (64, 0), (4, 0), (4, 3), (4, 9)])
def test_inv_txfm_kernel(n, tx):
    from rav1e_tpu_torch.ops import transforms as tt

    dev = _card()
    rng = np.random.default_rng(SEED + n + tx)
    x = rng.integers(-(1 << 15), 1 << 15, (60, n, n)).astype(np.int32)
    if n == 64:
        x[:, 32:] = 0
        x[:, :, 32:] = 0
    xt = torch.as_tensor(x, device=dev)
    assert torch.equal(tt.inv_txfm(xt, tx), tt.inv_txfm_plain(xt, tx))
    types = torch.as_tensor(rng.choice([0, 1, 2, 3, 9] if n <= 16 else [0],
                                       60), device=dev, dtype=torch.int32)
    got = tt.inv_txfm(xt, types)
    for t in torch.unique(types).tolist():
        sel = types == t
        assert torch.equal(got[sel], tt.inv_txfm_plain(xt[sel], t))


@pytest.mark.parametrize("plane_idx", [0, 1])
def test_deblock_kernel(plane_idx):
    from rav1e_tpu_torch.ops import deblock
    from rav1e_tpu_torch.ops import deblock_np as dnp

    dev = _card()
    rng = np.random.default_rng(SEED + plane_idx)
    H, W = 256, 384
    info = dnp.DeblockInfo(H // 4, W // 4)
    for sy in range(0, H, 64):
        for sx in range(0, W, 64):
            bs = int(rng.choice([8, 16, 32, 64]))
            for y in range(sy, sy + 64, bs):
                for x in range(sx, sx + 64, bs):
                    info.set_block(x, y, bs, bs, bool(rng.random() < 0.3))
    s = 0 if plane_idx == 0 else 1
    h, w = H >> s, W >> s
    base = np.repeat(np.repeat(rng.integers(60, 200, (h // 8, w // 8)), 8, 0),
                     8, 1)
    img = torch.as_tensor(np.clip(base + rng.integers(-1, 2, (h, w)), 0, 255),
                          device=dev, dtype=torch.int32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    lims = tuple(int(v) for v in dnp.thresholds(36, 0, 8))
    for img_d, tx, bp, sk in (
            (img, t(info.txw >> s), t(info.bx >> s), t(info.skip)),
            (img.t(), t(info.txh >> s).t(), t(info.by >> s).t(),
             t(info.skip).t())):
        got = deblock.deblock_pass(img_d, *lims, plane_idx, tx, bp, sk, s, s)
        ref = deblock.deblock_pass_plain(img_d, *lims, 8, plane_idx, tx, bp,
                                         sk, s, s)
        assert torch.equal(got, ref)
        assert not torch.equal(got, img_d)


def _content(rng, h, w):
    """A source plane and a blurred, noisy recon of it (int32)."""
    lo = rng.integers(30, 226, (h // 16 + 2, w // 16 + 2))
    src = np.kron(lo, np.ones((16, 16)))[:h, :w]
    src = src + 40 * (np.add.outer(np.arange(h), 2 * np.arange(w)) % 37 < 6)
    src = np.clip(src + rng.normal(0, 5, (h, w)), 0, 255)
    k = np.array([1, 4, 6, 4, 1]) / 16.0
    pad = np.pad(src, 2, mode="edge")
    rec = sum(k[i] * pad[i : i + h, 2 : 2 + w] for i in range(5))
    pad = np.pad(rec, 2, mode="edge")
    rec = sum(k[i] * pad[2 : 2 + h, i : i + w] for i in range(5))
    rec = np.clip(np.rint(rec + rng.normal(0, 2, (h, w))), 0, 255)
    return src.astype(np.int32), rec.astype(np.int32)


def test_cdef_dir_kernel():
    from rav1e_tpu_torch.ops import cdef

    dev = _card()
    rng = np.random.default_rng(SEED)
    plane = rng.integers(0, 256, (1080, 1920)).astype(np.int32)
    i, j = np.mgrid[0:8, 0:8]
    for n, pat in enumerate([(i + j) % 2, i % 2, j % 2, (i - j) % 4 < 2]):
        plane[8 * n : 8 * n + 8, :8] = 255 * pat  # maximum contrast
    x = torch.as_tensor(plane, device=dev)
    d, v = cdef.cdef_dir(x)
    dp, vp = cdef.cdef_dir_plain(x)
    assert torch.equal(d, dp) and torch.equal(v, vp)


@pytest.mark.parametrize("h,w", [(1080, 1920), (272, 200)])
def test_cdef_filter_kernel(h, w):
    """Search (every candidate's superblock SSE) and apply (random
    candidate pairs per superblock), partial superblocks included."""
    from rav1e_tpu_torch.ops import cdef

    dev = _card()
    rng = np.random.default_rng(SEED + h)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    planes = [_content(rng, h, w), _content(rng, h // 2, w // 2),
              _content(rng, h // 2, w // 2)]
    src = [t(s) for s, _ in planes]
    rec = [t(r) for _, r in planes]
    dirs, var = cdef.cdef_dir(rec[0])
    act = t(rng.random((h // 8, w // 8)) < 0.8)
    args = (*rec, *src, dirs, var, act, 4)
    sse = cdef.cdef_filter(*args, cdef.SEARCH)
    assert torch.equal(sse, cdef.cdef_filter_plain(*args, cdef.SEARCH))
    idx = t(rng.integers(0, 8, (-(-h // 64), -(-w // 64))).astype(np.int32))
    got = cdef.cdef_filter(*args, cdef.APPLY, idx)
    ref = cdef.cdef_filter_plain(*args, cdef.APPLY, idx)
    for g, r, p in zip(got, ref, rec):
        assert torch.equal(g, r)
        assert not torch.equal(g, p)


def test_wiener_solve_kernel():
    from rav1e_tpu_torch.ops import lrf

    dev = _card()
    rng = np.random.default_rng(SEED + 7)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    planes = [_content(rng, 1080, 1920), _content(rng, 544, 960),
              _content(rng, 544, 960)]
    ds = [t(r)[: 1080 >> (p > 0), :] for p, (_s, r) in enumerate(planes)]
    ss = [t(s)[: 1080 >> (p > 0), :] for p, (s, _r) in enumerate(planes)]
    taps, en = lrf.wiener_solve(ds, ss)
    rt, re = lrf.wiener_solve_plain(ds, ss)
    assert torch.equal(taps, rt) and torch.equal(en, re)
    assert en.all()


@pytest.mark.parametrize("unit,hh,ww", [(64, 1080, 1920), (32, 540, 960),
                                        (64, 134, 230), (32, 67, 115)])
def test_wiener_lr_kernel(unit, hh, ww):
    from rav1e_tpu_torch.ops import lrf

    dev = _card()
    rng = np.random.default_rng(SEED + hh)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    src, cd = _content(rng, (hh + 7) & ~7, (ww + 7) & ~7)
    db = np.clip(cd + rng.integers(-3, 4, cd.shape), 0, 255)
    taps, en = lrf.wiener_solve_plain([t(cd)[:hh, :ww]] * 3,
                                      [t(src)[:hh, :ww]] * 3)
    tp = taps[0:2] if unit == 64 else taps[2:4]
    args = (t(cd), t(db.astype(np.int32)), t(src), tp, en[:1], 300.0,
            lrf.LR_RATE_Y, unit, hh, ww)
    comp, choice = lrf.wiener_lr(*args)
    rc, rch = lrf.wiener_lr_plain(*args)
    assert torch.equal(comp, rc) and torch.equal(choice, rch)


def test_keyframes_on_card_conform(monkeypatch):
    """Two 320x240 key frames through Config -> Context on the card in
    bench.py's configuration (CDEF and LR on): every kernel launches, and
    the output conforms as chip_smoke.py checks it (libdav1d decode ==
    recon where it loads; sampled superblocks re-derived with the numpy
    oracles and the filtered frame held against deblock_np, cdef_np and
    lrf_np in every case)."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils.content import make_frames

    _card()
    monkeypatch.setattr(chip_smoke, "W", 320)
    monkeypatch.setattr(chip_smoke, "H", 240)
    kernels.reset_counts()
    data, recon, fes = chip_smoke.encode(make_frames(320, 240, 2), check=True)
    # the keyframe kernels K1-K8 (K9, K10 and the thinning are inter-only)
    assert all(kernels.COUNTS[k] > 0 for k in kernels.KERNELS[:8]), \
        kernels.COUNTS
    summary = chip_smoke.check_output(data, recon, fes, 2)
    assert summary["sbs_rederived"] > 0
    assert summary["filter_chain_np_frames"] == 2


def _padded_ref(rng, h, w, dev):
    from rav1e_tpu_torch.ops import mc

    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    pad = mc.pad_ref_plane(ref, mc.MC_MARGIN, (h + 63) & ~63, (w + 63) & ~63)
    return torch.as_tensor(pad.astype(np.uint8), device=dev)


@pytest.mark.parametrize("n,sub", [(64, 0), (32, 0), (16, 0), (32, 1),
                                   (16, 1), (8, 1)])
def test_mc_pred_kernel(n, sub):
    """K9 on every 1/16 phase in both axes, blocks at the plane's edges and
    MVs at +-MV_LIMIT, identical to the plain version."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import mc

    dev = _card()
    rng = np.random.default_rng(SEED + n + sub)
    h, w = (1080 >> sub, 1920 >> sub)
    ref = _padded_ref(rng, h, w, dev)
    hp, wp = ((h + 63) & ~63), ((w + 63) & ~63)
    B = 512
    px = rng.integers(0, wp // n, B) * n
    py = rng.integers(0, hp // n, B) * n
    px[:4], py[:4] = (0, wp - n, 0, wp - n), (0, 0, hp - n, hp - n)
    lim = mc.MV_LIMIT
    mv = rng.integers(-lim, lim + 1, (B, 2))
    mv[:8] = [(lim, lim), (-lim, -lim), (lim, -lim), (-lim, lim)] * 2
    # every residue mod 16 in each axis: all 16 phases of chroma, all the
    # (even) phases luma can take
    k = np.arange(B - 8)
    mv[8:, 0] = np.clip((mv[8:, 0] & ~15) + (k // 16) % 16, -lim, lim)
    mv[8:, 1] = np.clip((mv[8:, 1] & ~15) + k % 16, -lim, lim)
    t = lambda a: torch.as_tensor(a, device=dev, dtype=torch.int32)
    before = kernels.COUNTS["mc_pred"]
    args = (ref, mc.MC_MARGIN, t(px), t(py), t(mv[:, 0]), t(mv[:, 1]), n, n,
            sub, sub)
    got = mc.mc_block_batch(*args)
    assert kernels.COUNTS["mc_pred"] == before + 1
    assert torch.equal(got, mc.mc_block_batch_plain(*args))


@pytest.mark.parametrize("kind", ["shifted", "flat"])
def test_me_fullpel_kernel(kind):
    """K10 at 1088x1920: a reference shifted by a known offset plus noise,
    and a flat reference where every offset ties (first minimum wins);
    identical to the plain version."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models import device_pipeline as dp

    dev = _card()
    rng = np.random.default_rng(SEED + len(kind))
    h, w = 1088, 1920
    base = rng.integers(0, 256, (h + 64, w + 64))
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    src = base[32 : 32 + h, 32 : 32 + w]
    if kind == "flat":
        ref = np.full((h, w), 128)
    else:
        ref = np.clip(base[32 - 7 : 32 - 7 + h, 32 + 13 : 32 + 13 + w]
                      + rng.integers(-3, 4, (h, w)), 0, 255)
    t = lambda a: torch.as_tensor(a.astype(np.uint8), device=dev)
    before = kernels.COUNTS["me_fullpel"]
    got = dp.me_fullpel(t(src), t(ref), 32)
    assert kernels.COUNTS["me_fullpel"] == before + 1
    assert torch.equal(got, dp.me_fullpel_plain(t(src), t(ref), 32))
    if kind == "shifted":  # interior blocks find the shift
        assert (got[2:-2, 2:-2] == torch.as_tensor(
            (7, -13), dtype=torch.int32, device=dev)).float().mean() > 0.9


@pytest.mark.parametrize("n", [16, 32, 64])
def test_fwd_txq_thin_kernel(n):
    """K2 with per-block level-1 thinning thresholds, against the plain
    version (chip_smoke's rounding-tie rule); counted under
    fwd_txq_thin."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import transforms as tt
    from rav1e_tpu_torch.ops import transforms_np as tn

    dev = _card()
    rng = np.random.default_rng(SEED + 7 * n)
    m = min(n, 32)
    Fv, FhT = tt.fwd_mats(tn.DCT_DCT, n, n)
    Fv = torch.as_tensor(Fv[None, :m], device=dev)
    FhT = torch.as_tensor(FhT[None, :, :m], device=dev)
    B = 480
    resid = torch.as_tensor(rng.integers(-40, 41, (B, n, n)), device=dev,
                            dtype=torch.int32)
    qdc = torch.full((B,), 116, dtype=torch.int32, device=dev)
    qac = torch.full((B,), 140, dtype=torch.int32, device=dev)
    thr = torch.as_tensor(rng.uniform(0, 400, B), device=dev,
                          dtype=torch.float32)
    shift = {16: 0, 32: 1, 64: 2}[n]
    before = kernels.COUNTS["fwd_txq_thin"]
    lv, dq, dist, rate = tt.fwd_txq(resid, Fv, FhT, qdc, qac, shift, thr=thr)
    assert kernels.COUNTS["fwd_txq_thin"] == before + 1
    tidx = torch.zeros((B,), dtype=torch.int32, device=dev)
    rl, rdq, rdist, rrate = tt.fwd_txq_plain(resid, Fv, FhT, tidx, qdc, qac,
                                             shift, thr=thr)
    # chip_smoke's tie rule: levels may differ only at coefficients within
    # the fp32 bound of a .5 tie, and the sums agree in blocks without one
    # (a tie can move a coefficient, and with it the distortion, without
    # moving its level)
    ties = chip_smoke.fdct_ties(resid, Fv, FhT, None)
    bad = (lv != rl) | (dq != rdq)
    assert not (bad & ~ties).any()
    assert bad.float().mean() <= 1e-3
    clean = ~ties.flatten(1).any(1)
    assert torch.allclose(rate[clean], rrate[clean], rtol=1e-4)
    assert torch.allclose(dist[clean], rdist[clean], rtol=1e-4)
    unthinned = tt.fwd_txq_plain(resid, Fv, FhT, tidx, qdc, qac, shift)[0]
    assert (unthinned.abs() == 1).sum() > (rl.abs() == 1).sum()


def test_mixed_gop_on_card_conforms(monkeypatch):
    """1 key + 2 inter frames of 320x240 through Config -> Context on the
    card in bench.py's mixed configuration: every kernel launches, both
    inter frames take the inter wavefront, and the output conforms as
    chip_smoke.py checks it (inter blocks re-derived with mc_np)."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils.content import make_frames

    _card()
    monkeypatch.setattr(chip_smoke, "W", 320)
    monkeypatch.setattr(chip_smoke, "H", 240)
    kernels.reset_counts()
    data, recon, fes = chip_smoke.encode(make_frames(320, 240, 3), check=True,
                                         mixed=True)
    # every counter but the speed-5 path's own (cfl, K8's frame mode), the
    # host inter path's (frame_me_map), the host key walk's
    # (frame_rd_maps) and the tile route's (wavefront_tiles), as
    # chip_smoke.py's mixed-GOP phase counts them
    assert all(v > 0 for k, v in kernels.COUNTS.items()
               if k not in ("cfl", "wiener_lr_frame", "me_fullpel_frame",
                            "frame_rd_maps", "wavefront_tiles")), \
        kernels.COUNTS
    assert [fe._chk_wf.has_mv for fe in fes] == [False, True, True]
    summary = chip_smoke.check_output(data, recon, fes, 2)
    assert summary["sbs_rederived_with_inter_blocks"] > 0
    assert summary["filter_chain_np_frames"] == 2


@pytest.mark.parametrize("n", [8, 16, 32])
def test_cfl_kernel(n):
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import intra

    dev = _card()
    rng = np.random.default_rng(SEED + n)
    B, n2 = 600, n // 2
    luma = rng.integers(0, 256, (B, n, n))
    luma[:50] = luma[:50, :1, :1]  # flat: alpha 0
    dc = rng.integers(0, 256, (B, 2, 1, 1)).repeat(n2, 2).repeat(n2, 3)
    src = np.clip(dc + rng.integers(-60, 61, (B, 2, n2, n2)), 0, 255)
    t = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    before = kernels.COUNTS["cfl"]
    got = intra.cfl(t(luma), t(dc), t(src))
    assert kernels.COUNTS["cfl"] == before + 1
    ref = intra.cfl_plain(t(luma), t(dc), t(src))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert (got[0][:50] == 0).all() and got[0].abs().max() > 0


@pytest.mark.parametrize("stripe", [64, 32])
def test_wiener_lr_frame_kernel(stripe):
    """K8 in frame mode: the whole restored plane with the given taps and
    stripe size, identical to wiener_filter_plain."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import lrf

    dev = _card()
    rng = np.random.default_rng(SEED + stripe)
    hh, ww = (1080, 1920) if stripe == 64 else (540, 960)
    cd = torch.as_tensor(rng.integers(0, 256, (hh + 8, ww + 8)), device=dev,
                         dtype=torch.int32)
    db = torch.clamp(cd + torch.as_tensor(rng.integers(-9, 10, cd.shape),
                                          device=dev, dtype=torch.int32),
                     0, 255)
    taps = torch.tensor([[0 if stripe == 32 else 3, -7, 15], [0, 4, -3]],
                        dtype=torch.int32, device=dev)
    before = kernels.COUNTS["wiener_lr_frame"]
    got = lrf.wiener_filter_frame(cd, db, taps, stripe, hh, ww)
    assert kernels.COUNTS["wiener_lr_frame"] == before + 1
    ref = lrf.wiener_filter_plain(cd, db, taps[0], taps[1], stripe, hh, ww)
    assert torch.equal(got, ref)


def test_speed5_on_card_conforms(monkeypatch):
    """1 key + 1 inter frame of 320x240 content whose chroma follows its
    luma at speed 5 on the card: CFL wins blocks, the host deblock search
    leaves K4 and K7 idle, and the output conforms as chip_smoke.py checks
    it (CFL blocks re-derived; SGR and per-unit Wiener units through
    sgr_np and lrf_np)."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils.content import make_frames_cfl

    _card()
    kernels.reset_counts()
    data, recon, fes = chip_smoke.encode(make_frames_cfl(320, 240, 2),
                                         check=True, mixed=True, speed=5,
                                         size=(320, 240))
    counts = dict(kernels.COUNTS)
    assert all(counts[k] > 0 for k in ("cfl", "cdef_dir", "cdef_filter",
                                       "wiener_lr_frame", "mc_pred")), counts
    assert counts["deblock"] == counts["wiener_solve"] == 0, counts
    assert chip_smoke.encode.cfl_blocks > 0
    summary = chip_smoke.check_output(data, recon, fes, 2)
    assert summary["filter_chain_np_frames"] == 2
    assert chip_smoke.rederive_cfl(fes)["cfl_sbs_rederived"] > 0


def test_speed3_on_card_conforms():
    """A 320x240 preset-3 key frame (flat 8x8 patches on its left half) on
    the card: the pass runs its 8x8 level (K1, K2, K3 and K11 at the 8x8
    and 4x4 shapes among their calls), the host deblock search leaves K4
    and K7 idle, 8x8 leaves are chosen, and the superblocks holding them
    re-derive with the numpy oracles."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils.content import make_frames_split8

    _card()
    kernels.reset_counts()
    cap = chip_smoke.Capture(shapes=True)
    try:
        data, recon, fes = chip_smoke.encode(make_frames_split8(320, 240, 1),
                                             check=True, speed=3,
                                             size=(320, 240))
    finally:
        cap.restore()
    counts = dict(kernels.COUNTS)
    assert all(counts[k] > 0 for k in chip_smoke.SPEED5_LAUNCHED), counts
    assert counts["deblock"] == counts["wiener_solve"] == 0, counts
    assert all(k in cap.calls for k in chip_smoke.SPEED3_SHAPES), cap.calls
    assert fes[0]._chk_wf.split16_map.any()
    chip_smoke.check_output(data, recon, fes, 0)
    assert chip_smoke.rederive_split8(fes)["split8_sbs_rederived"] > 0


def test_frame_me_map_on_card(monkeypatch):
    """frame_me_map on the card: K10 over an edge-padded 1080p reference,
    counted as the host route (me_fullpel_frame, not me_fullpel), equal to
    the plain version in 1/8 pel."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models import device_pipeline as dp

    dev = _card()
    rng = np.random.default_rng(SEED + 339)
    h, w, rh = 1088, 1920, 1080
    src = rng.integers(0, 256, (h, w)).astype(np.int32)
    pad = np.empty_like(src)
    pad[:rh] = np.roll(src[:rh], (3, -5), (0, 1))
    pad[rh:] = pad[rh - 1 : rh]
    before = dict(kernels.COUNTS)
    got = dp.frame_me_map(src, pad, 32, device=dev)
    assert kernels.COUNTS["me_fullpel_frame"] == \
        before["me_fullpel_frame"] + 1
    assert kernels.COUNTS["me_fullpel"] == before["me_fullpel"]
    t = lambda a: torch.as_tensor(a.astype(np.uint8))
    assert np.array_equal(got, dp.me_fullpel_plain(t(src), t(pad),
                                                   32).numpy() * 8)


def test_default_gop_on_card_conforms():
    """1 key + 4 inter frames of 320x240 at EncoderConfig()'s defaults on
    the card: the first ALTREF on the inter wavefront, the host frames'
    ME maps through frame_me_map (one a reference), compound blocks, and
    two host frames re-derive through the numpy filters."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models.inter_frame import InterFrameEncoder
    from rav1e_tpu_torch.utils import recon_check
    from rav1e_tpu_torch.utils.content import make_frames

    _card()
    kernels.reset_counts()
    chip_smoke.encode(make_frames(320, 240, 5), check=True, default=True,
                      size=(320, 240))
    inter = [fe for fe in chip_smoke.encode.all_fes
             if isinstance(fe, InterFrameEncoder)]
    host = [fe for fe in inter if not fe.wf_inter]
    assert inter[0].wf_inter and len(host) == 3
    assert kernels.COUNTS["me_fullpel_frame"] == sum(len(fe.ref_ids)
                                                     for fe in host)
    assert sum(fe.comp_block_count for fe in host) > 0
    for fe in host[:2]:
        assert recon_check.filters_match(fe, fe._chk_prefilter, fe._chk_out)


# -- above 8 bits ----------------------------------------------------------------


def _hbd_planes(rng, h, w, bd):
    """(src, rec) int32 at bd bits: the 8-bit content shifted with random
    low bits, its top quarter at maximum contrast (0 and (1 << bd) - 1 in
    8x8 blocks, the source the inverse)."""
    mx = (1 << bd) - 1
    src, rec = (np.clip((p.astype(np.int64) << (bd - 8))
                        + rng.integers(0, 1 << (bd - 8), p.shape), 0, mx)
                for p in _content(rng, h, w))
    cb = (np.arange(h)[:, None] // 8 + np.arange(w) // 8) % 2
    rec[: h // 4] = cb[: h // 4] * mx
    src[: h // 4] = mx - rec[: h // 4]
    return src.astype(np.int32), rec.astype(np.int32)


@pytest.mark.parametrize("bd", [10, 12])
@pytest.mark.parametrize("h,w", [(1088, 1920), (272, 200)])
def test_cdef_kernels_high_bit_depth(h, w, bd):
    """K5 and K6 at 10 and 12 bits (strengths shifted by bd - 8, damping
    grown by it): directions, the search's int64 superblock SSE (beyond
    2^31 on the maximum-contrast rows) and the apply of random candidate
    pairs identical to the plain versions."""
    from rav1e_tpu_torch.ops import cdef

    dev = _card()
    rng = np.random.default_rng(SEED + h + bd)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    planes = [_hbd_planes(rng, h, w, bd),
              _hbd_planes(rng, h // 2, w // 2, bd),
              _hbd_planes(rng, h // 2, w // 2, bd)]
    src = [t(s) for s, _ in planes]
    rec = [t(r) for _, r in planes]
    dirs, var = cdef.cdef_dir(rec[0], bd)
    dp_, vp_ = cdef.cdef_dir_plain(rec[0], bd)
    assert torch.equal(dirs, dp_) and torch.equal(var, vp_)
    act = t(rng.random((h // 8, w // 8)) < 0.8)
    args = (*rec, *src, dirs, var, act, 4 + bd - 8)
    sse = cdef.cdef_filter(*args, cdef.SEARCH, None, bd)
    assert sse.dtype == torch.int64
    assert torch.equal(sse, cdef.cdef_filter_plain(*args, cdef.SEARCH, None,
                                                   bd))
    assert int(sse.max()) > 2 ** 31
    idx = t(rng.integers(0, 8, (-(-h // 64), -(-w // 64))).astype(np.int32))
    got = cdef.cdef_filter(*args, cdef.APPLY, idx, bd)
    ref = cdef.cdef_filter_plain(*args, cdef.APPLY, idx, bd)
    for g, r, p in zip(got, ref, rec):
        assert torch.equal(g, r)
        assert not torch.equal(g, p)


@pytest.mark.parametrize("bd", [10, 12])
@pytest.mark.parametrize("stripe", [64, 32])
def test_wiener_lr_frame_kernel_high_bit_depth(stripe, bd):
    """K8 in frame mode at 10 and 12 bits (round0/round1 and the clip of
    lrf_jax.py:50-55), identical to wiener_filter_plain, the output
    reaching both ends of the range."""
    from rav1e_tpu_torch.ops import lrf

    dev = _card()
    rng = np.random.default_rng(SEED + stripe + bd)
    mx = (1 << bd) - 1
    hh, ww = (1080, 1920) if stripe == 64 else (540, 960)
    cd = torch.as_tensor(rng.integers(0, mx + 1, (hh + 8, ww + 8)),
                         device=dev, dtype=torch.int32)
    cd[:16] = torch.where(cd[:16] > mx // 2, mx, 0)
    db = torch.clamp(cd + torch.as_tensor(rng.integers(-90, 91, cd.shape),
                                          device=dev, dtype=torch.int32),
                     0, mx)
    taps = torch.tensor([[0 if stripe == 32 else 3, -7, 15], [0, 4, -3]],
                        dtype=torch.int32, device=dev)
    got = lrf.wiener_filter_frame(cd, db, taps, stripe, hh, ww, bd)
    ref = lrf.wiener_filter_plain(cd, db, taps[0], taps[1], stripe, hh, ww,
                                  bd)
    assert torch.equal(got, ref)
    assert int(got.max()) == mx and int(got.min()) == 0


@pytest.mark.parametrize("bd", [10, 12])
def test_me_fullpel_kernel_uint16(bd):
    """K10 on uint16 planes (frame_me_map above 8 bits) at 1088x1920: a
    shifted noisy reference, identical to the plain version, through
    frame_me_map counted as the host route."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models import device_pipeline as dp

    dev = _card()
    rng = np.random.default_rng(SEED + bd)
    mx = (1 << bd) - 1
    h, w = 1088, 1920
    base = rng.integers(0, mx + 1, (h + 64, w + 64))
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    src = base[32 : 32 + h, 32 : 32 + w]
    ref = np.clip(base[32 - 7 : 32 - 7 + h, 32 + 13 : 32 + 13 + w]
                  + rng.integers(-12, 13, (h, w)), 0, mx)
    t = lambda a: torch.as_tensor(a.astype(np.uint16), device=dev)
    got = dp.me_fullpel(t(src), t(ref), 32)
    assert torch.equal(got, dp.me_fullpel_plain(t(src), t(ref), 32))
    assert (got[2:-2, 2:-2] == torch.as_tensor(
        (7, -13), dtype=torch.int32, device=dev)).float().mean() > 0.9
    before = kernels.COUNTS["me_fullpel_frame"]
    mv8 = dp.frame_me_map(src.astype(np.int32), ref.astype(np.int32), 32,
                          bit_depth=bd, device=dev)
    assert kernels.COUNTS["me_fullpel_frame"] == before + 1
    assert np.array_equal(mv8, got.cpu().numpy() * 8)


def test_frame_rd_maps_on_card():
    """frame_rd_maps of a 10-bit 1088x1920 plane on the card (K1 twice, K2's
    float variant twice, counted as the route) against the same route
    through the plain versions: modes, nnz and split32 identical but at
    near-ties (chip_smoke.rd_map_ties)."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models import device_pipeline as dp
    from rav1e_tpu_torch.ops import quantize_np as qz
    from rav1e_tpu_torch.utils.content import make_planes

    dev = _card()
    y = make_planes(1920, 1088, 1, bit_depth=10)[0][0].astype(np.int32)
    dc_q, ac_q = qz.dc_q(100, 0, 10), qz.ac_q(100, 0, 10)
    lam = 0.1155 * (dc_q / 8.0) ** 2
    before = dict(kernels.COUNTS)
    got = dp.frame_rd_maps(y, dc_q, ac_q, lam, device=dev)
    assert kernels.COUNTS["frame_rd_maps"] == before["frame_rd_maps"] + 1
    assert kernels.COUNTS["intra_pred"] == before["intra_pred"] + 2
    assert kernels.COUNTS["fwd_txq"] == before["fwd_txq"] + 2
    with chip_smoke.plain_kernels():
        ref = dp.frame_rd_maps(y, dc_q, ac_q, lam, device=dev)
    yt = torch.as_tensor(y, device=dev)
    lam_t = torch.tensor(float(lam), dtype=torch.float32)

    def table_of(n):
        from rav1e_tpu_torch.ops import transforms as tt

        blocks, stack = dp.predict_all(yt, n)
        Fv, FhT = dp._fwd_mats(n, dev)
        d, r, _z = tt.fwd_rd_float_plain(blocks[None] - stack, Fv, FhT,
                                         dc_q, ac_q, 1 if n == 32 else 0)
        return (d * dp.DIST_SCALE[n] + lam_t * (r + 6.0)).cpu().numpy()

    chip_smoke.rd_map_ties(got, ref, table_of)


def test_tile_route_on_card():
    """2 key frames of 512x256 with 4 tile columns and Config(threads=4)
    on the card: both take the tile route (`wavefront_tiles` counts each),
    K1-K3 launch inside it and K4 and K7 stay idle (the host filter path),
    and the bytes, recon and records equal the single-device encode's."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils.content import make_frames

    _card()
    frames = make_frames(512, 256, 2)
    kw = dict(check=True, size=(512, 256), tile_cols=4, tune="psnr")
    kernels.reset_counts()
    data, recon, fes = chip_smoke.encode(frames, threads=4, **kw)
    counts = dict(kernels.COUNTS)
    assert chip_smoke.encode.key_routes == {"tiles": 2}
    assert counts["wavefront_tiles"] == 2, counts
    assert all(counts[k] > 0 for k in chip_smoke.TILE_KERNELS), counts
    assert counts["deblock"] == counts["wiener_solve"] == 0, counts
    single, single_recon, single_fes = chip_smoke.encode(frames, **kw)
    assert chip_smoke.encode.key_routes == {"single": 2}
    assert single == data
    for a, b in zip(recon, single_recon):
        for p in range(3):
            assert np.array_equal(np.asarray(a[p]), np.asarray(b[p]))
    for fe, fs in zip(fes, single_fes):
        for r, c in zip(*fs._chk_wf.geom.device_sb.nonzero()):
            assert (chip_smoke._records(fe._chk_wf, r, c)
                    == chip_smoke._records(fs._chk_wf, r, c))
    assert sum(chip_smoke.rederive_tile_edges(fe) for fe in fes) > 0


def test_multidevice_on_card(monkeypatch):
    """deblock_sharded over 4 slots (the visible GPUs, or 4 slots on
    cuda:0) at 8, 10 and 12 bits, luma and chroma: K4 launches twice a shard
    and the result is identical to K4's single-device deblock_plane and to
    deblock_np.  Then 2 key frames of 512x256 with 4 tile columns through
    Config(threads=4) with the Context's mesh on 2 slots (two GPUs where
    two are visible, else both on cuda:0): the bytes, recon and records
    of the one-slot route."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import deblock
    from rav1e_tpu_torch.ops import deblock_np as dnp
    from rav1e_tpu_torch.parallel import mesh as tmesh
    from rav1e_tpu_torch.parallel import tiles as ttiles
    from rav1e_tpu_torch.parallel.dryrun import default_slots
    from rav1e_tpu_torch.utils.content import make_frames

    dev = _card()
    rng = np.random.default_rng(SEED)
    H, W = 256, 512
    info = dnp.DeblockInfo(H // 4, W // 4)
    for sy in range(0, H, 64):
        for sx in range(0, W, 64):
            bs = int(rng.choice([8, 16, 32, 64]))
            for y in range(sy, sy + 64, bs):
                for x in range(sx, sx + 64, bs):
                    info.set_block(x, y, bs, bs, bool(rng.random() < 0.3))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    maps = [t(a) for a in (info.txw, info.txh, info.bx, info.by, info.skip)]
    mesh = tmesh.make_mesh(4, devices=default_slots(4))
    levels = (36, 30, 28, 20)
    for bd in (8, 10, 12):
        for p in (0, 1):
            s = 0 if p == 0 else 1
            plane = chip_smoke.flat_plane(rng, H >> s, W >> s, bd)
            kernels.reset_counts()
            out = ttiles.deblock_sharded(mesh, plane, info, levels, 0, p, s,
                                         s, bd, W >> s, H >> s)
            assert kernels.COUNTS["deblock"] == 8
            single = deblock.deblock_plane(
                t(plane), *maps, p, s, s, *deblock.plane_lims(levels, 0, p,
                                                              bd), bd)
            ref = plane.copy()
            dnp.deblock_plane(ref, info, p, levels, 0, s, s, bd, W >> s,
                              H >> s)
            assert np.array_equal(single.cpu().numpy(), ref)
            assert np.array_equal(out, ref)
            assert not np.array_equal(ref, plane)

    frames = make_frames(512, 256, 2)
    kw = dict(check=True, size=(512, 256), tile_cols=4, tune="psnr",
              threads=4)
    data, recon, fes = chip_smoke.encode(frames, **kw)
    slots = [torch.device(d) for d in default_slots(2)]
    monkeypatch.setattr(tmesh, "slots_for", lambda _d, _n, _c: slots)
    kernels.reset_counts()
    data2, recon2, fes2 = chip_smoke.encode(frames, **kw)
    assert chip_smoke.encode.key_routes == {"tiles": 2}
    assert kernels.COUNTS["wavefront_tiles"] == 2
    assert list(fes2[0].wavefront_mesh.slots) == slots
    assert data2 == data
    for a, b in zip(recon, recon2):
        for p in range(3):
            assert np.array_equal(np.asarray(a[p]), np.asarray(b[p]))
    for fe, f2 in zip(fes, fes2):
        for r, c in zip(*fe._chk_wf.geom.device_sb.nonzero()):
            assert (chip_smoke._records(fe._chk_wf, r, c)
                    == chip_smoke._records(f2._chk_wf, r, c))
