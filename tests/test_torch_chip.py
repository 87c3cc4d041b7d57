"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and nvcc: each builds its kernel from
rav1e_tpu_torch/csrc, launches it on CUDA tensors and holds the result
against the plain version on the same inputs (identical for intra_pred,
also its channel lists, two planes a call and the race, inv_txfm, also
at every size class, fused with the prediction and over 64x64's 32x32
corner, deblock, cdef_dir, cdef_filter, wiener_solve, wiener_lr, also
in frame mode, mc_pred, me_fullpel, also through frame_me_map, and cfl,
its fit on strided views and its decide mode,
the four of the leaves also at the speed-3 pass's 8x8 and 4x4 shapes,
and above 8 bits cdef_dir, cdef_filter, wiener_lr in frame mode and
me_fullpel on uint16 planes; frame_rd_maps by its tie rule;
fwd_txq, with and without the inter race's thinning, within its
rounding-tie share, also on the pass's broadcast views, read in place,
and sums-only), and the paths that drive them (among them the tile
route of Config(threads=4) with 4 tile columns, also over 2 slots, and
the sharded deblock at 8 and 10 bits; the LR decision of a chain without
its fused stage, RAV1E_TPU_LR_FUSE=0, over wiener_lr), and the
source-edge analysis kernels mode_sad (also sharded), dr_predict (also
under predict_stack) and build_edges, put_single_batch over mc_pred
at 8, 10 and 12 bits, mc_pred's residual and two-plane modes, and the
CDEF decision cdef_decide.  Without a card they skip.  On a machine without JAX (the tests' conftest imports
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
def test_intra_pred_channel_lists_and_planes(n):
    """K1's list mode: any channel list equals the full set's slice; two
    planes' edges (U and V) in one launch equal two calls."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import intra

    dev = _card()
    rng = np.random.default_rng(SEED + 40 + n)
    a, l_, ha, hl = _edges(rng, 45, n, dev)
    a2, l2, _, _ = _edges(rng, 45, n, dev)
    full = intra.intra_pred_plain(a, l_, ha, hl, n, True)
    for chans in (intra.STACK13_CHANNELS, (0, 4, 11, 57, 58, 59, 60, 25,
                                           32, 39), (0,), (60, 1, 56, 0)):
        got = intra.intra_pred(a, l_, ha, hl, n, True, channels=chans)
        assert torch.equal(got, full[:, list(chans)]), chans
    before = kernels.COUNTS["intra_pred"]
    got = intra.intra_pred((a, a2), (l_, l2), ha, hl, n, False)
    assert kernels.COUNTS["intra_pred"] == before + 1
    assert torch.equal(got, intra.intra_pred_plain((a, a2), (l_, l2), ha, hl,
                                                   n, False))


@pytest.mark.parametrize("n,flat", [(4, False), (8, False), (16, False),
                                    (32, False), (16, True)])
def test_intra_pred_race_kernel(n, flat):
    """K1's race mode on a strided source view: stack and picks identical
    to the plain version (flat edges and source: every SAD ties)."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import intra

    dev = _card()
    rng = np.random.default_rng(SEED + 50 + n)
    a, l_, ha, hl = _edges(rng, 45, n, dev)
    tile = torch.as_tensor(rng.integers(0, 256, (45, 64, 64)),
                           dtype=torch.int32, device=dev)
    if flat:
        a[:] = 128
        l_[:] = 128
        tile[:] = 128
    src = tile[:, 32 : 32 + n, 16 : 16 + n]
    allow = torch.as_tensor(rng.random(45) < 0.5, device=dev)
    before = kernels.COUNTS["intra_pred"]
    got = intra.intra_pred(a, l_, ha, hl, n, True, src=src, allow_z1=allow)
    assert kernels.COUNTS["intra_pred"] == before + 1
    ref = intra.intra_pred_plain(a, l_, ha, hl, n, True, src=src,
                                 allow_z1=allow)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32),
                                 (64, 64), (8, 16), (16, 8), (4, 16),
                                 (32, 64), (64, 16)])
def test_inv_txfm_sizes_and_pred(w, h):
    """K3 at every size class with every type it allows, residual and
    fused reconstruction (pred=), at 8 and 10 bits."""
    from rav1e_tpu_torch.ops import transforms as tt
    from rav1e_tpu_torch.ops import transforms_np as tn

    dev = _card()
    rng = np.random.default_rng(SEED + 60 + w + 3 * h)
    types = [t for t in range(16) if all(
        k == "dct" or (k == "adst" and m <= 16) or (k == "id" and m <= 32)
        for k, m in zip(tn._TX1D[t][:2], (h, w)))]
    for t in types:
        x = rng.integers(-(1 << 12), 1 << 12, (70, h, w)).astype(np.int32)
        x[:, 32:] = 0
        x[:, :, 32:] = 0
        xt = torch.as_tensor(x, device=dev)
        for bd in (8, 10):
            pred = torch.as_tensor(rng.integers(0, 1 << bd, (70, h, w)),
                                   dtype=torch.int32, device=dev)
            assert torch.equal(tt.inv_txfm(xt, t, bd),
                               tt.inv_txfm_plain(xt, t, bd)), (t, bd)
            assert torch.equal(tt.inv_txfm(xt, t, bd, pred=pred),
                               tt.inv_txfm_plain(xt, t, bd, pred=pred))


def test_inv_txfm_tx64_and_broadcast_types():
    """K3's 64x64 transform of a 32x32 corner (residual and fused), and
    types broadcast over the lanes read in place, with pred."""
    from rav1e_tpu_torch.ops import transforms as tt

    dev = _card()
    rng = np.random.default_rng(SEED + 70)
    x = torch.as_tensor(rng.integers(-(1 << 13), 1 << 13, (40, 32, 32)),
                        dtype=torch.int32, device=dev)
    pred = torch.as_tensor(rng.integers(0, 256, (40, 64, 64)),
                           dtype=torch.int32, device=dev)
    assert torch.equal(tt.inv_txfm(x, 0, tx64=True),
                       tt.inv_txfm_plain(x, 0, tx64=True))
    assert torch.equal(tt.inv_txfm(x, 0, pred=pred, tx64=True),
                       tt.inv_txfm_plain(x, 0, pred=pred, tx64=True))
    c = torch.as_tensor(rng.integers(-4000, 4000, (45, 5, 16, 16)),
                        dtype=torch.int32, device=dev)
    types = torch.as_tensor([0, 3, 1, 2, 9], dtype=torch.int32,
                            device=dev).expand(45, 5)
    p5 = torch.as_tensor(rng.integers(0, 256, (45, 5, 16, 16)),
                         dtype=torch.int32, device=dev)
    assert torch.equal(tt.inv_txfm(c, types, pred=p5),
                       tt.inv_txfm_types_plain(c, types, pred=p5))


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


@pytest.mark.parametrize("case", ["types5_8", "types5_16", "uv2x7_4",
                                  "race13_32_sums", "race7_64", "thin_16",
                                  "copied_16", "scalar_32"])
def test_fwd_txq_broadcast_kernel(case):
    """K2 on the pass's broadcast views, read in place (block_layout):
    one launch a call, the outputs bit-identical to a launch on the
    views' contiguous copies; a sums-only call's sums equal the full
    call's; the levels within the tie rule of the plain version."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import transforms as tt
    from rav1e_tpu_torch.ops import transforms_np as tn

    dev = _card()
    rng = np.random.default_rng(SEED + len(case))
    kind, n = case.split("_")[0], int(case.split("_")[1])
    m = min(n, 32)
    types = ((tn.DCT_DCT, tn.ADST_ADST, tn.ADST_DCT, tn.DCT_ADST, tn.IDTX)
             if kind in ("types5", "uv2x7") else (tn.DCT_DCT,))
    mats = [tt.fwd_mats(t, n, n) for t in types]
    Fv = torch.as_tensor(np.stack([a[:m] for a, _ in mats]), device=dev)
    FhT = torch.as_tensor(np.stack([b[:, :m] for _, b in mats]), device=dev)
    B = 45
    t = lambda a, dt=torch.int32: torch.as_tensor(a, device=dev, dtype=dt)
    qdc = t(rng.integers(20, 300, B))
    qac = t(rng.integers(20, 300, B))
    lane = {"types5": (5,), "uv2x7": (2, 7), "race13": (13,), "race7": (7,),
            "thin": (6,), "copied": (3,), "scalar": (4,)}[kind]
    ex = lambda v: v.reshape((B,) + (1,) * len(lane)).expand((B,) + lane)
    k = {}
    if kind == "types5":
        resid = t(rng.integers(-120, 121, (B, n, n)))[:, None].expand(
            B, 5, n, n)
        k["tidx"] = torch.arange(5, dtype=torch.int32, device=dev).expand(
            B, 5)
    else:
        resid = t(rng.integers(-120, 121, (B,) + lane + (n, n)))
    if kind == "uv2x7":
        k["tidx"] = t([0, 0, 0, 0, 0, 1, 4]).expand(B, 2, 7)
    if kind == "thin":
        k["thr"] = ex(t(rng.random(B) * 300 + 100, torch.float32))
    if kind == "race13":
        k["levels"] = False
    q = (ex(qdc), ex(qac))
    if kind == "copied":  # a layout block_layout declines: copied
        q = (t(rng.integers(20, 300, (3, B))).t(), ex(qac))
        assert tt.block_layout(q[0], (B, 3)) is None
    if kind == "scalar":
        q = (116, 140)
    shift = {4: 0, 8: 0, 16: 0, 32: 1, 64: 2}[n]
    before = dict(kernels.COUNTS)
    got = tt.fwd_txq(resid, Fv, FhT, *q, shift, **k)
    name = "fwd_txq_thin" if kind == "thin" else "fwd_txq"
    assert kernels.COUNTS[name] == before[name] + 1
    dense = lambda v: (v.expand(resid.shape[:-2]).contiguous()
                       if torch.is_tensor(v) else v)
    kd = {kk: dense(v) if kk != "levels" else v for kk, v in k.items()}
    ref = tt.fwd_txq(resid.contiguous(), Fv, FhT, *map(dense, q), shift,
                     **kd)
    for g, r in zip(got, ref):
        assert (g is None and r is None) or torch.equal(g, r)
    full = tt.fwd_txq(resid, Fv, FhT, *q, shift, **dict(k, levels=True))
    assert torch.equal(full[2], got[2]) and torch.equal(full[3], got[3])
    ti = (dense(k["tidx"]) if "tidx" in k else
          torch.zeros(resid.shape[:-2], dtype=torch.int32, device=dev))
    rl, rdq, _rdist, rrate = tt.fwd_txq_plain(
        resid, Fv, FhT, ti, tt._as_blocks(q[0], resid),
        tt._as_blocks(q[1], resid), shift,
        thr=dense(k["thr"]) if "thr" in k else None)
    lv, dq = full[0], full[1]
    bad = (lv != rl) | (dq != rdq)
    assert (lv - rl).abs().max() <= 1
    assert bad.float().mean() <= 1e-3
    clean = ~bad.flatten(-2).any(-1)
    assert torch.allclose(full[3][clean], rrate[clean], rtol=1e-4)


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


@pytest.mark.parametrize("hh,ww", [(1079, 1917), (67, 130), (200, 63)])
def test_wiener_solve_kernel_odd_sizes(hh, ww):
    """K7 on planes whose sides are not multiples of its 64x64 tiles (and
    on strided views of larger ones): identical taps and en."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import lrf

    dev = _card()
    rng = np.random.default_rng(SEED + hh + ww)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    sizes = ((hh, ww), ((hh + 1) >> 1, (ww + 1) >> 1),
             ((hh + 1) >> 1, (ww + 1) >> 1))
    planes = [_content(rng, h + 8, w + 8) for h, w in sizes]
    ds = [t(r)[:h, :w] for (_s, r), (h, w) in zip(planes, sizes)]
    ss = [t(s)[:h, :w] for (s, _r), (h, w) in zip(planes, sizes)]
    before = kernels.COUNTS["wiener_solve"]
    taps, en = lrf.wiener_solve(ds, ss)
    assert kernels.COUNTS["wiener_solve"] == before + 1
    rt, re = lrf.wiener_solve_plain(ds, ss)
    assert torch.equal(taps, rt) and torch.equal(en, re)


@pytest.mark.parametrize("h,w", [(1080, 1920), (272, 200)])
def test_cdef_decide_kernel(h, w):
    """K15 on random superblock SSE (ties among the candidates included)
    and skip maps with all-skip superblocks, at sb_lam 0, a middling
    value, one that puts the frame pair's cost next to the per-superblock
    total's, and inf: identical to the plain version."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import cdef

    dev = _card()
    rng = np.random.default_rng(SEED + h)
    nsby, nsbx = -(-h // 64), -(-w // 64)
    sse = rng.integers(0, 1 << 22, (11, nsby, nsbx)).astype(np.int64)
    sse[3] = sse[2]  # ties between pairs 2 and 3
    sse[:, 0, 0] = 7  # every pair ties in the first superblock
    skip = rng.random(((h // 8) * 2 + 2, (w // 8) * 2 + 3)) < 0.7
    skip[:16, 16:48] = True  # all-skip superblocks
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    args = (t(sse), t(skip))
    ref0 = cdef.decide_plain(*args, 0.0, h, w)
    cost = sse[:8] + sse[8:][list(cdef.PAIR_UV_IDX)]
    gap = float(cost.sum((1, 2)).min() - cost.min(0).sum())
    mi = np.ones((nsby * 16, nsbx * 16), bool)
    mi[: (h // 8) * 2, : (w // 8) * 2] = skip[: (h // 8) * 2, : (w // 8) * 2]
    n_coded = int((~mi.reshape(nsby, 16, nsbx, 16).all((1, 3))).sum())
    edge = gap / (84 + 3 * n_coded)  # the rate term meets the gap here
    for lam in (0.0, 3.5, edge * (1 - 1e-12), edge, edge * (1 + 1e-12),
                float("inf")):
        before = kernels.COUNTS["cdef_decide"]
        got = cdef.decide(*args, lam, h, w)
        assert kernels.COUNTS["cdef_decide"] == before + 1
        ref = cdef.decide_plain(*args, lam, h, w)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert torch.equal(g, r), lam
    assert bool(ref0[0])
    # a skip view off its 16-byte alignment (the byte-wise reads) and
    # int32 SSE
    view = t(np.pad(skip, ((0, 0), (1, 0))))[:, 1:]
    got = cdef.decide(t(sse.astype(np.int32)), view, 3.5, h, w)
    ref = cdef.decide_plain(t(sse.astype(np.int32)), t(skip), 3.5, h, w)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


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


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_mc_pred_modes_kernel(n):
    """K9's residual mode (the race: 6 candidates a block, the source read
    at the block's position) and its two-plane mode (U and V of the
    chroma blocks of 2n luma: prediction, residual and both) on 1080p
    planes, one launch each, identical to the plain version."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import mc

    dev = _card()
    rng = np.random.default_rng(SEED + 60 + n)
    t = lambda a: torch.as_tensor(a, device=dev, dtype=torch.int32)
    u8 = lambda a: torch.as_tensor(a.astype(np.uint8), device=dev)
    lim, cands = mc.MV_LIMIT, 6
    for sub in (0, 1):
        h, w = 1088 >> sub, 1920 >> sub
        refs = [_padded_ref(rng, h, w, dev) for _ in range(1 + sub)]
        srcs = [u8(rng.integers(0, 256, (h, w))) for _ in range(1 + sub)]
        B = 300
        px = rng.integers(0, w // n, B) * n
        py = rng.integers(0, h // n, B) * n
        px[:4], py[:4] = (0, w - n, 0, w - n), (0, 0, h - n, h - n)
        mv = rng.integers(-lim, lim + 1, (B * cands, 2))
        mv[: 4 * cands : cands] = [(-lim, -lim), (-lim, lim), (lim, -lim),
                                   (lim, lim)]
        lanes = (t(px), t(py), t(mv[:, 0]), t(mv[:, 1]), n, n, sub, sub)
        if sub == 0:
            calls = [dict(src=srcs[0], cands=cands)]
            ref = refs[0]
        else:
            lanes = (t(np.repeat(px, cands)), t(np.repeat(py, cands)),
                     *lanes[2:])
            calls = [{}, dict(src=tuple(srcs)), dict(src=tuple(srcs),
                                                     both=True)]
            ref = tuple(refs)
        for k in calls:
            before = kernels.COUNTS["mc_pred"]
            got = mc.mc_block_batch(ref, mc.MC_MARGIN, *lanes, **k)
            assert kernels.COUNTS["mc_pred"] == before + 1
            want = mc.mc_block_batch_plain(ref, mc.MC_MARGIN, *lanes, **k)
            for g, r in zip(*(x if isinstance(x, tuple) else (x,)
                              for x in (got, want))):
                assert g.shape == r.shape and torch.equal(g, r)


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
    # every counter but the speed-5 path's own (cfl in both its modes,
    # K8's frame mode), the host inter path's (frame_me_map), the host key
    # walk's (frame_rd_maps), the tile route's (wavefront_tiles), the
    # unfused LR route's (wiener_lr_decide) and the analysis kernels', as
    # chip_smoke.py's mixed-GOP phase counts them
    assert all(v > 0 for k, v in kernels.COUNTS.items()
               if k not in ("cfl", "cfl_decide", "wiener_lr_frame",
                            "me_fullpel_frame",
                            "frame_rd_maps", "wavefront_tiles",
                            "wiener_lr_decide")
               + chip_smoke.ANALYSIS_KERNELS), kernels.COUNTS
    # K9 6 times an inter frame (a level's race and its U + V), K15 once
    # a frame
    assert kernels.COUNTS["mc_pred"] == 12, kernels.COUNTS
    assert kernels.COUNTS["cdef_decide"] == 3, kernels.COUNTS
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


@pytest.mark.parametrize("n", [8, 16, 32])
def test_cfl_fit_reads_strided_views(n):
    """K11's fit on the views the pass gives it (the DC prediction as
    channel 0 of a K1 candidate stack, the sources transposed, luma a
    column window) equals its plain version and its contiguous call."""
    from rav1e_tpu_torch.ops import intra

    dev = _card()
    rng = np.random.default_rng(SEED + 2 * n)
    B, n2 = 45, n // 2
    t = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    wide = t(rng.integers(0, 256, (B, n, n + 8)))
    stack = t(rng.integers(0, 256, (B, 2, 7, 1, 1)).repeat(n2, 3)
              .repeat(n2, 4))
    src = t(rng.integers(0, 256, (2, B, n2, n2))).transpose(0, 1)
    args = (wide[:, :, 4 : 4 + n], stack[:, :, 0], src)
    got = intra.cfl(*args)
    for g, r, c in zip(got, intra.cfl_plain(*args),
                       intra.cfl(*(a.contiguous() for a in args))):
        assert torch.equal(g, r) and torch.equal(g, c)


def _decide_inputs(rng, B, n2, dev, tie):
    """Inputs of K11's decide mode as the arm passes them: the CFL side
    contiguous, the DC side views of 7-candidate stacks, lam a strided
    view; with tie, CFL costs exactly DC's on every block."""
    t = lambda a, dt=np.int32: torch.as_tensor(a.astype(dt), device=dev)
    blk = lambda lo, hi: t(rng.integers(lo, hi, (B, 2, n2, n2)))
    rc, lc = blk(-255, 256), blk(-20, 21)
    ic = rc + blk(-20, 21)
    alpha = t(rng.integers(-16, 17, (B, 2)) * (rng.random((B, 2)) < 0.8))
    ratec = t(rng.uniform(0, 300, (B, 2)), np.float32)
    stacks = [t(rng.integers(lo, hi, (B, 2, 7, n2, n2)))
              for lo, hi in ((0, 256), (-20, 21), (-255, 256))]
    dd = t(rng.uniform(0, 300 * n2 * n2, (B, 2, 7)), np.float32)
    rate = t(rng.uniform(0, 300, (B, 2, 7)), np.float32)
    lam = t(rng.uniform(5, 500, (B, 3)), np.float32)[:, 1]
    tabs = [t(rng.uniform(0.5, 9, sh), np.float32)
            for sh in ((13, 14), (8,), (6, 16))]
    if tie:
        ic = rc.clone()
        alpha[alpha == 0] = 5
        dd.zero_()
        rate[:, :, 0] = ratec
        tabs[0][:, 0], tabs[0][:, 13] = 3.0, 1.0
        tabs[1][:], tabs[2][:] = 1.0, 0.5
    mode = torch.as_tensor(rng.integers(0, 13, B), device=dev)
    return (rc, ic, lc, ratec, alpha, blk(0, 256), stacks[0][:, :, 0],
            stacks[1][:, :, 0], stacks[2][:, :, 0], dd[:, :, 0],
            rate[:, :, 0], lam, mode, tuple(tabs))


@pytest.mark.parametrize("n2,tie", [(4, False), (8, False), (16, False),
                                    (16, True)])
def test_cfl_decide_kernel(n2, tie):
    """K11's decide mode (one launch) identical to cfl_decide_plain on
    mixed outcomes, and on blocks whose CFL cost ties DC's exactly (the
    strict < keeps DC)."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import intra

    dev = _card()
    rng = np.random.default_rng(SEED + n2 + tie)
    a = _decide_inputs(rng, 600, n2, dev, tie)
    before = kernels.COUNTS["cfl_decide"]
    got = intra.cfl_decide(*a)
    assert kernels.COUNTS["cfl_decide"] == before + 1
    ref = intra.cfl_decide_plain(*a)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    won = int((got[5] == 13).sum())
    assert won == 0 if tie else 0 < won < 600


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
    # the CFL arm: K11's fit and its decide mode once each a call
    assert counts["cfl_decide"] == counts["cfl"], counts
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


@pytest.mark.parametrize("n,count", [(8, 3), (8, 10), (16, 10), (32, 10)])
def test_mode_sad_kernel(n, count):
    """K12 on noisy content and on flat patches (ties), with and without a
    halo row above the planes, identical to the plain version; the
    sharded maps over 4 slots equal the whole plane's."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models import device_pipeline as dp
    from rav1e_tpu_torch.parallel import mesh as tmesh
    from rav1e_tpu_torch.parallel.dryrun import default_slots

    dev = _card()
    rng = np.random.default_rng(SEED + n + count)
    noisy = rng.integers(0, 256, (2, 288, 320))
    flat = np.kron(rng.integers(0, 256, (2, 5, 5)), np.ones((1, 64, 64),
                                                           np.int64))
    planes = torch.as_tensor(np.concatenate([noisy, flat[:, :288]]),
                             dtype=torch.int32, device=dev)
    row = torch.as_tensor(rng.integers(0, 256, (4, 320)), dtype=torch.int32,
                          device=dev)
    for above in (None, row):
        before = kernels.COUNTS["mode_sad"]
        got = dp.mode_sad(planes, n, count, above)
        assert kernels.COUNTS["mode_sad"] == before + 1
        ref = dp.mode_sad_plain(planes, n, count, above)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    if count == 10:
        mesh = tmesh.make_mesh(4, devices=default_slots(4))
        whole = dp.mode_analysis(planes[0], n)
        for g, w in zip(dp.sharded_mode_analysis(mesh, planes[0], n), whole):
            assert torch.equal(g.to(dev), w)


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32),
                                 (64, 64), (8, 16), (16, 8), (4, 32)])
def test_dr_predict_kernel(w, h):
    """K13 at each of the 56 directional angles, identical to the plain
    version; predict_stack (K1 + K13) at the square sizes."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import intra

    dev = _card()
    rng = np.random.default_rng(SEED + w * 64 + h)
    angles = np.tile(intra.DIR_ANGLES.reshape(-1), 8).astype(np.int32)
    B = angles.size
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    above = rng.integers(0, 256, (B, 1 + w + h)).astype(np.int32)
    left = rng.integers(0, 256, (B, 1 + w + h)).astype(np.int32)
    left[:, 0] = above[:, 0]
    args = (t(above), t(left), t(angles), w, h)
    before = kernels.COUNTS["dr_predict"]
    got = intra.dr_predict_batch(*args)
    assert kernels.COUNTS["dr_predict"] == before + 1
    assert torch.equal(got, intra.dr_predict_plain(*args))
    if w == h:
        ha, hl = t(rng.random(B) < 0.7), t(rng.random(B) < 0.7)
        stack = intra.predict_stack(args[0], args[1], w, h, ha, hl)
        nd = intra.intra_pred_plain(args[0], args[1], ha, hl, w, False)
        for ch, m in enumerate((intra.DC, intra.V, intra.H, intra.SMOOTH,
                                intra.SMOOTH_V, intra.SMOOTH_H,
                                intra.PAETH)):
            assert torch.equal(stack[:, m], nd[:, ch])
        for m in intra.STACK_DIRS:
            ang = torch.full((B,), intra.ip.MODE_ANGLE[m], dtype=torch.int32,
                             device=dev)
            assert torch.equal(stack[:, m], intra.dr_predict_plain(
                args[0], args[1], ang, w, h))


@pytest.mark.parametrize("w,h,bd", [(8, 8, 8), (16, 8, 8), (32, 32, 10),
                                    (64, 64, 12)])
def test_build_edges_kernel(w, h, bd):
    """K14 over every availability pattern and blocks at the plane's
    corners (the clamps), identical to the plain version."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import intra

    dev = _card()
    rng = np.random.default_rng(SEED + w + h + bd)
    H, W = 1080, 1920
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    B = 2048
    ys = (rng.integers(0, H // h, B) * h).astype(np.int32)
    xs = (rng.integers(0, W // w, B) * w).astype(np.int32)
    ys[:4], xs[:4] = (0, 0, H - h, H - h), (0, W - w, 0, W - w)
    args = (t(rng.integers(0, 1 << bd, (H, W)).astype(np.int32)), t(ys),
            t(xs), w, h, t(np.arange(B) % 2 == 0), t(np.arange(B) % 4 < 2),
            t((rng.integers(0, 3, B) * (w // 2)).astype(np.int32)),
            t((rng.integers(0, 3, B) * (h // 2)).astype(np.int32)),
            W - 3, H - 5, bd)
    before = kernels.COUNTS["build_edges"]
    got = intra.build_edges_batch(*args)
    assert kernels.COUNTS["build_edges"] == before + 1
    for g, r in zip(got, intra.build_edges_plain(*args)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("sub,bd,fset", [(0, 8, 0), (1, 8, 1), (0, 10, 2),
                                         (1, 12, 0)])
def test_put_single_batch_on_card(sub, bd, fset):
    """put_single_batch through K9 (uint8 or uint16 planes, any filter
    set) identical to the plain version on the CPU."""
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import mc

    _card()
    rng = np.random.default_rng(SEED + sub + bd + fset)
    ref = rng.integers(0, 1 << bd, (1080 >> sub, 1920 >> sub)).astype(
        np.int32)
    n = 16 >> sub
    B = 512
    blocks = np.stack([rng.integers(0, ref.shape[1] - n, B),
                       rng.integers(0, ref.shape[0] - n, B)], 1)
    mvs = rng.integers(-mc.MV_LIMIT, mc.MV_LIMIT + 1, (B, 2))
    args = (ref, blocks, mvs, n, n, sub, sub, bd, fset)
    before = kernels.COUNTS["mc_pred"]
    got = mc.put_single_batch(*args)
    assert kernels.COUNTS["mc_pred"] == before + 1
    assert np.array_equal(got, mc.put_single_batch(*args, device="cpu"))


def test_lr_decide_on_card(monkeypatch):
    """Two 320x240 key frames at the speed-6 defaults with
    RAV1E_TPU_LR_FUSE=0: K7 and K8's chain mode stay idle, K8 launches 3
    times a frame on the unfused route (counted wiener_lr_decide), every
    such call identical to wiener_lr_plain, and the output conforms as
    chip_smoke.py checks it."""
    import chip_smoke
    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import lrf
    from rav1e_tpu_torch.utils.content import make_frames

    _card()
    monkeypatch.setenv("RAV1E_TPU_LR_FUSE", "0")
    monkeypatch.setattr(chip_smoke, "W", 320)
    monkeypatch.setattr(chip_smoke, "H", 240)
    calls = []
    orig = lrf.wiener_lr

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(lrf, "wiener_lr", spy)
    kernels.reset_counts()
    data, recon, fes = chip_smoke.encode(make_frames(320, 240, 2), check=True)
    assert kernels.COUNTS["wiener_lr_decide"] == len(calls) == 6
    assert kernels.COUNTS["wiener_lr"] == kernels.COUNTS["wiener_solve"] == 0
    for a, k, (comp, choice) in calls:
        assert k["count"] == "wiener_lr_decide"
        rc, rch = lrf.wiener_lr_plain(*a)
        assert torch.equal(comp, rc) and torch.equal(choice, rch)
    summary = chip_smoke.check_output(data, recon, fes, 2)
    assert summary["filter_chain_np_frames"] == 2
