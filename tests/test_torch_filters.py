"""The port's CDEF and loop-restoration kernels against the JAX package, on
the CPU.

Each kernel of this slice (K5 cdef_dir, K6 cdef_filter, K7 wiener_solve,
K8 wiener_lr) has a plain PyTorch version that its wrapper runs for CPU
tensors.  The same numpy inputs, made from one seed, go through it and
through the JAX function it replaces:

- K5, K6 and K8 are normative and must be identical.
- The CDEF search sums its SSE exactly; the JAX search sums in f32.  Its
  choices must be equal, or each superblock that differs must show its
  two costs within f32 rounding of each other.
- K7 solves from exact sums in float64; the JAX solve is f32.  Taps must
  be equal, or differ by 1 where the exact coef * 128 lies within
  TIE_WINDOW of a .5 rounding tie.

The small JAX functions run op by op (eagerly): at these sizes every f32
sum they take is exact, so the order of operations cannot change their
result, and op-by-op dispatch avoids a ~40 s compile of the search graph.
The whole chain is held against the jitted JAX chain
(filter_chain_jax._make_kernel with damping 3 and the fused LR) at
320x240, compiled once in a module fixture.
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import cdef_jax as jcd
from rav1e_tpu.ops import cdef_np as jcnp
from rav1e_tpu.ops import deblock_np as jdnp
from rav1e_tpu.ops import filter_chain_jax as jfc
from rav1e_tpu.ops import lrf_jax as jlr
from rav1e_tpu.ops import lrf_np as jlnp
from rav1e_tpu_torch.ops import cdef as tcd
from rav1e_tpu_torch.ops import filter_chain as tfc
from rav1e_tpu_torch.ops import lrf as tlr

# one intra-op thread: the suite runs several test processes side by
# side on the CPU, and torch's default (a thread a core in each) makes
# them contend
torch.set_num_threads(1)

SEED = 20261017
# |coef * 128 - (k + 0.5)| within which an f32 solve may round a tap the
# other way (the f32 normal equations carry ~1e-6 relative error)
TIE_WINDOW = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class _Stage:
    def stage(self, _name):
        return contextlib.nullcontext()


def _content(rng, h, w):
    """A source plane (flat patches, diagonal edges, noise) and a
    coded-looking recon of it (blurred by a 5-tap binomial, plus noise):
    the Wiener fit sharpens it and CDEF smooths its noise."""
    lo = rng.integers(30, 226, (h // 16 + 2, w // 16 + 2))
    src = np.kron(lo, np.ones((16, 16)))[:h, :w]
    src = src + 40 * (np.add.outer(np.arange(h), 2 * np.arange(w)) % 37 < 6)
    src = np.clip(src + rng.normal(0, 5, (h, w)), 0, 255)
    k = np.array([1, 4, 6, 4, 1]) / 16.0
    pad = np.pad(src, 2, mode="edge")
    rec = sum(k[i] * pad[i : i + h, 2 : 2 + w] for i in range(5))
    pad = np.pad(rec, 2, mode="edge")
    rec = sum(k[i] * pad[2 : 2 + h, i : i + w] for i in range(5))
    rec = rec + rng.normal(0, 2, (h, w))
    return (src.astype(np.int32),
            np.clip(np.rint(rec), 0, 255).astype(np.int32))


def _tiling(rng, H, W):
    info = jdnp.DeblockInfo(H // 4, W // 4)
    for sy in range(0, H, 64):
        for sx in range(0, W, 64):
            bs = int(rng.choice([8, 16, 32, 64]))
            for y in range(sy, sy + 64, bs):
                for x in range(sx, sx + 64, bs):
                    info.set_block(x, y, bs, bs, bool(rng.random() < 0.3))
    return info


def _maps(rng, nby, nbx):
    """Directions and variances of 8x8 blocks, the variances next to the
    powers of two that floor(log2(var >> 6)) steps at."""
    dirs = rng.integers(0, 8, (nby, nbx)).astype(np.int32)
    k = rng.integers(0, 16, (nby, nbx))
    var = ((64 << k) + rng.integers(-2, 2, (nby, nbx))).astype(np.int32)
    var[rng.random((nby, nbx)) < 0.1] = 0
    return dirs, np.maximum(var, 0)


# -- K5 cdef_dir -----------------------------------------------------------------


def test_cdef_dir_matches_jax_and_numpy():
    """Directions and variances of random blocks and of maximum-contrast
    blocks (0/255 stripes in each direction, checkerboards), where the
    costs reach their int32 bound."""
    rng = np.random.default_rng(SEED)
    h, w = 64, 128
    plane = rng.integers(0, 256, (h, w)).astype(np.int32)
    i, j = np.mgrid[0:8, 0:8]
    pats = [(i + j) % 2, (i + j) % 4 < 2, i % 2, j % 2, (i - j) % 4 < 2,
            (i + (j >> 1)) % 2, ((i >> 1) + j) % 2, i < 4, j < 4,
            np.ones((8, 8), int)]
    for n, pat in enumerate(pats):
        by, bx = divmod(n, 8)
        plane[by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8] = 255 * pat
    d_np, v_np = jcnp.find_dir_all(plane, 8, h, w)
    d_j, v_j = jcd._find_dir_all_jnp(jnp, jnp.asarray(plane), 8, h, w)
    d_t, v_t = tcd.cdef_dir(_t(plane))
    assert np.array_equal(d_t.numpy(), np.asarray(d_j))
    assert np.array_equal(v_t.numpy(), np.asarray(v_j))
    assert np.array_equal(d_t.numpy(), d_np)
    assert np.array_equal(v_t.numpy(), v_np)
    assert v_t.max() > 1 << 19  # the maximum-contrast blocks


# -- K6 cdef_filter ----------------------------------------------------------------


@pytest.fixture(scope="module")
def cdef_planes():
    rng = np.random.default_rng(SEED + 1)
    h, w = 64, 128
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    y[:, :64] = np.clip(y[:, :64] // 16 + 120, 0, 255)  # a smooth half
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    dirs, var = _maps(rng, h // 8, w // 8)
    act = rng.random((h // 8, w // 8)) < 0.8
    return y, u, v, dirs, var, act


def _jax_plane(plane, dirs, pri_map, sec, damping, act, sub):
    h, w = plane.shape
    return np.asarray(jcd._filter_plane_jnp(
        jnp, jnp.asarray(plane), jnp.asarray(dirs), jnp.asarray(pri_map),
        sec, damping, 8, w, h, jnp.asarray(act), sub))


@pytest.mark.parametrize("cand", range(8))
def test_cdef_filter_luma_candidate_matches_jax(cdef_planes, cand):
    """K6 (apply mode, every superblock on luma candidate `cand`, damping
    4) equals _filter_plane_jnp with _adjust_vec_jnp's strengths."""
    y, u, v, dirs, var, act = cdef_planes
    pri, sec = jcd.Y_CANDIDATES[cand]
    pri_map = np.asarray(jcd._adjust_vec_jnp(jnp, pri, jnp.asarray(var)))
    ref = _jax_plane(y, dirs if pri else 0 * dirs, pri_map, sec, 4, act, 0)
    idx = torch.full((1, 2), cand, dtype=torch.int32)
    yo, _uo, _vo = tcd.cdef_filter(_t(y), _t(u), _t(v), _t(y), _t(u), _t(v),
                                   _t(dirs), _t(var), _t(act), 4, tcd.APPLY,
                                   idx)
    assert np.array_equal(yo.numpy(), ref)
    if pri or sec:
        assert not np.array_equal(ref, y)


@pytest.mark.parametrize("uv", range(3))
def test_cdef_filter_chroma_candidate_matches_jax(cdef_planes, uv):
    """K6's chroma (the pair whose chroma candidate is `uv`, damping 3)
    equals _filter_plane_jnp on both chroma planes."""
    y, u, v, dirs, var, act = cdef_planes
    cand = jcd.PAIR_UV_IDX.index(uv)
    pri = jcd.UV_CANDIDATES[uv][0]
    idx = torch.full((1, 2), cand, dtype=torch.int32)
    _yo, uo, vo = tcd.cdef_filter(_t(y), _t(u), _t(v), _t(y), _t(u), _t(v),
                                  _t(dirs), _t(var), _t(act), 4, tcd.APPLY,
                                  idx)
    for got, plane in ((uo, u), (vo, v)):
        ref = _jax_plane(plane, dirs if pri else 0 * dirs,
                         np.full(dirs.shape, pri, np.int32), 0, 3, act, 1)
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("act_kind", ["random", "none", "all"])
def test_cdef_filter_edge_frame_matches_jax(act_kind):
    """K6's apply mode with one candidate pair for every superblock (the
    fixed strengths of cdef_frame_device) on a frame of partial
    superblocks, 120x200 (height 56 mod 64, width 8 mod 64), with a
    random, an all-inactive and an all-active block map: every luma and
    chroma candidate equals _filter_plane_jnp."""
    rng = np.random.default_rng(SEED + 3)
    h, w = 120, 200
    y, u, v = (_content(rng, hh, ww)[1]
               for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    dirs, var = _maps(rng, h // 8, w // 8)
    act = {"random": rng.random((h // 8, w // 8)) < 0.7,
           "none": np.zeros((h // 8, w // 8), bool),
           "all": np.ones((h // 8, w // 8), bool)}[act_kind]
    planes = [_t(p) for p in (y, u, v)]
    for cand in range(8):
        idx = torch.full((2, 4), cand, dtype=torch.int32)
        got = tcd.cdef_filter(*planes, *planes, _t(dirs), _t(var), _t(act),
                              4, tcd.APPLY, idx)
        pri, sec = jcd.Y_CANDIDATES[cand]
        pri_map = np.asarray(jcd._adjust_vec_jnp(jnp, pri, jnp.asarray(var)))
        refs = [_jax_plane(y, dirs if pri else 0 * dirs, pri_map, sec, 4, act,
                           0)]
        upri = jcd.UV_CANDIDATES[jcd.PAIR_UV_IDX[cand]][0]
        refs += [_jax_plane(p, dirs if upri else 0 * dirs,
                            np.full(dirs.shape, upri, np.int32), 0, 3, act, 1)
                 for p in (u, v)]
        for g, r, p in zip(got, refs, (y, u, v)):
            assert np.array_equal(g.numpy(), r)
            if act_kind == "none":
                assert np.array_equal(r, p)


@pytest.mark.parametrize("sb_lam,all_skip", [(0.5, False), (np.inf, False),
                                             (0.5, True)])
def test_cdef_search_matches_jax(sb_lam, all_skip):
    """The search (K5, K6 search mode, the device decision, K6 apply mode)
    against cdef_jax._make_search_kernel(8, 128, 64), run op by op: the
    same choices and planes, or the differing superblock's two costs
    within f32 rounding.  The left superblock is noisy (CDEF helps), the
    right one exact (any filtering hurts) or all skip."""
    rng = np.random.default_rng(SEED + 2)
    h, w = 64, 128
    sy, y = _content(rng, h, w)
    su, u = _content(rng, h // 2, w // 2)
    sv, v = _content(rng, h // 2, w // 2)
    y[:, 64:], u[:, 32:], v[:, 32:] = sy[:, 64:], su[:, 32:], sv[:, 32:]
    skip = rng.random((h // 4, w // 4)) < 0.5
    if all_skip:
        skip[:, 16:] = True
    kern = jcd._make_search_kernel(8, w, h).__wrapped__
    j = kern(*(jnp.asarray(a.astype(np.uint16)) for a in (y, u, v, sy, su,
                                                          sv)),
             jnp.asarray(skip), np.float32(sb_lam), damping=3)
    use_sb, frame_best, idx_map, *planes = tcd.search_apply(
        _t(y), _t(u), _t(v), _t(sy), _t(su), _t(sv), _t(skip),
        float(np.float32(sb_lam)), 3)
    sse = tcd.cdef_filter(_t(y), _t(u), _t(v), _t(sy), _t(su), _t(sv),
                          *tcd.cdef_dir(_t(y)),
                          tcd.active_blocks(_t(skip), h, w), 3, tcd.SEARCH)
    cost = (sse[:8] + sse[8:][list(tcd.PAIR_UV_IDX)]).numpy()
    assert bool(use_sb) == bool(j[0]) and int(frame_best) == int(j[1])
    diff = idx_map.numpy() != np.asarray(j[2])
    for r, c in zip(*np.nonzero(diff)):
        a, b = cost[idx_map[r, c], r, c], cost[int(j[2][r, c]), r, c]
        assert abs(a - b) <= 2 ** -23 * max(a, b) * 64, (r, c, a, b)
    if not diff.any():
        for got, ref in zip(planes, j[3:]):
            assert np.array_equal(got.numpy(), np.asarray(ref))
    # the two superblocks' best candidates differ unless one is all skip
    assert bool(use_sb) == (sb_lam < 1 and not all_skip)


# -- K7 wiener_solve -------------------------------------------------------------


def _exact_coef(d, s):
    """float64 coefficients (2, 3) from exact sums (the tie check)."""
    sums = tlr._normal_sums(_t(d), _t(s)).numpy().astype(np.float64)
    out = []
    for m in sums:
        M = np.array([[m[0], m[1], m[2]], [m[1], m[3], m[4]],
                      [m[2], m[4], m[5]]])
        M += (1e-6 * np.trace(M) + 1e-3) * np.eye(3)
        out.append(np.linalg.solve(M, m[6:]))
    return np.array(out)


def test_wiener_solve_matches_jax():
    """K7's taps for a luma (134x70) and two chroma (67x35) planes equal
    _wiener_solve_dev's (chroma outer tap 0, en), or differ by 1 at a
    tie."""
    rng = np.random.default_rng(SEED + 3)
    planes = [_content(rng, 136, 72), _content(rng, 72, 40),
              _content(rng, 72, 40)]
    dims = ((134, 70), (67, 35), (67, 35))
    ss = [p[0][:hh, :ww] for p, (hh, ww) in zip(planes, dims)]
    ds = [p[1][:hh, :ww] for p, (hh, ww) in zip(planes, dims)]
    taps, en = tlr.wiener_solve([_t(d) for d in ds], [_t(s) for s in ss])
    ties = 0
    for p, (d, s) in enumerate(zip(ds, ss)):
        v3, h3 = jfc._wiener_solve_dev(jnp, jnp.asarray(d), jnp.asarray(s),
                                       *d.shape)
        ref = np.stack([np.asarray(v3), np.asarray(h3)])
        if p:
            ref[:, 0] = 0
        got = taps[2 * p : 2 * p + 2].numpy()
        coef = _exact_coef(d, s) * 128
        for k in zip(*np.nonzero(got != ref)):
            frac = abs(coef[k] - np.floor(coef[k]) - 0.5)
            assert abs(int(got[k]) - int(ref[k])) == 1 and frac < TIE_WINDOW
            ties += 1
        assert bool(en[p]) == bool(np.abs(ref).sum() > 0)
    assert ties <= 1
    assert en.all()


@pytest.mark.parametrize("w", [72, 130])
def test_wiener_solve_partial_band_matches_jax(w):
    """K7's plain version on planes of 56 rows (one partial 64-row band
    of the JAX sums, a partial 64x64 tile of K7's) and 28-row chroma:
    the same taps as _wiener_solve_dev on the same planes, or 1 apart
    where the exact coefficient lies within TIE_WINDOW of a tie (the JAX
    sums are f32)."""
    rng = np.random.default_rng(SEED + 5 + w)
    planes = [_content(rng, 56, w), _content(rng, 28, w // 2),
              _content(rng, 28, w // 2)]
    ss = [p[0] for p in planes]
    ds = [p[1] for p in planes]
    taps, en = tlr.wiener_solve_plain([_t(d) for d in ds],
                                      [_t(s) for s in ss])
    for p, (d, s) in enumerate(zip(ds, ss)):
        v3, h3 = jfc._wiener_solve_dev(jnp, jnp.asarray(d), jnp.asarray(s),
                                       *d.shape)
        ref = np.stack([np.asarray(v3), np.asarray(h3)])
        if p:
            ref[:, 0] = 0
        got = taps[2 * p : 2 * p + 2].numpy()
        coef = _exact_coef(d, s) * 128
        for k in zip(*np.nonzero(got != ref)):
            frac = abs(coef[k] - np.floor(coef[k]) - 0.5)
            assert abs(int(got[k]) - int(ref[k])) == 1 and frac < TIE_WINDOW
        assert bool(en[p]) == bool(np.abs(got).sum() > 0)


# -- K8 wiener_lr ----------------------------------------------------------------


@pytest.mark.parametrize("unit", [64, 32])
def test_wiener_lr_matches_jax(unit):
    """K8 at 134x70 (not multiples of 8: the stripe rule's boundary rows
    and the merged last units) restores exactly as _wiener_body and
    lrf_np.wiener_filter_frame, and makes _make_kernel.run's unit
    choices (exact int32 sums, f32 comparison) and composition."""
    rng = np.random.default_rng(SEED + 4 + unit)
    hh, ww = (134, 70) if unit == 64 else (67, 35)
    src, cd = _content(rng, (hh + 9) & ~7, (ww + 9) & ~7)
    db = np.clip(cd + rng.integers(-3, 4, cd.shape), 0, 255).astype(np.int32)
    src[: unit - 4] = cd[: unit - 4]  # unit 0 is exact: Wiener only hurts
    taps, _en = tlr.wiener_solve_plain([_t(cd[:hh, :ww])] * 3,
                                       [_t(src[:hh, :ww])] * 3)
    vt, ht = taps[0 if unit == 64 else 2 : : 1][:2].numpy()
    lam, rate = 50.0, tlr.LR_RATE_Y if unit == 64 else tlr.LR_RATE_C
    ridx, use_db = jlr._gather_tables(hh, unit)
    rest = np.asarray(jlr._wiener_body(
        jax, jnp, jnp.asarray(cd), jnp.asarray(db), jnp.asarray(ridx),
        jnp.asarray(use_db), jnp.asarray(jlnp.wiener_7tap(vt), jnp.int32),
        jnp.asarray(jlnp.wiener_7tap(ht), jnp.int32), 8, ww, hh))
    assert np.array_equal(rest, jlnp.wiener_filter_frame(
        cd, db, vt, ht, unit, 8, ww, hh))
    taps = _t(np.stack([vt, ht]).astype(np.int32))
    comp, choice = tlr.wiener_lr(_t(cd), _t(db), _t(src), taps,
                                 torch.ones(1, dtype=torch.int32), lam, rate,
                                 unit, hh, ww)
    rows = jlnp.unit_ranges(unit, hh, shifted=True)
    cols = jlnp.unit_ranges(unit, ww)
    base = cd[:hh, :ww]
    want = base.copy()
    for ur, (y0, y1) in enumerate(rows):
        for uc, (x0, x1) in enumerate(cols):
            sl = (slice(y0, y1), slice(x0, x1))
            s0 = ((base[sl] - src[sl]) ** 2).sum(dtype=np.int32)
            s1 = ((rest[sl] - src[sl]) ** 2).sum(dtype=np.int32)
            take = (np.float32(s1) + np.float32(lam) * np.float32(rate)
                    < np.float32(s0))
            assert bool(choice[ur, uc]) == take, (ur, uc)
            if take:
                want[sl] = rest[sl]
    assert np.array_equal(comp.numpy(), want)
    assert choice.any() and not choice.all()


# -- the whole chain -------------------------------------------------------------


def _chain_frame(rng, out_w, out_h, damping=3, lrf=True):
    """An encoder-shaped stand-in for the filter chains: SB-padded source
    and recon planes, deblock maps and the speed-6 filter settings at
    quantizer 100."""
    coded_w, coded_h = -(-out_w // 8) * 8, -(-out_h // 8) * 8
    Hp, Wp = -(-coded_h // 64) * 64, -(-coded_w // 64) * 64
    src, rec = [], []
    for hh, ww in ((Hp, Wp), (Hp >> 1, Wp >> 1), (Hp >> 1, Wp >> 1)):
        s, r = _content(rng, hh, ww)
        src.append(s)
        rec.append(r)
    return dict(h=Hp, w=Wp, coded_h=coded_h, coded_w=coded_w, out_w=out_w,
                out_h=out_h, bd=8, _is420=True, src=src, rec=rec,
                db_info=_tiling(rng, Hp, Wp), lf_levels=(18, 14, 10, 9),
                lf_sharpness=0, cdef_damping=damping, lrf=lrf,
                sgr_search=False, q=100, lam=812.5, stats=_Stage())


def _jax_taps(jfe):
    """A stand-in for K7's plain version that returns the JAX chain's taps
    (_wiener_solve_dev's, with the tap rule of filter_chain_jax.py:252-256)
    after checking that it is asked to solve for the JAX chain's CDEF
    output: on equal inputs the JAX solve gives those taps."""
    jtaps, jen = jfe._chain_lr[2], jfe._chain_lr[3]

    def solve(ds, ss):
        for p, d in enumerate(ds):
            assert np.array_equal(d.numpy(), jfe.rec[p][: d.shape[0],
                                                     : d.shape[1]]), p
        return (torch.from_numpy(np.asarray(jtaps, np.int32)),
                torch.from_numpy(np.asarray(jen, np.int32)))
    return solve


def _port_chain(base, **over):
    fe = SimpleNamespace(**{**base, **over})
    fe.rec = [p.copy() for p in base["rec"]]
    assert tfc.collect_filter_chain(fe, tfc.launch_filter_chain(fe))
    return fe


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX chain (deblock, CDEF search at damping 3 with per-SB
    strengths, fused LR) on a 318x236 frame (coded 320x240)."""
    base = _chain_frame(np.random.default_rng(SEED + 5), 318, 236)
    Hp, Wp = base["h"], base["w"]
    pack = np.concatenate([base["src"][0].ravel(), base["src"][1].ravel(),
                           base["src"][2].ravel()]).astype(np.uint8)
    assert pack.size == Hp * Wp * 3 // 2
    jfe = SimpleNamespace(**base, _src_dev=jnp.asarray(pack))
    jfe.rec = [p.copy() for p in base["rec"]]
    assert jfc.collect_filter_chain(jfe, jfc.launch_filter_chain(jfe))
    return base, jfe


@pytest.mark.parametrize("resident", [False, True])
def test_chain_matches_jax(jax_chain, monkeypatch, resident):
    """launch/collect of the whole chain, with the JAX chain's taps in
    place of K7's: the CDEF output, the strength choice and the fused LR
    decision (composed planes, choices, taps, en) equal the JAX chain's,
    uploading the whole recon or splicing the host stripe into the
    wavefront's resident planes."""
    base, jfe = jax_chain
    monkeypatch.setattr(tlr, "wiener_solve_plain", _jax_taps(jfe))
    dev = None
    if resident:
        dev = [_t(p.copy()).to(torch.uint8) for p in base["rec"]]
        for p, d in enumerate(dev):
            d[(192 >> (p > 0)):] = 7  # below the SB region: never read
    fe = _port_chain(base, device="cpu", _wf_dev_out=dev)
    for p in range(3):
        assert np.array_equal(fe.rec[p], jfe.rec[p]), p
    assert fe.cdef_strengths == jfe.cdef_strengths
    assert (fe.cdef_sb is None) == (jfe.cdef_sb is None)
    if fe.cdef_sb is not None:
        assert fe.cdef_sb[:3] == jfe.cdef_sb[:3]
        assert np.array_equal(fe.cdef_sb[3], jfe.cdef_sb[3])
    comp, choice, taps, en = fe._chain_lr
    jcomp, jchoice, jtaps, jen = jfe._chain_lr
    assert np.array_equal(taps, jtaps) and np.array_equal(en, jen)
    for p in range(3):
        assert np.array_equal(comp[p], jcomp[p]), p
        assert np.array_equal(choice[p], jchoice[p]), p
    assert choice[0].any()


def test_chain_own_solve_against_jax(jax_chain):
    """With its own tap solve the port's chain gives the JAX chain's CDEF
    output and choices; its taps equal the JAX taps or differ at a tie."""
    base, jfe = jax_chain
    fe = _port_chain(base, device="cpu", _wf_dev_out=None)
    for p in range(3):
        assert np.array_equal(fe.rec[p], jfe.rec[p]), p
    taps, jtaps = fe._chain_lr[2], jfe._chain_lr[2]
    assert np.abs(taps - jtaps).max() <= 1
    if np.array_equal(taps, jtaps):
        for p in range(3):
            assert np.array_equal(fe._chain_lr[0][p], jfe._chain_lr[0][p])


def _deblocked(base):
    rec = [p.copy() for p in base["rec"]]
    jdnp.deblock_frame(rec, base["db_info"], base["lf_levels"], 0, 8,
                       base["coded_w"], base["coded_h"])
    return rec


def test_chain_cdef_only_matches_numpy():
    """CDEF without LR (sb_lam = inf: one strength pair for the frame):
    the output is cdef_np.cdef_frame_batched with the chosen pair over
    deblock_np's frame, and the pair is the frame's exact SSE argmin."""
    base = _chain_frame(np.random.default_rng(SEED + 6), 192, 128, lrf=False)
    fe = _port_chain(base, device="cpu", _wf_dev_out=None)
    assert fe.cdef_sb is None and fe._chain_lr is None
    y_s, uv_s = fe.cdef_strengths
    h, w = base["coded_h"], base["coded_w"]
    ssd = {}
    for k, ((yp, ys), uvi) in enumerate(zip(jcd.Y_CANDIDATES,
                                            jcd.PAIR_UV_IDX)):
        rec = _deblocked(base)
        jcnp.cdef_frame_batched(rec, base["db_info"].skip, yp, ys,
                                jcd.UV_CANDIDATES[uvi][0], 0, 3, 8, w, h)
        ssd[k] = (sum(int(((rec[p][: h >> (p > 0), : w >> (p > 0)]
                            - base["src"][p][: h >> (p > 0), : w >> (p > 0)])
                           ** 2).sum()) for p in range(3)), rec)
    best = min(ssd, key=lambda k: ssd[k][0])
    assert (y_s, uv_s) == tuple(c[0] for c in jcd.strength_codes(False, best)[1:])
    for p in range(3):
        assert np.array_equal(fe.rec[p], ssd[best][1][p]), p


def test_chain_lr_only_matches_numpy():
    """LR without CDEF: each plane's composed output is
    lrf_np.wiener_filter_frame over deblock_np's frame (as both the CDEF
    output and the deblocked rows) where the unit chose Wiener."""
    base = _chain_frame(np.random.default_rng(SEED + 7), 190, 126,
                        damping=0)
    base["lam"] = 50.0  # a low rate cost: some units take Wiener
    fe = _port_chain(base, device="cpu", _wf_dev_out=None)
    assert fe.cdef_strengths is None
    dbk = _deblocked(base)
    comp, choice, taps, en = fe._chain_lr
    ow, oh = base["out_w"], base["out_h"]
    for p, (hh, ww, unit) in enumerate(((oh, ow, 64),
                                        ((oh + 1) >> 1, (ow + 1) >> 1, 32),
                                        ((oh + 1) >> 1, (ow + 1) >> 1, 32))):
        rest = jlnp.wiener_filter_frame(dbk[p], dbk[p], taps[2 * p],
                                        taps[2 * p + 1], unit, 8, ww, hh)
        want = dbk[p][:hh, :ww].copy()
        for ur, (y0, y1) in enumerate(jlnp.unit_ranges(unit, hh, True)):
            for uc, (x0, x1) in enumerate(jlnp.unit_ranges(unit, ww)):
                if choice[p][ur, uc]:
                    want[y0:y1, x0:x1] = rest[y0:y1, x0:x1]
        assert np.array_equal(comp[p], want), p
        assert choice[p].shape == (jlnp.count_units(unit, hh),
                                   jlnp.count_units(unit, ww))
    assert en[0] and choice[0].any()
