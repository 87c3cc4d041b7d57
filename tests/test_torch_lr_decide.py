"""The LR decision of a filter chain without its fused LR stage (PERF.md
row 9b), against the JAX package on the CPU.

With RAV1E_TPU_LR_FUSE=0 both packages run the chain without its LR
stage, keep its deblocked and CDEF planes and the sources on the device,
solve the frame's Wiener taps on the host (lrf_np.solve_wiener) and
decide every restoration unit with one device call a plane
(`lr_decide_device`: the JAX package's jitted program, the port's K8 in
its unit-choice mode).

- `lr_decide_device` of both packages on the same seeded planes (each
  package's stand-in encoder holding its own device arrays) at 320x240
  and 256x128, heights the stripe rule of ROADMAP F7 does not reach:
  with taps on every plane, without chroma taps, and without luma taps.
  Composed planes and unit choices identical.
- One 320x240 speed-6 key frame of the bench content encoded by both
  packages with the switch set: given the JAX fdct, the port writes the
  JAX package's bytes and recon (the taps come from the same host
  solve), and its stream decodes with libdav1d to its recon.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import lrf_jax as jlr
from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu_torch.ops import lrf as tlr
from rav1e_tpu_torch.ops import lrf_np as lr
from rav1e_tpu_torch.ops import transforms as tt
from rav1e_tpu_torch.utils import dav1d_oracle as dav1d
from rav1e_tpu_torch.utils.content import make_planes

# one intra-op thread: the suite runs several test processes side by
# side on the CPU
torch.set_num_threads(1)

SEED = 20261018
LAM = 400.0


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Free the JAX programs this module compiled when it ends: each of
    the suite's worker processes runs many modules, and their compiled
    programs would otherwise stay resident for the rest of the run."""
    yield
    jax.clear_caches()


class _Frame:
    """The fields of a frame encoder that lr_decide_device reads."""

    bd = 8
    lam = LAM


def _planes(out_h: int, out_w: int, seed: int):
    """(source, CDEF output, deblocked) planes of each of Y, U, V at the
    8-aligned coded size: smooth content, coded with noise on the left
    half of each plane (units there gain from the Wiener filter, units on
    the clean right half do not)."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(3):
        s = 0 if p == 0 else 1
        hh, ww = ((out_h + 7) & ~7) >> s, ((out_w + 7) & ~7) >> s
        yy, xx = np.mgrid[0:hh, 0:ww]
        src = (128 + 60 * np.sin(yy / (9.0 - 3 * s) + p)
               * np.cos(xx / 13.0)).astype(np.int32)
        noise = rng.integers(-9, 10, (hh, ww)) * (xx < ww // 2)
        cd = np.clip(src + noise, 0, 255).astype(np.int32)
        db = np.clip(cd + rng.integers(-2, 3, (hh, ww)), 0, 255).astype(
            np.int32)
        out.append((src, cd, db))
    return out


def _taps(planes, out_h: int, out_w: int):
    """The host solve of the three planes, as the encoders run it."""
    ch, cw = (out_h + 1) >> 1, (out_w + 1) >> 1
    vt, ht = lr.solve_wiener(planes[0][1][:out_h, :out_w],
                             planes[0][0][:out_h, :out_w])
    taps_c = {}
    for p in (1, 2):
        v, h = lr.solve_wiener(planes[p][1][:ch, :cw], planes[p][0][:ch, :cw])
        taps_c[p] = ((0, int(v[1]), int(v[2])), (0, int(h[1]), int(h[2])))
    return (vt, ht), taps_c


def _jax_frame(planes, out_h: int, out_w: int):
    fe = _Frame()
    fe.out_h, fe.out_w = out_h, out_w
    fe.h, fe.w = (out_h + 63) & ~63, (out_w + 63) & ~63
    src = []
    for p, (s, _cd, _db) in enumerate(planes):
        sub = 0 if p == 0 else 1
        pad = np.zeros((fe.h >> sub, fe.w >> sub), np.uint8)
        pad[: s.shape[0], : s.shape[1]] = s
        src.append(pad.ravel())
    fe._src_dev = jnp.asarray(np.concatenate(src))
    u16 = [(jnp.asarray(cd.astype(np.uint16)), jnp.asarray(db.astype(
        np.uint16))) for _s, cd, db in planes]
    fe._dev_cdef, fe._dev_db = u16[0]
    fe._dev_cdef_c = (u16[1][0], u16[2][0])
    fe._dev_db_c = (u16[1][1], u16[2][1])
    return fe


def _port_frame(planes, out_h: int, out_w: int):
    fe = _Frame()
    fe.out_h, fe.out_w = out_h, out_w
    t = [(torch.from_numpy(s), torch.from_numpy(cd), torch.from_numpy(db))
         for s, cd, db in planes]
    fe._dev_src = [s for s, _cd, _db in t]
    fe._dev_cdef, fe._dev_db = t[0][1], t[0][2]
    fe._dev_cdef_c = (t[1][1], t[2][1])
    fe._dev_db_c = (t[1][2], t[2][2])
    return fe


@pytest.mark.parametrize("taps", ["all", "no_chroma", "no_luma"])
@pytest.mark.parametrize("out_w,out_h", [(320, 240), (256, 128)])
def test_lr_decide_device_matches_jax(out_w, out_h, taps):
    planes = _planes(out_h, out_w, SEED + out_h)
    taps_y, taps_c = _taps(planes, out_h, out_w)
    if taps == "no_chroma":
        taps_c = {}
    elif taps == "no_luma":
        taps_y = None
    ref = jlr.lr_decide_device(_jax_frame(planes, out_h, out_w), taps_y,
                               taps_c)
    got = tlr.lr_decide_device(_port_frame(planes, out_h, out_w), taps_y,
                               taps_c)
    assert ref is not None and got is not None
    (jcomp, jchoice), (comp, choice) = ref, got
    for p in range(3):
        assert comp[p].dtype == np.int32
        assert np.array_equal(comp[p], jcomp[p]), p
        assert np.array_equal(choice[p], jchoice[p]), p
    if taps_y is not None:
        # the noisy half restores, the clean half does not
        assert choice[0].any() and not choice[0].all()
    else:
        assert not choice[0].any()
        assert np.array_equal(comp[0], planes[0][1][:out_h, :out_w])
    chroma = choice[1].any() or choice[2].any()
    assert chroma == (taps != "no_chroma")


def test_lr_decide_device_declines_without_planes():
    """A frame of the host filter path (no chroma planes on the device)
    takes the host per-unit path in both packages."""
    planes = _planes(128, 256, SEED)
    taps_y, taps_c = _taps(planes, 128, 256)
    jfe, fe = _jax_frame(planes, 128, 256), _port_frame(planes, 128, 256)
    jfe._dev_cdef_c = fe._dev_cdef_c = None
    assert jlr.lr_decide_device(jfe, taps_y, taps_c) is None
    assert tlr.lr_decide_device(fe, taps_y, taps_c) is None


# -- a key frame with the switch set ----------------------------------------------

W, H = 320, 240
_fdct_jit = jax.jit(tj.fdct_batch)


def _jax_fdct(resid, Fv, FhT):
    """The JAX package's fdct_batch, as a drop-in for tt.fdct_plain."""
    return torch.from_numpy(np.array(_fdct_jit(
        jnp.asarray(resid.numpy()), jnp.asarray(Fv.numpy()),
        jnp.asarray(FhT.numpy()))))


def _encode(pkg: str, **cfg_kw):
    """One key frame of the bench content at speed 6's defaults (CDEF and
    LR on), quantizer 100, low latency.  Returns (packets, recon
    planes)."""
    import importlib

    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    Fr = importlib.import_module(pkg + ".utils.frame")
    cfg = C.Config(enc=C.EncoderConfig(
        width=W, height=H, quantizer=100, min_key_frame_interval=1,
        max_key_frame_interval=1, rdo_lookahead_frames=8, low_latency=True,
        speed_settings=C.SpeedSettings.from_preset(6)), **cfg_kw)
    ctx = cfg.new_context()
    pkts = []
    y, u, v = make_planes(W, H, 1)[0]
    ctx.send_frame(Fr.Frame.from_planes(y, u, v))
    ctx.flush()
    while True:
        try:
            pkts.append(ctx.receive_packet())
        except X.EncoderError as e:
            if e.status in (X.EncoderStatus.NEED_MORE_DATA,
                            X.EncoderStatus.LIMIT_REACHED):
                break
            raise
    return [p.data for p in pkts], ctx._encoder.recon_by_input[0]


@pytest.fixture(scope="module")
def unfused_runs():
    """Both packages' encodes with RAV1E_TPU_LR_FUSE=0 (the port's with
    the JAX fdct), and how often each decided on the device."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RAV1E_TPU_LR_FUSE", "0")
    mp.setattr(tt, "fdct_plain", _jax_fdct)
    calls = {"jax": 0, "port": 0}
    for mod, key in ((jlr, "jax"), (tlr, "port")):
        orig = mod.lr_decide_device

        def spy(fe, ty, tc, _orig=orig, _key=key):
            res = _orig(fe, ty, tc)
            calls[_key] += res is not None
            return res
        mp.setattr(mod, "lr_decide_device", spy)
    try:
        jax_run = _encode("rav1e_tpu")
        port_run = _encode("rav1e_tpu_torch", device="cpu")
    finally:
        mp.undo()
    return jax_run, port_run, calls


def test_unfused_key_frame_matches_jax(unfused_runs):
    (jdata, jrecon), (data, recon), calls = unfused_runs
    assert calls == {"jax": 1, "port": 1}
    assert data == jdata
    for p in range(3):
        assert np.array_equal(np.asarray(recon[p]), np.asarray(jrecon[p])), p


def test_unfused_key_frame_decodes_to_recon(unfused_runs):
    _jax_run, (data, recon), _calls = unfused_runs
    dec = dav1d.decode_stream(data)
    assert len(dec) == 1
    for p in range(3):
        r = np.asarray(recon[p])
        assert np.array_equal(dec[0][p][: r.shape[0], : r.shape[1]],
                              r.astype(np.uint8)), p
